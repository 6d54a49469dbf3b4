"""A first layer of fan-in above 8 on K2 and K3, on the CPU: the wide
route takes it as an ordinary layer (``wide.py``: an ``OP_MM`` over the
log-clamped input, read from device memory a 128-column chunk at a time,
and in K3 its backward e_0 @ W_0ᵀ at the backward tier, a chunk of dx at
a time), as JAX's kernels run it (``layer_mode_plan``: a tier matmul,
``_dot_refs`` at the backward tier). Fan-in 12, and 160 (two input
chunks), on hidden (64, 64).

The program's emulation (``tests/_torch_f32.py::emulate_wide``) and the
port's plain versions are held to each other and to the JAX package's
Pallas K2 and K3 (interpret mode) on the same NumPy weights at every K2
tier and K3 pair, with ``tests/test_torch_wide_routes.py``'s tolerances:
values within rtol·(|logL| + c/2) + 1e-2 nats (rtol 1e-5 fp32, 1e-4
bf16x3, 5e-3 bf16; a DEFAULT forward, which the Pallas kernels compute in
fp32 on the CPU, against plain alone); gradients under ``bench_mcmc.py``'s
gate at an fp32 value tier, else no less accurate than plain against
Pallas's fp32 gradient by the gate's margins (``grad_gate_beside``). The
plain likelihoods and the emulator of a fan-in-12 model take it as JAX's
do. A skinny network's program is the one the planner gave it before the
dense layer was added, op for op.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_f32 import emulate_wide
from _torch_pair import one_torch_thread  # noqa: F401

from tpu21cmvae.ops.loglik import make_loglik as jax_make_loglik
from tpu21cmvae.ops.loglik import make_loglik_and_grad as jax_make_loglik_and_grad
from tpu21cmvae.ops.mlp import init_mlp
from tpu21cmvae.ops.mlp import mlp_apply as jax_mlp_apply
from tpu21cmvae.ops.pallas.fused_loglik import make_fused_loglik_grad_gram as jax_k3
from tpu21cmvae.ops.pallas.fused_loglik import make_fused_loglik_gram as jax_k2
from tpu21cmvae.ops.pallas.fused_mlp import _log_clamp as jax_log_clamp
from tpu21cmvae.ops.pallas.fused_mlp import fold_emulator_constants as jax_fold
from tpu21cmvae.ops.transforms import Normalizer as JaxNormalizer
from tpu21cmvae.utils.config import DirectEmulatorConfig as JaxConfig
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.ops.kernels import wide
from tpu21cmvae_torch.ops.kernels.fused_loglik import (
    k2_route,
    k3_route,
    loglik_grad_gram_reference,
    loglik_gram_reference,
    make_fused_loglik_grad_gram,
    make_fused_loglik_gram,
)
from tpu21cmvae_torch.ops.loglik import make_loglik, make_loglik_and_grad
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig
from tpu21cmvae_torch.utils.metrics import grad_gate_beside, grad_gate_violation

TIERS = ("highest", "high", "default")
ROUTES = [(t, None) for t in TIERS] + [(a, b) for a in TIERS for b in TIERS]
IDS = [f"k2-{t}" for t in TIERS] + [f"k3-{a}-{b}" for a, b in ROUTES[3:]]
VALUE_RTOL = {"highest": 1e-5, "high": 1e-4, "default": 5e-3}
TIER = {"highest": "f32", "high": "bf16x3", "default": "bf16"}
HIDDEN = (64, 64)
NOISE_VAR = 25.0


@pytest.fixture(scope="module")
def fan_in():
    """Per fan-in and hidden widths: JAX's config, normalizer and
    weights, the port's emulator on the same NumPy arrays, an observation
    and 37 raw rows (log columns positive, one fx == 0 row)."""
    cache = {}

    def get(n_params, hidden=HIDDEN):
        if (n_params, hidden) not in cache:
            rng = np.random.default_rng(n_params)
            raw = rng.uniform(0.2, 3.0, (37, n_params)).astype(np.float32)
            logs = np.asarray(jax_log_clamp(jnp.asarray(raw)))
            span = logs.max(0) - logs.min(0)
            norm = {"signal_mean": rng.normal(0, 20.0, 451).astype(np.float32),
                    "signal_std": np.float32(30.0),
                    "par_min": (logs.min(0) - 0.1 * span).astype(np.float32),
                    "par_max": (logs.max(0) + 0.1 * span).astype(np.float32)}
            raw[5, 2] = 0.0
            config = JaxConfig(n_params=n_params, hidden_dims=hidden)
            jparams = init_mlp(jax.random.key(n_params), config.mlp().sizes)
            jnorm = JaxNormalizer(**{k: jnp.asarray(v) for k, v in norm.items()})
            tm = DirectEmulator.from_numpy(
                jax.tree_util.tree_map(np.asarray, jparams), norm,
                config=DirectEmulatorConfig(n_params=n_params, hidden_dims=hidden),
                device="cpu")
            sig = np.asarray(tm.predict(raw[0]))
            obs = (sig + rng.normal(0, 5.0, sig.shape)).astype(np.float32)
            cache[n_params, hidden] = (config, jnorm, jparams, tm, obs, raw)
        return cache[n_params, hidden]

    return get


def _close(got, want, c, tier):
    tol = VALUE_RTOL[tier] * (np.abs(want) + 0.5 * abs(c)) + 1e-2
    assert bool((np.abs(got - want) <= tol).all()), float((np.abs(got - want) / tol).max())


def _outputs(out):
    return tuple(np.asarray(t) for t in (out if isinstance(out, tuple) else (out,)))


@pytest.mark.parametrize("tiers", ROUTES, ids=IDS)
@pytest.mark.parametrize("n_params", [12, 160])
def test_dense_first_layer_matches_pallas(fan_in, n_params, tiers):
    """The wide route's program with a dense first layer, emulated, and
    the port's plain version against each other and against JAX's Pallas
    K2 (``make_fused_loglik_gram``) or K3 (``make_fused_loglik_grad_gram``)
    on the same weights: the route is the wide one with a dense plan;
    values within the value tier's tolerance (a DEFAULT forward against
    plain alone); gradients under the gate at an fp32 value tier (against
    Pallas too at (fp32, fp32)), else beside plain against Pallas's fp32
    gradient; the fx == 0 slot exactly 0."""
    config, jnorm, jparams, tm, obs, raw = fan_in(n_params)
    k3 = tiers[1] is not None
    if k3:
        fn = make_fused_loglik_grad_gram(tm.config, tm.normalizer, obs, NOISE_VAR,
                                         precision=tiers[0], grad_precision=tiers[1],
                                         device="cpu")
        pallas = jax_k3(config, jnorm, obs, NOISE_VAR, precision=tiers[0],
                        grad_precision=tiers[1], block_rows=40, interpret=True)
        assert k3_route((n_params, *HIDDEN), TIER[tiers[0]], TIER[tiers[1]]) == "wide"
    else:
        fn = make_fused_loglik_gram(tm.config, tm.normalizer, obs, NOISE_VAR,
                                    precision=tiers[0], device="cpu")
        pallas = jax_k2(config, jnorm, obs, NOISE_VAR, precision=tiers[0], block_rows=40,
                        interpret=True)
        assert k2_route((n_params, *HIDDEN), TIER[tiers[0]]) == "wide"
    assert fn.wide and fn.plan.dense
    ops = fn.operands(tm.params)
    assert ops.dense and ops.widths == (n_params, *HIDDEN) and (ops.w0t is not None) == k3
    x = torch.as_tensor(raw)
    want = _outputs(pallas(jparams, jnp.asarray(raw)))
    plain = _outputs(fn(tm.params, x))
    ref = _outputs((loglik_grad_gram_reference if k3 else loglik_gram_reference)(ops, x))
    assert all(np.array_equal(a, b) for a, b in zip(plain, ref))  # the wrapper's plain version
    got = _outputs(emulate_wide(ops, x))
    assert all(np.isfinite(t).all() for t in got)
    c = float(ops.c)
    _close(got[0], plain[0], c, tiers[0])
    if tiers[0] != "default":
        _close(got[0], want[0], c, tiers[0])
        _close(plain[0], want[0], c, tiers[0])
    if not k3:
        return
    assert got[1][5, 2] == 0.0 and plain[1][5, 2] == 0.0
    if tiers[0] == "highest":
        assert grad_gate_violation(got[1], plain[1]) <= 0.0
    if tiers == ("highest", "highest"):
        assert grad_gate_violation(got[1], want[1]) <= 0.0
        assert grad_gate_violation(plain[1], want[1]) <= 0.0
    else:
        assert grad_gate_beside(got[1], plain[1], want[1]) <= 0.0


@pytest.mark.parametrize("tiers", [("high", None), ("highest", "default"), ("high", "high")])
def test_dense_workspace_plan_is_the_shared_plan_bit_for_bit(fan_in, tiers):
    """Fan-in 160 on hidden (1200, 1300) under a 120,000-byte budget: the
    plan spills the dense activation 0 (and at K3 the signals) to the
    workspace where the all-shared plan holds them; the emulation of both
    gives the same values and gradients bit for bit."""
    import dataclasses

    from tpu21cmvae_torch.ops.kernels.fused_loglik import ops_plan, pack_wide_operands

    _, _, _, tm, obs, raw = fan_in(160, (1200, 1300))
    if tiers[1] is None:
        fn = make_fused_loglik_gram(tm.config, tm.normalizer, obs, NOISE_VAR,
                                    precision=tiers[0], device="cpu")
    else:
        fn = make_fused_loglik_grad_gram(tm.config, tm.normalizer, obs, NOISE_VAR,
                                         precision=tiers[0], grad_precision=tiers[1],
                                         device="cpu")
    base = dataclasses.replace(fn.operands(tm.params), slabs=None, packed=None, program=None,
                               frags=None)
    plan = ops_plan(base, 120_000)
    assert ("a", 0) in plan.spilled and not ops_plan(base).spilled
    assert (("e", 0) in plan.spilled) == (tiers[1] is not None)
    x = torch.as_tensor(raw[:9])
    want = _outputs(emulate_wide(pack_wide_operands(base), x))
    got = _outputs(emulate_wide(pack_wide_operands(base, 120_000), x, plan))
    assert all(np.array_equal(a, b) for a, b in zip(want, got))


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_fan_in_12_plain_paths_match_jax(fan_in, precision):
    """A fan-in-12 direct model's plain paths take the first layer as a
    tier matmul, as JAX's do: ``predict`` against JAX's ``mlp_apply`` on
    the folded weights; ``make_loglik`` (direct and gram) and
    ``make_loglik_and_grad`` (``backend="torch"``) against JAX's XLA
    functions at the same tier; and the kernel backend's wrappers (their
    plain versions here) on the wide route."""
    config, jnorm, jparams, tm, obs, raw = fan_in(12)
    x = torch.as_tensor(raw)
    want = np.asarray(jax_mlp_apply(jax_fold(jparams, jnorm), jax_log_clamp(jnp.asarray(raw)),
                                    precision="highest"))
    got = tm.predict(raw)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    for method in ("direct", "gram"):
        mine = make_loglik(tm.config, tm.normalizer, obs, NOISE_VAR, method=method,
                           precision=precision)(tm.params, x).detach().numpy()
        theirs = np.asarray(jax_make_loglik(config, jnorm, obs, NOISE_VAR, method=method,
                                            precision=precision)(jparams, jnp.asarray(raw)))
        _close(mine, theirs, 2.0 * np.abs(theirs).max(), precision)
    v, g = make_loglik_and_grad(tm.config, tm.normalizer, obs, NOISE_VAR,
                                precision=precision)(tm.params, x)
    vj, gj = jax_make_loglik_and_grad(config, jnorm, obs, NOISE_VAR,
                                      precision=precision)(jparams, jnp.asarray(raw))
    _close(v.detach().numpy(), np.asarray(vj), 2.0 * np.abs(np.asarray(vj)).max(), precision)
    assert grad_gate_violation(g.detach().numpy(), np.asarray(gj)) <= 0.0
    kernel = make_loglik_and_grad(tm.config, tm.normalizer, obs, NOISE_VAR, backend="kernel",
                                  precision=precision)
    assert kernel.wide
    kv, kg = kernel(tm.params, x)
    _close(kv.detach().numpy(), np.asarray(vj), 2.0 * np.abs(np.asarray(vj)).max(), precision)
    assert grad_gate_violation(kg.detach().numpy(), np.asarray(gj)) <= 0.0


# The programs of skinny networks as the planner gave them before K1's
# program and the dense first layer were added: sha256 of (ops, blocks, frags,
# cols, mask columns, masks in the workspace, workspace rows, stream rows,
# A-tile parts, heights), its first 16 hex digits, by (hidden, parts,
# grad_parts)
SKINNY_PROGRAMS = {
    ((3200, 64, 64), 0, None): "29dffec1f5001713", ((3200, 64, 64), 2, None): "59b9db91e680ae8e",
    ((3200, 64, 64), 1, None): "e161d5d62c8ff9ce", ((3200, 64, 64), 0, 0): "0319ed3111477ad1",
    ((3200, 64, 64), 2, 1): "6546f7456d2511bd", ((3200, 64, 64), 1, 2): "d76c8b19a333a97b",
    ((3200, 64, 64), 2, 0): "77417d266deb0a1c", ((3200, 64, 64), 0, 1): "6270f10b09d83476",
    ((4096, 4096), 0, None): "29ec910d88d8a408", ((4096, 4096), 2, None): "9f241e44d731f350",
    ((4096, 4096), 1, None): "b5e8655efdc21265", ((4096, 4096), 0, 0): "6aa061161669dce1",
    ((4096, 4096), 2, 1): "7d8dd4a88d3831bd", ((4096, 4096), 1, 2): "ff4e69236354840f",
    ((4096, 4096), 2, 0): "9d77b4507b5aa856", ((4096, 4096), 0, 1): "86575062a1525c78",
    ((256,) * 12, 0, None): "ebacf9afdbc2deea", ((256,) * 12, 2, None): "412de4e6e878b76a",
    ((256,) * 12, 1, None): "6dfce4d3b8bf802c", ((256,) * 12, 0, 0): "4e791f56234b841c",
    ((256,) * 12, 2, 1): "395e7604e729fd02", ((256,) * 12, 1, 2): "274418c457ba4650",
    ((256,) * 12, 2, 0): "8dc8e80ce9fcd31d", ((256,) * 12, 0, 1): "abcdb8ec22c47007",
    ((1536,) * 3, 0, None): "197d751106010f73", ((1536,) * 3, 2, 1): "d0b81f3c67ee95f7",
    ((640, 520, 384), 2, None): "f6427babe9768308", ((640, 520, 384), 1, 2): "e1175814d738bc08",
}


@pytest.mark.parametrize("key", list(SKINNY_PROGRAMS), ids=lambda k: f"{k[0][:3]}-{k[1]}-{k[2]}")
def test_skinny_programs_are_unchanged(key):
    """A skinny network's plan (fan-in 7) is unchanged op for op: its
    digest is the one the planner gave before K1's program and the dense
    first layer were added, and it has no op of theirs."""
    hidden, parts, grad = key
    plan = wide.wide_plan((7, *hidden), parts, grad)
    fields = (plan.ops, plan.blocks, plan.frags, plan.cols, plan.mask_cols, plan.masks_in_ws,
              plan.ws_cols, plan.stream_rows, plan.a_parts, plan.heights)
    assert hashlib.sha256(repr(fields).encode()).hexdigest()[:16] == SKINNY_PROGRAMS[key]
    assert not plan.dense and not {wide.OP_INPUT, wide.OP_OUT} & {op[0] for op in plan.ops}
