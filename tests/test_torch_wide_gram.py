"""K3's wide route, ``csrc/fused_loglik_grad_gram.cu``, on the CPU: its
plan (``tpu21cmvae_torch/ops/kernels/wide.py``), the routing that sends a
network there, and its arithmetic through the packed operands.

The kernel runs the op program the plan builds; here
``tests/_torch_f32.py::emulate_wide`` runs the same program on
the CPU — the chunk order, the recomputed skinny chunks, the mask bits,
the split layers, the quad and dx summed per (row, slice) — and is held
to the port's plain version on 37 rows with an fx == 0 row, at (fp32,
fp32) and at both reverse pairs (the arithmetic is the same at every
tile height the kernel is built for), and to the JAX package's Pallas K3 (interpret mode, as JAX's
own tests run it) at (fp32, fp32) and (high, highest); JAX's DEFAULT
forward runs in fp32 under XLA on the CPU, so (default, highest) is
held to plain alone (as ``test_torch_reverse_gram.py`` does).

Tolerances: between the emulation and the plain version, which differ in
fp32 summation order and (at a reverse pair) in the grouping of the bf16
products, values within rtol·(|logL| + c/2) + 1e-2 nats at the value
tier's rtol (1e-5 fp32, 1e-4 bf16x3, 5e-3 bf16: ``chip_smoke.py``'s
VALUE_RTOL) and gradients under ``bench_mcmc.py``'s gate; against the
Pallas K3 the same, and at (fp32, fp32) also test_loglik's tolerance
(``tests/test_loglik.py:468-472``: values rtol 2e-4, atol 2e-3·max|v|;
gradients rtol 2e-3, atol 2e-3·max|g|).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_f32 import emulate_wide
from _torch_pair import one_torch_thread  # noqa: F401
from test_torch_fused_loglik import port_model  # noqa: F401

from tpu21cmvae.models.direct import DirectEmulator as JaxEmulator
from tpu21cmvae.ops.loglik import make_loglik_and_grad as jax_make_loglik_and_grad
from tpu21cmvae.ops.pallas.fused_mlp import _layer_matmul
from tpu21cmvae.utils.config import DirectEmulatorConfig as JaxConfig
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.ops.kernels import wide
from tpu21cmvae_torch.ops.kernels._common import MAX_SHARED_BYTES, TIER_CODE, member_strides
from tpu21cmvae_torch.ops.kernels.fused_loglik import (
    _kernel,
    grad_f32_heights,
    grad_reverse_bytes,
    loglik_grad_gram_reference,
    make_fused_loglik_grad_gram,
    pack_wide_operands,
    shared_bytes,
)
from tpu21cmvae_torch.ops.mlp import fused_skinny_dense, skinny_dense
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig
from tpu21cmvae_torch.utils.metrics import grad_gate_violation

# a wide skinny layer (the route's first example), one into a single column, a wide
# middle layer, and two adjacent wide layers
WIDE = [(3200, 64, 64), (3623, 1), (100, 3300, 64), (1700, 1700, 8)]
PAIRS = [("highest", "highest"), ("high", "highest"), ("default", "highest")]
VALUE_RTOL = {"highest": 1e-5, "high": 1e-4, "default": 5e-3}
TIER = {"highest": "f32", "high": "bf16x3", "default": "bf16"}
# tests/test_torch_fused_loglik.py's trunks of the fp32 K3's coverage test
F32_TRUNKS = [(7, 1812), (7, 1200, 1200), (7, 896, 896, 896), (8, 30, 1000, 1000),
              (7, 288, 352, 288, 224), (7, 2900, 300), (7, 2900, 8, 8)]


@pytest.fixture(scope="module")
def wide_pair(splits):
    """Per hidden widths: a JAX emulator, the port on its weights, an
    observation and 37 raw rows with an fx == 0 row."""
    cache = {}

    def get(hidden):
        if hidden not in cache:
            jm = JaxEmulator(splits, config=JaxConfig(hidden_dims=hidden), seed=2)
            tm = DirectEmulator.from_numpy(
                jax.tree_util.tree_map(np.asarray, jm.params),
                jax.tree_util.tree_map(np.asarray, jm.normalizer),
                config=DirectEmulatorConfig(hidden_dims=hidden), device="cpu")
            sig = jm.predict(splits.par_test[0])
            obs = (sig + np.random.default_rng(5).normal(0, 5.0, sig.shape)).astype(np.float32)
            raw = np.asarray(splits.par_test[:37], np.float32).copy()
            raw[5, 2] = 0.0
            cache[hidden] = (jm, tm, obs, raw)
        return cache[hidden]

    return get


def _wide_ops(tm, obs, tiers):
    """The wide route's operands at ``tiers``: the wrapper's own where it
    routes the network there, else packed for it all the same."""
    fn = make_fused_loglik_grad_gram(tm.config, tm.normalizer, obs, 25.0, precision=tiers[0],
                                     grad_precision=tiers[1], device="cpu")
    ops = fn.operands(tm.params)
    return (ops if fn.wide else pack_wide_operands(dataclasses.replace(ops, slabs=None,
                                                                       packed=None)))


def _close(got, want, c, tier):
    tol = VALUE_RTOL[tier] * (np.abs(want) + 0.5 * abs(c)) + 1e-2
    assert bool((np.abs(got - want) <= tol).all()), float((np.abs(got - want) / tol).max())


@pytest.mark.parametrize("tiers", PAIRS, ids=["-".join(t) for t in PAIRS])
@pytest.mark.parametrize("hidden", WIDE, ids=[str(h) for h in WIDE])
def test_wide_emulation_matches_pallas_and_plain(wide_pair, hidden, tiers):
    """The wide program, emulated through its packed operands, against
    the port's plain version and JAX's Pallas K3 on the
    same weights (plain alone at (default, highest)): values within the
    value tier's tolerance, gradients under the gate, the fx == 0 slot
    exactly 0; at (fp32, fp32) against Pallas also within test_loglik's
    tolerance."""
    jm, tm, obs, raw = wide_pair(hidden)
    ops = _wide_ops(tm, obs, tiers)
    x = torch.as_tensor(raw)
    vp, gp = (t.numpy() for t in loglik_grad_gram_reference(ops, x))
    fn = jax_make_loglik_and_grad(jm.config, jm.normalizer, obs, 25.0, backend="pallas",
                                  precision=tiers[0], grad_precision=tiers[1], block_rows=40,
                                  interpret=True)
    vj, gj = (np.asarray(t) for t in fn(jm.params, jnp.asarray(raw)))
    # JAX's DEFAULT forward runs fp32 under XLA on the CPU, where the port
    # rounds every activation to bf16: (default, highest) is held to plain
    refs = [(vp, gp)] + ([(vj, gj)] if tiers[0] != "default" else [])
    ve, ge = (t.numpy() for t in emulate_wide(ops, x))
    assert np.isfinite(ve).all() and np.isfinite(ge).all()
    assert ge[5, 2] == 0.0
    for v, g in refs:
        _close(ve, v, float(ops.c), tiers[0])
        assert grad_gate_violation(ge, g) <= 0.0
    if tiers == ("highest", "highest"):
        np.testing.assert_allclose(ve, vj, rtol=2e-4, atol=2e-3 * np.abs(vj).max())
        np.testing.assert_allclose(ge, gj, rtol=2e-3, atol=2e-3 * np.abs(gj).max())


def _old_route(trunk, tier):
    """Where K3 at (``tier``, fp32) ran ``trunk`` before the wide route:
    ``"reverse"``, ``"f32"`` (the register-tiled fp32 K3), ``"16-row"``
    (its first kernel: every activation and h@G at 16 rows) or None
    (refused)."""
    if tier != "f32" and grad_reverse_bytes(trunk, tier) <= MAX_SHARED_BYTES:
        return "reverse"
    if tier == "f32" and grad_f32_heights(trunk):
        return "f32"
    return "16-row" if 4 * 16 * (sum(trunk) + trunk[-1]) <= MAX_SHARED_BYTES else None


@pytest.mark.parametrize("trunk", [(7, *h) for h in WIDE] + F32_TRUNKS, ids=str)
def test_wide_routes_where_the_16_row_kernel_ran(port_model, trunk):
    """Each trunk, at (fp32, fp32) and both reverse pairs, routes where it
    did: the reverse mode and the register-tiled fp32 K3 keep theirs, and
    every network the first, 16-row kernel ran now runs the wide route, at a
    height whose shared memory fits; none that ran is refused."""
    m, obs = port_model((32,))
    cfg = DirectEmulatorConfig(hidden_dims=trunk[1:], n_params=trunk[0])
    for tier, grad in PAIRS:
        old = _old_route(trunk, TIER[tier])
        if old is None:
            continue
        fn = make_fused_loglik_grad_gram(cfg, m.normalizer, obs, precision=tier,
                                         grad_precision=grad, device="cpu")
        assert fn.reverse == (old == "reverse") and fn.register_tiled == (old == "f32")
        assert fn.wide == (old == "16-row")
        if fn.wide:
            parts = {"highest": 0, "high": 2, "default": 1}[tier]
            plan = wide.wide_plan(trunk, parts)
            assert fn.heights == plan.heights != ()
            assert shared_bytes(trunk, TIER[tier], "f32") == wide.plan_bytes(
                plan, fn.heights[0]) <= MAX_SHARED_BYTES


def test_wide_route_refuses_no_network_the_16_row_kernel_ran():
    """A seeded sweep of trunks (1 to 8 layers, 1 to 8 inputs, widths
    summing to at most 3625, some with one dominant layer): every one PR
    1's kernel held at (fp32, fp32) or a reverse pair, and the fp32 K3 or
    the reverse mode does not, fits the wide route at some height."""
    rng = np.random.default_rng(19)
    checked = 0
    for i in range(3000):
        n = int(rng.integers(1, 9))
        total = int(rng.integers(n, 3626))
        cuts = np.sort(rng.choice(np.arange(1, total), size=n - 1, replace=False))
        widths = np.diff(np.concatenate([[0], cuts, [total]])).astype(int)
        if i % 3 == 0:  # one dominant layer
            widths[int(rng.integers(n))] += int(rng.integers(0, 3000))
        trunk = (int(rng.integers(1, 9)), *map(int, widths))
        for tier in ("f32", "bf16x3", "bf16"):
            if _old_route(trunk, tier) == "16-row":
                checked += 1
                parts = {"f32": 0, "bf16x3": 2, "bf16": 1}[tier]
                assert wide.wide_plan(trunk, parts).heights, (trunk, tier)
    assert checked > 1000


@pytest.mark.parametrize("tiers", PAIRS, ids=["-".join(t) for t in PAIRS])
def test_wide_entry_and_operands(port_model, tiers):
    """The wide route's C entry, its operands in the order the source reads
    them (w0, b0, the biases, the stream, the program, the fragment buffer:
    at a reverse pair the forward's fragments, none at (fp32, fp32)) and
    its ints (the A tile's parts: the value tier's code, the height, the
    three held tiles' k rows, the mask columns, the stream's rows, the
    program's length, no workspace); the stream holds exactly the rows the
    program's fp32 ops read; a member-batched wrapper's operands have their
    member strides."""
    m, obs = port_model((32,))
    cfg = DirectEmulatorConfig(hidden_dims=(3200, 64, 64))
    fn = make_fused_loglik_grad_gram(cfg, m.normalizer, obs, precision=tiers[0],
                                     grad_precision=tiers[1], device="cpu")
    assert fn.wide
    params = DirectEmulator(config=cfg, normalizer=m.normalizer, seed=1, device="cpu").params
    ops = fn.operands(params)
    plan = wide.wide_plan(ops.widths, TIER_CODE[ops.tier], 0)
    assert fn.plan == plan
    entry, tensors, ints = _kernel(ops, True, rows=fn.rows_for(4096))
    assert entry == "k3_fused_loglik_grad_gram"
    assert ints == [TIER_CODE[ops.tier], fn.heights[0], *plan.cols, plan.mask_cols,
                    plan.stream_rows, len(plan.ops), 0, 0, 0, None]
    frags = None if tiers[0] == "highest" else ops.frags
    assert all(a is b for a, b in zip(tensors, [ops.w0, ops.b0, ops.slabs.b, ops.slabs.w,
                                                ops.program, frags]))
    assert len(tensors) == 6 and (frags is None) == (tiers[0] == "highest")
    assert ops.program.dtype == torch.int32 and ops.program.shape == (len(plan.ops), 16)
    assert ops.slabs.w.numel() == wide.SLAB_N * plan.stream_rows
    read = sum((64 if op[6] & wide.MM_SPLIT else op[3]) * (op[5] - op[4])
               for op in plan.ops if op[0] == wide.OP_MM and op[9] == 0)
    assert read == plan.stream_rows
    # (3200, 64, 64): layer 0 recomputed, 3200 → 64 split on the CUDA
    # cores, e_0 streamed into dx; two 32-row CTAs share an SM
    assert plan.streamed_forward == frozenset() and plan.streamed_backward == {0}
    assert plan.split == ({("a", 1)} if tiers[0] == "highest" else set())
    assert 2 * (wide.plan_bytes(wide.wide_plan(ops.widths, 0), 32) + 1024) <= 233_472
    stacked = make_fused_loglik_grad_gram(cfg, m.normalizer, obs, precision=tiers[0],
                                          grad_precision=tiers[1], members=2, device="cpu")
    two = tuple({k: torch.stack([v, v]) for k, v in layer.items()} for layer in params)
    _, tensors2, _ = _kernel(stacked.operands(two), True, rows=32)
    assert list(member_strides(tensors2, 2)) == [
        0 if t is None else t[0].numel() * t.element_size() for t in tensors2]


@pytest.mark.parametrize("n_in", [1, 7, 8])
def test_fused_skinny_dense_is_the_pallas_skinny_layer(n_in):
    """``fused_skinny_dense`` equals the Pallas kernels' skinny layer
    (``tpu21cmvae/ops/pallas/fused_mlp.py``, ``_layer_matmul`` in its
    ``"skinny"`` mode) bit for bit, evaluated op by op as the kernel body
    is written (under ``jax.disable_jit``: XLA's CPU backend would
    contract a multiply and an add into one fma); ``skinny_dense``, the
    plain ``mlp_apply``'s order, starts from the bias and differs."""
    rng = np.random.default_rng(n_in)
    x = rng.normal(size=(37, n_in)).astype(np.float32)
    w = rng.normal(size=(n_in, 300)).astype(np.float32)
    b = rng.normal(size=(300,)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(_layer_matmul(jnp.asarray(x), (jnp.asarray(w), jnp.asarray(b)[None]),
                                        "skinny", None))
    args = (torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b))
    assert np.array_equal(fused_skinny_dense(*args).numpy(), want)
    if n_in > 1:
        assert not np.array_equal(skinny_dense(*args).numpy(), want)
