"""K1 on the wide route, on the CPU: the program
(``tpu21cmvae_torch/ops/kernels/wide.py::wide_plan`` with ``n_out``) that
``csrc/fused_loglik_grad_gram.cu`` runs for every network the dedicated
K1 kernels refuse, by depth or by shared memory, run op by op by
``tests/_torch_f32.py::emulate_wide``; the routing rule ``k1_route``;
and the member axis.

The emulation is held to the port's plain version
(``fused_mlp_reference``) at every tier, and to the JAX package's Pallas
K1 (``make_fused_mlp``, ``make_fused_emulate``; interpret mode, as JAX's
own tests run it) on the same NumPy weights, for predict and ``sumsq``, on
(640, 520, 384), packed for the wide route directly (the dedicated
kernels hold it at some tiers), and on (128,)×12, which the wrapper routes
wide by depth at every tier. On the CPU the Pallas kernels' DEFAULT dots
run in fp32 under XLA, so a bf16 tier is held to plain alone.

Tolerances (``chip_smoke.py``'s): predictions within AMPLITUDE_RTOL of
their amplitude (1e-5 fp32, 1e-4 bf16x3, 5e-3 bf16); Σy² as ½Σy² within
VALUE_RTOL·(½Σy² + c/2) + 1e-2 (1e-5, 1e-4, 5e-3; c = b·b of the output
layer, the folded likelihood's scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_f32 import emulate_wide
from _torch_pair import one_torch_thread  # noqa: F401
from test_torch_fused_loglik import port_model  # noqa: F401

from tpu21cmvae.models.direct import DirectEmulator as JaxEmulator
from tpu21cmvae.ops.mlp import init_mlp
from tpu21cmvae.ops.pallas import make_fused_emulate as jax_make_fused_emulate
from tpu21cmvae.ops.pallas import make_fused_mlp as jax_make_fused_mlp
from tpu21cmvae.utils.config import DirectEmulatorConfig as JaxConfig
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.ops.kernels import wide
from tpu21cmvae_torch.ops.kernels._common import MAX_SHARED_BYTES, member_of
from tpu21cmvae_torch.ops.kernels.fused_loglik import (
    make_fused_loglik,
    make_fused_loglik_grad_gram,
    make_fused_loglik_gram,
)
from tpu21cmvae_torch.ops.kernels.fused_mlp import (
    fused_mlp_members_reference,
    fused_mlp_reference,
    k1_route,
    k1_wide_plan,
    make_fused_emulate,
    make_fused_mlp,
    mlp_operands,
)
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig

TIERS = ("highest", "high", "default")
TIER = {"highest": "f32", "high": "bf16x3", "default": "bf16"}
VALUE_RTOL = {"highest": 1e-5, "high": 1e-4, "default": 5e-3}
AMPLITUDE_RTOL = {"highest": 1e-5, "high": 1e-4, "default": 5e-3}
VALUE_ATOL = 1e-2
# a wide network the dedicated kernels hold at some tiers, and one deeper
# than their eight layers
NETS = {"640-520-384": (7, 640, 520, 384, 451), "128x12": (7,) + (128,) * 12 + (451,)}
FLAGSHIP = (7, 288, 352, 288, 224, 451)


def _weights(sizes, seed=2):
    """JAX's ``init_mlp`` weights and the same as torch layer dicts."""
    jp = init_mlp(jax.random.key(seed), sizes)
    tp = tuple({k: torch.tensor(np.asarray(v)) for k, v in layer.items()} for layer in jp)
    return jp, tp


def _rows(n, n_in, seed=12):
    x = np.abs(np.random.default_rng(seed).normal(size=(n, n_in))).astype(np.float32) + 0.1
    x[3, 2] = 0.0  # the fx == 0 clamp
    return x


def _wide_ops(sizes, tier, reduce, params):
    """K1's operands at ``tier`` packed for the wide route directly,
    whatever route the wrapper takes."""
    return mlp_operands(params, TIER[tier], True, reduce, k1_wide_plan(sizes, TIER[tier], reduce))


def _close(got, want, tier, reduce, c=0.0):
    """Predictions within the amplitude tolerance; Σy² as ½Σy² within the
    value tolerance on the folded likelihood's scale."""
    if reduce == "none":
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= AMPLITUDE_RTOL[tier], rel
        return
    tol = VALUE_RTOL[tier] * (0.5 * np.abs(want) + 0.5 * c) + VALUE_ATOL
    excess = 0.5 * np.abs(got - want) / tol
    assert bool((excess <= 1.0).all()), float(excess.max())


@pytest.mark.parametrize("reduce", ["none", "sumsq"])
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("net", list(NETS))
def test_k1_wide_emulation_matches_plain_and_pallas(net, tier, reduce):
    """The K1 program at every tier, emulated through its packed
    operands, against ``fused_mlp_reference`` and JAX's Pallas
    ``make_fused_mlp`` (log-clamped input, fx == 0 row) on the same
    weights: the signal or Σy², finite, of the right shape."""
    sizes = NETS[net]
    jp, tp = _weights(sizes)
    x = _rows(37, sizes[0])
    ops = _wide_ops(sizes, tier, reduce, tp)
    assert ops.program is not None and ops.slabs is not None and ops.packed is None
    got = emulate_wide(ops, torch.as_tensor(x)).numpy()
    assert got.shape == ((37,) if reduce == "sumsq" else (37, 451)) and np.isfinite(got).all()
    c = float(tp[-1]["b"] @ tp[-1]["b"])
    _close(got, fused_mlp_reference(ops, torch.as_tensor(x)).numpy(), tier, reduce, c)
    if tier != "default":
        want = np.asarray(jax_make_fused_mlp(sizes, block_rows=40, interpret=True,
                                             log_clamp_input=True, precision=tier,
                                             reduce=reduce)(jp, jnp.asarray(x)))
        _close(got, want, tier, reduce, c)


@pytest.mark.parametrize("tier", TIERS)
def test_k1_wide_emulate_matches_pallas_emulate(splits, tier):
    """``make_fused_emulate`` on a (128,)×12 emulator (the wrapper routes
    it wide at every tier; its normalizer folded into the first and last
    layers) emulated against JAX's Pallas ``make_fused_emulate`` on the
    same weights (a DEFAULT forward against plain alone), and on the CPU
    the wrapper's call is the plain version."""
    hidden = (128,) * 12
    jm = JaxEmulator(splits, config=JaxConfig(hidden_dims=hidden), seed=3)
    tm = DirectEmulator.from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params),
        jax.tree_util.tree_map(np.asarray, jm.normalizer),
        config=DirectEmulatorConfig(hidden_dims=hidden), device="cpu")
    fn = make_fused_emulate(tm.config, tm.normalizer, precision=tier, device="cpu")
    assert fn.wide and fn.route == "wide" and fn.plan == k1_wide_plan(fn.sizes, fn.tier)
    raw = np.asarray(splits.par_test[:37], np.float32).copy()
    raw[5, 2] = 0.0
    x = torch.as_tensor(raw)
    ops = fn.operands(tm.params)
    got = emulate_wide(ops, x).numpy()
    plain = fn(tm.params, x).numpy()
    assert fn.launches == 0 and np.array_equal(plain, fused_mlp_reference(ops, x).numpy())
    _close(got, plain, tier, "none")
    if tier != "default":
        want = np.asarray(jax_make_fused_emulate(jm.config, jm.normalizer, precision=tier,
                                                 block_rows=40, interpret=True)(
            jm.params, jnp.asarray(raw)))
        _close(got, want, tier, "none")


@pytest.mark.parametrize("reduce", ["none", "sumsq"])
@pytest.mark.parametrize("tier", TIERS)
def test_k1_wide_members_are_single_models(tier, reduce):
    """``members=3`` on (128,)×12: each member's slice of the stacked
    wide operands, emulated, is that member's own wrapper's emulation bit
    for bit, and holds to the member-batched plain version."""
    sizes = NETS["128x12"]
    members = [_weights(sizes, seed)[1] for seed in (4, 5, 6)]
    stacked = tuple({k: torch.stack([m[i][k] for m in members]) for k in ("w", "b")}
                    for i in range(len(sizes) - 1))
    batched = make_fused_mlp(sizes, log_clamp_input=True, precision=tier, reduce=reduce,
                             members=3, device="cpu")
    assert batched.wide and batched.wide_launch.members == 3
    ops = batched.operands(stacked)
    x = torch.as_tensor(_rows(37, 7))
    plain = fused_mlp_members_reference(ops, x).numpy()
    assert np.array_equal(batched(stacked, x).numpy(), plain)
    for m, params in enumerate(members):
        single = make_fused_mlp(sizes, log_clamp_input=True, precision=tier, reduce=reduce,
                                device="cpu")
        got = emulate_wide(member_of(ops, m), x)
        assert torch.equal(got, emulate_wide(single.operands(params), x))
        _close(got.numpy(), plain[m], tier, reduce, float(params[-1]["b"] @ params[-1]["b"]))


def test_k1_route():
    """``k1_route``: the flagship and ``DIRECT_ALIGNED``'s widths keep
    their kernels (``fused_mlp.cu`` at fp32, ``fused_mlp_mma.cu`` at the
    bf16 tiers), and so do the tuner's widths (≤ 384, up to eight layers);
    (1024, 1024) at bf16x3 is wider than ``fused_mlp_mma.cu``'s two tiles
    and (128,)×12 deeper than eight layers at every tier: the wide route,
    whose plan fits; a forced fp32 height keeps ``fused_mlp.cu``."""
    for sizes in (FLAGSHIP, (7, 256, 256, 128, 128, 128, 451), (7,) + (384,) * 7 + (451,)):
        assert [k1_route(sizes, TIER[t]) for t in TIERS] == ["f32", "mma", "mma"]
        for t in TIERS:
            assert not make_fused_mlp(sizes, precision=t, device="cpu").wide
    big = (7, 1024, 1024, 451)
    assert k1_route(big, "bf16x3") == "wide"
    assert k1_route(big, "f32") == "f32" and k1_route(big, "bf16") == "mma"
    for t in TIERS:
        assert k1_route(NETS["128x12"], TIER[t]) == "wide"
    fn = make_fused_mlp(big, precision="high", reduce="sumsq", device="cpu")
    assert fn.wide and fn.plan == wide.wide_plan(big[:-1], 2, None, n_out=451, sumsq=True)
    assert all(wide.plan_bytes(fn.plan, r) <= MAX_SHARED_BYTES for r in fn.heights)
    assert fn.rows_for(4096) == fn.heights[0]  # no SM count on the CPU: the tallest
    assert k1_route((7, 4096, 4096, 3), "f32", tile_rows=8) == "f32"
    with pytest.raises(ValueError, match="tile_rows"):
        make_fused_mlp(NETS["128x12"], tile_rows=64, device="cpu")


@pytest.mark.parametrize("reduce", ["none", "sumsq"])
def test_k1_wide_plan(reduce):
    """K1's program on the wide route: value only (no mask, no backward
    op), its head the output layer (``FIN_LINEAR``, no ReLU, its bias
    after the trunk's), each of its four 128-column chunks written (the
    signal, 451 = 3·128 + 67 valid columns) or added to the Σy² partials
    and written once; on (4096, 4096) the wide vectors spill to the
    workspace at every tier and the plan fits both heights."""
    plan = k1_wide_plan(FLAGSHIP, "f32", reduce)
    codes = [op[0] for op in plan.ops]
    assert plan.mask_cols == 0 and not {wide.OP_DX, wide.OP_DX_WRITE, wide.OP_GRAM} & set(codes)
    outs = [op for op in plan.ops if op[0] == wide.OP_OUT]
    mode = wide.OUT_SUMSQ if reduce == "sumsq" else wide.OUT_SIGNAL
    assert [op[2:] for op in outs] == [(0, 128, mode), (128, 128, mode), (256, 128, mode),
                                       (384, 67, mode)]
    assert codes.count(wide.OP_QUAD_WRITE) == (reduce == "sumsq")
    fins = [op for op in plan.ops if op[0] == wide.OP_FIN and op[7] == wide.FIN_LINEAR]
    assert len(fins) == 4 and fins[0][4] == 128 * (3 + 3 + 2)  # after layers 1-3's biases
    for parts in (0, 1, 2):
        big = wide.wide_plan((7, 4096, 4096), parts, None, n_out=451, sumsq=reduce == "sumsq")
        assert big.spilled and big.heights == (32, 16)
        assert {op[9] for op in big.ops if op[0] == wide.OP_MM} == {parts}


def test_k1_wide_lone_dense_layer():
    """A network of one dense layer too wide for the dedicated kernels
    (fan-in 700 at bf16x3): the output layer reads the input a chunk at a
    time (``OP_INPUT``) and the emulation holds to plain."""
    sizes = (700, 451)
    assert k1_route(sizes, "bf16x3") == "wide"
    _, tp = _weights(sizes)
    ops = _wide_ops(sizes, "high", "none", tp)
    plan = k1_wide_plan(sizes, "bf16x3")
    assert plan.dense and [op[1] for op in plan.ops if op[0] == wide.OP_INPUT] == [0, 1, 2, 3,
                                                                                 4, 5] * 4
    x = torch.as_tensor(_rows(9, 700))
    _close(emulate_wide(ops, x).numpy(), fused_mlp_reference(ops, x).numpy(), "high", "none")


@pytest.mark.parametrize("n_params,hidden", [(7, (128,) * 12), (7, (4096, 4096)),
                                             (12, (288, 352, 288, 224))],
                         ids=["128x12", "4096x2", "fan-in-12"])
def test_every_wrapper_takes_wide_and_deep_networks(port_model, n_params, hidden):
    """``make_fused_emulate``, ``make_fused_loglik`` (K1's Σy²),
    ``make_fused_loglik_gram`` and ``make_fused_loglik_grad_gram`` build
    on the CPU at every tier (and pair) on (128,)×12, (4096, 4096) and a
    fan-in-12 model: nothing is refused; K2 and K3 run the wide route on
    all three, K1 wherever ``k1_route`` sends it (a fan-in-12 first layer
    is a tier layer its dedicated kernels hold)."""
    m, obs = port_model((32,))
    cfg = DirectEmulatorConfig(n_params=n_params, hidden_dims=hidden)
    sizes = cfg.mlp().sizes
    for t in TIERS:
        emulate = make_fused_emulate(cfg, m.normalizer, precision=t, device="cpu")
        direct = make_fused_loglik(cfg, m.normalizer, obs, precision=t, device="cpu")
        gram = make_fused_loglik_gram(cfg, m.normalizer, obs, precision=t, device="cpu")
        assert emulate.route == direct.mlp.route == k1_route(sizes, TIER[t])
        assert emulate.wide == (n_params == 7) and gram.wide
        for g in TIERS:
            assert make_fused_loglik_grad_gram(cfg, m.normalizer, obs, precision=t,
                                               grad_precision=g, device="cpu").wide
