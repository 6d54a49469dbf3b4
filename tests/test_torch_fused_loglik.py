"""K3, the fused gram value-and-gradient kernel: its plain PyTorch version
against the JAX package's Pallas kernel (interpret mode on the CPU), and
the wrapper's contract. The kernel itself is held to its plain version in
``tests/test_torch_cuda.py``, on a CUDA card.

At the bf16 tiers K3 and K2 run ``csrc/fused_gram_mma.cu`` on the tensor
cores, from operands :func:`pack_gram_operands` packed into ``mma``
fragments. Here those fragments are read back by the PTX ISA's m16n8k16
layout, and a pure-torch emulation that computes through them is held to
the plain versions and to the Pallas K3 and K2. At the fp32 tier K2 runs
``csrc/fused_loglik_gram.cu``, register-tiled, from the fp32 slabs of
:func:`pack_gram_slabs`: they are read back by ``csrc/tile_f32.cuh``'s
layout, and an emulation through them (``tests/_torch_f32.py``) is held
to :func:`loglik_gram_reference` and to the Pallas K2. K3 at (fp32, fp32)
runs ``csrc/fused_loglik_grad_gram_f32.cu`` from the longer stream of
:func:`pack_grad_gram_slabs` (the backward's ``W_iᵀ`` after ``G``): the
same read-back, and an emulation of its forward, masks and backward held
to :func:`loglik_grad_gram_reference`, to K2's emulation and to the
Pallas K3.

Tolerances: test_loglik tolerance (``tests/test_loglik.py:468-472``:
values rtol 2e-4, atol 2e-3·max|v|; gradients rtol 2e-3, atol
2e-3·max|g|) between two implementations of one tier; the gradient gate
(``bench_mcmc.py::_grad_gate_violation`` ≤ 0) where the tiers differ, and
between the emulation and the plain version, which differ only in fp32
summation order (values within 1e-5 of |logL| + c/2, the gram form's
cancellation scale).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_f32 import _mma_forward, emulate_f32_grad_gram, emulate_f32_gram, unpack_slabs
from _torch_mma import mma_product, unpack

from tpu21cmvae.models.direct import DirectEmulator as JaxEmulator
from tpu21cmvae.ops.loglik import make_loglik_and_grad as jax_make_loglik_and_grad
from tpu21cmvae.ops.pallas.fused_loglik import make_fused_loglik_gram as jax_fused_gram
from tpu21cmvae.utils.config import DirectEmulatorConfig as JaxConfig
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.ops.fold import (
    _log_clamp,
    _log_clamp_grad,
    _split_hi_lo,
    bf16_round,
    gram_fold,
    noise_scale,
    obs_tensor,
)
from tpu21cmvae_torch.ops.kernels._common import (
    F32_PREFERRED_ROWS,
    F32_TILE_ROWS,
    MAX_SHARED_BYTES,
    TIER_CODE,
    f32_tile_bytes,
)
from tpu21cmvae_torch.ops.kernels.fused_loglik import (
    MIXED_TILE_ROWS,
    _gram_mma_bytes,
    _kernel,
    grad_f32_bytes,
    grad_f32_heights,
    grad_f32_rows,
    grad_mixed_bytes,
    grad_mixed_heights,
    grad_reverse_bytes,
    gram_f32_rows,
    gram_shared_bytes,
    k3_route,
    loglik_grad_gram_reference,
    loglik_gram_reference,
    make_fused_loglik_grad_gram,
    make_fused_loglik_gram,
    pack_gram_operands,
    shared_bytes,
)
from tpu21cmvae_torch.ops.kernels.wide import plan_bytes, wide_plan
from tpu21cmvae_torch.ops.mlp import fused_skinny_dense
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig
from tpu21cmvae_torch.utils.metrics import grad_gate_violation, grad_rel_error

SMALL = (32, 48, 32, 24)
FLAGSHIP = (7, 288, 352, 288, 224)  # (n_in, trunk widths)
# hidden widths that need padding to 16, a trunk of the skinny layer
# alone (the gram head is the only mma layer), and the flagship's shape
# at a quarter of its width
GRAM_WIDTHS = [SMALL, (40,), (72, 88, 72, 56)]
# (value tier, backward tier): K3 at two pairs, K2 (no backward) at two tiers
GRAM_CASES = [("high", "high"), ("high", "default"), ("high", None), ("default", None)]


@pytest.fixture(scope="module")
def pair(splits):
    jm = JaxEmulator(splits, config=JaxConfig(hidden_dims=SMALL), seed=2)
    tm = DirectEmulator.from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params),
        jax.tree_util.tree_map(np.asarray, jm.normalizer),
        config=DirectEmulatorConfig(hidden_dims=SMALL), device="cpu",
    )
    sig = jm.predict(splits.par_test[0])
    obs = (sig + np.random.default_rng(5).normal(0, 5.0, sig.shape)).astype(np.float32)
    raw = np.asarray(splits.par_test[:37], np.float32).copy()  # not a tile multiple
    raw[5, 2] = 0.0
    return jm, tm, obs, raw


def _pallas(pair, tiers):
    """JAX's K3 in interpret mode: one grid step (block_rows=40, which
    the default 4-way interleave divides)."""
    jm, _, obs, raw = pair
    fn = jax_make_loglik_and_grad(
        jm.config, jm.normalizer, obs, 25.0, backend="pallas", precision=tiers[0],
        grad_precision=tiers[1], block_rows=40, interpret=True,
    )
    v, g = fn(jm.params, jnp.asarray(raw))
    return np.asarray(v), np.asarray(g)


def _port(pair, tiers):
    _, tm, obs, raw = pair
    fn = make_fused_loglik_grad_gram(tm.config, tm.normalizer, obs, 25.0,
                                     precision=tiers[0], grad_precision=tiers[1],
                                     device="cpu")
    v, g = fn(tm.params, torch.as_tensor(raw))
    return v.numpy(), g.numpy()


@pytest.mark.parametrize("tiers", [("highest", "highest"), ("high", "high")])
def test_plain_k3_matches_pallas_k3(pair, tiers):
    """Same folds, same hi/lo split, same epilogue: the plain version and
    the Pallas kernel agree at test_loglik tolerance, on 37 rows with an
    fx == 0 row whose slot-2 gradient is exactly 0 in both."""
    vj, gj = _pallas(pair, tiers)
    vt, gt = _port(pair, tiers)
    assert vt.shape == (37,) and gt.shape == (37, 7)
    np.testing.assert_allclose(vt, vj, rtol=2e-4, atol=2e-3 * np.abs(vj).max())
    np.testing.assert_allclose(gt, gj, rtol=2e-3, atol=2e-3 * np.abs(gj).max())
    assert gt[5, 2] == 0.0 and gj[5, 2] == 0.0


def test_bf16_backward_passes_the_gradient_gate(pair):
    """At ("high", "default") the Pallas kernel's DEFAULT backward runs in
    full fp32 under XLA on the CPU (checked: a DEFAULT and a HIGH f32 dot
    equal the HIGHEST one bit for bit), while the port's rounds both
    operands to bf16 as a single-pass bf16 tier does. So the port's
    backward is held to that fp32 gradient under the gradient gate, and
    its value to the same value tier at test_loglik tolerance."""
    a = jax.random.normal(jax.random.key(0), (64, 96))
    b = jax.random.normal(jax.random.key(1), (96, 48))
    exact = jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)
    for p in (jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGH):
        np.testing.assert_array_equal(np.asarray(jnp.dot(a, b, precision=p)), np.asarray(exact))
    vj, gj = _pallas(pair, ("high", "default"))
    vt, gt = _port(pair, ("high", "default"))
    np.testing.assert_allclose(vt, vj, rtol=2e-4, atol=2e-3 * np.abs(vj).max())
    assert grad_gate_violation(gt, gj) <= 0.0
    assert not np.array_equal(gt, gj)  # the bf16 tier really rounds
    assert gt[5, 2] == 0.0


def test_single_row_and_shapes(pair):
    _, tm, obs, raw = pair
    fn = make_fused_loglik_grad_gram(tm.config, tm.normalizer, obs, 25.0, device="cpu")
    v1, g1 = fn(tm.params, torch.as_tensor(raw[1]))
    assert v1.shape == (1,) and g1.shape == (1, 7)
    vb, gb = fn(tm.params, torch.as_tensor(raw[:4]))
    np.testing.assert_allclose(v1.numpy(), vb.numpy()[1:2], rtol=1e-6)
    np.testing.assert_allclose(g1.numpy(), gb.numpy()[1:2], rtol=1e-5, atol=1e-6)
    assert np.isfinite(v1.numpy()).all() and np.isfinite(g1.numpy()).all()
    assert fn.launches == 0  # CPU tensors run the plain version


def test_wrapper_rejects_bad_inputs(pair):
    _, tm, obs, raw = pair
    fn = make_fused_loglik_grad_gram(tm.config, tm.normalizer, obs, 25.0, device="cpu")
    x = torch.as_tensor(raw)
    with pytest.raises(TypeError, match="float32"):
        fn(tm.params, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        fn(tm.params, torch.as_tensor(np.asfortranarray(raw)))
    with pytest.raises(ValueError, match="contiguous"):
        fn(tm.params, torch.cat([x, x], dim=1)[:, ::2])
    with pytest.raises(ValueError):
        fn(tm.params, x[:, :6].contiguous())
    with pytest.raises(ValueError, match="runs on"):
        fn(tm.params, torch.empty((3, 7), device="meta"))
    with pytest.raises(TypeError):
        fn(tm.params, raw)  # a NumPy array, not a tensor
    with pytest.raises(NotImplementedError, match="ReLU"):
        make_fused_loglik_grad_gram(DirectEmulatorConfig(hidden_dims=SMALL, activation="tanh"),
                                    tm.normalizer, obs, device="cpu")
    # a fan-in above 8 is a dense first layer: the wide route takes it
    nine = make_fused_loglik_grad_gram(DirectEmulatorConfig(hidden_dims=SMALL, n_params=9),
                                       tm.normalizer, obs, device="cpu")
    assert nine.wide and nine.plan.dense and k3_route((9, *SMALL), "bf16x3", "bf16x3") == "wide"
    # too wide for the tensor-core and the register-tiled kernels: the wide
    # route takes them, spilling to its workspace what shared memory
    # cannot hold
    for hidden, tier in (((1536,) * 3, "high"), ((3200,) * 3, "highest")):
        fn = make_fused_loglik_grad_gram(DirectEmulatorConfig(hidden_dims=hidden),
                                         tm.normalizer, obs, precision=tier, device="cpu")
        assert fn.wide and fn.plan.heights


def test_operands_cached_until_weights_change(pair):
    _, tm, obs, raw = pair
    fn = make_fused_loglik_grad_gram(tm.config, tm.normalizer, obs, 25.0, device="cpu")
    ops = fn.operands(tm.params)
    assert fn.operands(tm.params) is ops
    # the reverse pair: masks, e, the backward's tile and ring (over the
    # smaller forward tiles), the operand struct
    mixed = 4 * (32 + 64 + 32) + 4 * 18 * 64 + 4 * 18 * 64 + 4 * 3 * 8 * 128 + 552
    assert shared_bytes(ops.widths, "bf16x3", "f32") == grad_reverse_bytes(
        ops.widths, "bf16x3") == mixed
    assert shared_bytes(ops.widths) == grad_f32_bytes(ops.widths, 64) == (
        4 * 64 * (7 + 2 * 64) + 2 * 32 * 128 * 4 + 1024 + 8 * (32 + 64 + 32))
    v0 = fn(tm.params, torch.as_tensor(raw))[0]
    w = tm.params[1]["w"]
    with torch.no_grad():
        w.mul_(1.5)
    try:
        assert fn.operands(tm.params) is not ops
        assert not torch.equal(fn(tm.params, torch.as_tensor(raw))[0], v0)
    finally:
        with torch.no_grad():
            w.div_(1.5)


@pytest.fixture(scope="module")
def port_model(splits):
    """A randomly initialised port emulator and an observation, per hidden
    widths."""
    cache = {}

    def get(hidden):
        if hidden not in cache:
            m = DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=hidden),
                               seed=sum(hidden), device="cpu")
            sig = m.predict(splits.par_test[0])
            obs = (sig + np.random.default_rng(5).normal(0, 5.0, sig.shape)).astype(np.float32)
            cache[hidden] = (m, obs)
        return cache[hidden]

    return get


def _wrapper(m, obs, case):
    tier, grad = case
    if grad is None:
        return make_fused_loglik_gram(m.config, m.normalizer, obs, 25.0, precision=tier,
                                      device="cpu")
    return make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision=tier,
                                       grad_precision=grad, device="cpu")


def _raw(splits, n=37):
    raw = np.asarray(splits.par_test[:n], np.float32).copy()
    raw[5, 2] = 0.0  # the fx == 0 clamp
    return torch.as_tensor(raw)


def _emulate_gram(ops, x, grad=True, active=lambda a: a > 0.0):
    """``csrc/fused_gram_mma.cu``'s arithmetic in plain torch, through the
    packed, padded operands: the forward of ``_torch_f32._mma_forward``
    (the skinny layer exact, each activation split (bf16x3) or rounded
    (bf16) once into the next product, the quad from the fp32 ``h``), the
    ReLU masks from the fp32 activations (``active``), layer 0's backward
    signal in fp32 into the exact skinny backward; padded columns are
    carried as zeros. ``(logL, dlogL/dx)``, or ``logL`` alone without
    ``grad`` (K2)."""
    acts, hg, value = _mma_forward(ops, x)
    if not grad:
        return value
    p = ops.packed
    e = torch.where(active(acts[-1]), hg + p.u, 0.0)
    for i in range(len(acts) - 1, 0, -1):
        e = torch.where(active(acts[i - 1]), mma_product(e, p.wt[i - 1], ops.grad_tier), 0.0)
    e = e[:, : ops.w0.shape[1]] @ ops.w0.T
    return value, -(_log_clamp_grad(x) * e)


def _tier_parts(w, tier):
    return _split_hi_lo(w) if tier == "bf16x3" else (bf16_round(w),)


@pytest.mark.parametrize("hidden", GRAM_WIDTHS)
@pytest.mark.parametrize("case", GRAM_CASES)
def test_gram_packing_unpacks_to_the_tier_parts(port_model, hidden, case):
    """Read back by the PTX m16n8k16 B layout, the packed operands hold
    each trunk layer i ≥ 1 and ``G`` at the value tier, and (K3) each
    ``W_iᵀ`` at the backward tier, zero-padded to multiples of 16; the
    biases and ``u`` are zero-padded; K2 packs no backward operands."""
    m, obs = port_model(hidden)
    tier_name, grad_name = case
    fn = _wrapper(m, obs, case)
    ops = fn.operands(m.params)
    assert fn.tensor_cores and ops.packed is not None
    trunk, G, u, _ = gram_fold(m.params, m.normalizer, obs_tensor(obs, 451, device="cpu"),
                               noise_scale(25.0, 451, device="cpu"))
    p = ops.packed

    def check(packed, w, tier):
        k, n = w.shape
        got = unpack(packed)
        assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
        assert got.shape[1:] == (-(-k // 16) * 16, -(-n // 16) * 16)
        for part, want in zip(got, _tier_parts(w, tier), strict=True):
            assert torch.equal(part[:k, :n], want)
        assert not got[:, k:].any() and not got[:, :, n:].any()

    assert len(p.w) == len(p.b) == len(hidden) - 1
    assert len(p.wt) == (0 if grad_name is None else len(hidden) - 1)
    for i, layer in enumerate(trunk[1:]):
        check(p.w[i], layer["w"], ops.tier)
        n = layer["b"].shape[0]
        assert torch.equal(p.b[i][:n], layer["b"]) and not p.b[i][n:].any()
        if grad_name is not None:
            check(p.wt[i], layer["w"].T, ops.grad_tier)
    check(p.g, G, ops.tier)
    h = hidden[-1]
    assert p.u.shape == (-(-h // 16) * 16,)
    assert torch.equal(p.u[:h], u) and not p.u[h:].any()


@pytest.mark.parametrize("hidden", GRAM_WIDTHS)
@pytest.mark.parametrize("case", GRAM_CASES)
def test_gram_mma_emulation_matches_plain(port_model, splits, hidden, case):
    """Through the packed, padded operands, the tensor-core arithmetic
    equals :func:`loglik_grad_gram_reference` (K3) or
    :func:`loglik_gram_reference` (K2), which multiply the unpadded
    operands in one matmul: they differ only in fp32 summation order, so
    the values agree within 1e-5 of |logL| + c/2 and the gradients pass
    the gradient gate (37 rows, one with fx == 0)."""
    m, obs = port_model(hidden)
    ops = _wrapper(m, obs, case).operands(m.params)
    x = _raw(splits)
    scale = lambda v: v.abs() + 0.5 * abs(float(ops.c))  # noqa: E731
    if case[1] is None:
        got, want = _emulate_gram(ops, x, grad=False), loglik_gram_reference(ops, x)
    else:
        (got, g), (want, gp) = _emulate_gram(ops, x), loglik_grad_gram_reference(ops, x)
        assert g.shape == (37, 7) and torch.isfinite(g).all()
        assert grad_gate_violation(g.numpy(), gp.numpy()) <= 0.0
        assert g[5, 2] == 0.0
    assert got.shape == (37,) and torch.isfinite(got).all()
    assert bool(((got - want).abs() <= 1e-5 * scale(want)).all())


@pytest.mark.parametrize("kernel", ["K3", "K2"])
def test_gram_mma_emulation_matches_pallas(pair, kernel):
    """The emulation at bf16x3 against the JAX package's Pallas K3 and K2
    (interpret mode), at ``test_plain_k3_matches_pallas_k3``'s network
    and tolerance."""
    jm, tm, obs, raw = pair
    x = torch.as_tensor(raw)
    if kernel == "K3":
        vj, gj = _pallas(pair, ("high", "high"))
        fn = make_fused_loglik_grad_gram(tm.config, tm.normalizer, obs, 25.0, precision="high",
                                         grad_precision="high", device="cpu")
        vt, gt = (t.numpy() for t in _emulate_gram(fn.operands(tm.params), x))
        np.testing.assert_allclose(gt, gj, rtol=2e-3, atol=2e-3 * np.abs(gj).max())
    else:
        vj = np.asarray(jax_fused_gram(jm.config, jm.normalizer, obs, 25.0, precision="high",
                                       block_rows=40, interpret=True)(jm.params,
                                                                      jnp.asarray(raw)))
        fn = make_fused_loglik_gram(tm.config, tm.normalizer, obs, 25.0, precision="high",
                                    device="cpu")
        vt = _emulate_gram(fn.operands(tm.params), x, grad=False).numpy()
    np.testing.assert_allclose(vt, vj, rtol=2e-4, atol=2e-3 * np.abs(vj).max())


def test_gram_masks_follow_the_fp32_activations(port_model, splits):
    """A tiny positive activation (a subnormal whose ``hi()`` and
    ``bf16_rn()`` are both 0) is active for the backward: the plain
    version and the emulation take the ReLU mask from fp32 and pass its
    gradient, which a mask taken from the split tile would drop."""
    m, obs = port_model(SMALL)
    ops = _wrapper(m, obs, ("high", "high")).operands(m.params)
    j = 3  # layer 0's column j becomes x[:, 6] + 1e-44 (column 6 is not log-clamped)
    w0 = ops.w0.clone()
    w0[:, j] = 0.0
    w0[6, j] = 1.0
    b0 = ops.b0.clone()
    b0[j] = 1e-44
    ops = dataclasses.replace(ops, w0=w0, b0=b0)
    ops = dataclasses.replace(ops, packed=pack_gram_operands(ops))
    x = _raw(splits)
    x[:, 6] = 0.0
    a0 = torch.relu(fused_skinny_dense(_log_clamp(x), ops.w0, ops.b0))[:, j]
    assert (a0 > 0).all() and not _split_hi_lo(a0)[0].any() and not bf16_round(a0).any()
    _, want = loglik_grad_gram_reference(ops, x)
    _, got = _emulate_gram(ops, x)
    _, split = _emulate_gram(ops, x, active=lambda a: _split_hi_lo(a)[0] > 0.0)
    assert grad_gate_violation(got.numpy(), want.numpy()) <= 0.0
    # the split mask drops e_j · w0[6, j] = e_j from every row's dx[:, 6]
    gap = (split - want)[:, 6].abs()
    assert bool((gap > 1e-2 * want[:, 6].abs()).all())
    assert bool(((got - want)[:, 6].abs() <= 1e-4 * want[:, 6].abs() + 1e-6).all())
    assert torch.equal(split[:, :6], got[:, :6])  # only column 6 reads activation j


def test_gram_shared_bytes_and_routing(port_model):
    """``fused_gram_mma.cu`` at a reverse tier pair (a bf16 value tier, an
    fp32 backward) keeps its masks and the fp32 ``e`` apart, then the
    larger of K2's tensor-core tiles and the backward's other fp32 tile
    with its ring, plus its 552-byte operand struct: two blocks share an
    SM at the flagship; ``fused_loglik_grad_gram.cu`` (a reverse pair too
    wide for that) the tiles of its plan (``ops/kernels/wide.py``:
    ``plan_bytes``) at the tallest height that fits; ``fused_gram_mixed.cu`` (an fp32 value tier, a bf16 backward) the
    fp32 K3's masks and partials and two regions, one for the fp32 ``e``
    and later a bf16 A tile, one for the forward's other tile, ring and
    input tile and later the other A tile, plus its 256-byte operand
    struct: two 32-row blocks share an SM at the flagship;
    ``fused_loglik_gram.cu`` (fp32) k-major fp32 tiles of its tile height
    (64 rows here) with k rows padded to 32, its height's slab ring and 1
    KB of row partials, ``fused_loglik_grad_gram_f32.cu`` (fp32, fp32) the
    same tiles, a two-slot ring at 64 rows and 8 mask bytes per padded
    column of activations 0 … n−2; ``fused_gram_mma.cu`` (every tier bf16
    or bf16x3) bf16 A tiles of 16 rows, hi and lo where either tier is
    bf16x3, with rows padded to the widest padded trunk width + 8, an fp32
    tile of h (K3: and of layer 0's backward signal), K3's mask words, the
    input tile and the quad partials. Each wrapper routes, packs and
    refuses by the kernel its tiers run."""
    # masks, e, max(K2's tensor-core tiles, the backward's tile + ring), struct
    rev = 4 * 928 + 4 * 18 * 352
    assert shared_bytes(FLAGSHIP, "bf16x3", "f32") == grad_reverse_bytes(FLAGSHIP, "bf16x3") == (
        rev + 61_888 + 552) == 91_496
    assert shared_bytes(FLAGSHIP, "bf16", "f32") == rev + 2 * 2 * 16 * 360 + 4 * 16 * 232 + (
        4 * 16 * (7 + 8)) + 552 == 68_456
    assert 61_888 > 4 * 18 * 352 + 4 * 3 * 8 * 128  # the forward's tiles are the larger
    assert 2 * (91_496 + 1024) <= 233_472  # two blocks per SM at bf16x3
    # masks, partials, max(e tile, A tile), max(h tile + ring + input tile, A tile), struct
    fwd32 = 4 * 32 * 352 + 4 * (2 * 16 * 128 + 32 * 7)
    assert shared_bytes(FLAGSHIP, "f32", "bf16x3") == grad_mixed_bytes(FLAGSHIP, 32, "bf16x3") == (
        4 * 928 + 1024 + 2 * 2 * 32 * 360 + fwd32 + 256) == 113_408
    assert shared_bytes(FLAGSHIP, "f32", "bf16") == 4 * 928 + 1024 + 4 * 32 * 352 + fwd32 + 256
    assert shared_bytes(FLAGSHIP, "f32", "bf16") == 112_384
    assert 2 * (113_408 + 1024) <= 233_472  # two 32-row blocks per SM at bf16x3
    fwd16 = 4 * 18 * 352 + 4 * (3 * 8 * 128 + 18 * 7)
    assert shared_bytes(FLAGSHIP, "f32", "bf16x3", rows=16) == (
        2 * 928 + 1024 + 4 * 18 * 352 + fwd16 + 256)
    assert grad_mixed_heights(FLAGSHIP, "bf16x3") == MIXED_TILE_ROWS == (32, 16)
    assert shared_bytes(FLAGSHIP) == 182_016 + 2 * 32 * 128 * 4 + 1024 + 8 * 928 == 223_232
    tail = 4 * 16 * (7 + 8)  # input tile, quad partials
    k3 = 4 * 16 * (288 + 8) + 4 * (288 + 352 + 288) + tail
    assert shared_bytes(FLAGSHIP, "bf16x3", "bf16") == 2 * 2 * 2 * 16 * 360 + k3 == 69_696
    assert shared_bytes(FLAGSHIP, "bf16", "bf16x3") == 69_696
    assert shared_bytes(FLAGSHIP, "bf16", "bf16") == 2 * 2 * 16 * 360 + k3
    assert gram_shared_bytes(FLAGSHIP) == 4 * 64 * (7 + 2 * 352) + 49152 + 1024 == 232_192
    assert gram_shared_bytes(FLAGSHIP, "bf16x3") == 2 * 2 * 2 * 16 * 360 + 4 * 16 * 232 + tail
    assert gram_shared_bytes(FLAGSHIP, "bf16x3") == 61_888
    assert gram_shared_bytes(FLAGSHIP, "bf16") == 2 * 2 * 16 * 360 + 4 * 16 * 232 + tail
    # the skinny layer alone: the gram head's input is the widest, 40 → 48
    assert shared_bytes((7, 40), "bf16x3", "bf16x3") == 2 * 2 * 2 * 16 * 56 + 4 * 16 * 56 + tail

    m, obs = port_model(SMALL)
    for case in [("highest", "highest"), ("high", "highest"), ("highest", "high"),
                 ("highest", "default"), ("default", "highest"), *GRAM_CASES,
                 ("highest", None)]:
        fn = _wrapper(m, obs, case)
        ops = fn.operands(m.params)
        on_mma = "highest" not in case
        mixed = case in [("highest", "high"), ("highest", "default")]
        reverse = case in [("high", "highest"), ("default", "highest")]
        assert fn.tensor_cores == on_mma
        # fused_gram_mma.cu reads every packed operand (at a reverse pair
        # the forward's alone), fused_gram_mixed.cu the backward's
        # fragments alone
        assert (ops.packed is not None) == (on_mma or mixed or reverse)
        if mixed:
            assert ops.packed.w == ops.packed.b == () and ops.packed.g is None
            assert len(ops.packed.wt) == len(SMALL) - 1
        if reverse:
            assert ops.packed.wt == () and len(ops.packed.w) == len(SMALL) - 1
        # the register-tiled fp32 passes: K2 at fp32, K3 at (fp32, fp32)
        # (K3's longer stream), at a mixed pair (K2's stream) and at a
        # reverse pair (the backward's stream)
        tiled = case in [("highest", "highest"), ("highest", None)] or mixed or reverse
        assert (ops.slabs is not None) == tiled
        if case[1] is not None:
            assert fn.register_tiled == (case == ("highest", "highest"))
            assert fn.mixed == mixed and fn.reverse == reverse
    wide = DirectEmulatorConfig(hidden_dims=(1500,))  # fits the fp32 and bf16 tiles only
    assert _gram_mma_bytes((7, 1500), "bf16x3", "bf16x3") > MAX_SHARED_BYTES
    assert _gram_mma_bytes((7, 1500), "bf16x3", None) > MAX_SHARED_BYTES
    assert grad_mixed_heights((7, 1500), "bf16x3") == (16,)
    for precision in ("highest", "default"):
        make_fused_loglik_grad_gram(wide, m.normalizer, obs, precision=precision, device="cpu")
        make_fused_loglik_gram(wide, m.normalizer, obs, precision=precision, device="cpu")
    fn = make_fused_loglik_grad_gram(wide, m.normalizer, obs, precision="highest",
                                     grad_precision="high", device="cpu")
    assert fn.mixed and fn.heights == (16,)
    # too wide for the reverse mode: fused_loglik_grad_gram.cu, chosen here
    assert grad_reverse_bytes((7, 1500), "bf16") > MAX_SHARED_BYTES
    assert shared_bytes((7, 1500), "bf16", "f32") == plan_bytes(wide_plan((7, 1500), 1), 32)
    fn = make_fused_loglik_grad_gram(wide, m.normalizer, obs, precision="default",
                                     grad_precision="highest", device="cpu")
    assert fn.wide and fn.heights == (32, 16)
    assert not (fn.reverse or fn.tensor_cores or fn.mixed or fn.register_tiled)
    # too wide for the tensor-core kernel at bf16x3: K2 and K3 run the wide
    # route, whose plan fits
    fn = make_fused_loglik_grad_gram(wide, m.normalizer, obs, precision="high", device="cpu")
    assert fn.wide and not fn.tensor_cores
    assert shared_bytes((7, 1500), "bf16x3", "bf16x3") == plan_bytes(fn.plan, 32) <= (
        MAX_SHARED_BYTES)
    fn = make_fused_loglik_gram(wide, m.normalizer, obs, precision="high", device="cpu")
    assert fn.wide and not fn.tensor_cores
    assert gram_shared_bytes((7, 1500), "bf16x3") == plan_bytes(fn.plan, 32) <= MAX_SHARED_BYTES
    # too wide for the mixed kernel at either height: the wide route, with
    # its fp32 forward and tensor-core backward
    wider = DirectEmulatorConfig(hidden_dims=(1700,))
    assert grad_mixed_heights((7, 1700), "bf16") == ()
    fn = make_fused_loglik_grad_gram(wider, m.normalizer, obs, precision="highest",
                                     grad_precision="default", device="cpu")
    assert fn.wide and not fn.mixed
    for rows in (64, 8):
        with pytest.raises(ValueError, match="mixed tier pair"):
            make_fused_loglik_grad_gram(m.config, m.normalizer, obs, precision="highest",
                                        grad_precision="default", tile_rows=rows, device="cpu")


@pytest.mark.parametrize("case", [("highest", None), ("high", None), ("default", None),
                                  ("highest", "highest"), ("high", "highest"),
                                  ("highest", "default"), ("high", "high"), ("high", "default"),
                                  ("highest", "high"), ("default", "highest")])
def test_gram_entry_point_and_operands_follow_the_tiers(port_model, case):
    """Each tier (pair) reaches one C entry point with the operands in the
    order its source reads them: ``fused_gram_mma.cu`` the packed
    fragments (K3: each layer's backward fragments after its bias) and the
    tier codes; ``fused_loglik_gram.cu``, fp32 alone, the plain fp32
    operands and no tier code; ``fused_loglik_grad_gram_f32.cu``, (fp32,
    fp32) alone, its own longer stream and the tile height;
    ``fused_gram_mixed.cu``, an fp32 value tier with a bf16 backward, K2's
    stream, then the backward's fragments, the backward's tier code and
    the tile height; ``fused_gram_mma.cu``'s reverse entry, a bf16 value
    tier with an fp32 backward, the forward's fragments, then the
    backward's fp32 stream, and the value tier's code;
    operands stripped of fragments and slabs reach no kernel (the wide
    route's operands: ``test_torch_wide_gram.py``)."""
    m, obs = port_model(SMALL)
    ops = _wrapper(m, obs, case).operands(m.params)
    k3 = case[1] is not None
    entry, tensors, tiers = _kernel(ops, k3)
    names = (ops.tier, ops.grad_tier) if k3 else (ops.tier,)
    assert tensors[:2] == [ops.w0, ops.b0]
    if "highest" not in case:
        p = ops.packed
        assert entry == ("k3_fused_loglik_grad_gram_mma" if k3 else "k2_fused_loglik_gram_mma")
        layers = [[w, b, wt] for w, b, wt in zip(p.w, p.b, p.wt)] if k3 else \
            [[w, b] for w, b in zip(p.w, p.b)]
        want = [t for layer in layers for t in layer] + [p.g, p.u]
        assert tiers == [TIER_CODE[t] for t in names]
    elif not k3:
        assert entry == "k2_fused_loglik_gram" and tiers == [None]  # the wrapper passes its height
        assert _kernel(ops, k3, rows=32)[2] == [32]
        want = [ops.slabs.w, ops.slabs.b]
        assert all(t.dtype == torch.float32 for t in tensors)
    elif case == ("highest", "highest"):
        assert entry == "k3_fused_loglik_grad_gram_f32" and tiers == [None]
        assert _kernel(ops, k3, rows=16)[2] == [16]  # the wrapper passes the batch's height
        want = [ops.slabs.w, ops.slabs.b]
        k2_stream = _wrapper(m, obs, ("highest", None)).operands(m.params).slabs.w
        assert torch.equal(ops.slabs.w[: k2_stream.numel()], k2_stream)
        assert ops.slabs.w.numel() > k2_stream.numel()
        assert all(t.dtype == torch.float32 for t in tensors)
    elif case[0] == "highest":
        assert entry == "k3_fused_loglik_grad_gram_mixed"
        assert tiers == [TIER_CODE[ops.grad_tier], None]
        assert _kernel(ops, k3, rows=32)[2] == [TIER_CODE[ops.grad_tier], 32]
        want = [ops.slabs.w, ops.slabs.b, *ops.packed.wt]
        k2 = _wrapper(m, obs, ("highest", None)).operands(m.params).slabs
        assert torch.equal(ops.slabs.w, k2.w) and torch.equal(ops.slabs.b, k2.b)
        for wt, fused in zip(ops.packed.wt, _wrapper(m, obs, ("high", case[1]))
                             .operands(m.params).packed.wt, strict=True):
            assert wt.dtype == torch.bfloat16 and torch.equal(wt, fused)
    else:
        p = ops.packed
        assert entry == "k3_fused_loglik_grad_gram_reverse" and tiers == [TIER_CODE[ops.tier]]
        want = [t for w, b in zip(p.w, p.b) for t in (w, b)] + [p.g, p.u, ops.slabs.w]
        fused = _wrapper(m, obs, (case[0], None)).operands(m.params).packed
        for got, k2 in zip(tensors[2:-1], [t for w, b in zip(fused.w, fused.b)
                                           for t in (w, b)] + [fused.g, fused.u], strict=True):
            assert torch.equal(got, k2)  # the tensor-core K2's operands at the value tier
        assert tensors[-1].dtype == torch.float32
        f32 = _wrapper(m, obs, ("highest", "highest")).operands(m.params).slabs.w
        assert torch.equal(ops.slabs.w, f32[f32.numel() - ops.slabs.w.numel():])
        got = tensors[2:]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        # stripped of fragments and slabs: no kernel's operands
        with pytest.raises(ValueError, match="no kernel's packing"):
            _kernel(dataclasses.replace(ops, packed=None, slabs=None), k3)
        return
    got = tensors[2:]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


def _f32_gram(m, obs, **kw):
    fn = make_fused_loglik_gram(m.config, m.normalizer, obs, 25.0, precision="highest",
                                device="cpu", **kw)
    assert not fn.tensor_cores
    return fn


F32_GRAM_WIDTHS = [*GRAM_WIDTHS, FLAGSHIP[1:]]


@pytest.mark.parametrize("hidden", F32_GRAM_WIDTHS)
def test_gram_f32_slabs_unpack_to_the_fold(port_model, hidden):
    """``pack_gram_slabs`` read back by ``csrc/tile_f32.cuh``'s layout
    holds trunk layers 1 … n−1 and then ``G`` exactly, zero-padded to
    (padk(K), 128·chunks); the biases are zero-padded, and ``G``'s bias
    slot holds ``u``; nothing is packed for the tensor cores."""
    m, obs = port_model(hidden)
    ops = _f32_gram(m, obs).operands(m.params)
    assert ops.packed is None and ops.slabs is not None
    trunk, G, u, _ = gram_fold(m.params, m.normalizer, obs_tensor(obs, 451, device="cpu"),
                               noise_scale(25.0, 451, device="cpu"))
    layers = [(layer["w"], layer["b"]) for layer in trunk[1:]] + [(G, u)]
    shapes = [tuple(w.shape) for w, _ in layers]
    for (w, b), (want_w, want_b) in zip(unpack_slabs(ops.slabs, shapes), layers, strict=True):
        k, n = want_w.shape
        assert torch.equal(w[:k, :n], want_w) and torch.equal(b[:n], want_b)
        assert not w[k:].any() and not w[:, n:].any() and not b[n:].any()


@pytest.mark.parametrize("hidden", F32_GRAM_WIDTHS)
def test_gram_f32_emulation_matches_plain(port_model, splits, hidden):
    """Through the packed slabs, slab by slab and k ascending, the
    register-tiled K2 equals :func:`loglik_gram_reference`: they differ
    only in fp32 summation order, so within 1e-5 of |logL| + c/2 (37
    rows, one with fx == 0), at narrow widths and the flagship's."""
    m, obs = port_model(hidden)
    ops = _f32_gram(m, obs).operands(m.params)
    x = _raw(splits)
    got, want = emulate_f32_gram(ops, x), loglik_gram_reference(ops, x)
    assert got.shape == (37,) and torch.isfinite(got).all()
    assert bool(((got - want).abs() <= 1e-5 * (want.abs() + 0.5 * abs(float(ops.c)))).all())


def test_gram_f32_emulation_matches_pallas(pair):
    """The emulation against the JAX package's Pallas K2 at ``highest``
    (interpret mode), within the same fp32 tolerance."""
    jm, tm, obs, raw = pair
    want = np.asarray(jax_fused_gram(jm.config, jm.normalizer, obs, 25.0, precision="highest",
                                     block_rows=8, interpret=True)(jm.params, jnp.asarray(raw)))
    ops = _f32_gram(tm, obs).operands(tm.params)
    got = emulate_f32_gram(ops, torch.as_tensor(raw)).numpy()
    assert (np.abs(got - want) <= 1e-5 * (np.abs(want) + 0.5 * abs(float(ops.c)))).all()


def test_gram_f32_tile_height_follows_shared_memory(port_model):
    """K2 at fp32 runs the tallest tile up to the preferred height whose
    shared memory fits: the flagship at the preferred height, the widest
    trunk the 16-row fp32 design took (4·16·(7 + 2·1812) ≤ 232,448 bytes) at
    8 rows; every trunk within that limit fits; a forced height reaches
    the wrapper, an unknown one is refused."""
    assert gram_f32_rows(FLAGSHIP) == F32_PREFERRED_ROWS
    for trunk in [(7, 1812), (7, 1812, 1812), (8, 30, 1812, 1812), (1, 1815)]:
        assert 4 * 16 * (trunk[0] + 2 * max(trunk[1:])) <= MAX_SHARED_BYTES
        assert gram_f32_rows(trunk) == 8
        assert gram_shared_bytes(trunk) <= MAX_SHARED_BYTES
    for width in range(1, 1816, 37):
        assert gram_shared_bytes((7, width, max(1, width // 3))) <= MAX_SHARED_BYTES
    m, obs = port_model(SMALL)
    assert _f32_gram(m, obs).tile_rows == F32_PREFERRED_ROWS
    for rows in F32_TILE_ROWS:
        assert _f32_gram(m, obs, tile_rows=rows).tile_rows == rows
    with pytest.raises(ValueError, match="tile_rows"):
        _f32_gram(m, obs, tile_rows=12)


def _f32_grad_gram(m, obs, **kw):
    fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision="highest",
                                     grad_precision="highest", device="cpu", **kw)
    assert not fn.tensor_cores and fn.register_tiled
    return fn


@pytest.mark.parametrize("hidden", F32_GRAM_WIDTHS)
def test_grad_gram_f32_slabs_unpack_to_the_fold(port_model, hidden):
    """``pack_grad_gram_slabs`` read back by ``csrc/tile_f32.cuh``'s layout
    holds trunk layers 1 … n−1, ``G`` with ``u`` in its bias slot, then
    ``W_iᵀ`` for i = n−1 … 1 with zero biases, each exact and zero-padded
    to (padk(K), 128·chunks); nothing is packed for the tensor cores."""
    m, obs = port_model(hidden)
    ops = _f32_grad_gram(m, obs).operands(m.params)
    assert ops.packed is None and ops.slabs is not None
    trunk, G, u, _ = gram_fold(m.params, m.normalizer, obs_tensor(obs, 451, device="cpu"),
                               noise_scale(25.0, 451, device="cpu"))
    layers = [(layer["w"], layer["b"]) for layer in trunk[1:]] + [(G, u)]
    layers += [(layer["w"].T, torch.zeros(layer["w"].shape[0])) for layer in trunk[:0:-1]]
    assert len(layers) == 2 * len(hidden) - 1
    shapes = [tuple(w.shape) for w, _ in layers]
    for (w, b), (want_w, want_b) in zip(unpack_slabs(ops.slabs, shapes), layers, strict=True):
        k, n = want_w.shape
        assert torch.equal(w[:k, :n], want_w) and torch.equal(b[:n], want_b)
        assert not w[k:].any() and not w[:, n:].any() and not b[n:].any()


@pytest.mark.parametrize("hidden", F32_GRAM_WIDTHS)
def test_grad_gram_f32_emulation_matches_plain(port_model, splits, hidden):
    """Through the packed stream, forward and backward, slab by slab and k
    ascending, with the masks taken from the fp32 pre-activations, the
    register-tiled K3 equals :func:`loglik_grad_gram_reference`: they
    differ only in fp32 summation order, so values within 1e-5 of |logL|
    + c/2 and q99.9 of the per-row gradient error ≤ 1e-4 (37 rows, one
    with fx == 0, whose slot-2 gradient is exactly 0). Its value equals
    the register-tiled K2's bit for bit: the same forward."""
    m, obs = port_model(hidden)
    ops = _f32_grad_gram(m, obs).operands(m.params)
    x = _raw(splits)
    (got, g), (want, gp) = emulate_f32_grad_gram(ops, x), loglik_grad_gram_reference(ops, x)
    assert got.shape == (37,) and g.shape == (37, 7)
    assert torch.isfinite(got).all() and torch.isfinite(g).all()
    assert bool(((got - want).abs() <= 1e-5 * (want.abs() + 0.5 * abs(float(ops.c)))).all())
    assert np.quantile(grad_rel_error(g.numpy(), gp.numpy()), 0.999) <= 1e-4
    assert grad_gate_violation(g.numpy(), gp.numpy()) <= 0.0
    assert g[5, 2] == 0.0
    k2 = _f32_gram(m, obs).operands(m.params)
    assert torch.equal(got, emulate_f32_gram(k2, x))


def test_grad_gram_f32_emulation_matches_pallas(pair):
    """The emulation against the JAX package's Pallas K3 at ("highest",
    "highest") (interpret mode; the same checkpoint, 37 NumPy-seeded rows,
    one with fx == 0): values within the fp32 tolerance, 1e-5 of |logL| +
    c/2; gradients with q99.9 of the per-row error ≤ 1e-4 and, element by
    element, within rtol 1e-4 of the largest gradient entry."""
    _, tm, obs, raw = pair
    vj, gj = _pallas(pair, ("highest", "highest"))
    ops = _f32_grad_gram(tm, obs).operands(tm.params)
    vt, gt = (t.numpy() for t in emulate_f32_grad_gram(ops, torch.as_tensor(raw)))
    assert (np.abs(vt - vj) <= 1e-5 * (np.abs(vj) + 0.5 * abs(float(ops.c)))).all()
    assert np.quantile(grad_rel_error(gt, gj), 0.999) <= 1e-4
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())
    assert gt[5, 2] == 0.0 and gj[5, 2] == 0.0


def test_grad_gram_f32_rows_do_not_mix(port_model, splits):
    """A row's value and gradient depend on no other row: with a NaN row
    in the batch every other row comes out bit for bit as without it (the
    masks are selects, false for NaN, never products), the NaN row's value
    is NaN, and an fx == 0 row's slot-2 gradient is exactly 0."""
    m, obs = port_model(SMALL)
    ops = _f32_grad_gram(m, obs).operands(m.params)
    x = _raw(splits)
    v, g = emulate_f32_grad_gram(ops, x)
    bad = x.clone()
    bad[11, 4] = float("nan")
    vb, gb = emulate_f32_grad_gram(ops, bad)
    keep = torch.arange(37) != 11
    assert torch.equal(vb[keep], v[keep]) and torch.equal(gb[keep], g[keep])
    assert torch.isnan(vb[11]) and torch.isfinite(v).all() and torch.isfinite(g).all()
    assert g[5, 2] == 0.0 and gb[5, 2] == 0.0
    vp, gp = loglik_grad_gram_reference(ops, bad)
    assert torch.isnan(vp[11]) and torch.isfinite(vp[keep]).all() and torch.isfinite(gp[keep]).all()


def test_grad_gram_f32_shared_bytes(port_model):
    """``fused_loglik_grad_gram_f32.cu``'s shared memory: K2's tiles and
    partials, K3's ring (two 32-deep slots at 64 rows, else K2's) and the
    mask bytes: 8, 4, 2, 2 per padded column of activations 0 … n−2 at
    64, 32, 16, 8 rows. At the flagship a 64-row block fills an SM and two
    32-row blocks share one (each with 1 KB reserved, of 233,472)."""
    assert grad_f32_bytes(FLAGSHIP, 64) == 182_016 + 32_768 + 1_024 + 7_424 == 223_232
    assert grad_f32_bytes(FLAGSHIP, 32) == 91_008 + 16_384 + 1_024 + 3_712 == 112_128
    assert 2 * (grad_f32_bytes(FLAGSHIP, 32) + 1024) <= 233_472
    assert grad_f32_bytes(FLAGSHIP, 16) == 4 * 18 * 711 + 3 * 8 * 128 * 4 + 1_024 + 2 * 928
    assert grad_f32_bytes(FLAGSHIP, 8) == 4 * 9 * 711 + 3 * 8 * 128 * 4 + 1_024 + 2 * 928
    # K2's ring (three slots) would not fit beside the masks at 64 rows
    assert f32_tile_bytes(64, 7, 352) + 7_424 > MAX_SHARED_BYTES
    # a lone skinny layer keeps no mask: the gram epilogue reads h itself
    assert grad_f32_bytes((7, 40), 64) == f32_tile_bytes(64, 7, 64, mask_cols=0)
    assert grad_f32_heights(FLAGSHIP) == F32_TILE_ROWS
    assert grad_f32_heights((7, 704, 704)) == (32, 16, 8)
    assert shared_bytes((7, 704, 704)) == grad_f32_bytes((7, 704, 704), 32)
    assert shared_bytes(FLAGSHIP, rows=16) == grad_f32_bytes(FLAGSHIP, 16)


@pytest.mark.parametrize("n_rows, sm_count, want", [
    (65_536, 132, 64),  # 1024 blocks of 64 rows: several waves at every height
    (8_449, 132, 64),   # 133 blocks of 64 rows: no height runs it in one wave
    (8_448, 132, 64),   # exactly one 64-row block per SM; 264 blocks of 32 rows
    (4_225, 132, 64),
    (4_224, 132, 32),
    (4_096, 132, 32),   # the HMC batch: 128 blocks of 32 rows, each alone on an SM
    (2_113, 132, 32),
    (2_112, 132, 16),
    (1_057, 132, 16),
    (1_056, 132, 8),
    (37, 132, 8),
    (1, 132, 8),
    (4_096, 64, 64),
    (4_096, None, 64),  # no card: the tallest that fits
    (None, 132, 64),
])
def test_grad_gram_f32_tile_height_follows_the_batch(n_rows, sm_count, want):
    """K3 at (fp32, fp32) runs the shortest tile that still runs the batch
    as at most one block per SM, else the tallest that fits."""
    assert grad_f32_rows(FLAGSHIP, n_rows, sm_count) == want
    # only the heights that fit are candidates
    if want == 64:
        assert grad_f32_rows((7, 704, 704), n_rows, sm_count) == 32
    assert grad_f32_rows(FLAGSHIP, n_rows, sm_count, forced=16) == 16


def test_grad_gram_f32_takes_what_the_16_row_kernel_took(port_model):
    """No network the first, 16-row kernel held (every activation and ``h@G``
    at 16 rows within the block's shared memory) is refused at (fp32,
    fp32): the register-tiled kernel takes it at some height down to 8
    rows (stride 9), or, where one layer is too wide for two full-width
    8-row buffers, the wide route (``fused_loglik_grad_gram.cu``) does,
    at 32 rows. Heights are forced through the wrapper and per call; an
    unknown height is refused."""
    m, obs = port_model(SMALL)
    every = lambda widths: 4 * 16 * (sum(widths) + widths[-1])  # noqa: E731
    for trunk in [(7, 1812), (7, 1200, 1200), (7, 896, 896, 896), (8, 30, 1000, 1000),
                  (7, 288, 352, 288, 224), (7, 2900, 300), (7, 2900, 8, 8)]:
        assert every(trunk) <= MAX_SHARED_BYTES
        heights = grad_f32_heights(trunk)
        assert heights and heights[-1] == 8
        assert shared_bytes(trunk) == grad_f32_bytes(trunk, heights[0]) <= MAX_SHARED_BYTES
    for width in range(1, 1816, 37):
        assert grad_f32_heights((7, width, max(1, width // 3)))
    # one layer far wider than the rest: two full-width buffers do not fit
    # at 8 rows; the wide route streams it at 32
    for trunk in [(7, 3623, 1), (7, 3200, 64, 64)]:
        assert every(trunk) <= MAX_SHARED_BYTES and grad_f32_heights(trunk) == ()
        assert grad_f32_rows(trunk, 4096, 132) is None
        assert shared_bytes(trunk) == plan_bytes(wide_plan(trunk, 0), 32) <= MAX_SHARED_BYTES
        fn = make_fused_loglik_grad_gram(DirectEmulatorConfig(hidden_dims=trunk[1:]),
                                         m.normalizer, obs, precision="highest", device="cpu")
        assert fn.wide and not fn.register_tiled and not fn.tensor_cores
        assert fn.heights == (32, 16) and fn.rows_for(4096) == 32
    fn = _f32_grad_gram(m, obs)
    assert fn.tile_rows is None and fn.heights == F32_TILE_ROWS and fn.sm_count is None
    assert fn.rows_for(4096) == 64  # on the CPU no SM count: the tallest
    fn.sm_count = 132
    assert [fn.rows_for(n) for n in (65_536, 4_096, 2_048, 100)] == [64, 32, 16, 8]
    for rows in F32_TILE_ROWS:
        forced = _f32_grad_gram(m, obs, tile_rows=rows)
        assert forced.tile_rows == rows and forced.rows_for(4096) == rows
    with pytest.raises(ValueError, match="tile_rows"):
        _f32_grad_gram(m, obs, tile_rows=12)
    with pytest.raises(NotImplementedError, match="shared memory per K3 block at the f32"):
        make_fused_loglik_grad_gram(DirectEmulatorConfig(hidden_dims=(704, 704)), m.normalizer,
                                    obs, precision="highest", tile_rows=64, device="cpu")
