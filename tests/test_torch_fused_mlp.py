"""K1, the fused MLP: its plain PyTorch version against the JAX package's
Pallas kernel (interpret mode on the CPU), ``make_fused_emulate`` against
the port's predict, and the wrapper's contract. The kernel itself is held
to its plain version in ``tests/test_torch_cuda.py``, on a CUDA card.

Tolerances: rtol 1e-5 at ``highest`` (one fp32 computation in two
summation orders, ``tests/test_loglik.py::test_fused_mlp_skinny_single_layer``);
test_loglik tolerance (``tests/test_loglik.py:468-472``: rtol 2e-4,
atol 2e-3·max|y|) at ``high``; the forward gate of ``bench.py:71``
(1.5e-3 relative to amplitude) at ``default``, where the JAX package on
the CPU computes in fp32 and the port rounds both operands to bf16.

The bf16 tiers' tensor-core kernel (``csrc/fused_mlp_mma.cu``) reads
weights that :func:`pack_mma_operands` packed into ``mma`` fragments.
Here those fragments are read back by the PTX ISA's m16n8k16 layout, and
a pure-torch emulation that computes through them is held to
:func:`fused_mlp_reference` and to the Pallas K1. The fp32 tier's
register-tiled kernel (``csrc/fused_mlp.cu``) streams fp32 weight slabs
that ``pack_slabs`` packed: they are read back by ``csrc/tile_f32.cuh``'s
layout, and an emulation through them (``tests/_torch_f32.py``) is held
to the same two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_f32 import emulate_f32_mlp, unpack_slabs
from _torch_mma import mma_product
from _torch_mma import unpack as _unpack

from tpu21cmvae.models.direct import DirectEmulator as JaxEmulator
from tpu21cmvae.ops.mlp import init_mlp
from tpu21cmvae.ops.pallas import make_fused_emulate as jax_make_fused_emulate
from tpu21cmvae.ops.pallas import make_fused_mlp as jax_make_fused_mlp
from tpu21cmvae.utils.config import DirectEmulatorConfig as JaxConfig
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.ops.fold import _log_clamp, _split_hi_lo
from tpu21cmvae_torch.ops.kernels._common import (
    F32_PREFERRED_ROWS,
    F32_TILE_ROWS,
    MAX_SHARED_BYTES,
    f32_tile_bytes,
)
from tpu21cmvae_torch.ops.kernels.fused_mlp import (
    f32_geometry,
    f32_rows,
    fused_mlp_reference,
    k1_route,
    make_fused_emulate,
    make_fused_mlp,
    pack_mma_operands,
    shared_bytes,
)
from tpu21cmvae_torch.ops.mlp import fused_skinny_dense
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig

SMALL = (32, 48, 32, 24)
FLAGSHIP = (7, 288, 352, 288, 224, 451)
# the generic networks of tests/test_torch_cuda.py, the flagship, and
# widths that need padding (hidden 33 and 40, fan-in 12, outputs 20, 451)
MMA_SIZES = [(7, 33), (12, 40, 20), (7, 64, 96, 33), FLAGSHIP, (7, 33, 40, 20), (12, 40, 33, 451)]


def _jax_params(sizes, seed):
    return init_mlp(jax.random.key(seed), sizes)


def _torch_params(params):
    return tuple({k: torch.tensor(np.asarray(v)) for k, v in layer.items()}
                 for layer in params)


def _inputs(n, n_in, seed):
    return np.random.default_rng(seed).normal(size=(n, n_in)).astype(np.float32)


def _both(sizes, n, precision, reduce="none", block_rows=64, seed=1):
    """The same weights and rows through JAX's K1 (interpret mode) and
    the port's plain K1."""
    jp = _jax_params(sizes, seed)
    x = _inputs(n, sizes[0], seed + 10)
    want = np.asarray(jax_make_fused_mlp(sizes, block_rows=block_rows, interpret=True,
                                         precision=precision, reduce=reduce)(jp, jnp.asarray(x)))
    fn = make_fused_mlp(sizes, precision=precision, reduce=reduce, device="cpu")
    got = fn(_torch_params(jp), torch.as_tensor(x)).numpy()
    assert fn.launches == 0  # CPU tensors run the plain version
    return got, want


@pytest.mark.parametrize("n", [8, 100])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_plain_k1_matches_pallas_k1(n, precision):
    """(7, 64, 96, 33): skinny first layer, two tier layers, a ragged
    last tile at 100 rows (JAX pads with ones, the port never pads)."""
    got, want = _both((7, 64, 96, 33), n, precision, block_rows=8 if n == 8 else 64)
    assert got.shape == want.shape == (n, 33)
    if precision == "highest":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3 * np.abs(want).max())


@pytest.mark.parametrize("reduce", ["none", "sumsq"])
def test_single_skinny_layer_is_the_output_layer(reduce):
    """A one-layer network with a 7-wide input: the skinny layer IS the
    linear output layer (no ReLU), with and without the sumsq tail
    (``tests/test_loglik.py::test_fused_mlp_skinny_single_layer``)."""
    got, want = _both((7, 33), 50, "highest", reduce=reduce, block_rows=32, seed=4)
    assert got.shape == ((50,) if reduce == "sumsq" else (50, 33))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got < 0).any() or reduce == "sumsq"  # linear: no ReLU on the output


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_wide_first_layer_runs_as_a_tier_matmul(precision):
    """Fan-in 12 > 8: the first layer is a tier matmul, not the exact
    skinny FMA, in both packages; the log-clamp runs on columns 0–2."""
    sizes = (12, 40, 20)
    jp = _jax_params(sizes, 7)
    x = np.abs(_inputs(37, 12, 8)) + 0.1  # positive: log10 on columns 0-2
    x[3, 2] = 0.0  # the fx == 0 clamp
    want = np.asarray(jax_make_fused_mlp(sizes, block_rows=40, interpret=True,
                                         log_clamp_input=True,
                                         precision=precision)(jp, jnp.asarray(x)))
    fn = make_fused_mlp(sizes, log_clamp_input=True, precision=precision, device="cpu")
    ops = fn.operands(_torch_params(jp))
    assert not ops.skinny and ops.widths == sizes
    got = fn(_torch_params(jp), torch.as_tensor(x)).numpy()
    tol = (dict(rtol=1e-5, atol=1e-5) if precision == "highest"
           else dict(rtol=2e-4, atol=2e-3 * np.abs(want).max()))
    np.testing.assert_allclose(got, want, **tol)


@pytest.fixture(scope="module")
def pair(splits):
    """The same small emulator in both packages."""
    jm = JaxEmulator(splits, config=JaxConfig(hidden_dims=SMALL), seed=3)
    tm = DirectEmulator.from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params),
        jax.tree_util.tree_map(np.asarray, jm.normalizer),
        config=DirectEmulatorConfig(hidden_dims=SMALL), device="cpu",
    )
    return jm, tm


@pytest.fixture(scope="module")
def small_model(pair):
    return pair[1]


def test_default_tier_really_rounds_to_bf16(pair, splits):
    """At ``default`` the JAX package's CPU K1 is fp32 (DEFAULT precision
    is full fp32 under XLA on the CPU), while the port rounds both
    operands to bf16, as single-pass bf16 does on a GPU: the emulated
    signals differ, and the port's stay inside the 1.5e-3
    relative-to-amplitude forward gate of the exact tier."""
    jm, tm = pair
    raw = np.asarray(splits.par_test[:40], np.float32)
    want = np.asarray(jax_make_fused_emulate(jm.config, jm.normalizer, block_rows=40,
                                             interpret=True, precision="default")(
        jm.params, jnp.asarray(raw)))
    exact = tm.predict(raw)
    np.testing.assert_allclose(want, exact, rtol=0, atol=1e-5 * np.abs(exact).max())
    got = make_fused_emulate(tm.config, tm.normalizer, precision="default",
                             device="cpu")(tm.params, torch.as_tensor(raw)).numpy()
    assert not np.array_equal(got, want)
    assert np.abs(got - exact).max() / np.abs(exact).max() <= 1.5e-3


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_fused_emulate_matches_predict(small_model, splits, precision):
    """The normalizer folded into the first and last layers (K1's
    emulate) against the port's predict at the same tier, on a batch with
    an fx == 0 row and on one 1-D row."""
    m = small_model
    raw = np.asarray(splits.par_test[:45], np.float32).copy()
    raw[6, 2] = 0.0
    want = m.predict_fn(precision)(m.params, torch.as_tensor(raw)).numpy()
    fn = make_fused_emulate(m.config, m.normalizer, precision=precision, device="cpu")
    got = fn(m.params, torch.as_tensor(raw)).numpy()
    assert got.shape == (45, 451)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    one = fn(m.params, torch.as_tensor(raw[6])).numpy()
    assert one.shape == (1, 451)
    np.testing.assert_allclose(one[0], got[6], rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_wrapper_rejects_bad_inputs_and_caches(small_model, splits):
    m = small_model
    fn = make_fused_emulate(m.config, m.normalizer, device="cpu")
    x = torch.as_tensor(np.asarray(splits.par_test[:5], np.float32))
    with pytest.raises(TypeError, match="float32"):
        fn(m.params, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        fn(m.params, torch.cat([x, x], dim=1)[:, ::2])
    with pytest.raises(ValueError):
        fn(m.params, x[:, :6].contiguous())
    with pytest.raises(ValueError, match="runs on"):
        fn(m.params, torch.empty((3, 7), device="meta"))
    with pytest.raises(TypeError):
        fn(m.params, x.numpy())
    with pytest.raises(ValueError, match="widths"):
        make_fused_mlp((7, 8, 451), device="cpu")(m.params, x)
    with pytest.raises(ValueError, match="reduce"):
        make_fused_mlp((7, 8), reduce="mean", device="cpu")
    # deeper than the dedicated kernels' eight layers, or wider than their
    # shared memory: the wide route takes them
    deep, wide = (7,) + (8,) * 9 + (3,), (7, 4096, 4096, 3)
    assert k1_route(deep, "f32") == k1_route(wide, "f32") == "wide"
    assert make_fused_mlp(deep, device="cpu").wide and make_fused_mlp(wide, device="cpu").wide
    with pytest.raises(NotImplementedError, match="ReLU"):
        make_fused_emulate(DirectEmulatorConfig(hidden_dims=SMALL, activation="tanh"),
                           m.normalizer, device="cpu")
    assert fn(m.params, x[:0]).shape == (0, 451)
    ops = fn.operands(m.params)
    assert fn.operands(m.params) is ops
    # 64-row tile: input tile, two buffers of 48 → 64 k rows, the 48 KB ring, 1 KB partials
    assert shared_bytes(ops.widths) == 4 * 64 * (7 + 2 * 64) + 49152 + 1024
    w = m.params[2]["w"]
    with torch.no_grad():
        w.mul_(2.0)
    try:
        assert fn.operands(m.params) is not ops
    finally:
        with torch.no_grad():
            w.div_(2.0)


def _random_params(sizes, seed):
    gen = torch.Generator().manual_seed(seed)
    return tuple({"w": torch.randn(a, b, generator=gen) / a ** 0.5,
                  "b": 0.1 * torch.randn(b, generator=gen)}
                 for a, b in zip(sizes[:-1], sizes[1:]))


def _emulate_mma(ops, x):
    """``csrc/fused_mlp_mma.cu``'s arithmetic in plain torch, through the
    packed, padded operands: each activation split (bf16x3) or rounded
    (bf16) once per layer, the products summed in fp32, padded columns
    carried as zeros."""
    h = _log_clamp(x) if ops.log_clamp else x
    last = len(ops.packed) - 1
    for i, (w, b) in enumerate(ops.packed):
        if i == 0 and ops.skinny:
            h = fused_skinny_dense(h, w, b)
        else:
            h = mma_product(h, w, ops.tier) + b
        if i < last:
            h = torch.relu(h)
    h = h[:, : ops.widths[-1]]
    return torch.sum(h * h, dim=-1) if ops.reduce == "sumsq" else h


@pytest.mark.parametrize("sizes", MMA_SIZES)
@pytest.mark.parametrize("precision", ["high", "default"])
def test_packed_operands_unpack_to_the_tier_parts(sizes, precision):
    """Each tensor-core layer's packed bf16 fragments hold exactly
    ``w_hi`` and ``w_lo`` (bf16x3) or ``bf16_rn(w)`` (bf16), zero past
    the layer's widths; the bias is zero-padded to the same grid; a
    skinny first layer stays exact fp32; a lone skinny layer packs
    nothing (it runs ``fused_mlp.cu``)."""
    fn = make_fused_mlp(sizes, precision=precision, device="cpu")
    ops = fn.operands(_random_params(sizes, sum(sizes)))
    if sizes == (7, 33):
        assert ops.packed is None
        return
    assert len(ops.packed) == len(sizes) - 1
    for i, ((w, b), raw_w, raw_b) in enumerate(zip(ops.packed, ops.w, ops.b)):
        k, n = sizes[i], sizes[i + 1]
        if i == 0 and ops.skinny:
            assert w is raw_w and b is raw_b and w.dtype == torch.float32
            continue
        assert w.dtype == torch.bfloat16 and w.is_contiguous()
        kp, np_ = -(-k // 16) * 16, -(-n // 16) * 16
        assert w.shape == (np_ // 8, kp // 16, 32, 2 if precision == "high" else 1, 4)
        got = _unpack(w)
        parts = (_split_hi_lo(fn._fold(_random_params(sizes, sum(sizes)))[i]["w"])
                 if precision == "high" else (raw_w,))
        for p, want in enumerate(parts):
            assert torch.equal(got[p, :k, :n], want)
        assert not got[:, k:].any() and not got[:, :, n:].any()
        assert b.shape == (np_,) and torch.equal(b[:n], raw_b) and not b[n:].any()


@pytest.mark.parametrize("sizes", MMA_SIZES[1:])
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("reduce", ["none", "sumsq"])
def test_mma_emulation_matches_plain(sizes, precision, reduce):
    """Through the packed, padded operands, the tensor-core arithmetic
    equals :func:`fused_mlp_reference`, which multiplies the unpadded
    operands in one matmul (``[hi, hi, lo] @ [w_hi; w_lo; w_hi]`` at
    bf16x3): the two differ only in fp32 summation order, so within
    1e-5 of the amplitude (rows with an fx == 0 and a ragged count)."""
    params = _random_params(sizes, 3 * sum(sizes))
    x = torch.as_tensor(np.abs(_inputs(37, sizes[0], 5)) + 0.05)
    x[4, 2] = 0.0
    fn = make_fused_mlp(sizes, log_clamp_input=True, precision=precision, reduce=reduce,
                        device="cpu")
    ops = fn.operands(params)
    got, want = _emulate_mma(ops, x), fused_mlp_reference(ops, x)
    assert got.shape == want.shape == ((37,) if reduce == "sumsq" else (37, sizes[-1]))
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_mma_emulation_matches_pallas_k1():
    """The emulation at bf16x3 against the JAX package's Pallas K1
    (interpret mode), on ``test_plain_k1_matches_pallas_k1``'s network
    and tolerance."""
    sizes = (7, 64, 96, 33)
    jp = _jax_params(sizes, 1)
    x = _inputs(100, 7, 11)
    want = np.asarray(jax_make_fused_mlp(sizes, block_rows=64, interpret=True,
                                         precision="high")(jp, jnp.asarray(x)))
    ops = make_fused_mlp(sizes, precision="high", device="cpu").operands(_torch_params(jp))
    got = _emulate_mma(ops, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3 * np.abs(want).max())


def test_shared_bytes_per_kernel():
    """``fused_mlp.cu`` (fp32, and a lone skinny layer at every tier)
    keeps k-major fp32 tiles of its tile height (64 rows here) with k
    rows padded to 32, its height's slab ring (32 × 128 floats in three
    slots at 64 rows, 16 × 128 in two at 32, 8 × 128 in three below) and
    1 KB of row partials; ``fused_mlp_mma.cu`` bf16
    tiles of 32 rows, hi and lo at bf16x3, with rows padded to the widest
    padded layer input + 8; a network the kernel its tier runs cannot
    hold routes to the wide route (``k1_route``)."""
    f32 = 4 * 64 * (7 + 2 * 352) + 4 * 3 * 32 * 128 + 1024
    assert shared_bytes(FLAGSHIP) == shared_bytes(FLAGSHIP, "f32") == f32 == 232_192
    assert shared_bytes(FLAGSHIP, "f32", 32) == 4 * 32 * (7 + 2 * 352) + 4 * 2 * 16 * 128 + 1024
    assert shared_bytes(FLAGSHIP, "f32", 16) == 4 * 18 * (7 + 2 * 352) + 4 * 3 * 8 * 128 + 1024
    assert shared_bytes(FLAGSHIP, "bf16x3") == 2 * 2 * 2 * 32 * 360 + 4 * 32 * (7 + 8)
    assert shared_bytes(FLAGSHIP, "bf16") == 2 * 2 * 32 * 360 + 4 * 32 * (7 + 8)
    assert shared_bytes((7, 33), "bf16x3") == 4 * 64 * 7 + 4 * 3 * 32 * 128 + 1024
    # fan-in 12 is a tensor-core layer: its padded input joins the width
    assert shared_bytes((12, 40, 20), "bf16") == 2 * 2 * 32 * 56 + 4 * 32 * (12 + 8)
    assert shared_bytes((40, 20), "bf16x3") == 2 * 2 * 2 * 32 * 56 + 4 * 32 * (40 + 8)
    wide = (7, 1000, 3)  # fits the fp32 and bf16 kernels, not bf16x3's two tiles
    assert shared_bytes(wide, "bf16x3") > MAX_SHARED_BYTES
    for precision, route in (("highest", "f32"), ("default", "mma"), ("high", "wide")):
        fn = make_fused_mlp(wide, precision=precision, device="cpu")
        assert k1_route(wide, fn.tier) == fn.route == route and fn.wide == (route == "wide")


def _f32_ops(sizes, reduce="none", seed=None):
    fn = make_fused_mlp(sizes, log_clamp_input=True, reduce=reduce, device="cpu")
    return fn.operands(_random_params(sizes, 5 * sum(sizes) if seed is None else seed))


@pytest.mark.parametrize("sizes", MMA_SIZES)
def test_f32_slabs_unpack_to_the_weights(sizes):
    """``pack_slabs`` read back by ``csrc/tile_f32.cuh``'s layout holds
    every layer after a skinny first one (every layer without one)
    exactly, zero-padded to (padk(K), 128·chunks), and each bias
    zero-padded to 128·chunks; a lone skinny layer streams nothing."""
    ops = _f32_ops(sizes)
    assert ops.packed is None and ops.slabs.w.dtype == torch.float32
    first = int(ops.skinny)
    shapes = list(zip(sizes[first:-1], sizes[first + 1:]))
    for (w, b), raw_w, raw_b, (k, n) in zip(unpack_slabs(ops.slabs, shapes), ops.w[first:],
                                             ops.b[first:], shapes, strict=True):
        assert w.shape == (-(-k // 32) * 32, -(-n // 128) * 128) and b.shape == (w.shape[1],)
        assert torch.equal(w[:k, :n], raw_w) and torch.equal(b[:n], raw_b)
        assert not w[k:].any() and not w[:, n:].any() and not b[n:].any()
    if sizes == (7, 33):
        assert ops.slabs.w.numel() == ops.slabs.b.numel() == 0


@pytest.mark.parametrize("sizes", MMA_SIZES)
@pytest.mark.parametrize("reduce", ["none", "sumsq"])
def test_f32_emulation_matches_plain(sizes, reduce):
    """Through the packed slabs, slab by slab and k ascending, the
    register-tiled arithmetic equals :func:`fused_mlp_reference` (one
    fp32 matmul per layer): they differ only in fp32 summation order, so
    within 1e-5 of the amplitude, at narrow widths and the flagship (37
    rows, one with fx == 0)."""
    x = torch.as_tensor(np.abs(_inputs(37, sizes[0], 6)) + 0.05)
    x[4, 2] = 0.0
    ops = _f32_ops(sizes, reduce)
    got, want = emulate_f32_mlp(ops, x), fused_mlp_reference(ops, x)
    assert got.shape == want.shape == ((37,) if reduce == "sumsq" else (37, sizes[-1]))
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("sizes", [(7, 64, 96, 33), (12, 40, 20)])
@pytest.mark.parametrize("reduce", ["none", "sumsq"])
def test_f32_emulation_matches_pallas_k1(sizes, reduce):
    """The emulation against the JAX package's Pallas K1 at ``highest``
    (interpret mode, small ``block_rows``), with the log-clamp, on a
    skinny and a fan-in-12 first layer, at
    ``test_plain_k1_matches_pallas_k1``'s tolerance."""
    jp = _jax_params(sizes, 2)
    x = np.abs(_inputs(37, sizes[0], 12)) + 0.1
    x[3, 2] = 0.0
    want = np.asarray(jax_make_fused_mlp(sizes, block_rows=8, interpret=True,
                                         log_clamp_input=True, precision="highest",
                                         reduce=reduce)(jp, jnp.asarray(x)))
    ops = make_fused_mlp(sizes, log_clamp_input=True, reduce=reduce,
                         device="cpu").operands(_torch_params(jp))
    got = emulate_f32_mlp(ops, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_f32_tile_height_follows_shared_memory():
    """The wrapper runs the tallest tile up to its preferred height
    whose shared memory fits: the flagship at the preferred height, the
    widest networks the 16-row fp32 design took at 8 rows; a forced height
    reaches the launch, an unknown one is refused."""
    assert f32_rows(FLAGSHIP) == F32_PREFERRED_ROWS
    assert make_fused_mlp(FLAGSHIP, device="cpu").tile_rows == F32_PREFERRED_ROWS
    for widest in [(7, 1808, 1808, 3), (3616, 3), (8, 1808, 1808, 451)]:
        assert f32_rows(widest) == 8
        assert shared_bytes(widest) <= MAX_SHARED_BYTES
    assert f32_rows((7, 1000, 3)) == 16
    for rows in F32_TILE_ROWS:
        assert make_fused_mlp(SMALL + (451,), tile_rows=rows, device="cpu").tile_rows == rows
    with pytest.raises(ValueError, match="tile_rows"):
        make_fused_mlp(FLAGSHIP, tile_rows=48, device="cpu")
    with pytest.raises(NotImplementedError, match="shared memory"):
        make_fused_mlp((7, 1000, 3), tile_rows=64, device="cpu")


@pytest.mark.parametrize("n_in", [1, 7, 8, 9, 12, 40, 700])
def test_f32_takes_every_network_the_16_row_design_took(n_in):
    """Every network within the 16-row fp32 design's limit (4·16·(n_in +
    2·widest hidden + 8) ≤ 232,448 bytes) still fits a tile height: at
    its boundary and below it, with one hidden layer, two, or none."""
    for hidden in sorted({1, 7, 33, 352, (3624 - n_in) // 2 - 7, (3624 - n_in) // 2}):
        for sizes in [(n_in, hidden, 451), (n_in, hidden, hidden // 2 + 1, 3),
                      (n_in, 3 * hidden)]:
            widest = max(sizes[1:-1], default=0)
            if 4 * 16 * (n_in + 2 * widest + 8) > MAX_SHARED_BYTES:
                continue
            rows = f32_rows(sizes)
            assert shared_bytes(sizes) == f32_tile_bytes(rows, *f32_geometry(sizes))
            assert shared_bytes(sizes) <= MAX_SHARED_BYTES, sizes
            make_fused_mlp(sizes, device="cpu")
