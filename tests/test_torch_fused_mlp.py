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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu21cmvae.models.direct import DirectEmulator as JaxEmulator
from tpu21cmvae.ops.mlp import init_mlp
from tpu21cmvae.ops.pallas import make_fused_emulate as jax_make_fused_emulate
from tpu21cmvae.ops.pallas import make_fused_mlp as jax_make_fused_mlp
from tpu21cmvae.utils.config import DirectEmulatorConfig as JaxConfig
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.ops.kernels.fused_mlp import (
    make_fused_emulate,
    make_fused_mlp,
    shared_bytes,
)
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig

SMALL = (32, 48, 32, 24)


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
    with pytest.raises(NotImplementedError, match="layers"):
        make_fused_mlp((7,) + (8,) * 9 + (3,), device="cpu")
    with pytest.raises(NotImplementedError, match="shared memory"):
        make_fused_mlp((7, 4096, 4096, 3), device="cpu")
    with pytest.raises(NotImplementedError, match="ReLU"):
        make_fused_emulate(DirectEmulatorConfig(hidden_dims=SMALL, activation="tanh"),
                           m.normalizer, device="cpu")
    assert fn(m.params, x[:0]).shape == (0, 451)
    ops = fn.operands(m.params)
    assert fn.operands(m.params) is ops
    assert shared_bytes(ops.widths) == 4 * 16 * (7 + 2 * max(SMALL) + 8)
    w = m.params[2]["w"]
    with torch.no_grad():
        w.mul_(2.0)
    try:
        assert fn.operands(m.params) is not ops
    finally:
        with torch.no_grad():
            w.div_(2.0)
