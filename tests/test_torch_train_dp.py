"""The port's data-parallel training against the JAX package's (the
training half of ``tests/test_parallel.py``).

Both packages start from the same NumPy weights. JAX shards its batch
over its eight virtual CPU devices; the port cuts each batch into one
chunk per entry of a mesh of eight CPU entries, sums the chunks'
gradients and divides once. The port's shuffles are JAX's, through its
one training draw seam (``_torch_pair.jax_seam``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import jax_seam, one_torch_thread  # noqa: F401

from tpu21cmvae.ops.mlp import init_mlp as jax_init_mlp
from tpu21cmvae.ops.mlp import mlp_apply as jax_mlp_apply
from tpu21cmvae.ops.transforms import par_transform as jax_par, preproc as jax_pre
from tpu21cmvae.parallel import dp_fit as jax_dp_fit
from tpu21cmvae.parallel import make_dp_train_step as jax_dp_step
from tpu21cmvae.parallel import make_mesh as jax_make_mesh
from tpu21cmvae.parallel import replicate as jax_replicate
from tpu21cmvae.parallel import shard_batch as jax_shard_batch
from tpu21cmvae.train.adam import adam_init as jax_adam_init
from tpu21cmvae.utils.config import TrainConfig as JaxTrainConfig
from tpu21cmvae_torch.ops.mlp import mlp_apply
from tpu21cmvae_torch.parallel import Mesh, dp_fit, dp_fit_scan, make_dp_train_step, shard_batch
from tpu21cmvae_torch.parallel.train_dp import _pad_to_mesh
from tpu21cmvae_torch.train.loop import fit
from tpu21cmvae_torch.train.scan import fit_scan
from tpu21cmvae_torch.utils.config import TrainConfig

CPU8 = Mesh([torch.device("cpu")] * 8)


def _port(params):
    """JAX weights as the port's trainable tensors."""
    return tuple({k: torch.tensor(np.asarray(v)) for k, v in layer.items()} for layer in params)


def _mse(p, x, y):
    return torch.mean((mlp_apply(p, x) - y) ** 2, dim=-1)


def _jax_mse(p, x, y):
    return jnp.mean((jax_mlp_apply(p, x) - y) ** 2, axis=-1)


def _data(splits, normalizer, n_train, n_val, splits_src=None):
    s = splits if splits_src is None else splits_src
    x = np.asarray(jax_par(jnp.asarray(s.par_train[:n_train], jnp.float32), normalizer))
    y = np.asarray(jax_pre(jnp.asarray(s.signal_train[:n_train], jnp.float32), normalizer))
    xv = np.asarray(jax_par(jnp.asarray(s.par_val[:n_val], jnp.float32), normalizer))
    yv = np.asarray(jax_pre(jnp.asarray(s.signal_val[:n_val], jnp.float32), normalizer))
    return x, y, xv, yv


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_weights(port, ref, atol):
    """Layer by layer, ``ref`` the port's or JAX's layer dicts."""
    for a, b in zip(port, ref):
        for k in ("w", "b"):
            np.testing.assert_allclose(_np(a[k]), _np(b[k]), rtol=0.0, atol=atol)


def test_pad_to_mesh_cycles_real_rows():
    """JAX's padding: rows cycled from the start (more than once for a
    tiny array), the real count returned; a divisible array unchanged."""
    from tpu21cmvae.parallel.train_dp import _pad_to_mesh as jax_pad

    x = np.arange(3 * 2, dtype=np.float32).reshape(3, 2)
    got, n = _pad_to_mesh(x, CPU8)
    want, n_jax = jax_pad(x, jax_make_mesh())
    assert n == n_jax == 3 and got.shape == (8, 2)
    np.testing.assert_array_equal(got, want)
    t, n = _pad_to_mesh(torch.tensor(x), CPU8)
    assert isinstance(t, torch.Tensor) and torch.equal(t, torch.tensor(want))
    same, n = _pad_to_mesh(np.zeros((16, 2)), CPU8)
    assert same.shape == (16, 2) and n == 16


@pytest.mark.parametrize("chunks", [False, True])
def test_dp_train_step_matches_jax(splits, normalizer, chunks):
    """One step from the same weights and batch: JAX's sharded step and
    the port's (the batch whole, or as ``shard_batch``'s chunks), loss
    within rtol 1e-5, weights within atol 1e-5."""
    cfg = JaxTrainConfig()
    params = jax_init_mlp(jax.random.key(0), (7, 32, 451))
    x, y, _, _ = _data(splits, normalizer, 64, 1)
    mesh = jax_make_mesh()
    p2, _, l2 = jax_dp_step(_jax_mse, cfg, mesh)(
        jax_replicate(params, mesh), jax_replicate(jax_adam_init(params), mesh),
        jnp.float32(0.01), jax_shard_batch(jnp.asarray(x), mesh),
        jax_shard_batch(jnp.asarray(y), mesh))
    mine = _port(params)
    bx, by = torch.tensor(x), torch.tensor(y)
    if chunks:
        bx, by = shard_batch(bx, CPU8), shard_batch(by, CPU8)
    p1, state, l1 = make_dp_train_step(_mse, TrainConfig(), CPU8)(mine, None, 0.01, bx, by)
    assert p1 is mine and state.step == 1
    assert np.allclose(float(l1), float(l2), rtol=1e-5)
    _assert_weights(mine, p2, atol=1e-5)


def test_dp_fit_matches_fit_and_jax(splits, normalizer):
    """Three epochs: the port's ``dp_fit`` against its one-device ``fit``
    and against JAX's ``dp_fit`` on JAX's shuffles (rtol 1e-4)."""
    cfg = dict(epochs=3, early_stop_patience=None, plateau_patience=None)
    params = jax_init_mlp(jax.random.key(1), (7, 16, 451))
    data = _data(splits, normalizer, 256, 64)
    _, _, h_jax = jax_dp_fit(params, _jax_mse, *map(jnp.asarray, data), JaxTrainConfig(**cfg),
                             jax_make_mesh())
    with jax_seam():
        single = _port(params)
        _, _, h1 = fit(single, _mse, *data, TrainConfig(**cfg))
        dp = _port(params)
        _, _, h2 = dp_fit(dp, _mse, *data, TrainConfig(**cfg), CPU8)
    np.testing.assert_allclose(h2.loss, h1.loss, rtol=1e-4)
    np.testing.assert_allclose(h2.loss, h_jax.loss, rtol=1e-4)
    np.testing.assert_allclose(h2.val_loss, h_jax.val_loss, rtol=1e-4)
    _assert_weights(dp, single, atol=1e-4)


@pytest.mark.parametrize("n_train,n_val,batch,epochs", [(333, 65, 64, 3), (126, 64, 63, 2)])
def test_dp_fit_uneven_and_all_pad_splits(splits, normalizer, n_train, n_val, batch, epochs):
    """Split sizes that do not divide the mesh (333/65), and 126 rows at
    batch 63, which JAX pads into an all-padding third batch: the port
    pads each batch to a mesh multiple with weight-0 rows and matches
    its one-device run (rtol 1e-4 on the losses, atol 1e-4 on the
    weights) and JAX's ``dp_fit``."""
    cfg = dict(epochs=epochs, batch_size=batch, learning_rate=0.003,
               early_stop_patience=None, plateau_patience=None)
    params = jax_init_mlp(jax.random.key(2), (7, 16, 451))
    data = _data(splits, normalizer, n_train, n_val)
    _, _, h_jax = jax_dp_fit(params, _jax_mse, *map(jnp.asarray, data), JaxTrainConfig(**cfg),
                             jax_make_mesh())
    with jax_seam():
        single = _port(params)
        _, _, h1 = fit(single, _mse, *data, TrainConfig(**cfg))
        dp = _port(params)
        _, _, h2 = dp_fit(dp, _mse, *data, TrainConfig(**cfg), CPU8)
    np.testing.assert_allclose(h2.loss, h1.loss, rtol=1e-4)
    np.testing.assert_allclose(h2.val_loss, h1.val_loss, rtol=1e-4)
    np.testing.assert_allclose(h2.loss, h_jax.loss, rtol=1e-4)
    _assert_weights(dp, single, atol=1e-4)


def test_dp_fit_scan_real_dataset_split_sizes(normalizer):
    """The real 21cmGEM split sizes, 26,889 train / 1,704 val (reference
    ``sample_notebook.ipynb`` cell 19), train data-parallel on the
    eight-entry mesh and match the one-device device-loop trainer."""
    from tpu21cmvae_torch.data.synthetic import synthetic_dataset

    data = synthetic_dataset(n_train=26889, n_val=1704, n_test=8, seed=11)
    assert data.par_train.shape[0] % 8 != 0
    params = jax_init_mlp(jax.random.key(0), (7, 8, 451))
    arrays = _data(None, normalizer, 26889, 1704, splits_src=data)
    cfg = TrainConfig(epochs=2, learning_rate=0.003, early_stop_patience=None,
                      plateau_patience=None)
    dp = _port(params)
    _, _, h_dp = dp_fit_scan(dp, _mse, *arrays, cfg, CPU8)
    one = _port(params)
    _, _, h_1 = fit_scan(one, _mse, *arrays, cfg)
    np.testing.assert_allclose(h_dp.loss, h_1.loss, rtol=1e-4)
    np.testing.assert_allclose(h_dp.val_loss, h_1.val_loss, rtol=1e-4)
    for a, b in zip(dp, one):
        np.testing.assert_allclose(_np(a["w"]), _np(b["w"]), rtol=1e-4, atol=1e-5)


def test_dp_fit_stochastic_loss_draws_the_one_device_normals(splits, normalizer):
    """A stochastic loss on the mesh reads its chunk's rows of the whole
    batch's draw: the run is the one-device run up to summation order."""
    cfg = TrainConfig(epochs=2, batch_size=48, early_stop_patience=None, plateau_patience=None)
    params = jax_init_mlp(jax.random.key(4), (7, 16, 451))
    data = _data(splits, normalizer, 150, 40)

    def noisy(p, x, y, noise, epoch):
        return _mse(p, x, y) * (1.0 + 0.1 * noise((x.shape[0],)) + 0.01 * epoch)

    one, dp = _port(params), _port(params)
    _, _, h1 = fit(one, noisy, *data, cfg, stochastic=True, pass_epoch=True)
    _, _, h2 = dp_fit(dp, noisy, *data, cfg, CPU8, stochastic=True, pass_epoch=True)
    np.testing.assert_allclose(h2.loss, h1.loss, rtol=1e-5)
    np.testing.assert_allclose(h2.val_loss, h1.val_loss, rtol=1e-5)
    _assert_weights(dp, one, atol=1e-5)


def test_ensemble_member_sharded_training_matches_unsharded(splits):
    """Seed parallelism: ``fit_scan_stack`` with the member axis on the
    eight-entry mesh (one member per entry) gives each member the weights
    and history it reaches alone; eight members must divide the mesh."""
    from tpu21cmvae_torch.models.ensemble import DeepEnsemble
    from tpu21cmvae_torch.utils.config import DirectEmulatorConfig

    cfg = DirectEmulatorConfig(hidden_dims=(16,))
    tc = TrainConfig(epochs=4, early_stop_patience=None, plateau_patience=None)
    kw = dict(n_members=8, config=cfg, train_config=tc, seeds=list(range(8)), parallel=True,
              device="cpu")
    plain = DeepEnsemble.train(splits, **kw)
    meshed = DeepEnsemble.train(splits, mesh=CPU8, **kw)
    for mp, ms in zip(meshed.members, plain.members):
        assert mp.history.loss == ms.history.loss
        for lp, ls in zip(mp.params, ms.params):
            assert torch.equal(lp["w"], ls["w"]) and torch.equal(lp["b"], ls["b"])
    with pytest.raises(ValueError, match="do not shard evenly over 8 devices"):
        DeepEnsemble.train(splits, mesh=CPU8, **dict(kw, n_members=4, seeds=[0, 1, 2, 3]))
    with pytest.raises(ValueError, match="parallel=True"):
        DeepEnsemble.train(splits, mesh=CPU8, **dict(kw, parallel=False))
