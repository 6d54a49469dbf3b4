"""The port's mesh and mesh-split inference against the JAX package's
(the inference half of ``tests/test_parallel.py``).

The multi-device split runs on a mesh of eight CPU entries (every chunk
on the CPU, each against its own replica of the weights): it holds the
padding, the split and the order of the outputs. No test here runs the
split on several GPUs. Training and the samplers on a mesh are
``test_torch_train_dp.py`` and ``test_torch_parallel_sampling.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import make_pair, one_torch_thread  # noqa: F401

from tpu21cmvae_torch.parallel import Mesh, ShardedEmulator, make_mesh, replicate, shard_batch
from tpu21cmvae_torch.parallel.inference import _bucket_size

CPU8 = Mesh([torch.device("cpu")] * 8)
CPU1 = Mesh([torch.device("cpu")])


@pytest.fixture(scope="module")
def pair(splits):
    return make_pair(splits, (48, 56), seed=3)


@pytest.mark.parametrize("n_dev", range(1, 8))
def test_bucket_and_quantum_match_jax(n_dev):
    """``quantum = lcm(min_quantum, n_devices)`` and the power-of-two
    buckets are JAX's, for 1–7 devices."""
    import math

    from tpu21cmvae.parallel.inference import _bucket_size as jax_bucket

    quantum = math.lcm(8, n_dev)
    assert ShardedEmulator(lambda p, x: x, (), mesh=Mesh(["cpu"] * n_dev)).quantum == quantum
    for n in (0, 1, 7, 8, 9, 13, 100, 1000, 4097):
        assert _bucket_size(n, quantum) == jax_bucket(n, quantum)


def test_make_mesh_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh()
    mesh = make_mesh(devices=[torch.device("cpu")])
    assert mesh.devices.size == 1 and mesh.axis_names == ("data",)
    assert [str(d) for d in mesh.devices.ravel()] == ["cpu"]


def test_replicate_and_shard_batch():
    x = torch.arange(16.0).reshape(8, 2)
    shards = shard_batch(x, CPU8)
    assert len(shards) == 8 and all(s.shape == (1, 2) for s in shards)
    torch.testing.assert_close(torch.cat(shards), x)
    with pytest.raises(ValueError, match="divide evenly"):
        shard_batch(x[:7], CPU8)
    tree = ({"w": torch.ones(2, 3), "b": torch.zeros(3)},)
    reps = replicate(tree, CPU8)
    # on the tensors' own device a replica is the same tensors (so the
    # kernels' operand caches, keyed on identity, fold once)
    assert len(reps) == 8 and all(r[0]["w"] is tree[0]["w"] for r in reps)


def test_sharded_predict_matches_single_device(pair, splits):
    jm, tm = pair
    sharded = ShardedEmulator.for_model(tm, mesh=CPU8)
    raw = splits.par_test[:64]
    got = sharded(raw)
    assert got.shape == (64, 451)
    np.testing.assert_allclose(got, tm.predict(raw), atol=1e-5)
    # and JAX's sharded predict on its 8-device mesh, same weights
    from tpu21cmvae.parallel import ShardedEmulator as JaxSharded

    np.testing.assert_allclose(got, JaxSharded.for_model(jm)(raw), rtol=1e-5, atol=1e-4)


def test_sharded_predict_pads_ragged_batches(pair, splits):
    """Ragged sizes pad to a bucket by repeating row 0; the padding is
    cut off and every row lands where it came from; one row squeezes."""
    _, tm = pair
    seen = []

    def recording(params, x):
        seen.append(x.shape[0])
        return tm.predict_fn()(params, x)

    sharded = ShardedEmulator([recording] * 8, tm.params, mesh=CPU8)
    for n in (1, 7, 8, 13, 100):
        seen.clear()
        got = sharded(splits.par_test[:n])
        assert got.shape == ((451,) if n == 1 else (n, 451))
        assert sum(seen) == _bucket_size(n, 8) and len(set(seen)) == 1
        np.testing.assert_allclose(np.atleast_2d(got), np.atleast_2d(tm.predict(
            splits.par_test[:n])), atol=1e-5)
    np.testing.assert_allclose(sharded(splits.par_test[0]), tm.predict(splits.par_test[0]),
                               atol=1e-5)


def test_sharded_emulator_ae_and_vae_families(splits, tmp_path):
    from tpu21cmvae.models.autoencoder import AutoEncoderEmulator as JaxAE
    from tpu21cmvae.models.vae import VAEEmulator as JaxVAE
    from tpu21cmvae.utils.config import AutoEncoderConfig as JaxAECfg, VAEConfig as JaxVAECfg
    from tpu21cmvae_torch.models.autoencoder import AutoEncoderEmulator
    from tpu21cmvae_torch.models.vae import VAEEmulator
    from tpu21cmvae_torch.utils.config import AutoEncoderConfig, VAEConfig

    small = dict(latent_dim=4, enc_hidden_dims=(32,), dec_hidden_dims=(32,),
                 em_hidden_dims=(24,))
    raw = np.asarray(splits.par_test[:33], np.float32)
    for jcls, jcfg, cls, cfg in ((JaxAE, JaxAECfg, AutoEncoderEmulator, AutoEncoderConfig),
                                 (JaxVAE, JaxVAECfg, VAEEmulator, VAEConfig)):
        jm = jcls(splits, config=jcfg(**small))
        path = str(tmp_path / f"{cls.__name__}.npz")
        jm.save(path)
        tm = cls.from_checkpoint(path, device="cpu")
        out = ShardedEmulator.for_model(tm, mesh=CPU8)(raw)
        assert out.shape == (33, splits.n_bins)
        np.testing.assert_allclose(out, tm.predict(raw), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(out, jm.predict(raw), rtol=1e-5, atol=1e-4)


def test_sharded_emulator_device_call(pair, splits):
    """The on-device path: no padding; a tensor comes back as one tensor,
    a list of shards as one output per device."""
    _, tm = pair
    sharded = ShardedEmulator.for_model(tm, mesh=CPU8)
    x = torch.as_tensor(np.asarray(splits.par_test[:16], np.float32))
    out = sharded.device_call(x)
    assert isinstance(out, torch.Tensor) and out.shape == (16, splits.n_bins)
    np.testing.assert_allclose(out.numpy(), tm.predict(splits.par_test[:16]), rtol=1e-5,
                               atol=1e-4)
    per_dev = sharded.device_call(shard_batch(x, sharded.mesh))
    assert len(per_dev) == 8
    torch.testing.assert_close(torch.cat(per_dev), out)
    with pytest.raises(ValueError, match="divide evenly"):
        sharded.device_call(x[:15])


def test_warmup_covers_its_buckets(pair, splits):
    _, tm = pair
    seen = []

    def recording(params, x):
        seen.append(x.shape[0])
        return tm.predict_fn()(params, x)

    sharded = ShardedEmulator(recording, tm.params, mesh=CPU1)
    sharded.warmup([5, 17, 40])
    assert sorted(set(seen)) == [8, 32, 64]
    for n in (5, 17, 40):
        assert sharded(np.asarray(splits.par_test[:n], np.float32)).shape == (n, 451)


def test_sharded_loglik_matches_single_device(pair, splits):
    """The likelihood through the mesh split equals the unsplit call, for
    both methods, and JAX's on the same weights."""
    jm, tm = pair
    obs = (tm.predict(splits.par_test[0])
           + np.random.default_rng(9).normal(0, 5.0, splits.n_bins)).astype(np.float32)
    raw = np.asarray(splits.par_test[:64], np.float32)
    for method in ("direct", "gram"):
        fn = tm.loglik_fn(obs, 25.0, method=method)
        with torch.no_grad():
            want = fn(tm.params, torch.as_tensor(raw)).numpy()
        got = ShardedEmulator(fn, tm.params, mesh=CPU8)(raw)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        jfn = jm.loglik_fn(jnp.asarray(obs), 25.0, backend="xla", method=method)
        np.testing.assert_allclose(got, np.asarray(jfn(jm.params, jnp.asarray(raw))),
                                   rtol=2e-4, atol=1e-2)


def test_sharded_emulator_wraps_loglik(pair, splits):
    """Any ``(weights, raw) → (B,)`` function: ragged batches padded to
    buckets, a single row squeezed to a scalar."""
    _, tm = pair
    obs = tm.predict(splits.par_test[0])
    fn = tm.loglik_fn(obs, 25.0)
    sharded = ShardedEmulator(fn, tm.params, mesh=CPU1)
    got = sharded(splits.par_test[:13])
    with torch.no_grad():
        want = fn(tm.params, torch.as_tensor(np.asarray(splits.par_test[:13], np.float32)))
    assert got.shape == (13,)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5)
    assert np.shape(sharded(splits.par_test[0])) == ()


def test_for_model_kernel_backend_is_the_direct_family_only(pair, splits):
    """``backend="kernel"`` builds one K1 wrapper per device (its plain
    version on the CPU); any other family, or backend, is refused."""
    from tpu21cmvae_torch.models.ensemble import DeepEnsemble
    from tpu21cmvae_torch.ops.kernels.fused_mlp import FusedMLP

    _, tm = pair
    sharded = ShardedEmulator.for_model(tm, mesh=CPU8, backend="kernel")
    assert all(isinstance(f, FusedMLP) and f.tier == "f32" for f in sharded.fns)
    assert len({id(f) for f in sharded.fns}) == 8
    for n in (1, 20):  # one row pads to a batch NumPy lays out column-major
        np.testing.assert_allclose(sharded(splits.par_test[:n]), tm.predict(splits.par_test[:n]),
                                   rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="direct family"):
        ShardedEmulator.for_model(DeepEnsemble([tm]), mesh=CPU1, backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        ShardedEmulator.for_model(tm, mesh=CPU1, backend="xla")


def test_refuse_mesh_passes_one_device_only():
    """The refusal of a larger mesh is gone: ``_shard_rows`` passes a
    likelihood through unchanged without a mesh, splits its rows over a
    mesh of one device or of eight (the same values), and refuses a
    walker axis that does not divide with JAX's ``ValueError``;
    ``multihost_init`` wants its three addresses."""
    from tpu21cmvae_torch.parallel.mesh import multihost_init
    from tpu21cmvae_torch.sampling._common import MeshSplit, _shard_rows

    def loglik(params, x):
        return -0.5 * (x * x).sum(-1)

    assert _shard_rows(loglik, None, 7) is loglik
    x = torch.arange(7 * 16, dtype=torch.float32).reshape(16, 7) / 50.0
    for mesh in (CPU1, Mesh(["cpu", "cpu"]), CPU8):
        split = _shard_rows(loglik, mesh, 16)
        assert isinstance(split, MeshSplit)
        assert torch.equal(split(None, x), loglik(None, x))
    with pytest.raises(ValueError, match="must divide evenly across the 8-device mesh"):
        _shard_rows(loglik, CPU8, 12)
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost_init()


def test_samplers_run_on_a_one_device_mesh(pair, splits):
    """``mesh=`` a one-device Mesh runs the sampler as without one: the
    same draws from the same seed."""
    _, tm = pair
    obs = tm.predict(splits.par_test[0])
    kw = dict(sampler="mh", n_walkers=32, n_steps=10, n_warmup=10, thin=5, seed=0)
    a = tm.sample_posterior(obs, 25.0, **kw)
    b = tm.sample_posterior(obs, 25.0, mesh=CPU1, **kw)
    np.testing.assert_array_equal(a.chain, b.chain)


def test_replica_on_another_device_copies_what_the_functions_close_over(pair, splits):
    """A model's replica on another device (``meta`` here: no data) has
    its normalizer and, for an ensemble, its members there; the model
    itself is untouched, and on its own device it is its own replica."""
    from tpu21cmvae_torch.models.autoencoder import AutoEncoderEmulator
    from tpu21cmvae_torch.models.ensemble import DeepEnsemble
    from tpu21cmvae_torch.utils.config import AutoEncoderConfig

    _, tm = pair
    assert tm.replica("cpu") is tm
    tm.loglik_fn(np.zeros(451, np.float32), 1.0)  # a memo entry the replica must not share
    rep = tm.replica("meta")
    assert rep is not tm and rep.device.type == "meta"
    assert rep.normalizer.device.type == "meta" and tm.normalizer.device.type == "cpu"
    assert "_t21_loglik_memo" in vars(tm) and "_t21_loglik_memo" not in vars(rep)
    ens = DeepEnsemble([tm, tm])
    rep = ens.replica("meta")
    assert rep.device.type == "meta" and rep.normalizer.device.type == "meta"
    assert all(m.normalizer.device.type == "meta" for m in rep.members)
    assert all(m.normalizer.device.type == "cpu" for m in ens.members)
    cfg = AutoEncoderConfig(latent_dim=3, enc_hidden_dims=(8,), dec_hidden_dims=(8,),
                            em_hidden_dims=(8,))
    ae = AutoEncoderEmulator(splits, config=cfg, seed=5, device="cpu")
    rep = ae.replica("meta")
    assert ae.replica("cpu") is ae and rep.normalizer.device.type == "meta"
