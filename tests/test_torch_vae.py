"""The port's VAE family (``tpu21cmvae_torch/models/vae.py``) against the
JAX package's on a small net (451 → 24 → (mu, logvar) 4 → 16 → 24 → 451,
params → 16 → 4), both packages from the same NumPy weights.

The VAE's stage A is the one stochastic loss: each batch takes fresh
normals. The port draws them through one seam,
``tpu21cmvae_torch.train.loop._normal(seed, epoch, step, shape, device)``;
here it returns the normals JAX draws from ``fold_in(loss_key, step)``
(and from ``key(seed ^ 0x5EED)`` for validation,
``_torch_pair.jax_normal_seam``), beside JAX's permutations through the
shuffle seam.

Tolerances: as ``tests/test_torch_autoencoder.py`` (epoch losses 2e-6
relative, weights 1e-5 relative and 1e-6 absolute, predictions 1e-5 of
the amplitude); the reparameterized sample and the prior draws on the
same normals 1e-5 of the amplitude; the port against itself (host loop,
device loop, resume; the same seam draws) bit for bit.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from _torch_pair import jax_normal_seam, jax_seam, one_torch_thread  # noqa: F401
from tpu21cmvae.models.vae import VAEEmulator as JaxVAE
from tpu21cmvae.utils import config as jconfig
from tpu21cmvae_torch.models.vae import VAEEmulator
from tpu21cmvae_torch.ops.transforms import Normalizer, preproc
from tpu21cmvae_torch.train import loop
from tpu21cmvae_torch.utils import config

ARCH = dict(latent_dim=4, enc_hidden_dims=(24,), dec_hidden_dims=(16, 24), em_hidden_dims=(16,),
            beta=1e-3, kl_anneal_epochs=2)
TRAIN = dict(epochs=3, batch_size=64, learning_rate=1e-3, early_stop_patience=None,
             plateau_patience=None)
EM_TRAIN = dict(TRAIN, learning_rate=1e-2)
HIST_RTOL, W_RTOL, W_ATOL = 2e-6, 1e-5, 1e-6


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_of(jm, splits) -> VAEEmulator:
    return VAEEmulator(
        splits, config=config.VAEConfig(**ARCH),
        normalizer=Normalizer.from_arrays(numpy_tree(jm.normalizer), device="cpu"),
        vae_params=numpy_tree(jm.vae.params), em_params=numpy_tree(jm.em_params), device="cpu",
    )


@pytest.fixture(scope="module")
def pair(splits):
    jm = JaxVAE(splits, config=jconfig.VAEConfig(**ARCH), seed=5)
    return jm, port_of(jm, splits)


def assert_amp(got, want):
    amp = np.abs(want).max(axis=-1, keepdims=True)
    assert float((np.abs(got - want) / amp).max()) <= 1e-5


def assert_weights(port_tree, jax_tree):
    for a, b in zip(jax.tree_util.tree_leaves(numpy_tree(jax_tree)),
                    [t.detach().numpy() for t in jax.tree_util.tree_leaves(port_tree)]):
        np.testing.assert_allclose(b, a, rtol=W_RTOL, atol=W_ATOL)


def test_predict_reconstruct_and_config_match(pair, splits):
    jm, tm = pair
    assert dataclasses.asdict(config.VAEConfig()) == dataclasses.asdict(jconfig.VAEConfig())
    assert_amp(tm.predict(splits.par_test[:16]), np.asarray(jm.predict(splits.par_test[:16])))
    assert_amp(tm.reconstruct(splits.signal_test[:16]),
               np.asarray(jm.reconstruct(splits.signal_test[:16])))
    np.testing.assert_allclose(tm.test_error(use_vae=True), jm.test_error(use_vae=True),
                               rtol=1e-4)
    assert_amp(tm.latent_traversal(1, np.linspace(-2, 2, 5), base_params=splits.par_test[2]),
               np.asarray(jm.latent_traversal(1, np.linspace(-2, 2, 5),
                                              base_params=splits.par_test[2])))


def test_checkpoints_both_ways(pair, splits, tmp_path):
    jm, tm = pair
    raw = splits.par_test[:8]
    back = JaxVAE.from_checkpoint(tm.save(str(tmp_path / "port.npz")))
    assert_amp(np.asarray(back.predict(raw)), tm.predict(raw))
    assert back.config == jm.config
    mine = VAEEmulator.from_checkpoint(jm.save(str(tmp_path / "jax.npz")), device="cpu")
    np.testing.assert_array_equal(mine.predict(raw), tm.predict(raw))
    assert mine.config == tm.config and mine.config.beta == ARCH["beta"]


def test_reparameterize_and_sample_signals_on_injected_normals(pair, splits):
    """JAX's ``reparameterize(key, …)`` and ``sample_signals(key, n)``
    against the port's on the normals JAX draws from the same keys,
    handed over as a tensor; a generator gives the same draws on the same
    seed."""
    jm, tm = pair
    key = jax.random.key(11)
    y = np.asarray(preproc(torch.as_tensor(np.asarray(splits.signal_test[:6], np.float32)),
                           tm.normalizer))
    mu, logvar = jm.vae.encode(jm.vae.params, y)
    want = np.asarray(jm.vae.reparameterize(key, mu, logvar))
    eps = torch.tensor(np.asarray(jax.random.normal(key, mu.shape, mu.dtype)))
    with torch.no_grad():
        tmu, tlv = tm.vae.encode(tm.vae.params, torch.as_tensor(y))
        got = tm.vae.reparameterize(eps, tmu, tlv).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want = np.asarray(jm.sample_signals(key, 5))
    z = torch.tensor(np.asarray(jax.random.normal(key, (5, ARCH["latent_dim"]))))
    assert_amp(tm.sample_signals(z, 5), want)
    a = tm.sample_signals(torch.Generator().manual_seed(3), 5)
    b = tm.sample_signals(torch.Generator().manual_seed(3), 5)
    assert a.shape == (5, 451) and np.array_equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        tm.sample_signals(z[:4], 5)


def test_kl_warmup_weight_is_jax_float32():
    m = VAEEmulator(config=config.VAEConfig(beta=3e-6, kl_anneal_epochs=50),
                    normalizer=Normalizer.template(451, 7), device="cpu")
    for epoch in (0, 1, 24, 49, 50, 300):
        want = float(np.float32(3e-6) * np.float32(min(np.float32(1.0),
                                                       np.float32(epoch + 1) / np.float32(50))))
        assert m.kl_weight(epoch) == want
    assert VAEEmulator(config=config.VAEConfig(kl_anneal_epochs=0),
                       normalizer=Normalizer.template(451, 7),
                       device="cpu").kl_weight(0) == float(np.float32(1e-4))


def test_normal_seam_draws_by_seed_epoch_and_step():
    a = loop._normal(3, 1, 2, (5, 4), "cpu")
    assert a.shape == (5, 4) and a.dtype == torch.float32
    assert torch.equal(a, loop._normal(3, 1, 2, (5, 4), "cpu"))
    others = [loop._normal(*k, (5, 4), "cpu") for k in ((3, 1, 3), (3, 2, 2), (4, 1, 2),
                                                        (3, loop.EVAL_EPOCH, 2))]
    assert not any(torch.equal(a, b) for b in others)


def test_stage_losses_follow_jax_on_jax_normals(splits):
    """Both stages from the same weights, JAX's permutations and JAX's
    normals: the epoch losses and the weights follow JAX's."""
    jm = JaxVAE(splits, config=jconfig.VAEConfig(**ARCH), seed=5)
    tm = port_of(jm, splits)
    want = jm.train(vae_train_config=jconfig.TrainConfig(**TRAIN),
                    em_train_config=jconfig.TrainConfig(**EM_TRAIN))
    with jax_seam(), jax_normal_seam(TRAIN["batch_size"]):
        got = tm.train(vae_train_config=config.TrainConfig(**TRAIN),
                       em_train_config=config.TrainConfig(**EM_TRAIN))
    for g, w in zip(got, want):
        assert len(g) == TRAIN["epochs"]
        np.testing.assert_allclose(g, w, rtol=HIST_RTOL)
    assert set(tm.history) == {"vae", "emulator"}
    assert_weights(tm.vae.params, jm.vae.params)
    assert_weights(tm.em_params, jm.em_params)


def test_host_loop_device_loop_and_resume_bit_for_bit(splits, tmp_path):
    vae_cfg, em_cfg = config.TrainConfig(**TRAIN), config.TrainConfig(**EM_TRAIN)

    def model():
        return VAEEmulator(splits, config=config.VAEConfig(**ARCH), seed=6, device="cpu")

    runs = {}
    for name, kw in (("host", dict(checkpoint_dir=str(tmp_path), checkpoint_every=1)),
                     ("device", dict(device_loop=True))):
        m = model()
        runs[name] = (m, m.train(vae_train_config=vae_cfg, em_train_config=em_cfg, **kw))
    # what a run preempted inside stage A after its epoch 2 leaves, resumed
    (tmp_path / "stage_vae" / "ckpt_000002.npz").unlink()
    shutil.rmtree(tmp_path / "stage_em")
    resumed = model()
    runs["resumed"] = (resumed, resumed.train(vae_train_config=vae_cfg, em_train_config=em_cfg,
                                              checkpoint_dir=str(tmp_path), resume=True))
    host, want = runs["host"]
    for name in ("device", "resumed"):
        m, got = runs[name]
        assert got == want, name
        for a, b in zip(jax.tree_util.tree_leaves(m.params),
                        jax.tree_util.tree_leaves(host.params)):
            assert torch.equal(a, b), name
    assert sorted(p.name for p in tmp_path.iterdir()) == ["stage_em", "stage_vae"]
