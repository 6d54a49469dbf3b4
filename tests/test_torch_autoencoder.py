"""The port's autoencoder family (``tpu21cmvae_torch/models/autoencoder.py``)
against the JAX package's on a small net (451 → 24 → 5 → 16 → 24 → 451,
params → 16 → 16 → 5), both packages from the same NumPy weights.

Tolerances:
- predictions within 1e-5 of the amplitude, as for the shipped
  checkpoints (``tests/test_torch_families_pretrained.py``);
- training: both stages' epoch losses within 2e-6 relative of JAX's, the
  bound ``tests/test_torch_train.py`` holds the direct net's training to
  (the port measured ≤ 3.5e-7 there), with JAX's own permutations fed
  through the port's shuffle seam; the weights after both stages within
  1e-5 relative, 1e-6 absolute;
- host loop, device loop and a resumed run of the port: bit for bit.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from _torch_pair import jax_seam, one_torch_thread  # noqa: F401
from tpu21cmvae.models.autoencoder import AutoEncoderEmulator as JaxAE
from tpu21cmvae.utils import config as jconfig
from tpu21cmvae_torch.models.autoencoder import AutoEncoderEmulator
from tpu21cmvae_torch.ops.transforms import Normalizer
from tpu21cmvae_torch.utils import config

ARCH = dict(latent_dim=5, enc_hidden_dims=(24,), dec_hidden_dims=(16, 24), em_hidden_dims=(16, 16))
TRAIN = dict(epochs=3, batch_size=64, learning_rate=1e-3, early_stop_patience=None,
             plateau_patience=None)
HIST_RTOL, W_RTOL, W_ATOL = 2e-6, 1e-5, 1e-6


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_of(jm, splits) -> AutoEncoderEmulator:
    """The port's model with ``jm``'s weights and normalizer, on the CPU."""
    return AutoEncoderEmulator(
        splits, config=config.AutoEncoderConfig(**ARCH),
        normalizer=Normalizer.from_arrays(numpy_tree(jm.normalizer), device="cpu"),
        enc_params=numpy_tree(jm.autoencoder.enc_params),
        dec_params=numpy_tree(jm.autoencoder.dec_params),
        em_params=numpy_tree(jm.em_params), device="cpu",
    )


@pytest.fixture(scope="module")
def pair(splits):
    jm = JaxAE(splits, config=jconfig.AutoEncoderConfig(**ARCH), seed=2)
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
    assert dataclasses.asdict(config.AutoEncoderConfig()) == dataclasses.asdict(
        jconfig.AutoEncoderConfig())
    for name in ("AE_TRAIN_DEFAULT", "AE_EMULATOR_TRAIN_DEFAULT", "AE_TRAIN_STRONG",
                 "AE_EMULATOR_TRAIN_STRONG"):
        assert dataclasses.asdict(getattr(config, name)) == dataclasses.asdict(
            getattr(jconfig, name))
    assert_amp(tm.predict(splits.par_test[:16]), np.asarray(jm.predict(splits.par_test[:16])))
    assert_amp(tm.reconstruct(splits.signal_test[:16]),
               np.asarray(jm.reconstruct(splits.signal_test[:16])))
    assert tm.predict(splits.par_test[0]).shape == (451,)
    from tpu21cmvae.ops.mlp import count_params as jax_count_params
    from tpu21cmvae_torch.ops.mlp import count_params

    assert count_params(tm.params) == jax_count_params(jm.params) > 0
    np.testing.assert_allclose(tm.test_error(use_autoencoder=True),
                               jm.test_error(use_autoencoder=True), rtol=1e-4)


def test_checkpoints_both_ways(pair, splits, tmp_path):
    jm, tm = pair
    raw = splits.par_test[:8]
    back = JaxAE.from_checkpoint(tm.save(str(tmp_path / "port.npz")))
    assert_amp(np.asarray(back.predict(raw)), tm.predict(raw))
    mine = AutoEncoderEmulator.from_checkpoint(jm.save(str(tmp_path / "jax.npz")), device="cpu")
    np.testing.assert_array_equal(mine.predict(raw), tm.predict(raw))
    assert mine.config == tm.config
    np.testing.assert_array_equal(mine.redshifts, tm.redshifts)
    with pytest.raises(ValueError, match="DirectEmulator"):  # another family's is refused
        from tpu21cmvae_torch.models.direct import DirectEmulator

        path = DirectEmulator(splits, device="cpu").save(str(tmp_path / "direct.npz"))
        AutoEncoderEmulator.from_checkpoint(path, device="cpu")


def train_both(splits, seed=2):
    jm = JaxAE(splits, config=jconfig.AutoEncoderConfig(**ARCH), seed=seed)
    tm = port_of(jm, splits)
    j = jm.train(ae_train_config=jconfig.TrainConfig(**TRAIN),
                 em_train_config=jconfig.TrainConfig(**dict(TRAIN, learning_rate=1e-2)))
    with jax_seam():
        t = tm.train(ae_train_config=config.TrainConfig(**TRAIN),
                     em_train_config=config.TrainConfig(**dict(TRAIN, learning_rate=1e-2)))
    return jm, tm, j, t


def test_two_stage_training_follows_jax(splits):
    jm, tm, j, t = train_both(splits)
    for got, want in zip(t, j):
        assert len(got) == TRAIN["epochs"]
        np.testing.assert_allclose(got, want, rtol=HIST_RTOL)
    assert set(tm.history) == {"autoencoder", "emulator"}
    assert_weights(tm.autoencoder.params, jm.autoencoder.params)
    assert_weights(tm.em_params, jm.em_params)


def test_host_loop_device_loop_and_resume_bit_for_bit(splits, tmp_path):
    ae_cfg = config.TrainConfig(**TRAIN)
    em_cfg = config.TrainConfig(**dict(TRAIN, learning_rate=1e-2))
    def model():
        return AutoEncoderEmulator(splits, config=config.AutoEncoderConfig(**ARCH), seed=4,
                                   device="cpu")

    runs = {}
    for name, kw in (("host", dict(checkpoint_dir=str(tmp_path), checkpoint_every=1)),
                     ("device", dict(device_loop=True))):
        m = model()
        runs[name] = (m, m.train(ae_train_config=ae_cfg, em_train_config=em_cfg, **kw))
    # what a run preempted inside stage A after its epoch 2 leaves, resumed
    (tmp_path / "stage_ae" / "ckpt_000002.npz").unlink()
    shutil.rmtree(tmp_path / "stage_em")
    resumed = model()
    runs["resumed"] = (resumed, resumed.train(ae_train_config=ae_cfg, em_train_config=em_cfg,
                                              checkpoint_dir=str(tmp_path), resume=True))
    host, want = runs["host"]
    for name in ("device", "resumed"):
        m, got = runs[name]
        assert got == want, name
        for a, b in zip(jax.tree_util.tree_leaves(m.params),
                        jax.tree_util.tree_leaves(host.params)):
            assert torch.equal(a, b), name
    assert sorted(p.name for p in tmp_path.iterdir()) == ["stage_ae", "stage_em"]
    with pytest.raises(ValueError, match="host hooks"):
        host.train(ae_train_config=ae_cfg, device_loop=True, checkpoint_dir=str(tmp_path))


def test_family_entry_points_run(pair, splits):
    """The samplers, the fit, the evidence and the batched paths run over
    the family's autograd likelihood and give finite results of the right
    shapes."""
    _, tm = pair
    obs = tm.predict(splits.par_test[3]) + np.random.default_rng(1).normal(0, 5.0, 451)
    res = tm.sample_posterior(obs, 25.0, sampler="hmc", n_walkers=16, n_warmup=4, n_steps=6,
                              n_leapfrog=3, thin=2, seed=0)
    assert res.final.shape == (16, 7) and np.isfinite(res.logp).all()
    res = tm.sample_posterior(obs, 25.0, sampler="mh", n_walkers=32, n_warmup=10, n_steps=20,
                              thin=5, seed=0)
    assert np.isfinite(res.logp).all()
    fit = tm.fit_params(obs, 25.0, n_starts=16, n_steps=10, seed=0)
    assert np.isfinite(fit.best).all()
    lap = tm.log_evidence(obs, 25.0, method="laplace", n_starts=16, n_steps=20, n_is=256,
                          n_rounds=1, seed=0)
    assert np.isfinite(lap.logz)
    batch = tm.sample_posterior_batch(np.stack([obs, obs]), 25.0, n_walkers=16, n_warmup=4,
                                      n_steps=10, thin=5, seed=0)
    assert batch.n_obs == 2 and batch.result.final.shape == (32, 7)
    band = tm.posterior_predictive(res.flat[:32])
    assert band.bands.shape == (3, 451)
    gof = tm.goodness_of_fit(obs, 25.0, res)
    assert 0.0 <= gof.p_value <= 1.0
    mn = tm.marginalize_foreground(25.0, n_terms=3)
    with torch.no_grad():
        v = tm.loglik_fn(obs, mn)(tm.params, torch.as_tensor(res.flat[:8]))
    assert v.shape == (8,) and torch.isfinite(v).all()
    with pytest.raises(ValueError, match="sampler"):
        tm.sample_posterior(obs, 25.0, sampler="nope")
