"""The shipped checkpoints of the other families — the autoencoder
emulator, the VAE emulator and the three-member deep ensemble — loaded by
both packages and compared on the CPU, on the split they were trained on
(``synthetic_dataset(26888, 1704, 1704, seed=0)``), and the golden errors
of ``tests/test_pretrained.py`` held in the port at the same bounds.

Tolerances:
- predictions and reconstructions within 1e-5 of the signal amplitude
  (max |signal| of each row): both packages run the same fp32 products in
  other summation orders; measured 4e-7 (AE), 4e-7 (VAE);
- the likelihood on 256 prior draws within 1e-5 relative (+1e-2 nats):
  its value is −½‖r‖²/σ², whose rounding follows the predictions'
  (measured ≤ 2e-7 relative); its gradient (autograd against JAX's
  autodiff, both fp32) at the test_loglik gradient tolerance (rtol
  2e-3, atol 2e-3·max|g|).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import one_torch_thread  # noqa: F401
from tpu21cmvae.models import load_model as jax_load_model
from tpu21cmvae_torch.models import DeepEnsemble, load_model
from tpu21cmvae_torch.models.autoencoder import AutoEncoderEmulator
from tpu21cmvae_torch.models.vae import VAEEmulator
from tpu21cmvae_torch.ops.transforms import preproc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAINED = os.path.join(REPO, "pretrained")
PATHS = {"ae": os.path.join(PRETRAINED, "ae_synthetic.npz"),
         "vae": os.path.join(PRETRAINED, "vae_synthetic.npz"),
         "ensemble": os.path.join(PRETRAINED, "ensemble_direct")}
AMP_RTOL = 1e-5
LOGL_RTOL, LOGL_ATOL = 1e-5, 1e-2
NOISE_VAR = 25.0


@pytest.fixture(scope="module")
def refdata():
    from tpu21cmvae_torch.data.synthetic import synthetic_dataset

    return synthetic_dataset(n_train=26888, n_val=1704, n_test=1704, seed=0)


@pytest.fixture(scope="module")
def models(refdata):
    """``{family: (jax model, port model on the CPU)}``."""
    return {name: (jax_load_model(path, refdata), load_model(path, refdata, device="cpu"))
            for name, path in PATHS.items()}


@pytest.fixture(scope="module")
def draws():
    from tpu21cmvae_torch.data.synthetic import synthetic_params

    x = synthetic_params(256, np.random.default_rng(13)).astype(np.float32)
    x[3, 2] = 0.0  # the fx == 0 clamp
    return x


def obs_for(model, refdata):
    sig = np.asarray(model.predict(refdata.par_test[7]))
    return (sig + np.random.default_rng(3).normal(0.0, 5.0, sig.shape)).astype(np.float32)


def assert_amplitude_close(got, want):
    amp = np.abs(want).max(axis=-1, keepdims=True)
    assert float((np.abs(got - want) / amp).max()) <= AMP_RTOL


@pytest.mark.parametrize("family", ["ae", "vae", "ensemble"])
def test_predict_and_reconstruct_match_jax(models, refdata, family):
    jm, tm = models[family]
    raw = refdata.par_test[:64]
    assert_amplitude_close(tm.predict(raw), np.asarray(jm.predict(raw)))
    one = tm.predict(refdata.par_test[0])
    assert one.shape == (451,)
    if family == "ensemble":
        mean, std = tm.predict_with_uncertainty(raw[:8])
        jmean, jstd = jm.predict_with_uncertainty(raw[:8])
        assert_amplitude_close(mean, jmean)
        np.testing.assert_allclose(std, jstd, atol=AMP_RTOL * np.abs(jmean).max())
    else:
        sig = refdata.signal_test[:64]
        assert_amplitude_close(tm.reconstruct(sig), np.asarray(jm.reconstruct(sig)))


@pytest.mark.parametrize("family", ["ae", "vae"])
def test_loglik_and_gradient_match_jax(models, refdata, draws, family):
    jm, tm = models[family]
    obs = obs_for(jm, refdata)
    want = np.asarray(jm.loglik_fn(obs, NOISE_VAR)(jm.params, jnp.asarray(draws)))
    jv, jg = jm.loglik_and_grad_fn(obs, NOISE_VAR)(jm.params, jnp.asarray(draws))
    x = torch.as_tensor(draws)
    with torch.no_grad():
        got = tm.loglik_fn(obs, NOISE_VAR)(tm.params, x).numpy()
    tv, tg = tm.loglik_and_grad_fn(obs, NOISE_VAR)(tm.params, x)
    assert got.shape == (256,) and tg.shape == (256, 7) and not tv.requires_grad
    np.testing.assert_allclose(got, want, rtol=LOGL_RTOL, atol=LOGL_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=LOGL_RTOL, atol=LOGL_ATOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=2e-3,
                               atol=2e-3 * np.abs(np.asarray(jg)).max())
    assert tg[3, 2] == 0.0  # the fx == 0 slot, as JAX's clamp gives
    assert tm.loglik_fn(obs, NOISE_VAR) is tm.loglik_fn(obs.copy(), NOISE_VAR)  # memoized


def test_golden_ae(models):
    _, ae = models["ae"]
    err, rec = ae.test_error(), ae.test_error(use_autoencoder=True)
    assert err.mean() < 0.25  # trained to 0.180 %
    assert rec.mean() < 0.20  # reconstruction trained to 0.125 %


def test_golden_vae(models, refdata):
    _, vae = models["vae"]
    err = vae.test_error()
    assert err.mean() < 0.35 and np.median(err) < 0.35  # trained to 0.278 % / 0.244 %
    y_val = preproc(torch.as_tensor(np.asarray(refdata.signal_val, np.float32)), vae.normalizer)
    with torch.no_grad():
        mu = vae.vae.encode(vae.vae.params, y_val)[0].numpy()
    active = int((mu.var(axis=0) > 0.01).sum())
    assert 2 * active >= vae.config.latent_dim, f"{active}/{vae.config.latent_dim} active"
    curves = vae.latent_traversal(dim=0, values=np.linspace(-2, 2, 5))
    assert curves.shape == (5, 451) and np.isfinite(curves).all()


def test_golden_ensemble(models, refdata):
    _, ens = models["ensemble"]
    assert len(ens.members) == 3
    assert ens.test_error().mean() < 0.25  # trained to 0.150 %
    mean, std = ens.predict_with_uncertainty(refdata.par_test[:8])
    assert mean.shape == std.shape == (8, refdata.n_bins)
    assert np.isfinite(std).all() and std.max() > 0


def test_load_model_dispatches_on_kind_and_directory(models, tmp_path):
    kinds = {"ae": AutoEncoderEmulator, "vae": VAEEmulator, "ensemble": DeepEnsemble}
    for family, (_, tm) in models.items():
        assert type(tm) is kinds[family]
        assert tm.device == torch.device("cpu")
    direct = load_model(os.path.join(PRETRAINED, "direct_synthetic.npz"), device="cpu")
    assert type(direct).__name__ == "DirectEmulator"
    # a directory the port writes loads in both packages as an ensemble
    ens = models["ensemble"][1]
    paths = ens.save(str(tmp_path))
    assert [os.path.basename(p) for p in paths] == [f"member_{i:02d}.npz" for i in range(3)]
    back, jback = load_model(str(tmp_path), device="cpu"), jax_load_model(str(tmp_path))
    raw = np.asarray(ens.members[0].data.par_test[:4])
    np.testing.assert_array_equal(back.predict(raw), ens.predict(raw))
    assert_amplitude_close(np.asarray(jback.predict(raw)), ens.predict(raw))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        load_model(str(tmp_path / "empty"), device="cpu")
    with pytest.raises(TypeError):
        load_model(PATHS["ae"])  # no device: refused
