"""The port's deep ensemble (``tpu21cmvae_torch/models/ensemble.py``): the
targets of the JAX suite's ``tests/test_ensemble.py``, and the kernel
backend's member-batched mixture (one wrapper over the stacked weights,
JAX's vmap over ``pallas_call``) against JAX's ``backend="xla"`` and
``"pallas"`` mixtures (the Pallas kernels in interpret mode).

The members are the JAX suite's ensemble (three 7→32→48→451 replicas, 8
epochs of ``DeepEnsemble.train``), carried into the port by their NumPy
weights.

Tolerances:
- the mixture against logsumexp of the members' own likelihoods: 1e-6
  relative (the same member functions, one logsumexp);
- kernel backend against JAX at the contract tier (fp32 on both sides,
  in other summation orders): values within 1e-5·(|logL| + c/2) + 1e-2
  (``chip_smoke.py``'s fp32 value bound; c/2 the gram form's cancellation
  scale, the largest member's), gradients at the test_loglik gradient
  tolerance (rtol 2e-3, atol 2e-3·max|g|);
- at bf16x3 (JAX's Pallas kernels split by hand; JAX's XLA path on the
  CPU computes fp32 whatever the tier, so it is not compared there):
  values within 1e-4·(|logL| + c/2) + 1e-2, the bf16x3 value bound, and
  the gradient under ``bench_mcmc.py``'s gate (q99.9 ≤ 1e-2, max ≤ 0.5).
  ``logsumexp`` is 1-Lipschitz in the max norm, so member bounds carry
  to the mixture value; the gradient also moves through the softmax
  weights, hence the gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import one_torch_thread  # noqa: F401
from tpu21cmvae.models.ensemble import DeepEnsemble as JaxEnsemble
from tpu21cmvae.ops.loglik import make_loglik as jax_make_loglik
from tpu21cmvae.ops.loglik import make_loglik_and_grad as jax_make_loglik_and_grad
from tpu21cmvae.utils.config import DirectEmulatorConfig as JaxConfig
from tpu21cmvae.utils.config import TrainConfig as JaxTrainConfig
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.models.ensemble import DeepEnsemble, MixtureLoglik, MixtureValGrad
from tpu21cmvae_torch.ops.loglik import per_row_grad
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig, TrainConfig
from tpu21cmvae_torch.utils.metrics import grad_gate_violation

HIDDEN = (32, 48)
NOISE_VAR = 25.0
VALUE_RTOL = {"contract": 1e-5, "high": 1e-4}


@pytest.fixture(scope="module")
def jens(splits):
    return JaxEnsemble.train(splits, n_members=3, config=JaxConfig(hidden_dims=HIDDEN),
                             train_config=JaxTrainConfig(epochs=8, early_stop_patience=None))


def port_of(jax_members, splits):
    cfg = DirectEmulatorConfig(hidden_dims=tuple(jax_members[0].config.hidden_dims))
    return DeepEnsemble([
        DirectEmulator.from_numpy(jax.tree_util.tree_map(np.asarray, m.params),
                                  jax.tree_util.tree_map(np.asarray, m.normalizer),
                                  config=cfg, device="cpu", data=splits)
        for m in jax_members
    ])


@pytest.fixture(scope="module")
def ens(jens, splits):
    return port_of(jens.members, splits)


@pytest.fixture(scope="module")
def obs(jens, splits):
    sig = jens.predict(splits.par_test[0])
    return np.asarray(sig + np.random.default_rng(7).normal(0, 5.0, sig.shape), np.float32)


def rows(splits, n):
    raw = np.asarray(splits.par_test[:n], np.float32).copy()
    raw[1, 2] = 0.0  # the fx == 0 clamp
    return raw


def half_c(ens, obs):
    """The largest member's gram cancellation scale c/2 (phase 6's)."""
    from tpu21cmvae_torch.ops.fold import gram_fold, noise_scale, obs_tensor

    cfg = ens.config
    scale = noise_scale(NOISE_VAR, cfg.n_bins, device="cpu")
    o = obs_tensor(obs, cfg.n_bins, device="cpu")
    return max(0.5 * abs(float(gram_fold(p, ens.normalizer, o, scale)[3]))
               for p in ens.member_params(ens.params))


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_mixture_loglik_is_logmeanexp(ens, splits, obs, backend):
    """The mixture is logsumexp of the members' own likelihoods − log M,
    on both backends (the kernel backend's plain versions here)."""
    x = torch.as_tensor(rows(splits, 9))
    kw = dict(method="direct", precision="highest")
    mix = ens.loglik_fn(obs, NOISE_VAR, backend=backend, **kw)
    assert isinstance(mix, MixtureLoglik)
    with torch.no_grad():
        got = mix(ens.params, x).numpy()
        member = np.stack([m.loglik_fn(obs, NOISE_VAR, backend=backend, **kw)(m.params, x)
                           .numpy() for m in ens.members])
    want = np.logaddexp.reduce(member.astype(np.float64), axis=0) - np.log(3)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_single_member_mixture_degenerates(splits, obs):
    m = DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=(32,)), device="cpu")
    one = DeepEnsemble([m])
    x = torch.as_tensor(rows(splits, 5))
    with torch.no_grad():
        got = one.loglik_fn(obs, NOISE_VAR, precision="highest")(one.params, x).numpy()
        want = m.loglik_fn(obs, NOISE_VAR, precision="highest")(m.params, x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_mixture_valgrad_matches_autodiff(ens, splits, obs):
    """The softmax-weighted member gradients equal autograd through the
    mixture value itself."""
    x = torch.as_tensor(rows(splits, 6))
    kw = dict(method="direct", precision="highest")
    vg = ens.loglik_and_grad_fn(obs, NOISE_VAR, grad_precision="highest", **kw)
    assert isinstance(vg, MixtureValGrad)
    val, grad = vg(ens.params, x)
    aval, agrad = per_row_grad(ens.loglik_fn(obs, NOISE_VAR, **kw))(ens.params, x)
    np.testing.assert_allclose(val.numpy(), aval.numpy(), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(grad.numpy(), agrad.numpy(), rtol=2e-3, atol=2e-3)


def test_mismatched_members_rejected(splits):
    from tpu21cmvae_torch.data.synthetic import synthetic_dataset

    cfg = DirectEmulatorConfig(hidden_dims=(32,))
    a = DirectEmulator(splits, config=cfg, device="cpu")
    with pytest.raises(ValueError, match="architecture"):
        DeepEnsemble([a, DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=(48,)),
                                        device="cpu")])
    with pytest.raises(ValueError, match="at least one"):
        DeepEnsemble([])
    other = synthetic_dataset(n_train=256, n_val=64, n_test=64, seed=99)
    with pytest.raises(ValueError, match="normalization constants"):
        DeepEnsemble([a, DirectEmulator(other, config=cfg, device="cpu")])


def test_checkpoint_round_trip_both_ways(jens, ens, splits, tmp_path):
    raw = splits.par_test[:4]
    ens.save(str(tmp_path / "port"))
    back = DeepEnsemble.load(str(tmp_path / "port"), splits, device="cpu")
    np.testing.assert_array_equal(back.predict(raw), ens.predict(raw))
    np.testing.assert_allclose(np.asarray(JaxEnsemble.load(str(tmp_path / "port")).predict(raw)),
                               ens.predict(raw), atol=1e-4)
    jens.save(str(tmp_path / "jax"))
    np.testing.assert_array_equal(
        DeepEnsemble.load(str(tmp_path / "jax"), device="cpu").predict(raw), ens.predict(raw))


def test_predict_fn_is_the_mean_and_members_match(ens, jens, splits):
    raw = np.asarray(splits.par_test[:4], np.float32)
    got = ens.predict_fn()(ens.params, torch.as_tensor(raw)).numpy()
    np.testing.assert_allclose(got, ens.predict(raw), atol=1e-5)
    stacked = ens.member_predictions(raw)
    assert stacked.shape == (3, 4, splits.n_bins)
    for i, m in enumerate(ens.members):
        np.testing.assert_allclose(stacked[i], m.predict(raw), atol=1e-5)
    np.testing.assert_allclose(stacked, np.asarray(jens.member_predictions(raw)), atol=1e-4)


def test_posterior_predictive_mixture_widens(ens, splits):
    samples = np.asarray(splits.par_test[:32], np.float32)
    band = ens.posterior_predictive(samples)
    member_bands = [m.posterior_predictive(samples) for m in ens.members]
    assert band.bands.shape == member_bands[0].bands.shape == (3, 451)
    mean_var = np.mean([b.std ** 2 for b in member_bands], axis=0)
    assert (band.std ** 2 >= mean_var - 1e-6).all() and np.isfinite(band.bands).all()


def test_parallel_training_matches_sequential(splits):
    """``train(parallel=True)`` (the stacked weights through
    ``fit_scan_stack``) gives every member the sequential run's history and
    weights, bit for bit."""
    cfg = DirectEmulatorConfig(hidden_dims=(16,))
    tc = TrainConfig(epochs=3, batch_size=128, early_stop_patience=None)
    seq = DeepEnsemble.train(splits, n_members=2, config=cfg, train_config=tc, seeds=[3, 11],
                             device="cpu")
    par = DeepEnsemble.train(splits, n_members=2, config=cfg, train_config=tc, seeds=[3, 11],
                             parallel=True, device="cpu")
    for mp, ms in zip(par.members, seq.members):
        assert mp.history.loss == ms.history.loss and mp.history.val_loss == ms.history.val_loss
        for lp, ls in zip(mp.params, ms.params):
            assert torch.equal(lp["w"], ls["w"]) and torch.equal(lp["b"], ls["b"])
    for a, b in zip(par.params, seq.params):
        assert torch.equal(a["w"], b["w"])
    with pytest.raises(ValueError, match="device_loop"):
        DeepEnsemble.train(splits, n_members=2, config=cfg, train_config=tc, parallel=True,
                           device_loop=False, device="cpu")


def jax_mixture(jens, obs, tier, backend, grad=False):
    """JAX's mixture as its ensemble builds it (a vmap of the member
    factory, logsumexp − log M), with the Pallas kernels' grid at 40 rows
    in interpret mode."""
    kw = dict(backend=backend, precision=tier, grad_precision=tier) if grad else dict(
        backend=backend, precision=tier)
    if backend == "pallas":
        kw.update(block_rows=40, interpret=True)
    make = jax_make_loglik_and_grad if grad else jax_make_loglik
    member = jax.vmap(make(jens.config, jens.normalizer, obs, NOISE_VAR, **kw), in_axes=(0, None))
    log_m = np.log(len(jens.members))

    def mix(raw):
        if not grad:
            return jax.scipy.special.logsumexp(member(jens.stacked_params, raw), axis=0) - log_m
        lm, gm = member(jens.stacked_params, raw)
        w = jax.nn.softmax(lm, axis=0)
        return (jax.scipy.special.logsumexp(lm, axis=0) - log_m,
                jnp.sum(w[..., None] * gm, axis=0))

    return mix


@pytest.mark.parametrize("tier,backend", [("contract", "xla"), ("contract", "pallas"),
                                          ("high", "pallas")])
def test_kernel_mixture_matches_jax(jens, ens, splits, obs, tier, backend):
    """The port's ``backend="kernel"`` mixture (K2, and K3 with its
    backward at the same tier, per member; their plain versions on the
    CPU) against JAX's mixture over its XLA path or its Pallas K2 and K3,
    on 37 rows."""
    raw = rows(splits, 37)
    x = torch.as_tensor(raw)
    jtier = "highest" if tier == "contract" else tier
    want = np.asarray(jax_mixture(jens, obs, jtier, backend)(jnp.asarray(raw)))
    jv, jg = (np.asarray(a) for a in jax_mixture(jens, obs, jtier, backend, grad=True)(
        jnp.asarray(raw)))
    with torch.no_grad():
        got = ens.loglik_fn(obs, NOISE_VAR, backend="kernel", precision=tier)(ens.params, x)
    tv, tg = ens.loglik_and_grad_fn(obs, NOISE_VAR, backend="kernel", precision=tier,
                                    grad_precision=tier)(ens.params, x)
    tol = VALUE_RTOL[tier] * (np.abs(want) + half_c(ens, obs)) + 1e-2
    assert (np.abs(got.numpy() - want) <= tol).all()
    assert (np.abs(tv.numpy() - jv) <= tol).all()
    if tier == "contract":
        np.testing.assert_allclose(tg.numpy(), jg, rtol=2e-3, atol=2e-3 * np.abs(jg).max())
    else:
        assert grad_gate_violation(tg.numpy(), jg) <= 0.0


def test_kernel_mixture_direct_matches_jax(jens, ens, splits, obs):
    """The port's direct-form kernel mixture at the contract tier (the
    member-batched K1 sumsq; its plain version on the CPU) against JAX's
    vmap of ``make_loglik(method="direct", backend="pallas")``, its K1
    in interpret mode, on 37 rows."""
    raw = rows(splits, 37)
    member = jax.vmap(jax_make_loglik(jens.config, jens.normalizer, obs, NOISE_VAR,
                                      backend="pallas", method="direct", precision="highest",
                                      block_rows=40, interpret=True), in_axes=(0, None))
    want = np.asarray(jax.scipy.special.logsumexp(member(jens.stacked_params, jnp.asarray(raw)),
                                                  axis=0) - np.log(len(jens.members)))
    with torch.no_grad():
        got = ens.loglik_fn(obs, NOISE_VAR, backend="kernel", method="direct",
                            precision="contract")(ens.params, torch.as_tensor(raw)).numpy()
    tol = VALUE_RTOL["contract"] * (np.abs(want) + half_c(ens, obs)) + 1e-2
    assert (np.abs(got - want) <= tol).all()


def kernel_wrapper(fn):
    """The kernel wrapper under a likelihood: through K1's and K2's
    autograd shells (``fused``) and K1's likelihood (``mlp``)."""
    for name in ("fused", "mlp"):
        if hasattr(fn, name):
            return kernel_wrapper(getattr(fn, name))
    return fn


def test_kernel_mixture_folds_once_per_member(ens, splits, obs):
    """The kernel backend's mixtures (K1 for the direct form, K2, K3) hold
    one member-batched wrapper over the stacked weights: across ten calls
    it folds once (every member in that one fold), an in-place update of
    the stacked weights refolds it, and on the CPU it launches nothing.
    The plain backend's mixture has no fold."""
    copy = DeepEnsemble(ens.members)
    x = torch.as_tensor(rows(splits, 16))
    fns = [copy.loglik_fn(obs, NOISE_VAR, backend="kernel", method="direct",
                          precision="contract"),
           copy.loglik_fn(obs, NOISE_VAR, backend="kernel"),
           copy.loglik_and_grad_fn(obs, NOISE_VAR, backend="kernel", grad_precision="default")]
    for fn in fns:
        assert kernel_wrapper(fn.members).members == 3
        with torch.no_grad():
            for _ in range(10):
                fn(copy.params, x)
        assert fn.folds == 1 and fn.launches == 0
        with torch.no_grad():
            copy.params[0]["b"].add_(0.0)  # bumps the version counter
            fn(copy.params, x)
        assert fn.folds == 2 and fn.launches == 0
    assert ens.loglik_fn(obs, NOISE_VAR).folds is None


def test_ensemble_sampling_fit_and_evidence(ens, obs):
    """MH and HMC chains, the fit and nested sampling run end to end on
    the mixture (the kernel backend's plain versions on the CPU)."""
    res = ens.sample_posterior(obs, NOISE_VAR, sampler="mh", n_walkers=32, n_steps=20,
                               n_warmup=10, thin=5, seed=0)
    assert res.final.shape == (32, 7) and np.isfinite(res.logp).all()
    res = ens.sample_posterior(obs, NOISE_VAR, sampler="hmc", n_walkers=16, n_steps=8,
                               n_warmup=4, n_leapfrog=3, thin=2, seed=0)
    assert res.final.shape == (16, 7) and np.isfinite(res.logp).all()
    fit = ens.fit_params(obs, NOISE_VAR, n_starts=32, n_steps=20, seed=0)
    assert fit.params.shape == (32, 7) and np.isfinite(fit.best).all()
    ev = ens.log_evidence(obs, NOISE_VAR, n_live=64, n_mh=8, max_iters=192, seed=0)
    assert np.isfinite(ev.logz)
    with pytest.raises(ValueError, match="sampler"):
        ens.sample_posterior(obs, NOISE_VAR, sampler="nope")
