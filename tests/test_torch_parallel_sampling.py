"""The port's samplers, fits and estimators on a mesh of eight CPU
entries (the port of ``tests/test_parallel_sampling.py``).

The port splits only the likelihood's rows over the mesh; the chain's
state and its randoms stay on one device. So each sharded run must equal
the same run without a mesh bit for bit, and then meets the JAX suite's
moment and evidence checks on the same analytic Gaussian. A likelihood
must score each row alone: the JAX suite's per-block targets, which read
a row's position in the batch, are replaced here by row-wise ones with
the same block structure.
"""

import numpy as np
import pytest
import torch

from _torch_pair import make_pair, one_torch_thread  # noqa: F401

from tpu21cmvae_torch.nested import nested_sampling, nested_sampling_batch
from tpu21cmvae_torch.parallel import Mesh
from tpu21cmvae_torch.sampling.evidence import laplace_evidence, log_evidence
from tpu21cmvae_torch.sampling.fit import fit_map, profile_likelihood
from tpu21cmvae_torch.sampling.gradient import sample_chees, sample_hmc, sample_nuts
from tpu21cmvae_torch.sampling.mh import sample_ensemble, sample_mh
from tpu21cmvae_torch.sampling.pt import sample_pt
from tpu21cmvae_torch.sampling.smc import sample_smc

MU = np.array([0.3, -0.6, 1.2])
SIG = np.array([0.5, 0.25, 0.8])
BOUNDS = np.stack([MU - 10 * SIG, MU + 10 * SIG], axis=1)
# flat box prior: log Z of a NORMALIZED likelihood is -log(box volume)
LOGZ_BOX = float(-np.log(BOUNDS[:, 1] - BOUNDS[:, 0]).sum())
CPU8 = Mesh([torch.device("cpu")] * 8)
_MU, _SIG = torch.tensor(MU, dtype=torch.float32), torch.tensor(SIG, dtype=torch.float32)
_NORM = float(0.5 * np.log(2 * np.pi * SIG**2).sum())


def normalized_loglik(params, x):
    z = (x - _MU) / _SIG
    return -0.5 * torch.sum(z * z, dim=-1) - _NORM


def valgrad(params, x):
    z = (x - _MU) / _SIG
    return -0.5 * torch.sum(z * z, dim=-1), -(z / _SIG)


def _check_moments(flat, n_steps):
    assert np.allclose(flat.mean(0), MU, atol=5 * SIG / np.sqrt(n_steps))
    assert np.allclose(flat.std(0), SIG, rtol=0.12)


def _assert_same(a, b):
    """Every array and number of two results equal, bit for bit."""
    for k, v in vars(a).items():
        w = getattr(b, k)
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, w, err_msg=k)
        elif isinstance(v, (float, int, np.floating)):
            assert v == w or (np.isnan(v) and np.isnan(w)), (k, v, w)


def _both(run, *args, **kwargs):
    """``run`` without a mesh and on the eight-entry mesh: the sharded
    result, after holding it equal to the unsharded one."""
    plain = run(*args, **kwargs, device="cpu")
    sharded = run(*args, **kwargs, mesh=CPU8, device="cpu")
    _assert_same(plain, sharded)
    return sharded


def test_shard_rows_splits_calls_and_validates():
    """Each likelihood call is cut into eight chunks of the rows; a
    walker axis that does not divide raises JAX's error; per-observation
    blocks split alike."""
    from tpu21cmvae_torch.sampling._common import _shard_rows

    sizes = []

    def loglik(params, x):
        sizes.append(x.shape[0])
        return normalized_loglik(params, x)

    split = _shard_rows(loglik, CPU8, 64)
    x = torch.randn(64, 3)
    assert torch.equal(split(None, x), normalized_loglik(None, x)) and sizes == [8] * 8
    with pytest.raises(ValueError, match="divide evenly across the 8-device mesh"):
        _shard_rows(loglik, CPU8, 63)
    sizes.clear()
    mus = torch.tensor([[0.0, 0.0, 0.0], [5.0, 5.0, 5.0]])

    def two_obs(params, x):
        sizes.append(x.shape[0])
        z = x.reshape(2, -1, 3) - mus[:, None]
        return (-0.5 * (z * z).sum(-1)).reshape(-1)

    xs = torch.randn(2 * 16, 3)
    got = _shard_rows(two_obs, CPU8, 16, groups=2)(None, xs)
    assert torch.equal(got, two_obs(None, xs)) and sizes[:-1] == [4] * 8
    with pytest.raises(TypeError, match="Mesh"):
        _shard_rows(loglik, object(), 64)


def test_mh_sharded_moments():
    res = _both(sample_mh, normalized_loglik, None, n_walkers=256, n_steps=400, n_warmup=300,
                thin=5, bounds=BOUNDS, seed=0)
    _check_moments(res.flat, 400)


def test_stretch_sharded_moments():
    res = _both(sample_ensemble, normalized_loglik, None, n_walkers=256, n_steps=500,
                n_warmup=300, thin=5, bounds=BOUNDS, seed=1)
    _check_moments(res.flat, 500)


def test_hmc_sharded_moments():
    res = _both(sample_hmc, valgrad, None, n_walkers=256, n_steps=300, n_warmup=150,
                n_leapfrog=6, thin=5, bounds=BOUNDS, seed=2)
    _check_moments(res.flat, 300)


def test_chees_sharded_moments():
    res = _both(sample_chees, valgrad, None, n_walkers=256, n_steps=300, n_warmup=200,
                thin=5, bounds=BOUNDS, seed=2)
    _check_moments(res.flat, 300)
    assert res.trajectory_length > 0.2  # adapted above the 0.08 init


def test_nuts_sharded_moments():
    res = _both(sample_nuts, valgrad, None, n_walkers=256, n_steps=300, n_warmup=200,
                thin=5, bounds=BOUNDS, seed=2, max_depth=6)
    _check_moments(res.flat, 300)
    assert res.divergence_rate < 0.01
    assert res.ess().min() > 1000.0


def test_fit_map_and_profile_sharded():
    res = _both(fit_map, valgrad, None, n_starts=64, n_steps=200, bounds=BOUNDS, seed=3)
    np.testing.assert_allclose(res.best, MU, atol=0.02)
    prof = _both(profile_likelihood, valgrad, None, 0, np.linspace(-0.2, 0.8, 8), n_starts=16,
                 n_steps=150, bounds=BOUNDS, seed=4)
    assert abs(prof.grid[np.argmax(prof.logl)] - MU[0]) < 0.15
    with pytest.raises(ValueError, match="divide"):
        fit_map(valgrad, None, n_starts=60, bounds=BOUNDS, mesh=CPU8, device="cpu")


def test_ladder_evidence_sharded():
    res = _both(log_evidence, normalized_loglik, None, n_rungs=16, n_walkers=128, n_steps=400,
                n_warmup=200, bounds=BOUNDS, seed=0)
    assert abs(res.logz - LOGZ_BOX) < max(0.5, 4 * res.logz_err)
    # the rung axis must divide across the mesh
    with pytest.raises(ValueError, match="divide"):
        log_evidence(normalized_loglik, None, n_rungs=9, n_walkers=64, n_steps=10,
                     n_warmup=5, bounds=BOUNDS, mesh=CPU8, device="cpu")


def test_nested_evidence_sharded():
    res = _both(nested_sampling, normalized_loglik, None, n_live=512, n_mh=12, bounds=BOUNDS,
                seed=0)
    assert abs(res.logz - LOGZ_BOX) < max(0.3, 3 * res.logz_err)
    post = res.posterior(20000, seed=1)
    np.testing.assert_allclose(post.mean(0), MU, atol=0.1)
    with pytest.raises(ValueError, match="divide"):
        nested_sampling(normalized_loglik, None, n_live=100, n_batch=25, n_mh=2,
                        bounds=BOUNDS, mesh=CPU8, device="cpu")


def test_nested_batch_sharded_per_observation():
    """The stacked-observation likelihood sees each observation's live
    rows split alike; two observations' evidences are the unsharded
    ones."""
    mus = torch.tensor(np.stack([MU, MU + 0.5 * SIG]), dtype=torch.float32)

    def loglik_multi(params, x):
        z = (x.reshape(2, -1, 3) - mus[:, None, :]) / _SIG
        return (-0.5 * torch.sum(z * z, dim=-1)).reshape(-1) - _NORM

    kw = dict(bounds=BOUNDS, n_live=128, n_batch=16, n_mh=6, max_iters=512, seed=9)
    plain = nested_sampling_batch(loglik_multi, None, 2, device="cpu", **kw)
    sharded = nested_sampling_batch(loglik_multi, None, 2, mesh=CPU8, device="cpu", **kw)
    for a, b in zip(plain, sharded):
        _assert_same(a, b)
        assert abs(b.logz - LOGZ_BOX) < max(0.3, 4 * b.logz_err)


def test_pt_sharded_moments_and_swaps():
    res = _both(sample_pt, normalized_loglik, None, n_rungs=16, n_walkers=128, n_steps=400,
                n_warmup=200, thin=5, bounds=BOUNDS, seed=0)
    _check_moments(res.flat, 400)
    assert res.swap_rate.shape == (15,)
    with pytest.raises(ValueError, match="divide"):
        sample_pt(normalized_loglik, None, n_rungs=9, n_walkers=64, n_steps=10, n_warmup=5,
                  bounds=BOUNDS, mesh=CPU8, device="cpu")


def test_smc_sharded_evidence_and_moments():
    res = _both(sample_smc, normalized_loglik, None, n_particles=512, bounds=BOUNDS, seed=0)
    assert abs(res.logz - LOGZ_BOX) < max(0.3, 4 * res.logz_err)
    assert np.allclose(res.final.mean(0), MU, atol=6 * SIG / np.sqrt(512))
    assert np.allclose(res.final.std(0), SIG, rtol=0.15)
    assert res.betas[-1] == 1.0
    with pytest.raises(ValueError, match="n_particles/2 = 252"):
        sample_smc(normalized_loglik, None, n_particles=504, bounds=BOUNDS, mesh=CPU8,
                   device="cpu")


def test_laplace_evidence_sharded():
    res = _both(laplace_evidence, normalized_loglik, None, bounds=BOUNDS, n_starts=64,
                n_steps=300, seed=0)
    assert res.pd
    assert abs(res.logz - LOGZ_BOX) < 0.05


def test_mh_adapt_blocks_sharded():
    """Per-block adaptation on the mesh: two walker blocks whose targets
    differ 50× in width (row-wise: block 1 lives on the far side of the
    box) recover their own moments and adapted scales."""
    far = torch.tensor([10.0, 0.0, 0.0])

    def loglik(params, x):
        narrow = x[:, 0] > 8.0
        s = torch.where(narrow, 0.02, 1.0)[:, None]
        return -0.5 * torch.sum(((x - narrow[:, None] * far) / s) ** 2, -1)

    bounds = np.array([[-8.0, 8.0], [-8.0, 8.0], [-8.0, 8.0]])
    x0 = np.zeros((256, 3), np.float32)
    x0[128:, 0] = 10.0
    bounds[0, 1] = 12.0
    res = _both(sample_mh, loglik, None, n_walkers=256, adapt_blocks=2, n_steps=800,
                n_warmup=600, thin=5, bounds=bounds, seed=0, x0=x0)
    wide = res.chain[:, :128].reshape(-1, 3)
    narrow = res.chain[:, 128:].reshape(-1, 3)
    assert np.allclose(wide[:, 1:].std(0), 1.0, rtol=0.15)
    assert np.allclose(narrow.std(0), 0.02, rtol=0.15)
    assert res.block_step_sizes[0] > 8 * res.block_step_sizes[1]


def test_model_level_mesh_passthrough(splits):
    """The emulator's plain likelihood (its matmuls) through the model's
    ``sample_posterior``, ``fit_params`` and ``log_evidence`` on the mesh:
    the unsharded draws, fit and evidence."""
    _, tm = make_pair(splits, (16,))
    obs = tm.predict(splits.par_test[0])
    kw = dict(sampler="mh", n_walkers=64, n_steps=20, n_warmup=10, thin=5, seed=0)
    res = tm.sample_posterior(obs, 25.0, mesh=CPU8, **kw)
    assert res.final.shape == (64, 7) and np.isfinite(res.logp).all()
    _assert_same(tm.sample_posterior(obs, 25.0, **kw), res)
    ev_kw = dict(n_live=128, n_batch=16, n_mh=4, max_iters=64, seed=0)
    ev = tm.log_evidence(obs, 25.0, mesh=CPU8, **ev_kw)
    assert np.isfinite(ev.logz)
    _assert_same(tm.log_evidence(obs, 25.0, **ev_kw), ev)
    fit = tm.fit_params(obs, 25.0, n_starts=64, n_steps=30, seed=1, mesh=CPU8)
    _assert_same(tm.fit_params(obs, 25.0, n_starts=64, n_steps=30, seed=1), fit)


def test_kernel_wrappers_replicate_per_device(splits):
    """The routed likelihoods build one replica per mesh device, cached on
    the likelihood and keyed by the device (itself on its own device);
    the launch count sums over the distinct replicas."""
    from tpu21cmvae_torch.ops.kernels.fused_loglik import FusedLoglikGradGram
    from tpu21cmvae_torch.parallel.mesh import replica_of
    from tpu21cmvae_torch.sampling._common import MeshSplit

    _, tm = make_pair(splits, (16,))
    obs = tm.predict(splits.par_test[0])
    vg = tm.loglik_and_grad_fn(obs, 25.0, backend="kernel", precision="contract")
    assert isinstance(vg, FusedLoglikGradGram) and replica_of(vg, "cpu") is vg
    rep = vg.replica("meta")
    assert rep is not vg and rep.device.type == "meta" and rep.tier == vg.tier
    value = tm.loglik_fn(obs, 25.0, backend="kernel")
    assert value.replica("cpu") is value and value.replica("meta").fused.device.type == "meta"
    split = MeshSplit(vg, CPU8)
    x = torch.as_tensor(np.asarray(splits.par_test[:32], np.float32))
    v, g = split(tm.params, x)
    want_v, want_g = vg(tm.params, x)
    assert torch.equal(v, want_v) and torch.equal(g, want_g)
    assert split.launches == 0  # the CPU runs the plain version


def test_service_samples_fits_and_estimates_evidence_on_a_mesh(splits):
    """``EmulatorService`` on a mesh of two CPU entries passes it to
    ``/sample``, ``/fit`` and ``/evidence``: the answers of the service on
    the model's one device."""
    from tpu21cmvae_torch.serve import EmulatorService

    _, tm = make_pair(splits, (16,))
    obs = tm.predict(splits.par_test[0])
    one, two = EmulatorService(tm), EmulatorService(tm, mesh=Mesh(["cpu", "cpu"]))
    assert two.health()["devices"] == ["cpu", "cpu"]
    for name, kw in (("sample", dict(n_walkers=64, n_steps=20, n_warmup=10, thin=5)),
                     ("fit", dict(n_starts=64, n_steps=30, top=4)),
                     ("evidence", dict(method="laplace", n_starts=64, n_steps=40)),
                     ("evidence", dict(method="nested", n_live=128, n_mh=4))):
        assert getattr(two, name)(obs, 25.0, **kw) == getattr(one, name)(obs, 25.0, **kw), name


def test_batched_posteriors_and_evidence_on_a_mesh(splits):
    """The stacked-observation paths (``sample_posterior_batch`` and
    ``log_evidence_batch``): each observation's rows split alike over the
    mesh, the unsharded results bit for bit; the stacked walker axis
    must divide the mesh."""
    _, tm = make_pair(splits, (16,))
    obs = np.stack([tm.predict(splits.par_test[i]) for i in range(2)])
    for sampler in ("mh", "hmc"):
        kw = dict(sampler=sampler, n_walkers=32, n_steps=10, n_warmup=10, thin=5, seed=0)
        a = tm.sample_posterior_batch(obs, 25.0, **kw)
        b = tm.sample_posterior_batch(obs, 25.0, mesh=CPU8, **kw)
        _assert_same(a.result, b.result)
    with pytest.raises(ValueError, match="divide"):
        tm.sample_posterior_batch(obs, 25.0, n_walkers=30, mesh=CPU8)
    kw = dict(method="laplace", n_starts=64, n_steps=40, n_is=256)
    for a, b in zip(tm.log_evidence_batch(obs, 25.0, **kw),
                    tm.log_evidence_batch(obs, 25.0, mesh=CPU8, **kw)):
        assert a.logz == b.logz and a.khat == b.khat


def _meta_cases():
    """Every likelihood a sampler on a mesh may replicate: name and a
    builder ``(tm, ae, ens, obs, obs_batch) → fn``."""
    from tpu21cmvae_torch.foregrounds import foreground_basis, marginalize_foreground
    from tpu21cmvae_torch.noisescale import ScaleMarginalNoise
    from tpu21cmvae_torch.ops.loglik import (
        make_loglik_and_grad_multi,
        make_loglik_multi,
        per_row_grad,
    )

    def fg(tm):
        return marginalize_foreground(foreground_basis(tm.frequencies, 3), 25.0,
                                      n_bins=int(tm.frequencies.shape[0]))

    return {
        "direct_gram": lambda tm, ae, ens, o, ob: tm.loglik_fn(o, 25.0, method="gram"),
        "direct_direct": lambda tm, ae, ens, o, ob: tm.loglik_fn(o, 25.0, method="direct"),
        "direct_scale": lambda tm, ae, ens, o, ob: tm.loglik_fn(
            o, ScaleMarginalNoise(25.0)),
        "direct_foreground": lambda tm, ae, ens, o, ob: tm.loglik_fn(o, fg(tm)),
        "valgrad_analytic": lambda tm, ae, ens, o, ob: tm.loglik_and_grad_fn(o, 25.0),
        "valgrad_autodiff": lambda tm, ae, ens, o, ob: tm.loglik_and_grad_fn(
            o, 25.0, method="direct"),
        "multi_gram": lambda tm, ae, ens, o, ob: make_loglik_multi(
            tm.config, tm.normalizer, ob, 25.0),
        "multi_direct": lambda tm, ae, ens, o, ob: make_loglik_multi(
            tm.config, tm.normalizer, ob, 25.0, method="direct"),
        "multi_valgrad": lambda tm, ae, ens, o, ob: make_loglik_and_grad_multi(
            tm.config, tm.normalizer, ob, 25.0),
        "multi_per_row_grad": lambda tm, ae, ens, o, ob: per_row_grad(
            make_loglik_multi(tm.config, tm.normalizer, ob, 25.0), device=tm.device),
        "ae_loglik": lambda tm, ae, ens, o, ob: ae.loglik_fn(o, 25.0),
        "ae_valgrad": lambda tm, ae, ens, o, ob: ae.loglik_and_grad_fn(o, 25.0),
        "ae_multi": lambda tm, ae, ens, o, ob: ae.loglik_multi_fn(ob, 25.0),
        "ensemble_mixture": lambda tm, ae, ens, o, ob: ens.loglik_fn(o, 25.0),
        "ensemble_multi": lambda tm, ae, ens, o, ob: ens.loglik_multi_fn(ob, 25.0),
    }


@pytest.mark.parametrize("case", sorted(_meta_cases()))
def test_likelihood_replicas_run_on_their_device(splits, case):
    """Each likelihood's replica on another device (``meta`` here: shapes,
    no data) runs there: rows and weights on that device give outputs
    on it, so no tensor it closes over stayed on the CPU (an elementwise
    op between a ``meta`` and a CPU tensor raises). On its own device a
    likelihood is its own replica."""
    from tpu21cmvae_torch.models.autoencoder import AutoEncoderEmulator
    from tpu21cmvae_torch.models.ensemble import DeepEnsemble
    from tpu21cmvae_torch.parallel.mesh import replica_of, tree_to
    from tpu21cmvae_torch.utils.config import AutoEncoderConfig

    _, tm = make_pair(splits, (16,))
    cfg = AutoEncoderConfig(latent_dim=3, enc_hidden_dims=(8,), dec_hidden_dims=(8,),
                            em_hidden_dims=(8,))
    ae = AutoEncoderEmulator(splits, config=cfg, seed=5, device="cpu")
    ens = DeepEnsemble([tm, tm])
    obs = tm.predict(splits.par_test[0])
    obs_batch = np.stack([obs, tm.predict(splits.par_test[1])])
    fn = _meta_cases()[case](tm, ae, ens, obs, obs_batch)
    model = ae if case.startswith("ae") else ens if case.startswith("ensemble") else tm
    assert replica_of(fn, "cpu") is fn
    rep = replica_of(fn, "meta")
    assert rep is not fn and replica_of(fn, "meta") is rep
    meta = torch.device("meta")
    out = rep(tree_to(model.params, meta), torch.empty((4, 7), device=meta))
    for o, tail in zip(out if isinstance(out, tuple) else (out,), ((), (7,))):
        assert o.device == meta and o.shape == (4, *tail)
