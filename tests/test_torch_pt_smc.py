"""The port's parallel tempering (``sampling/pt.py``) and adaptive
tempered SMC (``sampling/smc.py``) against the JAX package's.

Tolerances: one step's states to rtol 1e-5 from the same inputs and the
same randoms (the randoms are the ones the JAX step draws from its key,
read back and handed to the port's step), with every accept/reject,
swap and resampling decision equal; the JAX functions themselves are
called, reached through the closures of their program builders. The
analytic targets at the JAX suite's own assertions and sizes
(``tests/test_smc.py``, ``tests/test_sampling.py``). JAX's threefry and
torch's Philox never give the same bits, so whole runs agree in
distribution, not draw by draw.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import make_pair, one_torch_thread, train_box  # noqa: F401
from tpu21cmvae.sampling import pt as jpt
from tpu21cmvae.sampling import smc as jsmc
from tpu21cmvae.sampling._common import _resolve_log_prior as jax_log_prior
from tpu21cmvae_torch.sampling import pt as tpt
from tpu21cmvae_torch.sampling import smc as tsmc
from tpu21cmvae_torch.sampling.results import PTSampleResult
from tpu21cmvae_torch.sampling.smc import SMCResult

MU = np.array([0.5, -0.3, 0.1], np.float32)
SIG = np.array([0.3, 0.1, 0.6], np.float32)
BOUNDS = np.stack([MU - 6 * SIG, MU + 6 * SIG], axis=1).astype(np.float32)
LOGZ_BOX = float(-np.log(BOUNDS[:, 1] - BOUNDS[:, 0]).sum())
NORM = float(0.5 * np.log(2 * np.pi * SIG.astype(np.float64) ** 2).sum())


def _jax_ll(params, x):
    z = (jnp.asarray(x) - MU) / SIG
    return -0.5 * jnp.sum(z * z, axis=-1) - NORM


def _torch_ll(params, x):
    z = (x - torch.as_tensor(MU)) / torch.as_tensor(SIG)
    return -0.5 * torch.sum(z * z, dim=-1) - NORM


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(mine, theirs):
    mine = mine.numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    theirs = np.asarray(theirs)
    fin = np.isfinite(theirs)
    assert (np.isfinite(mine) == fin).all()
    np.testing.assert_allclose(mine[fin], theirs[fin], rtol=1e-5, atol=1e-6)


def _box():
    lo, hi = BOUNDS[:, 0], BOUNDS[:, 1]
    return (jnp.asarray(lo), jnp.asarray(hi)), (torch.as_tensor(lo), torch.as_tensor(hi))


def _ladder_state(n_rungs, n_walkers, seed):
    """Walkers around the mode (a few outside the box, so their rows are
    scored at the midpoint and rejected) with their logL and log π."""
    rng = np.random.default_rng(seed)
    x = (MU + 2.0 * SIG * rng.normal(size=(n_rungs, n_walkers, 3))).astype(np.float32)
    x[1, 0] = BOUNDS[:, 1] + 0.1  # outside the box
    lo, hi = BOUNDS[:, 0], BOUNDS[:, 1]
    inside = ((x >= lo) & (x <= hi)).all(-1)
    ll = np.where(inside, np.asarray(_jax_ll(None, x.reshape(-1, 3))).reshape(inside.shape),
                  -np.inf).astype(np.float32)
    return x, ll, np.zeros_like(ll)


# -- parallel tempering --------------------------------------------------------


def _pt_jax_kernel(n_rungs, n_walkers, n_sw):
    (jlo, jhi), _ = _box()
    _, sweep, swap_phase = jpt._pt_kernel(_jax_ll, jax_log_prior(None), jlo, jhi, n_rungs,
                                          n_walkers, 2.0, n_sw)
    return jax.jit(sweep), jax.jit(swap_phase)


def _pt_sweep_draws(k, n_rungs, half):
    """The randoms JAX's ``sweep`` draws from ``k``, as the port's
    ``pt_sweep`` takes them."""
    out = []
    for kk in jax.random.split(k):
        kz, kj, ku, kp = jax.random.split(kk, 4)
        out.append((
            _t(jax.random.uniform(kz, (n_rungs, half), jnp.float32)),
            _t(jax.random.randint(kj, (n_rungs, half), 0, half), torch.long),
            _t(jax.random.uniform(kp, (half, 3))),
            _t(jnp.log(jax.random.uniform(ku, (n_rungs, half)))),
        ))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_one_pt_sweep_with_injected_randoms_matches_jax(seed):
    """A tempered red-black sweep of every rung (rung 0 refreshed by
    independence draws from the box, no stretch term), states and
    per-rung acceptance to rtol 1e-5, every decision equal."""
    n_rungs, n_walkers = 5, 16
    jsweep, _ = _pt_jax_kernel(n_rungs, n_walkers, 2)
    x, ll, lpr = _ladder_state(n_rungs, n_walkers, seed)
    betas = np.asarray(jpt._geometric_ladder(n_rungs, 1e-3), np.float32)
    k = jax.random.key(100 + seed)
    jx, jll, jlpr, jacc = jsweep(None, jnp.asarray(x), jnp.asarray(ll), jnp.asarray(lpr),
                                 jnp.asarray(betas), k)
    (_, _), (tlo, thi) = _box()
    eval_ll = tpt.box_eval(_torch_ll, lambda v: torch.zeros(v.shape[0]), tlo, thi)
    tx, tll, tlpr, tacc = tpt.pt_sweep(eval_ll, None, _t(x), _t(ll), _t(lpr), _t(betas), 2.0,
                                       tlo, thi, _pt_sweep_draws(k, n_rungs, n_walkers // 2))
    moved = (np.asarray(jx) != x).any(-1)
    assert moved[0].all()  # the independence rung accepts every in-box draw
    assert 0 < moved.mean() < 1
    np.testing.assert_array_equal((tx.numpy() != x).any(-1), moved)
    _close(tx, jx)
    _close(tll, jll)
    _close(tlpr, jlpr)
    _close(tacc, jacc)


def test_one_pt_swap_phase_with_injected_randoms_matches_jax():
    """A replica-exchange phase (alternating edges, starting at an odd
    parity) moves the same walkers between the same rungs and reports the
    same per-edge rates."""
    n_rungs, n_walkers, n_sw = 6, 32, 4
    _, jswap = _pt_jax_kernel(n_rungs, n_walkers, n_sw)
    x, ll, lpr = _ladder_state(n_rungs, n_walkers, 3)
    ll = np.where(np.isfinite(ll), ll, -50.0).astype(np.float32)
    lpr = np.random.default_rng(4).normal(size=ll.shape).astype(np.float32)
    betas = np.asarray(jpt._geometric_ladder(n_rungs, 0.05), np.float32)
    k = jax.random.key(7)
    jx, jll, jlpr, jrate = jswap(jnp.asarray(x), jnp.asarray(ll), jnp.asarray(lpr),
                                 jnp.asarray(betas), jnp.float32(1.0), k)
    log_us = torch.stack([_t(jnp.log(jax.random.uniform(kk, (n_rungs - 1, n_walkers))))
                          for kk in jax.random.split(k, n_sw)])
    tx, tll, tlpr, trate = tpt.pt_swap_phase(_t(x), _t(ll), _t(lpr), _t(betas), 1, log_us)
    assert 0.0 < float(np.asarray(jrate).mean()) < 1.0
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tll.numpy(), np.asarray(jll))
    np.testing.assert_array_equal(tlpr.numpy(), np.asarray(jlpr))
    _close(trate, jrate)


@pytest.mark.parametrize("n_rungs,beta_min", [(2, 1e-6), (3, 1e-3), (32, 1e-6)])
def test_geometric_ladder_and_sizes_match_jax(n_rungs, beta_min):
    """``_geometric_ladder`` bit for bit in float64; the size checks and
    the swap-sweep count as JAX's."""
    assert (tpt._geometric_ladder(n_rungs, beta_min).tobytes()
            == jpt._geometric_ladder(n_rungs, beta_min).tobytes())
    for sweeps in (None, 1, 5, 100):
        assert tpt._pt_swap_sweeps(sweeps, n_rungs) == jpt._pt_swap_sweeps(sweeps, n_rungs)
    for bad in ((1, 16, 3, 2.0), (4, 15, 3, 2.0), (4, 6, 3, 2.0), (4, 16, 3, 1.0)):
        with pytest.raises(ValueError) as mine:
            tpt._pt_sizes_check(*bad)
        with pytest.raises(ValueError) as theirs:
            jpt._pt_sizes_check(*bad)
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="beta_min"):
        tpt._geometric_ladder(4, 1.0)


def _bimodal_torch(params, x):
    x = x[..., 0]
    la = np.log(0.8) - 0.5 * ((x + 3.0) / 0.1) ** 2
    lb = np.log(0.2) - 0.5 * ((x - 3.0) / 0.1) ** 2
    return torch.logaddexp(la, lb)


def test_pt_recovers_mode_weights_where_mh_cannot():
    """``tests/test_sampling.py::test_pt_recovers_mode_weights_where_mh_cannot``:
    on the 80/20 two-Gaussian target MH stays frozen at the 50/50 of its
    uniform start while PT's cold chain recovers the split, with exact
    within-mode moments and every ladder edge exchanging."""
    from tpu21cmvae_torch.sampling.mh import sample_mh

    common = dict(n_walkers=512, n_steps=600, n_warmup=400, thin=10,
                  bounds=np.array([[-6.0, 6.0]]), seed=0, device="cpu")
    mh = sample_mh(_bimodal_torch, None, **common)
    assert abs(float((mh.flat[:, 0] < 0).mean()) - 0.5) < 0.1
    pt = tpt.sample_pt(_bimodal_torch, None, n_rungs=16, **common)
    assert isinstance(pt, PTSampleResult)
    frac = float((pt.flat[:, 0] < 0).mean())
    assert abs(frac - 0.8) < 0.05, frac
    in_a = pt.flat[pt.flat[:, 0] < 0, 0]
    assert abs(in_a.mean() + 3.0) < 0.02
    assert abs(in_a.std() - 0.1) < 0.02
    assert pt.betas.shape == (16,) and pt.betas[-1] == 1.0
    assert pt.swap_rate.shape == (15,)
    assert pt.swap_rate.min() > 0.05


def test_pt_ladder_adaptation_and_warm_start():
    """``adapt_ladder=True`` keeps the endpoints pinned at 0 and exactly
    1 and the ladder increasing; ``x0`` seeds every rung, refusing a
    wrong shape; the mesh is refused."""
    res = tpt.sample_pt(_torch_ll, None, n_rungs=6, n_walkers=16, n_steps=20, n_warmup=60,
                        bounds=BOUNDS, adapt_ladder=True, thin=5, seed=1, device="cpu")
    assert res.betas[0] == 0.0 and res.betas[-1] == 1.0
    assert (np.diff(res.betas) > 0).all()
    assert not np.allclose(res.betas, tpt._geometric_ladder(6, 1e-6))
    assert res.chain.shape == (4, 16, 3) and res.accept_rate.shape == (20,)
    x0 = np.tile(MU, (16, 1))
    warm = tpt.sample_pt(_torch_ll, None, n_rungs=4, n_walkers=16, n_steps=10, n_warmup=0,
                         bounds=BOUNDS, thin=0, x0=x0, seed=0, device="cpu")
    assert warm.chain.shape == (0, 16, 3) and np.isfinite(warm.logp).all()
    with pytest.raises(ValueError, match="x0 must have shape"):
        tpt.sample_pt(_torch_ll, None, n_rungs=4, n_walkers=16, bounds=BOUNDS, x0=x0[:8],
                      device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        tpt.sample_pt(_torch_ll, None, bounds=BOUNDS, mesh=object(), device="cpu")


# -- SMC -------------------------------------------------------------------------


def _smc_jax_stage(n_particles, n_mh=2, tef=0.5):
    """JAX's stage functions (``pick_delta``, ``resample``, ``mutate``),
    read from the closure of its SMC program."""
    (jlo, jhi), _ = _box()
    cfg = jsmc._SMCProgram(n_particles=n_particles, n_mh=n_mh, a=2.0, target_ess_frac=tef,
                           max_stages=8)
    run = jsmc._build_smc_program(_jax_ll, None, jlo, jhi, cfg)
    return inspect.getclosurevars(run.__wrapped__).nonlocals


def _population(m, seed, spread=3.0):
    rng = np.random.default_rng(seed)
    x = (MU + spread * SIG * rng.normal(size=(2, m, 3))).astype(np.float32)
    x = np.clip(x, BOUNDS[:, 0], BOUNDS[:, 1])
    ll = np.asarray(_jax_ll(None, x.reshape(-1, 3))).reshape(2, m).astype(np.float32)
    return x, ll, np.zeros_like(ll)


@pytest.mark.parametrize("beta", [0.0, 0.3, 0.9999])
def test_pick_delta_matches_jax(beta):
    """The 32-step bisection for the largest δβ whose incremental weights
    keep the pooled ESS fraction at its target, and the full step where
    it already does, to rtol 1e-5; the ESS fraction itself too."""
    stage = _smc_jax_stage(256)
    _, ll, _ = _population(128, 11, spread=6.0)
    ll = ll * 40.0  # a sharp likelihood: the full step fails at small β
    d_jax, full = stage["pick_delta"](jnp.asarray(ll), jnp.float32(beta))
    d = tsmc.pick_delta(_t(ll), torch.tensor(beta, dtype=torch.float32), 0.5)
    _close(d, d_jax)
    assert bool(full) == (beta == 0.9999)
    _close(tsmc.ess_frac(_t(ll), d), stage["ess_frac"](jnp.asarray(ll), d_jax))


def test_one_systematic_resample_matches_jax():
    """Systematic resampling within each sub-population (left-side
    searches, as ``jnp.searchsorted``) picks the same ancestors."""
    stage = _smc_jax_stage(256)
    x, ll, lpr = _population(128, 12)
    lpr = np.random.default_rng(2).normal(size=ll.shape).astype(np.float32)
    logw = 0.7 * ll
    k = jax.random.key(5)
    jx, jll, jlpr = stage["resample"](jnp.asarray(x), jnp.asarray(ll), jnp.asarray(lpr),
                                      jnp.asarray(logw), k)
    u = _t(jax.random.uniform(k, (2, 1)))
    tx, tll, tlpr = tsmc.resample(_t(x), _t(ll), _t(lpr), _t(logw), u)
    assert len(np.unique(np.asarray(jll))) < ll.size  # duplicates: a real resample
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tll.numpy(), np.asarray(jll))
    np.testing.assert_array_equal(tlpr.numpy(), np.asarray(jlpr))


def _mutation_draws(k, m):
    """``draws(i)``: the randoms JAX's ``mutate`` draws on sweep ``i``."""
    half = m // 2

    def stretch(kk):
        kz, kj, ku = jax.random.split(kk, 3)
        return (_t(jax.random.uniform(kz, (2, half), jnp.float32)),
                _t(jax.random.randint(kj, (2, half), 0, half), torch.long),
                _t(jnp.log(jax.random.uniform(ku, (2, half)))))

    def draws(i):
        ka, kb, ki = jax.random.split(jax.random.fold_in(k, i), 3)
        kz, ku = jax.random.split(ki)
        return stretch(ka), stretch(kb), (
            _t(jax.random.normal(kz, (2, m, 3), jnp.float32)),
            _t(jnp.log(jax.random.uniform(ku, (2, m)))))

    return draws


@pytest.mark.parametrize("beta", [0.2, 1.0])
def test_one_mutate_with_injected_randoms_matches_jax(beta):
    """One mutation (stretch half-moves and the independence move from
    the frozen moment-matched Gaussian, at least ``n_mh`` sweeps, then
    until 95 % of the particles are refreshed): the same sweep count,
    states to rtol 1e-5 and the mean stretch acceptance."""
    n_mh, m = 2, 64
    stage = _smc_jax_stage(2 * m, n_mh=n_mh)
    x, ll, lpr = _population(m, 13, spread=1.5)
    k = jax.random.key(21)
    jx, jll, jlpr, jr = stage["mutate"](None, jnp.asarray(x), jnp.asarray(ll), jnp.asarray(lpr),
                                        jnp.float32(beta), k)
    (_, _), (tlo, thi) = _box()
    eval_ll = tsmc.smc_eval(_torch_ll, lambda v: torch.zeros(v.shape[0]), tlo, thi)
    calls = []
    draws = _mutation_draws(k, m)

    def counted(i):
        calls.append(i)
        return draws(i)

    tx, tll, tlpr, tr = tsmc.mutate(eval_ll, None, _t(x), _t(ll), _t(lpr),
                                    torch.tensor(beta), 2.0, n_mh, counted)
    assert len(calls) > n_mh  # the refresh criterion extended the sweeps
    moved = (np.asarray(jx) != x).any(-1)
    assert 0 < moved.mean()
    np.testing.assert_array_equal((tx.numpy() != x).any(-1), moved)
    _close(tx, jx)
    _close(tll, jll)
    _close(tlpr, jlpr)
    _close(tr, jr)


def test_smc_gaussian_evidence_and_moments():
    """``tests/test_smc.py::test_smc_gaussian_evidence_and_moments``: on
    a normalized Gaussian likelihood log Z is −log(box volume), the β=1
    population carries the posterior moments, the schedule rises
    strictly from 0 to exactly 1, and a second seed agrees."""
    res = tsmc.sample_smc(_torch_ll, None, n_particles=2048, bounds=BOUNDS, seed=0,
                          device="cpu")
    assert isinstance(res, SMCResult)
    assert abs(res.logz - LOGZ_BOX) < 0.2
    assert abs(res.logz - LOGZ_BOX) < max(0.15, 4 * res.logz_err)
    assert np.allclose(res.final.mean(0), MU, atol=0.05)
    assert np.allclose(res.final.std(0), SIG, rtol=0.12)
    assert res.flat is res.final
    assert np.isfinite(res.logp).all()
    assert res.betas[0] == 0.0 and res.betas[-1] == 1.0
    assert (np.diff(res.betas) > 0).all()
    assert res.n_stages == len(res.betas) - 1
    assert (res.stage_ess > 0.2).all()
    assert (res.accept_rate > 0.2).all()
    res2 = tsmc.sample_smc(_torch_ll, None, n_particles=2048, bounds=BOUNDS, seed=3,
                           device="cpu")
    assert abs(res2.logz - res.logz) < 0.5


def test_smc_recovers_mode_weights_and_bimodal_evidence():
    """``tests/test_smc.py::test_smc_recovers_mode_weights_and_bimodal_evidence``:
    the 80/20 split, the dominant mode's moments and log(σ√(2π)/V)."""
    res = tsmc.sample_smc(_bimodal_torch, None, n_particles=4096,
                          bounds=np.array([[-6.0, 6.0]], np.float32), seed=0, device="cpu")
    frac = float((res.final[:, 0] < 0).mean())
    assert abs(frac - 0.8) < 0.05, frac
    in_a = res.final[res.final[:, 0] < 0, 0]
    assert abs(in_a.mean() + 3.0) < 0.02
    assert abs(in_a.std() - 0.1) < 0.02
    logz_true = float(np.log(0.1 * np.sqrt(2 * np.pi) / 12.0))
    assert abs(res.logz - logz_true) < max(0.2, 4 * res.logz_err)


def test_smc_prior_conversion_and_validation():
    """Under a ``log_prior`` the box population is first converted to the
    prior (β=0), so log Z is the evidence under the box-normalized prior:
    a Gaussian prior N(μ, σ) on the normalized Gaussian likelihood gives
    log ∫ N(x; μ, σ) N(x; μ, σ) dx per axis (the box cuts 6σ, negligibly).
    ``tests/test_smc.py::test_smc_validation_and_truncation``'s refusals."""
    from tpu21cmvae_torch.priors import GaussianBoxPrior

    prior = GaussianBoxPrior.for_params({i: (float(MU[i]), float(SIG[i])) for i in range(3)},
                                        n_params=3, bounds=BOUNDS)
    res = tsmc.sample_smc(_torch_ll, None, n_particles=2048, bounds=BOUNDS, seed=0,
                          log_prior=prior.log_prior, device="cpu")
    want = float(-np.log(2.0 * np.sqrt(np.pi) * SIG.astype(np.float64)).sum())
    assert abs(res.logz - want) < max(0.2, 4 * res.logz_err), (res.logz, want)
    assert np.allclose(res.final.std(0), SIG / np.sqrt(2.0), rtol=0.15)
    for kw, match in ((dict(n_particles=130), "divisible by 4"), (dict(n_particles=8), "span"),
                      (dict(target_ess_frac=1.5), "target_ess_frac"),
                      (dict(max_stages=1), "max_stages"), (dict(a=0.5), "stretch scale")):
        with pytest.raises(ValueError, match=match):
            tsmc.sample_smc(_torch_ll, None, bounds=BOUNDS, device="cpu", **kw)
    with pytest.raises(RuntimeError, match="truncated"):
        tsmc.sample_smc(_torch_ll, None, n_particles=512, bounds=BOUNDS, max_stages=2,
                        target_ess_frac=0.99, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        tsmc.sample_smc(_torch_ll, None, bounds=BOUNDS, mesh=object(), device="cpu")


# -- the model-level samplers ------------------------------------------------------


@pytest.fixture(scope="module")
def pair(splits):
    return make_pair(splits, (16,))


def test_sample_posterior_pt_and_smc_on_the_small_model(pair, splits):
    """``sample_posterior(sampler="pt"|"smc")`` on the small emulator
    (``tests/test_sampling.py::test_model_level_pt``,
    ``tests/test_smc.py::test_smc_model_entry_and_summary``): result
    types and shapes, and each sampler's posterior mean beside the JAX
    package's within 5 % of the box (the draws differ, the posteriors do
    not)."""
    jm, tm = pair
    obs = tm.predict(splits.par_test[0])
    bounds = train_box(splits.par_train)
    span = bounds[:, 1] - bounds[:, 0]
    kw = dict(n_rungs=8, n_walkers=32, n_steps=40, n_warmup=40, thin=10, seed=0)
    res = tm.sample_posterior(obs, 25.0, sampler="pt", bounds=bounds, **kw)
    assert isinstance(res, PTSampleResult)
    assert res.chain.shape == (4, 32, 7) and np.isfinite(res.logp).all()
    assert res.swap_rate.shape == (7,)
    kw = dict(n_particles=512, seed=0)
    smc = tm.sample_posterior(obs, 25.0, sampler="smc", bounds=bounds, **kw)
    assert isinstance(smc, SMCResult) and smc.final.shape == (512, 7)
    assert np.isfinite(smc.logp).all() and np.isfinite(smc.logz)
    s = smc.summary(tm.par_labels)
    assert "log Z" in s and "fstar" in s
    theirs = jm.sample_posterior(obs, 25.0, sampler="smc", bounds=bounds, **kw)
    d = (smc.final.mean(0) - theirs.final.mean(0)) / span
    assert np.abs(d).max() < 0.05, d
