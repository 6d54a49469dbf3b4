"""The port's adaptive gradient samplers, ChEES and NUTS, and the
per-block ensemble metric, against the JAX package
(``tpu21cmvae/sampling/gradient.py``).

Tolerances: bit-for-bit for the integer helpers (``_vdc``,
``_popcount32``); rtol 1e-5 for one step's continuous outputs from the
same inputs and randoms (float32 sigmoid, log-sigmoid and logaddexp
round differently in the two libraries), with every discrete decision
(acceptance, leapfrog count, leaf choice, U-turn, divergence) equal,
on inputs whose margins the tests assert to be at least 1e-4; rtol 1e-5
for the metric; the JAX suite's own assertions for the analytic
targets, at its sizes or below. JAX's threefry and torch's Philox never
give the same bits, so whole runs agree in distribution, not draw by
draw.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import one_torch_thread  # noqa: F401  (autouse fixture)
from tpu21cmvae.sampling import gradient as jgrad
from tpu21cmvae_torch.sampling import gradient as tgrad
from tpu21cmvae_torch.sampling.gradient import (
    ChEESSampleResult,
    NUTSSampleResult,
    sample_chees,
    sample_hmc,
    sample_nuts,
)

MU = np.array([1.0, -0.5, 2.0], np.float32)
SIG = np.array([2.0, 0.05, 0.4], np.float32)
BOUNDS = np.stack([MU - 8 * SIG, MU + 8 * SIG], axis=1)
CORR = np.array([[1.0, 0.99, 0.0], [0.99, 1.0, 0.0], [0.0, 0.0, 0.04]], np.float32)
PREC = np.linalg.inv(CORR).astype(np.float32)
MARGIN = 1e-4


def _torch_valgrad(params, x):
    z = (x - torch.as_tensor(MU)) / torch.as_tensor(SIG)
    return -0.5 * torch.sum(z**2, dim=-1), -z / torch.as_tensor(SIG)


def _jax_valgrad(params, x):
    z = (x - MU) / SIG
    return -0.5 * jnp.sum(z**2, axis=-1), -z / SIG


def _correlated_valgrad(params, x):
    g = -x @ torch.as_tensor(PREC).T
    return 0.5 * torch.sum(x * g, dim=-1), g


def _targets():
    """The whitened target of the anisotropic Gaussian in both packages."""
    lo, span = BOUNDS[:, 0], BOUNDS[:, 1] - BOUNDS[:, 0]
    _, jt = jgrad._whitened_target(_jax_valgrad, None, jnp.asarray(lo), jnp.asarray(span))
    _, tt = tgrad._whitened_target(_torch_valgrad, None, torch.as_tensor(lo),
                                   torch.as_tensor(span))
    return jt, tt


def _start(n, rng, spread=1.0):
    """Whitened starts near the mode, their lp and gradient in both
    packages; walker 0's lp set to -inf (the recovery rules)."""
    lo, span = BOUNDS[:, 0], BOUNDS[:, 1] - BOUNDS[:, 0]
    x0 = (MU + spread * SIG * rng.normal(size=(n, 3))).astype(np.float32)
    jt, tt = _targets()
    y = jgrad._whiten_init(jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(span))
    lp, glp = jt(None, y)
    lp = lp.at[0].set(-jnp.inf)
    ty = torch.as_tensor(np.asarray(y))
    tlp, tglp = tt(None, ty)
    tlp[0] = -torch.inf
    return (jt, y, lp, glp), (tt, ty, tlp, tglp)


def _metric(dense, rng, n):
    if not dense:
        return rng.uniform(0.5, 2.0, size=3).astype(np.float32)
    a = rng.normal(size=(3, 3))
    sq = np.linalg.cholesky(a @ a.T + 3 * np.eye(3)).astype(np.float32) / 3
    return np.repeat(sq[None], n, axis=0)  # per-walker rows, as a block metric gives


def _close(mine, theirs):
    mine = mine.numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    theirs = np.asarray(theirs)
    fin = np.isfinite(theirs)
    assert (np.isfinite(mine) == fin).all()
    scale = np.abs(theirs[fin]).max() if fin.any() else 1.0
    np.testing.assert_allclose(mine[fin], theirs[fin], rtol=1e-5, atol=1e-5 * scale)


# -- integer helpers and the metric -------------------------------------------


def test_vdc_and_popcount_are_bit_exact():
    """``_vdc`` equals the JAX fraction bit for bit over 0…2¹⁷ and near
    2³¹ − 2 (where ``i + 1`` wraps in int32); ``_popcount32`` is exact."""
    idx = np.concatenate([np.arange(2**17 + 1), np.arange(2**31 - 40, 2**31)])
    want = np.asarray(jgrad._vdc(jnp.asarray(idx, jnp.int32)))
    got = np.array([tgrad._vdc(int(i)) for i in idx], np.float32)
    assert got.tobytes() == want.tobytes()
    assert 0.0 < got.min() and got.max() <= 1.0  # float32 rounds 1 − 2⁻³² up to 1
    ints = np.concatenate([np.arange(-300, 5000), [2**31 - 1, -(2**31)]]).astype(np.int32)
    want = np.asarray(jgrad._popcount32(jnp.asarray(ints)))
    np.testing.assert_array_equal([tgrad._popcount32(int(i)) for i in ints], want)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("n_blk", [1, 4])
def test_ensemble_metric_blocks_match_jax(dense, n_blk):
    """Per-block metrics (each block's own spread, repeated to its
    walkers' rows) equal JAX's, diagonal and dense, to rtol 1e-5."""
    rng = np.random.default_rng(10 + n_blk)
    y = rng.normal(size=(400, 4)) * [1.0, 0.1, 5.0, 2.0]
    y[:, 3] += 0.5 * y[:, 0]
    y += np.repeat(rng.normal(size=(4, 4)) * 3.0, 100, axis=0)  # the blocks differ
    y = y.astype(np.float32)
    got = tgrad._ens_metric_blocks(torch.as_tensor(y), dense, n_blk).numpy()
    want = np.asarray(jgrad._ens_metric_blocks(jnp.asarray(y), dense, n_blk))
    assert got.shape == want.shape
    assert got.shape == ({(False, 1): (4,), (True, 1): (1, 4, 4)}.get(
        (dense, n_blk), (400, 4, 4) if dense else (400, 4)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# -- one ChEES step --------------------------------------------------------------


def _jax_chees_step(logp_and_grad, y, lp, glp, sd, eps_s, h, u, p0, log_u, max_leapfrog):
    """``gradient.py:601-653`` with the randoms passed in and
    ``want_grad=True``; also returns the leapfrog count and the margins
    of its decisions."""
    raw = u * h / eps_s
    n_leap = jnp.clip(jnp.ceil(raw).astype(jnp.int32), 1, max_leapfrog)
    p = p0 + 0.5 * eps_s * jgrad._met_pull(sd, glp)
    q, g = y, glp
    for _ in range(int(n_leap) - 1):
        q = q + eps_s * jgrad._met_scale(sd, p)
        _, g = logp_and_grad(None, q)
        p = p + eps_s * jgrad._met_pull(sd, g)
    q = q + eps_s * jgrad._met_scale(sd, p)
    lp_new, g_new = logp_and_grad(None, q)
    p_end = p + 0.5 * eps_s * jgrad._met_pull(sd, g_new)
    dh = (lp_new - lp) - 0.5 * (jnp.sum(p_end**2, -1) - jnp.sum(p0**2, -1))
    alpha = jnp.exp(jnp.minimum(dh, 0.0))
    m = jnp.mean(y, axis=0)
    dqp = q - m
    delta = jnp.sum(dqp**2, -1) - jnp.sum((y - m) ** 2, -1)
    dot = jnp.sum(dqp * jgrad._met_scale(sd, p_end), -1)
    per = alpha * u * delta * dot
    ok = jnp.isfinite(per)
    w = jnp.where(ok, alpha, 0.0)
    g_logh = jnp.sum(jnp.where(ok, per, 0.0)) / jnp.maximum(jnp.sum(w), 1e-6)
    acc = log_u < dh
    acc = acc | (~jnp.isfinite(lp) & jnp.isfinite(lp_new))
    y = jnp.where(acc[:, None], q, y)
    lp = jnp.where(acc, lp_new, lp)
    glp = jnp.where(acc[:, None], g_new, glp)
    a_mean = jnp.mean(jnp.minimum(1.0, jnp.exp(dh)))
    fin = np.isfinite(np.asarray(dh))
    margins = [abs(float(raw) - round(float(raw))),
               float(np.abs(np.asarray(log_u - dh))[fin].min())]
    return (y, lp, glp, a_mean, g_logh), int(n_leap), min(margins)


@pytest.mark.parametrize("dense", [False, True])
def test_one_chees_step_with_injected_randoms_matches_jax(dense):
    """One ChEES transition (with its gradient) of 64 walkers: the same
    start, jitter fraction, momenta and log-uniforms give the same
    outputs to rtol 1e-5, the same leapfrog count and the same accepted
    walkers; walker 0 starts at a non-finite lp and recovers."""
    rng = np.random.default_rng(3 + dense)
    (jt, y, lp, glp), (tt, ty, tlp, tglp) = _start(64, rng)
    met = _metric(dense, rng, 64)
    p0 = rng.normal(size=(64, 3)).astype(np.float32)
    log_u = np.log(rng.uniform(size=64)).astype(np.float32)
    log_u[1::7] = 5.0  # some walkers must reject
    eps, h, u = np.float32(0.07), np.float32(0.83), tgrad._vdc(40)
    want, n_leap, margin = _jax_chees_step(jt, y, lp, glp, jnp.asarray(met), jnp.float32(eps),
                                           jnp.float32(h), jnp.float32(u), jnp.asarray(p0),
                                           jnp.asarray(log_u), 128)
    assert margin >= MARGIN and n_leap > 1
    assert tgrad._chees_leapfrogs(u, torch.tensor(h), torch.tensor(eps), 128) == n_leap
    got = tgrad.chees_step(tt, None, ty, tlp, tglp, torch.as_tensor(met), torch.tensor(eps),
                           torch.tensor(h), u, torch.as_tensor(p0), torch.as_tensor(log_u),
                           128, True)
    for mine, theirs in zip(got, want):
        _close(mine, theirs)
    moved = (got[0] != ty).any(dim=1).numpy()
    np.testing.assert_array_equal(moved, np.asarray((want[0] != y).any(axis=1)))
    assert moved[0] and not moved[1::7].any() and np.isfinite(got[1].numpy()).all()
    # the sampling phase skips the gradient: same move, g_logh 0
    again = tgrad.chees_step(tt, None, ty, tlp, tglp, torch.as_tensor(met), torch.tensor(eps),
                             torch.tensor(h), u, torch.as_tensor(p0), torch.as_tensor(log_u),
                             128, False)
    assert torch.equal(again[0], got[0]) and float(again[4]) == 0.0
    assert tgrad._chees_leapfrogs(u, torch.tensor(h), torch.tensor(eps), 3) == min(n_leap, 3)
    assert tgrad._chees_leapfrogs(u, torch.tensor(float("nan")), torch.tensor(eps), 9) == 1


# -- one NUTS step ----------------------------------------------------------------


def _jax_nuts_step(logp_and_grad, y, lp, glp, sd, eps_blk, md, p0, randoms):
    """``gradient.py:959-1098`` with the randoms passed in
    (``randoms[d] = (right, log_u_leaf (2**d, B), log_u_take)``) and the
    fori_loops unrolled, the checkpoint stack kept as JAX keeps it: a
    masked check over every slot. Also returns per-walker divergence
    flags and leaf counts, and the smallest margin of any decision of a
    walker still building."""
    B, D = y.shape
    n_blk = eps_blk.shape[0]
    eps_w = jnp.repeat(eps_blk, B // n_blk)
    h0 = lp - 0.5 * jnp.sum(p0**2, -1)
    zl, pl, gl, zr, pr, gr, zp, lpp, gp, rho = y, p0, glp, y, p0, glp, y, lp, glp, p0
    logw = jnp.zeros((B,))
    done = jnp.zeros((B,), bool)
    zb = jnp.zeros((B,), jnp.float32)
    ndiv, a_sum, a_cnt, nleap = zb, zb, zb, zb
    margins = []

    def note(active, values):
        v = np.abs(np.asarray(values))[np.asarray(active)]
        v = v[np.isfinite(v)]
        if v.size:
            margins.append(float(v.min()))

    for d in range(md):
        if bool(jnp.all(done)):
            break
        right, log_u_leaf, log_u_take = (jnp.asarray(r) for r in randoms[d])
        live = ~done
        eps_d = jnp.where(right, eps_w, -eps_w)[:, None]
        z = jnp.where(right[:, None], zr, zl)
        p = jnp.where(right[:, None], pr, pl)
        g = jnp.where(right[:, None], gr, gl)
        n_ck = max(d, 1)
        cum = jnp.zeros((B, D))
        lw = jnp.full((B,), -jnp.inf)
        zs, ls, gs = z, jnp.full((B,), -jnp.inf), g
        turn = jnp.zeros((B,), bool)
        div = jnp.zeros((B,), bool)
        pck = jnp.zeros((n_ck, B, D))
        rck = jnp.zeros((n_ck, B, D))
        for i in range(2**d):
            ph = p + 0.5 * eps_d * jgrad._met_pull(sd, g)
            z = z + eps_d * jgrad._met_scale(sd, ph)
            lp2, g = logp_and_grad(None, z)
            p = ph + 0.5 * eps_d * jgrad._met_pull(sd, g)
            w = lp2 - 0.5 * jnp.sum(p**2, -1) - h0
            w = jnp.where(jnp.isfinite(w), w, -jnp.inf)
            note(live, w + 1000.0)
            div = div | (w < -1000.0)
            lw_new = jnp.logaddexp(lw, w)
            note(live & ~div, log_u_leaf[i] - (w - lw_new))
            take = log_u_leaf[i] < (w - lw_new)
            lw = lw_new
            zs = jnp.where(take[:, None], z, zs)
            ls = jnp.where(take, lp2, ls)
            gs = jnp.where(take[:, None], g, gs)
            cum = cum + p
            ii = jnp.int32(i)
            pc = jgrad._popcount32(ii)
            even = (ii % 2) == 0
            slot = jnp.where(even, pc, 0)
            pck = pck.at[slot].set(jnp.where(even, p, pck[slot]))
            rck = rck.at[slot].set(jnp.where(even, cum, rck[slot]))
            tz = jgrad._popcount32(~(ii + 1) & ii)
            smin, smax = pc - tz, pc - 1
            for s in range(n_ck):
                seg = cum - rck[s] + pck[s]
                a, b = jnp.sum(seg * pck[s], -1), jnp.sum(seg * p, -1)
                m = (~even) & (s >= smin) & (s <= smax)
                if bool(m):
                    note(live & ~turn & ~div, a)
                    note(live & ~turn & ~div, b)
                turn = turn | (m & ((a <= 0.0) | (b <= 0.0)))
            a_sum = a_sum + jnp.where(~done, jnp.minimum(1.0, jnp.exp(w)), 0.0)
        ok = (~done) & (~turn) & (~div)
        note(ok, log_u_take - (lw - logw))
        take = ok & (log_u_take < (lw - logw))
        zp = jnp.where(take[:, None], zs, zp)
        lpp = jnp.where(take, ls, lpp)
        gp = jnp.where(take[:, None], gs, gp)
        logw = jnp.where(ok, jnp.logaddexp(logw, lw), logw)
        rho = jnp.where(ok[:, None], rho + cum, rho)
        upd_r, upd_l = (ok & right)[:, None], (ok & ~right)[:, None]
        zr, pr, gr = jnp.where(upd_r, z, zr), jnp.where(upd_r, p, pr), jnp.where(upd_r, g, gr)
        zl, pl, gl = jnp.where(upd_l, z, zl), jnp.where(upd_l, p, pl), jnp.where(upd_l, g, gl)
        ft_l, ft_r = jnp.sum(rho * pl, -1), jnp.sum(rho * pr, -1)
        note(ok, ft_l)
        note(ok, ft_r)
        full_turn = (ft_l <= 0.0) | (ft_r <= 0.0)
        ndiv = ndiv + jnp.where((~done) & div, 1.0, 0.0)
        nleap = nleap + jnp.where(~done, float(2**d), 0.0)
        a_cnt = a_cnt + jnp.where(~done, float(2**d), 0.0)
        done = done | turn | div | (ok & full_turn)
    a_blk = (a_sum / jnp.maximum(a_cnt, 1.0)).reshape(n_blk, -1).mean(axis=1)
    return (zp, lpp, gp, a_blk, ndiv > 0, nleap), min(margins)


@pytest.mark.parametrize("dense,max_depth,eps", [(False, 4, (0.05, 0.09)),
                                                  (True, 3, (0.12, 0.3)),
                                                  (False, 4, (0.1, 4.0))])
def test_one_nuts_step_with_injected_randoms_matches_jax(dense, max_depth, eps):
    """One NUTS transition of 32 walkers in two step blocks, from the same
    start, momenta and per-depth randoms (directions, leaf and subtree
    log-uniforms): positions, lp, gradients and accept statistics to
    rtol 1e-5; per-walker divergence flags and leaf counts exactly;
    walker 0 starts at a non-finite lp (it diverges at once and stays).
    The last case's second block takes steps large enough to diverge."""
    rng = np.random.default_rng(20 + max_depth + int(10 * eps[1]))
    n = 32
    (jt, y, lp, glp), (tt, ty, tlp, tglp) = _start(n, rng, spread=2.0)
    met = _metric(dense, rng, n)
    p0 = rng.normal(size=(n, 3)).astype(np.float32)
    randoms = [(rng.uniform(size=n) < 0.5,
                np.log(rng.uniform(size=(2**d, n))).astype(np.float32),
                np.log(rng.uniform(size=n)).astype(np.float32)) for d in range(max_depth)]
    eps_blk = np.asarray(eps, np.float32)
    want, margin = _jax_nuts_step(jt, y, lp, glp, jnp.asarray(met), jnp.asarray(eps_blk),
                                  max_depth, jnp.asarray(p0), randoms)
    assert margin >= MARGIN
    drawn = []

    def draw(d):
        drawn.append(d)
        return tuple(torch.as_tensor(r) for r in randoms[d])

    got = tgrad.nuts_step(tt, None, ty, tlp, tglp, torch.as_tensor(met),
                          torch.as_tensor(eps_blk), max_depth, torch.as_tensor(p0), draw)
    for k in range(4):
        _close(got[k], want[k])
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    moved = (got[0] != ty).any(dim=1).numpy()
    np.testing.assert_array_equal(moved, np.asarray((want[0] != y).any(axis=1)))
    assert got[4][0] and not moved[0] and got[5][0] == 1.0
    assert moved[1:n // 2].sum() > n // 4
    assert drawn == list(range(len(drawn))) and len(drawn) >= 2
    if eps[1] > 1.0:
        assert got[4][n // 2:].any()  # a real divergence beside walker 0's


# -- the samplers on the JAX suite's analytic targets --------------------------------


def test_chees_exact_on_analytic_anisotropic_gaussian():
    """``tests/test_sampling.py::test_chees_exact_on_analytic_anisotropic_gaussian``
    at its sizes: exact moments, with the trajectory length adapted more
    than 10× above its initial 8·init_step."""
    res = sample_chees(_torch_valgrad, None, n_walkers=256, n_steps=300, n_warmup=200,
                       thin=5, bounds=BOUNDS, seed=2, device="cpu")
    assert isinstance(res, ChEESSampleResult)
    flat = res.flat
    assert np.allclose(flat.mean(0), MU, atol=4 * SIG / np.sqrt(300))
    assert np.allclose(flat.std(0), SIG, rtol=0.12)
    assert 0.4 < float(res.accept_rate[-20:].mean()) <= 1.0
    assert res.trajectory_length > 10 * 0.08
    assert res.step_size > 0 and res.block_step_sizes is None


def test_chees_beats_fixed_trajectory_on_correlated_gaussian():
    """``…::test_chees_beats_fixed_trajectory_on_correlated_gaussian`` at
    its sizes: on a 0.99-correlated Gaussian under the diagonal metric,
    fixed-L8 HMC leaves the correlated pair's std > 15 % off, ChEES gets
    within 8 % and more than twice the ESS."""
    sig = np.sqrt(np.diag(CORR))
    kw = dict(n_walkers=256, n_steps=300, n_warmup=200, thin=5, seed=3,
              bounds=np.stack([-8 * sig, 8 * sig], axis=1), metric="diag", device="cpu")
    r_c = sample_chees(_correlated_valgrad, None, **kw)
    r_h = sample_hmc(_correlated_valgrad, None, n_leapfrog=8, **kw)
    assert np.allclose(r_c.flat.std(0), sig, rtol=0.08)
    assert abs(r_h.flat.std(0)[0] - sig[0]) > 0.15 * sig[0]
    assert r_c.ess().min() > 2.0 * r_h.ess().min()


def test_nuts_exact_on_analytic_anisotropic_gaussian():
    """``…::test_nuts_exact_on_analytic_anisotropic_gaussian`` at its
    sizes: exact moments, acceptance near the 0.8 target, no
    divergences."""
    res = sample_nuts(_torch_valgrad, None, n_walkers=256, n_steps=300, n_warmup=200,
                      thin=5, bounds=BOUNDS, seed=2, device="cpu")
    assert isinstance(res, NUTSSampleResult)
    flat = res.flat
    assert np.allclose(flat.mean(0), MU, atol=4 * SIG / np.sqrt(300))
    assert np.allclose(flat.std(0), SIG, rtol=0.12)
    assert 0.6 < float(res.accept_rate[-20:].mean()) <= 1.0
    assert res.divergence_rate == 0.0
    assert 1.0 <= res.mean_leapfrog <= 2**6 - 1
    assert res.step_size > 0 and res.block_step_sizes.shape == (1,)


def test_nuts_deep_trees_on_correlated_gaussian():
    """``…::test_nuts_deep_trees_on_correlated_gaussian`` (256 walkers,
    max_depth 8, diagonal metric; 200 steps where the JAX suite runs
    300): the U-turn criterion deepens the trees until the stiff
    direction mixes."""
    sig = np.sqrt(np.diag(CORR))
    res = sample_nuts(_correlated_valgrad, None, n_walkers=256, n_steps=200, n_warmup=200,
                      thin=5, seed=3, bounds=np.stack([-8 * sig, 8 * sig], axis=1),
                      max_depth=8, metric="diag", device="cpu")
    assert np.allclose(res.flat.std(0), sig, rtol=0.08)
    assert res.mean_leapfrog > 8.0
    assert res.divergence_rate == 0.0
    assert res.ess().min() > 1000.0


def test_nuts_divergences_are_detected():
    """``…::test_nuts_divergences_are_detected``: a step far too large
    for a narrow Gaussian is flagged (ΔH > 1000), and the reported state
    stays finite."""
    sig = np.float32(1e-3)

    def valgrad(params, x):
        return -0.5 * torch.sum((x / sig) ** 2, dim=-1), -x / sig**2

    res = sample_nuts(valgrad, None, n_walkers=64, n_steps=20, n_warmup=0, init_step=10.0,
                      thin=0, bounds=np.array([[-1.0, 1.0], [-1.0, 1.0]], np.float32), seed=0,
                      device="cpu")
    assert res.divergence_rate > 0.5
    assert np.isfinite(res.final).all() and np.isfinite(res.logp).all()
    assert res.chain.shape == (0, 64, 2)


def _two_block_valgrad(sig):
    """A target whose two walker blocks are Gaussians of widths ``sig``
    ((2, D): one row per block)."""
    def valgrad(params, x):
        s = torch.repeat_interleave(torch.as_tensor(sig), x.shape[0] // 2, dim=0)
        z = x / s
        return -0.5 * torch.sum(z**2, dim=-1), -z / s

    return valgrad


def test_hmc_adapt_blocks_heterogeneous_widths():
    """``…::test_hmc_adapt_blocks_heterogeneous_widths`` at its sizes:
    per-block steps recover both blocks of a 50×-split target, their
    steps split by more than 8× (the metric stays pooled)."""
    sig = np.array([[1.0] * 3, [0.02] * 3], np.float32)
    bounds = np.stack([np.full(3, -8.0), np.full(3, 8.0)], axis=1)
    res = sample_hmc(_two_block_valgrad(sig), None, n_walkers=256, adapt_blocks=2,
                     n_steps=400, n_warmup=300, n_leapfrog=8, thin=5, bounds=bounds, seed=1,
                     device="cpu")
    assert np.allclose(res.chain[:, :128].reshape(-1, 3).std(0), 1.0, rtol=0.15)
    assert np.allclose(res.chain[:, 128:].reshape(-1, 3).std(0), 0.02, rtol=0.15)
    assert res.block_step_sizes.shape == (2,)
    assert res.block_step_sizes[0] > 8 * res.block_step_sizes[1]
    with pytest.raises(ValueError, match="adapt_blocks"):
        sample_hmc(_two_block_valgrad(sig), None, n_walkers=100, adapt_blocks=3,
                   bounds=bounds, device="cpu")


def test_nuts_adapt_blocks_heterogeneous_geometry():
    """``…::test_nuts_adapt_blocks_heterogeneous_geometry`` (warmup 300
    where the JAX suite takes 400, and half its steps; the pooled run
    warms up 150 steps and draws 20): two blocks with a 10× width split
    along opposite axes; per-block steps and per-block metrics recover
    both, with short trees, where a pooled metric needs 1.5× the
    leapfrogs."""
    sig = np.array([[2.0, 0.2, 2.0], [0.2, 2.0, 0.2]], np.float32)
    bounds = np.stack([np.full(3, -8.0), np.full(3, 8.0)], axis=1)
    kw = dict(n_walkers=256, n_warmup=300, thin=5, bounds=bounds, seed=0, max_depth=7,
              device="cpu")
    res = sample_nuts(_two_block_valgrad(sig), None, adapt_blocks=2, n_steps=150, **kw)
    draws = res.chain.reshape(res.chain.shape[0], 2, 128, 3)
    for b in range(2):
        flat = draws[:, b].reshape(-1, 3)
        np.testing.assert_allclose(flat.std(0), sig[b], rtol=0.15)
        assert np.abs(flat.mean(0)).max() < 0.3
    assert res.block_step_sizes.shape == (2,)
    assert res.divergence_rate < 0.02
    pooled = sample_nuts(_two_block_valgrad(sig), None, adapt_blocks=1, n_steps=20,
                         **dict(kw, n_warmup=150))
    assert res.mean_leapfrog < 8
    assert pooled.mean_leapfrog > 1.5 * res.mean_leapfrog
    with pytest.raises(ValueError, match="adapt_blocks"):
        sample_nuts(_two_block_valgrad(sig), None, n_walkers=100, adapt_blocks=3,
                    bounds=bounds, device="cpu")


def test_adaptive_thinning_and_refusals():
    """Kept rows equal the thin=1 run's ``chain[thin-1::thin]`` (ChEES
    counts post-warmup steps though its jitter runs on the global index);
    thin=0 keeps nothing and runs the same chain; bad arguments raise."""
    kw = dict(bounds=BOUNDS, n_steps=11, n_warmup=16, seed=3, n_walkers=32, device="cpu")
    for run in (lambda thin: sample_chees(_torch_valgrad, None, thin=thin, **kw),
                lambda thin: sample_nuts(_torch_valgrad, None, max_depth=3, thin=thin, **kw)):
        full, thinned, none = run(1), run(3), run(0)
        assert full.chain.shape[0] == 11 and thinned.chain.shape[0] == 3
        np.testing.assert_array_equal(thinned.chain, full.chain[2::3])
        np.testing.assert_array_equal(none.final, full.final)
        assert none.chain.shape[0] == 0
    with pytest.raises(ValueError, match="max_depth"):
        sample_nuts(_torch_valgrad, None, max_depth=0, device="cpu")
    with pytest.raises(ValueError, match="metric"):
        sample_chees(_torch_valgrad, None, metric="full", device="cpu")
