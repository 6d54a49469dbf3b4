"""Nested sampling for the Bayesian evidence (Skilling 2006) — the port of
``tpu21cmvae/nested.py``.

Each iteration kills the ``n_batch`` worst live points of every
observation and regrows them with ``n_mh`` Metropolis steps constrained
to ``logL > L*``, every chain of every observation advancing in one
likelihood call per step (on a CUDA model, K2 at bf16x3 through
``DirectEmulator.loglik_fn(backend="kernel")``: calls of ``n_obs ·
n_batch`` rows). Volume bookkeeping is exact for batched deaths: death
``m`` of a batch shrinks ``log X`` by ``1/(n_live − m)``, and all weights
are kept in log space. Iterations run in chunks of ``iters_per_chunk``;
after each chunk the host tests every observation's stop rule, and the
run continues until every observation passes it (as in the JAX package:
converged rows keep compressing).

One iteration (:func:`one_iter`) takes its randoms as arguments, so a
test can feed both packages the same draws; :func:`nested_sampling_batch`
draws them from a ``torch.Generator`` on the device seeded with
``seed``. The JAX package runs each chunk as one ``lax.scan``; here it
is a Python loop whose tensors stay on the device, under
``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu21cmvae_torch.sampling._common import _init_walkers, _refuse_mesh, _resolve_bounds

__all__ = ["NestedResult", "nested_sampling", "nested_sampling_batch"]


def _log1mexp(neg_delta: np.ndarray) -> np.ndarray:
    """log(1 - exp(neg_delta)) for neg_delta < 0, stable near 0."""
    neg_delta = np.minimum(neg_delta, -1e-300)
    out = np.empty_like(neg_delta)
    small = neg_delta > -0.6931471805599453  # log 2
    out[small] = np.log(-np.expm1(neg_delta[small]))
    out[~small] = np.log1p(-np.exp(neg_delta[~small]))
    return out


def _log_widths(n: int, batch_shrink: float, cum_in_batch: np.ndarray):
    """``(logx, log_dx)`` of the first ``n`` dead points: each one's log
    prior volume and the log of the shell it leaves."""
    n_batch = len(cum_in_batch)
    j = np.arange(n) // n_batch
    i = np.arange(n) % n_batch
    logx = -(j * batch_shrink + cum_in_batch[i])
    logx_prev = np.concatenate([[0.0], logx[:-1]])
    return logx, logx_prev + _log1mexp(logx - logx_prev)


def _logz_dead(dead_ll: np.ndarray, batch_shrink: float, cum_in_batch: np.ndarray) -> float:
    """The evidence the dead points ``dead_ll`` (in death order) carry."""
    _, log_dx = _log_widths(len(dead_ll), batch_shrink, cum_in_batch)
    return float(np.logaddexp.reduce(dead_ll + log_dx))


@dataclasses.dataclass
class NestedResult:
    """Result of :func:`nested_sampling`.

    ``logz`` / ``logz_err``: the evidence under the flat box prior (or the
    ``prior_transform``'s prior) and its statistical error ``sqrt(H /
    n_live)`` (H: the information, the prior-to-posterior compression in
    nats). ``samples`` / ``logl`` / ``log_w``: all dead and final live
    points (raw θ units), their log-likelihoods and normalized posterior
    log-weights (``logsumexp(log_w) = 0``); :meth:`posterior` resamples
    them to equal weight. ``logx``: each sample's log prior volume.
    ``ess``: Kish effective sample size of the weights. ``n_like``:
    likelihood rows evaluated per observation. ``truncated``: True if
    ``max_iters`` ran out before the live set's remainder fell below
    ``stop_frac`` of the accumulated evidence (``logz`` is then a lower
    bound).
    """

    logz: float
    logz_err: float
    h: float
    samples: np.ndarray
    logl: np.ndarray
    log_w: np.ndarray
    logx: np.ndarray
    ess: float
    n_iters: int
    n_like: int
    accept_rate: float
    truncated: bool

    def posterior(self, n: int, seed: int = 0) -> np.ndarray:
        """Equal-weight posterior draws by multinomial resampling."""
        rng = np.random.default_rng(seed)
        p = np.exp(self.log_w - self.log_w.max())
        p /= p.sum()
        idx = rng.choice(len(p), size=n, p=p)
        return self.samples[idx]

    def summary(self) -> str:
        note = (
            "  ** truncated at max_iters: logz is a LOWER bound — "
            "raise max_iters or n_live **"
            if self.truncated
            else ""
        )
        return (
            f"log Z = {self.logz:.4f} ± {self.logz_err:.3f}  "
            f"(H = {self.h:.1f} nats, {self.n_iters} dead points, "
            f"ESS {self.ess:.0f}, MH accept {self.accept_rate:.2f})"
            f"{note}"
        )


def box_loglik(loglik_multi, to_theta, lo, hi):
    """``safe_ll(params, flat (O·B, P)) → (O·B,)``: the likelihood of
    ``to_theta`` of each row inside the box, ``-inf`` outside it (scored
    on the box's midpoint, so the emulator never sees such a row)."""
    mid = (lo + hi) / 2.0

    def safe_ll(params, flat):
        inside = ((flat >= lo) & (flat <= hi)).all(dim=1)
        ll = loglik_multi(params, to_theta(torch.where(inside[:, None], flat, mid)))
        return torch.where(inside, ll, -torch.inf)

    return safe_ll


def one_iter(safe_ll, params, x, ll, log_scale, n_batch: int, target_accept: float,
             lo, hi, ri, noise):
    """One nested-sampling iteration of every observation
    (``tpu21cmvae/nested.py:155-208``) on live points ``x`` (O, L, P),
    ``ll`` (O, L) and proposal log-scales ``log_scale`` (O,): the
    ``n_batch`` worst points die (a stable sort: dead points tie at
    ``-inf``), survivors ``ri`` (O, B; indices into the survivors) seed
    Metropolis chains that take ``len(noise)`` steps of ``noise`` (n_mh,
    O, B, P) standard normals scaled by the survivors' spread, accepting
    ``logL > L*``; the chains replace the dead. Returns ``(x, ll,
    log_scale, dead_ll (O, B) ascending, dead_x, acceptance (O,))``."""
    n_obs = x.shape[0]
    order = torch.argsort(ll, dim=1, stable=True)
    dead_idx, surv_idx = order[:, :n_batch], order[:, n_batch:]
    lstar = torch.gather(ll, 1, order[:, n_batch - 1:n_batch])
    xs = torch.take_along_dim(x, surv_idx[:, :, None], dim=1)
    # the survivors' per-dimension spread sets the proposal's shape, the
    # adapted factor its size (a floor lets chains leave a collapsed face)
    std = xs.std(dim=1, correction=0) + 1e-7 * (hi - lo)
    starts = torch.gather(surv_idx, 1, ri)
    xc = torch.take_along_dim(x, starts[:, :, None], dim=1)
    llc = torch.gather(ll, 1, starts)
    step = torch.exp(log_scale)[:, None, None] * std[:, None, :]
    nacc = torch.zeros((n_obs,), dtype=torch.float32, device=x.device)
    for z in noise:
        prop = xc + step * z
        llp = safe_ll(params, prop.reshape(-1, x.shape[2])).reshape(n_obs, n_batch)
        ok = llp > lstar
        xc = torch.where(ok[:, :, None], prop, xc)
        llc = torch.where(ok, llp, llc)
        nacc = nacc + ok.to(torch.float32).mean(dim=1)
    acc = nacc / len(noise)
    dead_ll = torch.gather(ll, 1, dead_idx)
    dead_x = torch.take_along_dim(x, dead_idx[:, :, None], dim=1)
    rows = torch.arange(n_obs, device=x.device)[:, None]
    x, ll = x.clone(), ll.clone()
    x[rows, dead_idx] = xc
    ll[rows, dead_idx] = llc
    log_scale = torch.clamp(log_scale + 0.5 * (acc - target_accept), -8.0, 2.0)
    return x, ll, log_scale, dead_ll, dead_x, acc


@torch.no_grad()
def nested_sampling_batch(
    loglik_multi,
    params,
    n_obs: int,
    *,
    n_live: int = 1024,
    n_batch: int | None = None,
    n_mh: int = 24,
    bounds=None,
    target_accept: float = 0.3,
    stop_frac: float = 1e-3,
    max_iters: int = 4096,
    iters_per_chunk: int = 32,
    seed: int = 0,
    prior_transform=None,
    mesh=None,
    device,
) -> list:
    """Nested sampling over a batch of observations:
    ``loglik_multi(params, raw (O·W, P)) → (O·W,)`` is a stacked-
    observation likelihood (row ``o·W + w`` scores against observation
    ``o``; :func:`tpu21cmvae_torch.ops.loglik.make_loglik_multi`). Every
    observation carries its own live set, threshold and adapted proposal
    scale; each iteration kills the ``n_batch`` (default ``n_live // 8``)
    worst points of every observation and regrows them. Chunks of
    ``iters_per_chunk`` iterations run until every observation passes
    the stop test (the live set's remainder below ``stop_frac`` of the
    evidence so far) or ``max_iters`` run out.

    ``prior_transform``: an optional unit-cube map ``(B, P) u → θ`` such
    that uniform ``u`` is prior-distributed (e.g.
    :meth:`tpu21cmvae_torch.priors.GaussianBoxPrior.prior_transform`):
    the sampler then explores ``u`` and ``bounds`` only fixes the
    dimension; ``samples`` are raw θ either way. ``mesh`` takes one device
    (more wait for the port of ``parallel/``). Returns ``n_obs`` :class:`NestedResult`.
    """
    _refuse_mesh(mesh)
    device = torch.empty(0, device=device).device
    lo, hi = _resolve_bounds(bounds, device)
    n_params = int(lo.shape[0])
    if prior_transform is None:
        def to_theta(u):
            return u
    else:
        lo, hi = torch.zeros_like(lo), torch.ones_like(hi)
        to_theta = prior_transform
    if n_batch is None:
        n_batch = max(1, n_live // 8)
    if not 1 <= n_batch < n_live:
        raise ValueError(f"n_batch must be in [1, n_live); got {n_batch} vs {n_live}")
    if n_obs < 1:
        raise ValueError(f"n_obs must be >= 1; got {n_obs}")
    gen = torch.Generator(device=device).manual_seed(seed)
    safe_ll = box_loglik(loglik_multi, to_theta, lo, hi)
    x = _init_walkers(gen, n_obs * n_live, lo, hi).reshape(n_obs, n_live, n_params)
    ll = safe_ll(params, x.reshape(-1, n_params)).reshape(n_obs, n_live)
    log_scale = torch.zeros((n_obs,), dtype=torch.float32, device=device)
    # exact batched shrinkage: death m of a batch shrinks log X by
    # 1/(n_live − m); deaths within a batch are ordered ascending in L
    per_death = 1.0 / (n_live - np.arange(n_batch, dtype=np.float64))
    batch_shrink = per_death.sum()
    cum_in_batch = np.cumsum(per_death)

    dead_ll_chunks, dead_x_chunks, acc_chunks = [], [], []
    n_done = 0
    done = np.zeros(n_obs, bool)
    for _ in range(-(-max_iters // iters_per_chunk)):
        dll, dx, accs = [], [], []
        for _ in range(iters_per_chunk):
            ri = torch.randint(0, n_live - n_batch, (n_obs, n_batch), generator=gen,
                               device=device)
            noise = torch.randn((n_mh, n_obs, n_batch, n_params), generator=gen, device=device)
            x, ll, log_scale, d_ll, d_x, acc = one_iter(
                safe_ll, params, x, ll, log_scale, n_batch, target_accept, lo, hi, ri, noise)
            dll.append(d_ll)
            dx.append(d_x)
            accs.append(acc)
        dead_ll_chunks.append(torch.stack(dll).cpu().numpy().astype(np.float64))
        dead_x_chunks.append(torch.stack(dx).cpu().numpy())
        acc_chunks.append(torch.stack(accs).cpu().numpy())
        n_done += iters_per_chunk
        # per-observation stop test: can the live set still move the
        # total? The chunks continue until every row passes.
        dead_flat = np.concatenate(dead_ll_chunks)  # (iters, O, B)
        ll_host = ll.cpu().numpy().astype(np.float64)
        remainder = -n_done * batch_shrink + np.logaddexp.reduce(ll_host, axis=1) - np.log(n_live)
        for o in np.flatnonzero(~done):
            logz_dead_o = _logz_dead(dead_flat[:, o, :].reshape(-1), batch_shrink, cum_in_batch)
            if remainder[o] < logz_dead_o + np.log(stop_frac):
                done[o] = True
        if done.all():
            break

    dead_ll = np.concatenate(dead_ll_chunks)  # (iters, O, B)
    dead_x = np.concatenate(dead_x_chunks)
    accs = np.concatenate(acc_chunks)  # (iters, O)
    n_iters = dead_ll.shape[0] * n_batch
    n_like_per_obs = n_live + n_done * n_batch * n_mh

    # the shared exact log-volume ladder (every row has n_live, n_batch)
    logx, log_dx = _log_widths(n_iters, batch_shrink, cum_in_batch)
    logx_final = logx[-1] if n_iters else 0.0
    log_dx_live = np.full(n_live, logx_final - np.log(n_live))
    ll_live = ll.cpu().numpy().astype(np.float64)
    x_live = x.cpu().numpy()

    results = []
    for o in range(n_obs):
        dll_o = dead_ll[:, o, :].reshape(-1)
        all_ll = np.concatenate([dll_o, ll_live[o]])
        all_x = np.concatenate([dead_x[:, o, :, :].reshape(-1, n_params), x_live[o]])
        if prior_transform is not None:
            # internal coordinates are unit-cube u; report raw θ
            all_x = to_theta(torch.as_tensor(all_x, device=device)).cpu().numpy()
        log_w = np.concatenate([dll_o + log_dx, ll_live[o] + log_dx_live])
        logz = np.logaddexp.reduce(log_w)
        log_p = log_w - logz
        p = np.exp(log_p)
        finite = np.isfinite(all_ll)
        h = float((p[finite] * (all_ll[finite] - logz)).sum())
        results.append(NestedResult(
            logz=float(logz),
            logz_err=float(np.sqrt(max(h, 0.0) / n_live)),
            h=h,
            samples=all_x,
            logl=all_ll,
            log_w=log_p,
            logx=np.concatenate([logx, np.full(n_live, logx_final)]),
            ess=float(1.0 / (p**2).sum()),
            n_iters=n_iters,
            n_like=n_like_per_obs,
            accept_rate=float(accs[:, o].mean()),
            truncated=bool(not done[o]),
        ))
    return results


def nested_sampling(
    loglik,
    params,
    *,
    n_live: int = 1024,
    n_batch: int | None = None,
    n_mh: int = 24,
    bounds=None,
    target_accept: float = 0.3,
    stop_frac: float = 1e-3,
    max_iters: int = 4096,
    iters_per_chunk: int = 32,
    seed: int = 0,
    prior_transform=None,
    mesh=None,
    device,
) -> NestedResult:
    """Evidence by batched nested sampling over the flat box prior (or
    ``prior_transform``'s): the ``n_obs = 1`` view of
    :func:`nested_sampling_batch` for a likelihood ``loglik(params, x (B,
    P)) → (B,)`` (e.g. :meth:`DirectEmulator.loglik_fn`'s). Cost:
    ``n_iters × n_mh`` likelihood calls of ``n_batch`` rows, ``n_iters ≈
    n_live · H / n_batch``."""
    return nested_sampling_batch(
        loglik, params, 1,
        n_live=n_live, n_batch=n_batch, n_mh=n_mh, bounds=bounds,
        target_accept=target_accept, stop_frac=stop_frac,
        max_iters=max_iters, iters_per_chunk=iters_per_chunk,
        seed=seed, prior_transform=prior_transform, mesh=mesh, device=device,
    )[0]
