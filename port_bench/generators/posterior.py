"""Posterior draws: whole ``sample_posterior`` calls back to back on one
observation, each with a fresh seed.

The traffic file gives the sampler and its sizes (``sampler``,
``n_walkers``, ``n_warmup``, ``n_steps``, optional ``kwargs``), the
set-up call (``warmup``: the warm-up and kept steps of one call at the
same walker count), and how many calls' draws the check reads
(``checked_chains``). The observation is the reference's signal at a
truth drawn from the seed inside the prior box, plus Gaussian noise at
the configuration's σ². Call ``i`` of the window takes sampler seed
``i + 1`` (the set-up call 0) in every run, so that every run makes the
same leapfrog counts call for call (HMC draws them from its seed) and
the run's seed changes the observation, not the work.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

from port_bench.reference import Reference, in_blocks, jacobian_logdet
from port_bench.trace import counted, profiled

GRADIENT_SAMPLERS = ("hmc", "chees", "nuts")


@dataclasses.dataclass
class State:
    model: object
    obs: np.ndarray
    bounds: np.ndarray
    pick: np.random.Generator
    finals: list = dataclasses.field(default_factory=list)
    logps: list = dataclasses.field(default_factory=list)
    chains: dict = dataclasses.field(default_factory=dict)
    slots: list = dataclasses.field(default_factory=list)
    grads: dict = dataclasses.field(default_factory=dict)


def load_model(ctx):
    """The configuration's checkpoint through the program's loader."""
    path = ctx.path(ctx.config["checkpoint"])
    if ctx.config["family"] == "direct":
        from tpu21cmvae_torch.models.direct import DirectEmulator

        return DirectEmulator.from_checkpoint(path, device=ctx.device)
    from tpu21cmvae_torch.models.autoencoder import AutoEncoderEmulator

    return AutoEncoderEmulator.from_checkpoint(path, device=ctx.device)


def observation(ctx, rng: np.random.Generator) -> np.ndarray:
    """The reference's signal at a truth uniform in the middle nine
    tenths of the prior box, plus noise at σ² (float32)."""
    box = np.asarray(ctx.config["prior_box"], np.float64)
    u = rng.uniform(0.05, 0.95, size=(1, box.shape[0]))
    truth = box[:, 0] + u * (box[:, 1] - box[:, 0])
    ref = Reference(ctx.path(ctx.config["checkpoint"]), device="cpu")
    signal = ref.forward(truth).numpy()[0]
    noise = rng.normal(0.0, np.sqrt(ctx.config["noise_var"]), size=signal.shape)
    return (signal + noise).astype(np.float32)


def _sample(ctx, st: State, seed: int, n_warmup: int, n_steps: int):
    t = ctx.traffic
    return st.model.sample_posterior(
        st.obs, ctx.config["noise_var"], sampler=t["sampler"], bounds=st.bounds,
        n_walkers=t["n_walkers"], n_warmup=n_warmup, n_steps=n_steps, seed=seed,
        **t.get("kwargs", {}))


def setup(ctx) -> State:
    rng_obs, rng_pick = (np.random.default_rng(s)
                         for s in np.random.SeedSequence(ctx.seed).spawn(2))
    st = State(model=load_model(ctx), obs=observation(ctx, rng_obs),
               bounds=np.asarray(ctx.config["prior_box"], np.float32), pick=rng_pick)
    w = ctx.traffic["warmup"]
    _sample(ctx, st, 0, w["n_warmup"], w["n_steps"])
    return st


def window(ctx, st: State, seconds: float) -> dict:
    """Whole calls until the first that finishes after ``seconds``; with
    ``ctx.trace`` the first call is profiled, and the rows its
    likelihood calls score are counted."""
    t = ctx.traffic
    keep = t["checked_chains"]
    call_s, failed, trace = [], 0, None
    t_open = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        if ctx.trace and i == 0:
            with counted(st.model, {"value": 0, "valgrad": 0}) as rows, profiled() as trace:
                res = _sample(ctx, st, i + 1, t["n_warmup"], t["n_steps"])
        else:
            res = _sample(ctx, st, i + 1, t["n_warmup"], t["n_steps"])
        t1 = time.perf_counter()
        call_s.append(t1 - t0)
        failed += int(not np.all(np.isfinite(res.logp)))
        st.finals.append(res.final)
        st.logps.append(res.logp)
        # a uniform sample of `keep` calls' draws (reservoir sampling)
        j = i if i < keep else int(st.pick.integers(0, i + 1))
        if j < keep:
            if j < len(st.slots):
                del st.chains[st.slots[j]]
                st.slots[j] = i
            else:
                st.slots.append(i)
            st.chains[i] = res.chain
        del res
        i += 1
        if t1 - t_open >= seconds:
            break
    draws = i * t["n_walkers"] * t["n_steps"]
    rec = {"window_s": t1 - t_open, "calls": i, "call_s": call_s, "failed": failed,
           "work": {"draws": draws}, "rows_per_launch": t["n_walkers"]}
    if trace is not None:
        rec["trace"] = dict(trace, iterations=t["n_warmup"] + t["n_steps"],
                            rows_value=rows["value"], rows_valgrad=rows["valgrad"])
    return rec


def program_outputs(ctx, st: State) -> None:
    """Once the window has closed: the gradient at the checked calls'
    final walkers through the same memoized value+gradient wrapper the
    window drove, at the window's batch."""
    if ctx.traffic["sampler"] not in GRADIENT_SAMPLERS:
        return
    model, nv = st.model, ctx.config["noise_var"]
    if ctx.config["family"] == "direct":
        valgrad = model.loglik_and_grad_fn(st.obs, nv, backend=model._backend(),
                                           grad_precision="default")
    else:
        valgrad = model.loglik_and_grad_fn(st.obs, nv)
    for i in st.chains:
        x = torch.as_tensor(st.finals[i], device=ctx.device)
        _, g = valgrad(model.params, x)
        st.grads[i] = g.detach().cpu().numpy()


def free_program(st: State) -> None:
    st.model = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def outputs(st: State) -> dict:
    """What the timed path produced, as the check reads it."""
    return {"finals": st.finals, "logps": st.logps, "chains": st.chains, "grads": st.grads}


EDGE = 1e-4


def inside(x, lo, hi):
    """Walkers at least ``EDGE`` of the span inside the box in every
    parameter: where the sigmoid map saturates in float32 the position no
    longer determines the log-Jacobian the sampler carries (at 1e-4 of
    the span the float32 position gives it to ~6e-4 nats)."""
    f = (x - lo) / (hi - lo)
    return torch.all((f > EDGE) & (f < 1.0 - EDGE), dim=-1)


def readings(ctx, obs, out: dict, ref: Reference) -> dict:
    """The numbers the check compares, from ``out`` (the program's
    outputs, or the control's) against the float64 reference:

    * ``logp_gap`` and ``logp_gap_q999``: the widest |carried
      log-density − reference| over every call's final walkers, and its
      99.9th percentile, nats (the gradient samplers' carry the sigmoid
      map's log-Jacobian, which the reference adds, on the walkers
      :func:`inside` the box's edges);
    * ``grad_err``: the 99th percentile over the checked calls' final
      walkers of |g − g_ref| / |g_ref| (gradient samplers);
    * ``draws_gap``: the median over the checked calls' draws of the
      reference log-likelihood's distance below its best draw, nats: a
      sampler that does not move its walkers reads thousands.
    """
    nv = ctx.config["noise_var"]
    box = torch.as_tensor(np.asarray(ctx.config["prior_box"], np.float32), dtype=torch.float64)
    lo, hi = box[:, 0], box[:, 1]
    grad_sampler = ctx.traffic["sampler"] in GRADIENT_SAMPLERS
    gaps = []
    for final, logp in zip(out["finals"], out["logps"]):
        gap = torch.as_tensor(logp, dtype=torch.float64) - in_blocks(
            lambda x: ref.loglik(x, obs, nv), final)
        if grad_sampler:
            x = torch.as_tensor(final, dtype=torch.float64)
            gap = (gap - jacobian_logdet(x, lo, hi))[inside(x, lo, hi)]
        gaps.append(torch.abs(gap))
    gaps = torch.cat(gaps)
    r = ({"logp_gap": float(torch.max(gaps)), "logp_gap_q999": float(torch.quantile(gaps, 0.999))}
         if gaps.numel() else {"logp_gap": math.nan, "logp_gap_q999": math.nan})
    if grad_sampler and out["grads"]:
        errs = []
        for i, g in out["grads"].items():
            _, g_ref = in_blocks(lambda x: ref.loglik_and_grad(x, obs, nv), out["finals"][i])
            num = torch.linalg.vector_norm(torch.as_tensor(g, dtype=torch.float64) - g_ref, dim=-1)
            errs.append(num / torch.linalg.vector_norm(g_ref, dim=-1))
        r["grad_err"] = float(torch.quantile(torch.cat(errs), 0.99))
    lls = [in_blocks(lambda x: ref.loglik(x, obs, nv), c.reshape(-1, c.shape[-1]))
           for c in out["chains"].values()]
    lls = torch.cat(lls)
    r["draws_gap"] = float(torch.median(torch.max(lls) - lls))
    return r


def control_outputs(ctx, obs, out: dict, ref: Reference, mode: str, grad_mode: str) -> dict:
    """The control in the program's place: at the program's own final
    walkers, the log-density and gradient the reference gives at the
    lower precision (the draws are the program's)."""
    nv = ctx.config["noise_var"]
    box = torch.as_tensor(np.asarray(ctx.config["prior_box"], np.float32), dtype=torch.float64)
    grad_sampler = ctx.traffic["sampler"] in GRADIENT_SAMPLERS
    logps, grads = [], {}
    for final in out["finals"]:
        lp = in_blocks(lambda x: ref.loglik(x, obs, nv, mode), final)
        if grad_sampler:
            lp = lp + jacobian_logdet(torch.as_tensor(final, dtype=torch.float64),
                                      box[:, 0], box[:, 1])
        logps.append(lp.numpy())
    for i in out["grads"]:
        _, g = in_blocks(lambda x: ref.loglik_and_grad(x, obs, nv, mode, grad_mode),
                         out["finals"][i])
        grads[i] = g.numpy()
    return {"finals": out["finals"], "logps": logps, "chains": out["chains"], "grads": grads}


def check(ctx, st: State, control=None):
    """The program's readings; with ``control`` (the cell file's
    ``{"mode", "grad_mode"}``) also the control's on the same walkers."""
    program_outputs(ctx, st)
    obs, out = st.obs, outputs(st)
    free_program(st)
    ref = Reference(ctx.path(ctx.config["checkpoint"]), device=ctx.device)
    if control is None:
        return readings(ctx, obs, out, ref)
    ctrl = control_outputs(ctx, obs, out, ref, control["mode"], control["grad_mode"])
    return readings(ctx, obs, out, ref), readings(ctx, obs, ctrl, ref)
