"""Posterior draws under a deep ensemble's mixture likelihood: whole
``DeepEnsemble.sample_posterior`` calls back to back on one observation,
each with a fresh seed, as :mod:`port_bench.generators.posterior` makes
them for one model, whose traffic keys, seeds, reservoir of checked
calls and readings this generator shares.

What differs: the model is the configuration's checkpoint directory
through ``DeepEnsemble.load``; the observation is drawn from the members'
mean signal; the gradient at the checked calls' final walkers comes from
``model._hmc_valgrad``, the memoized mixture the window drove; the check
holds all of it to the float64 mixture
(:class:`~port_bench.reference_ensemble.MixtureReference`); and the
traced call runs under :func:`recorded` (:func:`port_bench.spans.recorded`
and the host's CUDA runtime calls), so the program's spans and counters
(the ``mixture`` span, the K3 route counters) reach the record beside the
device's operations.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from port_bench import spans
from port_bench.generators.posterior import (  # noqa: F401  (the harness's interface)
    GRADIENT_SAMPLERS,
    State,
    _sample,
    control_outputs,
    free_program,
    inside,
    outputs,
    readings,
)
from port_bench.reference_ensemble import MixtureReference
from port_bench.trace import _mark, counted, summarize
from tpu21cmvae_torch.utils.profiling import recording


def load_model(ctx):
    """The configuration's member checkpoints through the program's
    loader."""
    from tpu21cmvae_torch.models.ensemble import DeepEnsemble

    return DeepEnsemble.load(ctx.path(ctx.config["checkpoint"]), device=ctx.device)


def observation(ctx, rng: np.random.Generator) -> np.ndarray:
    """The members' mean signal (the reference's) at a truth uniform in
    the middle nine tenths of the prior box, plus noise at σ² (float32)."""
    box = np.asarray(ctx.config["prior_box"], np.float64)
    u = rng.uniform(0.05, 0.95, size=(1, box.shape[0]))
    truth = box[:, 0] + u * (box[:, 1] - box[:, 0])
    ref = MixtureReference(ctx.path(ctx.config["checkpoint"]), device="cpu")
    signal = ref.forward(truth).numpy()[0]
    noise = rng.normal(0.0, np.sqrt(ctx.config["noise_var"]), size=signal.shape)
    return (signal + noise).astype(np.float32)


@contextlib.contextmanager
def recorded():
    """:func:`port_bench.spans.recorded`, whose summary also holds
    ``runtime_ns``: the ``[start, end]`` on the host of each call into the
    CUDA API in the slice (``cuda*`` and ``cu*``: a launch, a copy, an
    allocation), in time order, so that a span's host time can be read
    less the time it spent inside them (``mixture_us.members``). Without a
    card there are none."""
    if not torch.cuda.is_available():
        with spans.recorded() as out:
            yield out
        out["runtime_ns"] = []
        return
    from torch.profiler import ProfilerActivity, profile

    out = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _mark()
        with recording() as rec:
            yield out
        _mark()
    events = prof.profiler.kineto_results.events()
    host, device = spans._launch_times(events)
    launch_ns = {e.start_ns(): host[c] for c, e in device.items() if c in host}
    out.update(summarize(events), spans=rec.spans, counters=dict(rec.counters),
               launch_ns=launch_ns,
               clock_least_ns=min((k - r for k, r in launch_ns.items()), default=None),
               runtime_ns=sorted([e.start_ns(), e.start_ns() + e.duration_ns()] for e in events
                                 if e.device_type() != torch.autograd.DeviceType.CUDA
                                 and e.name().startswith("cu")))


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
    ``ctx.trace`` the first call is profiled with the program's recording
    open, and the rows its likelihood calls score are counted."""
    t = ctx.traffic
    keep = t["checked_chains"]
    call_s, failed, trace = [], 0, None
    t_open = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        if ctx.trace and i == 0:
            with counted(st.model, {"value": 0, "valgrad": 0}) as rows, recorded() as trace:
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
    rec = {"window_s": t1 - t_open, "calls": i, "call_s": call_s, "failed": failed,
           "work": {"draws": i * t["n_walkers"] * t["n_steps"]},
           "rows_per_launch": t["n_walkers"]}
    if trace is not None:
        rec["trace"] = dict(trace, iterations=t["n_warmup"] + t["n_steps"],
                            rows_value=rows["value"], rows_valgrad=rows["valgrad"])
    return rec


def program_outputs(ctx, st: State) -> None:
    """Once the window has closed: the mixture's gradient at the checked
    calls' final walkers through ``model._hmc_valgrad``, the memoized
    wrapper the window drove, at the window's batch."""
    if ctx.traffic["sampler"] not in GRADIENT_SAMPLERS:
        return
    valgrad = st.model._hmc_valgrad(st.obs, ctx.config["noise_var"])
    for i in st.chains:
        x = torch.as_tensor(st.finals[i], device=ctx.device)
        _, g = valgrad(st.model.params, x)
        st.grads[i] = g.detach().cpu().numpy()


def reference(ctx) -> MixtureReference:
    return MixtureReference(ctx.path(ctx.config["checkpoint"]), device=ctx.device)


def check(ctx, st: State, control=None):
    """The program's readings against the float64 mixture; with
    ``control`` (the cell file's ``{"mode", "grad_mode"}``) also the
    control's on the same walkers."""
    program_outputs(ctx, st)
    obs, out = st.obs, outputs(st)
    free_program(st)
    ref = reference(ctx)
    if control is None:
        return readings(ctx, obs, out, ref)
    ctrl = control_outputs(ctx, obs, out, ref, control["mode"], control["grad_mode"])
    return readings(ctx, obs, out, ref), readings(ctx, obs, ctrl, ref)
