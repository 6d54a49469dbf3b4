"""The port's profiling utilities (``tpu21cmvae_torch.utils.profiling``)
on the CPU: timing, the span and counter recorder, a Chrome trace with
the program's spans beside the profiler's events, the spans and counters
the hot path records, and the NaN trap; on a card, that every kernel's
launch call lies in the launch span that issued it."""

import glob
import json
import os
import threading

import numpy as np
import pytest
import torch

from tpu21cmvae_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THETA = np.array([0.1, 40.0, 10.0, 0.06, 1.2, 1.0, 30.0])


def test_benchmark_times_every_call():
    calls = []
    res = profiling.benchmark(lambda x: calls.append(x), 3, iters=5, warmup=2,
                              items_per_call=10, name="noop")
    assert len(calls) == 7 and len(res.times_s) == 5
    assert res.name == "noop" and res.items_per_sec > 0 and "noop" in res.summary()
    assert res.min_s <= res.mean_s and res.std_s >= 0


def test_spans_nest_under_their_parents_and_share_their_root():
    with profiling.recording() as rec:
        with profiling.span("a", profiling.ENTRY):
            with profiling.span("b", profiling.WRAPPERS):
                with profiling.span("c", profiling.KERNELS):
                    pass
            with profiling.span("d", profiling.ENTRY):
                pass
        with profiling.span("e", profiling.SAMPLER):
            pass
    a, b, c, d, e = rec.spans
    assert [s.name for s in rec.spans] == list("abcde")
    assert [s.layer for s in rec.spans] == [profiling.ENTRY, profiling.WRAPPERS, profiling.KERNELS,
                                            profiling.ENTRY, profiling.SAMPLER]
    assert [s.parent for s in rec.spans] == [None, 0, 1, 0, None]
    assert [s.root for s in rec.spans] == [0, 0, 0, 0, 4]
    assert (a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns
            <= d.end_ns <= a.end_ns <= e.start_ns <= e.end_ns)
    assert {s.thread for s in rec.spans} == {threading.get_ident()}


def test_a_second_threads_spans_do_not_nest_under_the_first():
    opened, done = threading.Event(), threading.Event()

    def other():
        assert opened.wait(10)
        with profiling.span("other", profiling.SAMPLER):
            with profiling.span("inner", profiling.KERNELS):
                pass
        done.set()

    with profiling.recording() as rec:
        worker = threading.Thread(target=other)
        worker.start()
        with profiling.span("main", profiling.ENTRY):
            opened.set()
            assert done.wait(10)
        worker.join(10)
    assert not worker.is_alive()
    index = {s.name: i for i, s in enumerate(rec.spans)}
    main, o, inner = (rec.spans[index[n]] for n in ("main", "other", "inner"))
    assert main.parent is None and main.root == index["main"]
    assert o.parent is None and o.root == index["other"]
    assert inner.parent == index["other"] and inner.root == index["other"]
    assert main.thread == threading.get_ident() != o.thread == inner.thread
    # the other thread's span lies inside the main one's time, not under it
    assert main.start_ns <= o.start_ns <= o.end_ns <= main.end_ns


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    noop = profiling.span("x", profiling.KERNELS)
    assert noop is profiling.span("y", profiling.ENTRY)  # the one shared context

    def no_clock():
        raise AssertionError("the clock was read with recording off")

    monkeypatch.setattr(profiling.time, "time_ns", no_clock)
    with profiling.span("x", profiling.KERNELS):
        profiling.count("operand.hit", 5)
    monkeypatch.undo()
    with profiling.recording() as rec:
        profiling.count("operand.hit", 5)
        profiling.count("operand.hit")
        profiling.count("memo.hit")
        with profiling.span("x", profiling.KERNELS):
            pass
    with profiling.span("after", profiling.KERNELS):
        profiling.count("operand.hit", 5)
    assert [s.name for s in rec.spans] == ["x"]
    assert rec.counters == {"operand.hit": 6, "memo.hit": 1}
    with pytest.raises(RuntimeError, match="already open"):
        with profiling.recording():
            with profiling.recording():
                pass
    assert profiling.span("z", profiling.KERNELS) is noop


def test_trace_writes_the_programs_spans_beside_the_profilers_events(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("t21_region", profiling.ENTRY):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = glob.glob(os.path.join(str(tmp_path), "trace_*.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    (mine,) = [e for e in events if e.get("name") == "t21_region"]
    assert mine["ph"] == "X" and mine["cat"] == profiling.ENTRY
    assert mine["args"] == {"layer": profiling.ENTRY, "span": 0, "parent": None, "root": 0}
    # the matmul ran inside the span: both on the profiler's clock
    (mm,) = [e for e in events if e.get("name") == "aten::matmul"]
    assert mine["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= mine["ts"] + mine["dur"]
    assert profiling.span("after", profiling.KERNELS) is profiling.span("again", profiling.KERNELS)


def test_a_region_that_raises_closes_its_spans_and_its_recording(tmp_path):
    with pytest.raises(ValueError):
        with profiling.recording() as rec:
            with profiling.span("outer", profiling.ENTRY):
                with profiling.span("inner", profiling.KERNELS):
                    raise ValueError("in the launch")
    outer, inner = rec.spans
    assert inner.parent == 0 and outer.start_ns <= inner.end_ns <= outer.end_ns
    assert profiling.span("after", profiling.KERNELS) is profiling.span("x", profiling.ENTRY)
    with pytest.raises(ValueError):
        with profiling.trace(str(tmp_path)):
            with profiling.span("t21_region", profiling.ENTRY):
                raise ValueError("in the region")
    assert profiling.span("after", profiling.KERNELS) is profiling.span("x", profiling.ENTRY)
    with profiling.recording() as rec:  # a new recording starts with an empty stack
        with profiling.span("fresh", profiling.SAMPLER):
            pass
    assert [(s.name, s.parent, s.root) for s in rec.spans] == [("fresh", None, 0)]


def _direct(monkeypatch):
    """The shipped direct emulator on the CPU, its samplers routed
    through the kernel wrappers (which run their plain versions here)."""
    from tpu21cmvae_torch.models.direct import DirectEmulator

    torch.set_num_threads(1)
    model = DirectEmulator.from_checkpoint(
        os.path.join(ROOT, "pretrained/direct_synthetic.npz"), device="cpu")
    monkeypatch.setattr(model, "_backend", lambda: "kernel")
    return model


def _named(rec, layer):
    return [s for s in rec.spans if s.layer == layer]


def _sampler_phases(rec):
    """The root ``sample_posterior`` and its four phases, in order."""
    root, *phases = _named(rec, profiling.SAMPLER)
    assert root.name == "sample_posterior" and root.parent is None
    assert [s.name for s in phases] == ["start", "warmup", "draws", "collect"]
    assert all(rec.spans[s.parent] is root for s in phases)
    assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))
    return root, phases


@pytest.mark.parametrize("sampler", ["hmc", "mh"])
def test_a_sampler_call_records_its_phases_wrappers_and_counters(sampler, monkeypatch):
    model = _direct(monkeypatch)
    obs = model.predict(THETA)
    kw = (dict(n_leapfrog=3, jitter=False, thin=1) if sampler == "hmc" else dict(thin=1))
    call = dict(sampler=sampler, n_walkers=16, n_warmup=2, n_steps=2, **kw)
    model.sample_posterior(obs, 25.0, **call)  # builds, folds and memoizes the wrapper
    with profiling.recording() as rec:
        model.sample_posterior(obs, 25.0, **call)
    root, phases = _sampler_phases(rec)
    wrappers = _named(rec, profiling.WRAPPERS)
    assert {s.root for s in rec.spans} == {0}
    if sampler == "hmc":
        # the first gradient, then 4 iterations of 3 leapfrog steps, each a K3 call
        assert [s.name for s in wrappers] == ["K3"] * 13
        assert {rec.spans[s.parent].name for s in wrappers} == {"start", "warmup", "draws"}
        assert rec.counters == {"memo.hit": 1, "operand.hit": 13}
    else:
        # the first value, then one proposal batch per iteration: the
        # kernel value wrapper around K2
        outer = [s for s in wrappers if s.name == "kernel_value"]
        inner = [s for s in wrappers if s.name == "K2"]
        assert len(outer) == len(inner) == 5
        assert all(rec.spans[s.parent] is o for s, o in zip(inner, outer))
        assert rec.counters == {"memo.hit": 1, "operand.hit": 5}
    assert not _named(rec, profiling.KERNELS)  # the plain versions launch nothing


def test_emulation_records_the_entry_point_and_k1(monkeypatch):
    from tpu21cmvae_torch.parallel.inference import ShardedEmulator
    from tpu21cmvae_torch.parallel.mesh import make_mesh

    model = _direct(monkeypatch)
    emulator = ShardedEmulator.for_model(model, mesh=make_mesh([torch.device("cpu")]),
                                         backend="kernel")
    x = torch.as_tensor(np.tile(THETA, (16, 1)), dtype=torch.float32)
    emulator.device_call(x)
    with profiling.recording() as rec:
        on_device = emulator.device_call(x)
        on_host = emulator(x.numpy()[:5])
    assert [(s.name, s.layer, s.parent) for s in rec.spans] == [
        ("device_call", profiling.ENTRY, None), ("split_rows", profiling.ENTRY, 0),
        ("run", profiling.ENTRY, 0), ("K1", profiling.WRAPPERS, 2),
        ("merge_rows", profiling.ENTRY, 0),
        ("call", profiling.ENTRY, None), ("split_rows", profiling.ENTRY, 5),
        ("run", profiling.ENTRY, 5), ("K1", profiling.WRAPPERS, 7),
        ("merge_rows", profiling.ENTRY, 5)]
    assert [s.root for s in rec.spans] == [0] * 5 + [5] * 5
    assert rec.counters == {"operand.hit": 2}
    assert on_device.shape == (16, 451) and on_host.shape == (5, 451)


def test_the_autoencoders_sampler_records_its_autograd_wrapper():
    from tpu21cmvae_torch.models.autoencoder import AutoEncoderEmulator

    torch.set_num_threads(1)
    model = AutoEncoderEmulator.from_checkpoint(
        os.path.join(ROOT, "pretrained/ae_synthetic.npz"), device="cpu")
    obs = model.predict(THETA)
    with profiling.recording() as rec:
        model.sample_posterior(obs, 25.0, n_walkers=16, n_warmup=2, n_steps=2, thin=1,
                               jitter=False, n_leapfrog=3)
    _sampler_phases(rec)
    wrappers = _named(rec, profiling.WRAPPERS)
    assert [s.name for s in wrappers] == ["autograd_valgrad"] * 13
    assert rec.counters == {"memo.miss": 1}


def _ensemble(monkeypatch):
    """The shipped three-member ensemble on the CPU, its samplers routed
    through the member-batched kernel wrappers (their plain versions
    here)."""
    from tpu21cmvae_torch.models.ensemble import DeepEnsemble

    torch.set_num_threads(1)
    ens = DeepEnsemble.load(os.path.join(ROOT, "pretrained/ensemble_direct"), device="cpu")
    monkeypatch.setattr(ens, "_backend", lambda: "kernel")
    return ens


def test_each_mixture_call_is_a_span_around_its_member_wrapper(monkeypatch):
    ens = _ensemble(monkeypatch)
    obs = ens.predict(THETA)
    x = torch.as_tensor(np.tile(THETA, (16, 1)), dtype=torch.float32)
    valgrad = ens.loglik_and_grad_fn(obs, 25.0, backend="kernel", grad_precision="default")
    value = ens.loglik_fn(obs, 25.0, backend="kernel")
    with profiling.recording() as rec:
        valgrad(ens.params, x)
        value(ens.params, x)
    # the value's member-batched wrapper is the kernel value shell around K2
    assert [(s.name, s.layer, s.parent) for s in rec.spans] == [
        ("mixture", profiling.WRAPPERS, None), ("K3", profiling.WRAPPERS, 0),
        ("mixture", profiling.WRAPPERS, None), ("kernel_value", profiling.WRAPPERS, 2),
        ("K2", profiling.WRAPPERS, 3)]
    for outer, inner in (rec.spans[:2], rec.spans[2:4]):
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    # HMC: the first gradient, then 4 iterations of 3 leapfrog steps, each
    # one mixture call around one member-batched K3
    call = dict(n_walkers=16, n_warmup=2, n_steps=2, n_leapfrog=3, jitter=False, thin=1)
    ens.sample_posterior(obs, 25.0, **call)
    with profiling.recording() as rec:
        ens.sample_posterior(obs, 25.0, **call)
    _sampler_phases(rec)
    mixtures = [i for i, s in enumerate(rec.spans) if s.name == "mixture"]
    assert len(mixtures) == 13
    assert [(s.name, rec.spans[s.parent].name) for s in _named(rec, profiling.WRAPPERS)
            if s.name != "mixture"] == [("K3", "mixture")] * 13
    assert all(rec.spans[i + 1].parent == i for i in mixtures)


def test_a_mixture_records_nothing_with_recording_off(monkeypatch):
    ens = _ensemble(monkeypatch)
    obs = ens.predict(THETA)
    fn = ens.loglik_and_grad_fn(obs, 25.0, backend="kernel", grad_precision="default")
    x = torch.as_tensor(np.tile(THETA, (8, 1)), dtype=torch.float32)
    fn(ens.params, x)  # fold before the clock goes

    def no_clock():
        raise AssertionError("the clock was read with recording off")

    def not_asked(n_rows):
        raise AssertionError("the declined flag was computed with recording off")

    monkeypatch.setattr(profiling.time, "time_ns", no_clock)
    k3 = fn.members
    monkeypatch.setattr(k3, "tall_declined", not_asked)
    ops = k3.operands(ens.params)
    k3.sm_count = 132
    fn(ens.params, x)
    k3._launch_kernel(lambda o, rows, h: None, ops, torch.zeros(65_536, 7))
    monkeypatch.undo()
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


TALL, NOT_TALL = ("high", "default"), ("high", "high")


@pytest.mark.parametrize("members", [None, 3])
@pytest.mark.parametrize("tiers", [TALL, NOT_TALL], ids=["high-default", "high-high"])
def test_the_tall_kernel_declines_a_member_axis(monkeypatch, tiers, members):
    """The decision on the CPU, with an H100's 132 SMs: a K3 call is
    declined where the one-model wrapper would take the tall kernel (its
    pair, (bf16x3, bf16), and a batch from the crossover on) and the call
    carries a member axis; inside a recording each member-batched K3 call
    adds 1 or 0 to ``k3.tall_declined`` beside its route (the launch
    stubbed), a one-model call nothing."""
    from tpu21cmvae_torch.ops.kernels.fused_loglik import (
        make_fused_loglik_grad_gram,
        tall_crossover,
    )

    ens = _ensemble(monkeypatch)
    obs = ens.predict(THETA)
    fn = make_fused_loglik_grad_gram(ens.config, ens.normalizer, obs, 25.0, precision=tiers[0],
                                     grad_precision=tiers[1], members=members, device="cpu")
    assert fn.tall_plan is None or members is None
    assert not fn.tall_declined(65_536)  # no card: no SMs, no crossover
    fn.sm_count = 132  # as read from an H100
    edge = tall_crossover(132)
    batches = (1, 4096, edge - 1, edge, 65_536)
    want = [tiers == TALL and members is not None and n >= edge for n in batches]
    assert [fn.tall_declined(n) for n in batches] == want
    ops = fn.operands(ens.params if members else ens.members[0].params)
    monkeypatch.setattr("tpu21cmvae_torch.ops.kernels.fused_loglik._loglik_grad_gram_tall_cuda",
                        lambda *a: None)
    with profiling.recording() as rec:
        for n in batches:
            fn._launch_kernel(lambda o, x, rows: None, ops, torch.zeros(n, 7))
    routes = {k: v for k, v in rec.counters.items() if k.startswith("k3.route.")}
    assert sum(routes.values()) == len(batches)
    if members is None:
        assert "k3.tall_declined" not in rec.counters
    else:
        assert routes == {"k3.route.mma": len(batches)}
        assert rec.counters["k3.tall_declined"] == sum(want)


def test_device_memory_stats_is_none_on_the_cpu():
    assert profiling.device_memory_stats("cpu") is None


def test_debug_guard_traps_a_nan():
    x = torch.tensor([1.0, -1.0])
    assert torch.isnan(torch.sqrt(x)).any()  # no trap outside the guard
    with pytest.raises(FloatingPointError, match="NaN"):
        with profiling.debug_guard():
            torch.sqrt(x)
    with profiling.debug_guard():
        torch.exp(torch.tensor([1000.0]))  # Inf is trapped only on request
    with pytest.raises(FloatingPointError, match="Inf"):
        with profiling.debug_guard(infs=True):
            torch.exp(torch.tensor([1000.0]))
    assert np.isnan(torch.sqrt(x).numpy()).any()  # the mode is gone after the region


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels launch only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_each_launch_call_lies_in_one_launch_span_and_its_kernel_follows_it(cuda):
    """The spans are on the profiler's host clock on the card: each K1, K2
    and K3 kernel's runtime launch call (joined by the profiler's
    correlation id) lies inside one launch span, and on an idle device the
    kernel starts no later than 2 ms after that span's end. That the kernel
    starts after the span opened is not checked: the profiler's device
    timestamps run off its host timestamps in some profiles (kernels that
    seem to start up to 17 ms before their launch call, on an H100)."""
    from torch.profiler import ProfilerActivity, profile

    from tpu21cmvae_torch.models.direct import DirectEmulator
    from tpu21cmvae_torch.ops.kernels.fused_loglik import (
        make_fused_loglik_grad_gram,
        make_fused_loglik_gram,
    )
    from tpu21cmvae_torch.ops.kernels.fused_mlp import make_fused_emulate

    model = DirectEmulator.from_checkpoint(
        os.path.join(ROOT, "pretrained/direct_synthetic.npz"), device=cuda)
    obs = model.predict(THETA)
    args = (model.config, model.normalizer, obs, 25.0)
    fns = [make_fused_emulate(model.config, model.normalizer, device=cuda),
           make_fused_loglik_gram(*args, device=cuda),
           make_fused_loglik_grad_gram(*args, grad_precision="default", device=cuda)]
    x = torch.as_tensor(np.tile(THETA, (4096, 1)), dtype=torch.float32, device=cuda)
    for fn in fns:  # build, load and fold before the profile
        fn(model.params, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.recording() as rec:
            for _ in range(20):
                for fn in fns:
                    fn(model.params, x)
                    torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    on_card = torch.autograd.DeviceType.CUDA
    host = {e.correlation_id(): e.start_ns() for e in events
            if e.device_type() != on_card and "aunchKernel" in e.name()}
    ran = [(e.start_ns(), e.name(), host[e.correlation_id()]) for e in events
           if e.device_type() == on_card and e.correlation_id() in host]
    launches = _named(rec, profiling.KERNELS)
    assert len(launches) == 60
    checked = 0
    for start, name, launched in ran:
        if "fused_" not in name:
            continue
        (s,) = [s for s in launches if s.start_ns <= launched <= s.end_ns]
        assert start <= s.end_ns + 2_000_000, (s.name, name, start - s.end_ns)
        checked += 1
    # the profiler may drop a record now and then; most launches are checked
    assert checked >= 55
