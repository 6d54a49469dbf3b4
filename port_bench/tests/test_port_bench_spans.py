"""The arithmetic over the program's spans (``port_bench/spans.py``) on a
hand-built slice, and traced runs of the generators on the CPU at a
test's size with the program's recording open."""

import dataclasses

import pytest
import torch

from port_bench import harness, readers, spans
from tpu21cmvae_torch.utils.profiling import Span

K2 = "void (anonymous namespace)::fused_gram_mma_kernel<2, 0>(float const*, float*)"
K1 = "void fused_mlp_kernel<64>(float const*, float*, int, MlpNet)"
LAUNCH_K2 = "k2_fused_loglik_gram_mma"


def _span(name, layer, start, end, parent=None):
    return Span(name, layer, start, end, parent, None, 1)


def _slice():
    """One sampler call: two value calls, each a kernel-value wrapper
    around K2 around its launch; the device runs two K2 kernels, a copy
    and a short fill."""
    sp = [
        _span("sample_posterior", "sampler loop", 0, 1000),
        _span("draws", "sampler loop", 50, 950, 0),
        _span("kernel_value", "likelihood wrappers", 100, 400, 1),
        _span("K2", "likelihood wrappers", 150, 350, 2),
        _span(LAUNCH_K2, "kernels", 200, 300, 3),
        _span("kernel_value", "likelihood wrappers", 500, 800, 1),
        _span("K2", "likelihood wrappers", 520, 780, 5),
        _span(LAUNCH_K2, "kernels", 600, 650, 6),
    ]
    device = [[K2, 320, 480, "kernel"], ["Memcpy DtoH", 480, 490, "copy"],
              [K2, 700, 900, "kernel"], ["Memset", 920, 930, "fill"]]
    # each K2 kernel's runtime launch, inside its launch span
    return {"work": {"draws": 1}, "trace": {"lo_ns": 0, "hi_ns": 1100, "device": device,
                                            "spans": sp, "counters": {},
                                            "launch_ns": {320: 210, 700: 610}}}


def test_each_gap_is_cut_by_the_span_the_host_was_in():
    rec = _slice()
    gaps = spans.attributed_gaps(rec)
    # [0, 320): sample_posterior 50, draws 50, kernel_value 50, K2 50, the
    # launch 100, K2 again 20
    assert [(ns, s and s.name) for ns, s in gaps[:6]] == [
        (50, "sample_posterior"), (50, "draws"), (50, "kernel_value"), (50, "K2"),
        (100, LAUNCH_K2), (20, "K2")]
    # [930, 1100): draws 20, sample_posterior 50, then 100 after the call
    assert [(ns, s and s.name) for ns, s in gaps[-3:]] == [
        (20, "draws"), (50, "sample_posterior"), (100, None)]
    shares = spans.idle_shares(rec)
    assert shares == pytest.approx({"sampler": 100 * 200 / 1100, "wrapper": 100 * 420 / 1100,
                                    "entry": 0.0, "outside": 100 * 100 / 1100})
    assert sum(shares.values()) == pytest.approx(readers.idle_pct(rec), abs=1e-9)


def test_the_shares_add_up_to_the_idle_share_on_a_ragged_timeline():
    # overlapping operations, one reaching past the slice, spans of two
    # threads and an entry point
    sp = [_span("device_call", "entry point", 10, 400),
          _span("run", "entry point", 60, 300, 0),
          _span("K1", "likelihood wrappers", 70, 290, 1),
          _span("k1_fused_mlp", "kernels", 100, 120, 2),
          Span("sample_posterior", "sampler loop", 350, 700, None, 4, 2)]
    dev = [[K1, 130, 260, "kernel"], [K1, 200, 380, "kernel"], ["Memcpy", 390, 395, "copy"],
           [K1, 650, 900, "kernel"]]
    rec = {"work": {"signals": 1}, "trace": {"lo_ns": 5, "hi_ns": 800, "device": dev,
                                             "spans": sp}}
    shares = spans.idle_shares(rec)
    assert sum(shares.values()) == pytest.approx(readers.idle_pct(rec), abs=1e-9)
    # [5, 130): 5 before any span, device_call 50, run 10, K1 30 + 10 and
    # its launch 20; [380, 390) and [395, 650) in sample_posterior, opened
    # last of the two roots open then
    assert shares == pytest.approx({"entry": 100 * 60 / 795, "wrapper": 100 * 60 / 795,
                                    "sampler": 100 * 265 / 795, "outside": 100 * 5 / 795})


def test_launches_pair_with_the_kernels_they_launched():
    rec = _slice()
    pairs = spans.launch_pairs(rec, "k2")
    assert [(s.start_ns, op[1]) for s, op in pairs] == [(200, 320), (600, 700)]
    # launch ends 300 → start 320, 650 → 700: the median of 20 and 50 ns
    assert spans.launch_lead_us(rec, ("k2", "k3")) == pytest.approx(0.035)
    assert spans.launch_lead_us(rec, ("k3",)) is None
    # a kernel record the profiler dropped takes no other launch's kernel
    rec["trace"]["device"].pop(0)
    assert [(s.start_ns, op[1]) for s, op in spans.launch_pairs(rec, "k2")] == [(600, 700)]
    assert spans.launch_lead_us(rec, ("k2",)) == pytest.approx(0.05)
    # nor does a launch whose runtime call was dropped, or one outside any span
    rec["trace"]["launch_ns"] = {700: 660}
    assert spans.launch_pairs(rec, "k2") == []


def test_nothing_is_set_against_the_device_where_its_clock_ran_off():
    rec = _slice()
    rec["trace"]["clock_least_ns"] = -4_000  # within the slack
    assert spans.idle_shares(rec) is not None and spans.launch_lead_us(rec, ("k2",)) is not None
    rec["trace"]["clock_least_ns"] = -6_000
    assert not spans.clock_holds(rec)
    assert spans.idle_shares(rec) is None and spans.attributed_gaps(rec) is None
    assert spans.launch_lead_us(rec, ("k2",)) is None
    # what reads the host alone still reads
    assert spans.wrapper_us(rec) == pytest.approx(0.225)


class _Event:
    def __init__(self, name, start, cid, on_card):
        self._v = name, start, cid, on_card

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU


def test_launch_calls_join_their_kernels_by_correlation_id():
    events = [_Event("cudaLaunchKernel", 4000, 2, False), _Event(K2, 5050, 2, True),
              _Event("cudaMemcpyAsync", 6000, 4, False), _Event("Memcpy DtoH", 7000, 4, True),
              _Event(K2, 9000, 5, True)]  # its launch call's record dropped
    host, device = spans._launch_times(events)
    assert host == {2: 4000} and {c: e.start_ns() for c, e in device.items()} == {
        2: 5050, 4: 7000, 5: 9000}


def test_wrapper_time_leaves_out_its_launches():
    rec = _slice()
    # the outermost wrappers: 300 ns less a 100 ns launch, 300 less 50
    assert spans.wrapper_self_ns(rec["trace"]["spans"]) == [200, 250]
    assert spans.wrapper_us(rec) == pytest.approx(0.225)
    assert spans.wrapper_us(rec, names={"K2"}) is None  # K2 runs inside kernel_value
    assert spans.entry_us(rec) is None


def test_entry_time_and_cache_hits():
    sp = [_span("device_call", "entry point", 0, 600),
          _span("K1", "likelihood wrappers", 10, 500, 0),
          _span("k1_fused_mlp", "kernels", 100, 200, 1),
          _span("device_call", "entry point", 700, 1100)]
    rec = {"trace": {"spans": sp, "device": [], "counters": {
        "operand.hit": 6, "operand.fold": 1, "memo.hit": 2, "memo.miss": 1, "other": 9}}}
    assert spans.entry_us(rec) == pytest.approx(0.5)
    assert spans.wrapper_us(rec, names={"K1"}) == pytest.approx(0.39)
    assert spans.cache_hit_pct(rec) == pytest.approx(80.0)
    assert spans.cache_hit_pct({"trace": {"counters": {"other": 3}}}) is None
    # a parent's program records nothing: no spans, no counters, no reading
    bare = {"work": {"draws": 1}, "trace": {"lo_ns": 0, "hi_ns": 10, "device": []}}
    for read in (spans.idle_shares, spans.wrapper_us, spans.entry_us, spans.cache_hit_pct):
        assert read(bare) is None
    assert spans.launch_lead_us(bare, ("k2", "k3")) is None


SMALL = {
    "posterior": {"n_walkers": 16, "n_warmup": 2, "n_steps": 2, "checked_chains": 1,
                  "warmup": {"n_warmup": 1, "n_steps": 0}},
    "emulate": {"rows": 256, "n_batches": 2, "sample_rows": 8, "pick_cycle": 4,
                "trace_skip": 0, "trace_calls": 2},
}


@pytest.mark.parametrize("cell", ["direct-hmc-65k", "ae-hmc-65k", "direct-mh-65k",
                                  "direct-predict-1m"])
def test_a_traced_cpu_run_records_the_programs_spans(cell, monkeypatch):
    from tpu21cmvae_torch.models.direct import DirectEmulator

    torch.set_num_threads(2)
    # the direct model's samplers through the kernel wrappers (their plain
    # versions on the CPU), as on the card
    monkeypatch.setattr(DirectEmulator, "_backend", lambda self: "kernel")
    ctx = harness.load(cell, seed=2**31 + 5, seconds=0.0, trace=True, device="cpu")
    ctx = dataclasses.replace(ctx, traffic={**ctx.traffic, **SMALL[ctx.traffic["generator"]]})
    drv = harness.generator(ctx)
    monkeypatch.setattr(drv, "profiled", spans.recorded)
    rec = drv.window(ctx, drv.setup(ctx), 0.0)
    tr = rec["trace"]
    names = {s.name for s in tr["spans"]}
    assert tr["lo_ns"] <= min(s.start_ns for s in tr["spans"])
    assert max(s.end_ns for s in tr["spans"]) <= tr["hi_ns"]
    if cell == "direct-predict-1m":
        assert {"device_call", "split_rows", "run", "merge_rows", "K1"} <= names
        assert spans.entry_us(rec) > spans.wrapper_us(rec, names={"K1"}) > 0
    else:
        assert {"sample_posterior", "start", "warmup", "draws", "collect"} <= names
        assert spans.wrapper_us(rec) > 0
    assert spans.cache_hit_pct(rec) == 100.0
    assert spans.idle_shares(rec) is None  # no device operations on the CPU
