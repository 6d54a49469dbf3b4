"""The deep ensemble's cell on the CPU, at the sizes
``test_port_bench_faults.py`` runs: sound runs ``correct``, the control
and planted faults not, a mixture that leaves a member out among them;
and the member metrics' readers on hand-built records."""

import dataclasses

import pytest
import torch

from port_bench import harness, members, yardstick
from port_bench.tests.test_port_bench_faults import SEED, SMALL, _broken_likelihood, _unchanged
from tpu21cmvae_torch.utils.profiling import Span

CELL = "ensemble-hmc-65k"
DIRECT = {"family": "direct", "n_params": 7, "hidden_dims": [288, 352, 288, 224],
          "n_bins": 451}
ENSEMBLE = dict(DIRECT, family="ensemble", members=3)
K3 = "void (anonymous namespace)::fused_gram_mma_kernel<2, 1>(float const*, float*)"
K2 = "void (anonymous namespace)::fused_gram_mma_kernel<2, 0>(float const*, float*)"
MEMBER_METRICS = ["k3_roofline.members", "mfu_pct.members", "mixture_us.members",
                  "tall_declined_pct.members"]


def read(name, record):
    return harness.reader(name)(record)


def small_ctx(cell, seed=SEED):
    """The cell at the one-model sampler cells' test sizes."""
    torch.set_num_threads(2)
    ctx = harness.load(cell, seed=seed, seconds=0.0, trace=False, device="cpu")
    return dataclasses.replace(ctx, traffic={**ctx.traffic, **SMALL["posterior"]})


def correct(cell):
    return harness.run(small_ctx(cell), 0.0)["correct"]


def test_sound_runs_are_correct():
    assert correct(CELL)


def test_the_control_fails():
    ctx = small_ctx(CELL, seed=SEED + 1)
    drv = harness.generator(ctx)
    st = drv.setup(ctx)
    drv.window(ctx, st, 0.0)
    program, control = drv.check(ctx, st, control=harness._json(
        harness.ROOT, "port_bench", "workloads", CELL + ".json")["control"])
    assert harness.passes(harness.compare(program, ctx.limits))
    assert not harness.passes(harness.compare(control, ctx.limits))


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    _unchanged(monkeypatch, "tpu21cmvae_torch.sampling.gradient", "hmc_step")
    assert not correct(CELL)


@pytest.mark.parametrize("how", ["half", "altered"])
def test_a_broken_likelihood(how, monkeypatch):
    """Half of the batch left out, or an answer altered, where the
    mixture reaches the sampler (the seam the one-model cells' faults
    are planted at)."""
    _broken_likelihood(monkeypatch, CELL, how)
    assert not correct(CELL)


def test_a_mixture_that_leaves_a_member_out(monkeypatch):
    """The mixture over the first M − 1 members' values and gradients,
    the − log M kept: off by about log(M / (M − 1)) where the members
    agree."""
    from tpu21cmvae_torch.models.ensemble import MixtureValGrad

    def dropped(self, stacked, raw):
        lm, gm = (t[:-1] for t in self.members(stacked, raw))
        w = torch.softmax(lm, dim=0)
        return torch.logsumexp(lm, dim=0) - self._log_m, torch.sum(w[..., None] * gm, dim=0)

    monkeypatch.setattr(MixtureValGrad, "__call__", dropped)
    assert not correct(CELL)


def _slice(device, **extra):
    return {"lo_ns": 0, "hi_ns": 5_000_000, "device": device, "rows_value": 0,
            "rows_valgrad": 0, "iterations": 1, **extra}


def _records(rows=65536):
    """A one-model and an ensemble record over the same five K3 launches,
    each four times the one model's least time."""
    least = yardstick.least_seconds(DIRECT, "k3", rows)
    dev = [[K3, i * 1_000_000, i * 1_000_000 + int(4 * least * 1e9), "kernel"]
           for i in range(5)]
    return [{"config": cfg, "rows_per_launch": rows, "work": {"draws": 1},
             "trace": _slice(dev, rows_valgrad=5 * rows)} for cfg in (DIRECT, ENSEMBLE)]


def test_member_shares_count_m_members_work():
    one, ens = _records()
    assert read("k3_roofline", one) == pytest.approx(25.0, rel=1e-5)  # ns rounding
    assert read("k3_roofline.members", ens) == pytest.approx(3 * read("k3_roofline", one))
    assert read("mfu_pct.members", ens) == pytest.approx(3 * read("mfu_pct.draws", one))
    assert members.least_seconds(ENSEMBLE, "k3", 65536) == pytest.approx(
        3 * yardstick.least_seconds(DIRECT, "k3", 65536))
    # one model's configuration has no members to count
    assert read("k3_roofline.members", one) is None and read("mfu_pct.members", one) is None


def _spans():
    """Two mixture calls, each around a K3 wrapper around its launch."""
    return [Span("sample_posterior", "sampler loop", 0, 1000, None, 0, 1),
            Span("mixture", "likelihood wrappers", 100, 400, 0, 0, 1),
            Span("K3", "likelihood wrappers", 150, 350, 1, 0, 1),
            Span("k3_fused_loglik_grad_gram_mma", "kernels", 200, 300, 2, 0, 1),
            Span("mixture", "likelihood wrappers", 500, 800, 0, 0, 1),
            Span("K3", "likelihood wrappers", 520, 780, 4, 0, 1)]


def test_mixture_time_less_its_member_wrapper():
    """Less the nested wrapper and launch spans, and less the runtime
    calls inside a mixture span: one outside its K3, one overlapping it,
    one inside it; a call after both spans counts nowhere."""
    runtime = [[110, 130], [140, 160], [250, 260], [790, 795], [810, 900]]
    rec = {"work": {"draws": 1}, "trace": _slice([], spans=_spans(), runtime_ns=runtime)}
    # (300 − 20 − 210) and (300 − 260 − 5) ns
    assert read("mixture_us.members", rec) == pytest.approx(0.0525)
    rec["trace"]["runtime_ns"] = []
    # (300 − 200) and (300 − 260) ns
    assert read("mixture_us.members", rec) == pytest.approx(0.070)
    # a record without the runtime calls (a slice not taken by this
    # generator) reads nothing
    del rec["trace"]["runtime_ns"]
    assert read("mixture_us.members", rec) is None


@pytest.mark.parametrize("declined, calls, want", [(1823, {"k3.route.mma": 1823}, 100.0),
                                                   (0, {"k3.route.tall": 1800}, 0.0),
                                                   (3, {"k3.route.mma": 6}, 50.0)])
def test_tall_declined_share(declined, calls, want):
    counters = {"k3.tall_declined": declined, "memo.hit": 1, **calls}
    rec = {"work": {"draws": 1}, "trace": _slice([], counters=counters)}
    assert read("tall_declined_pct.members", rec) == pytest.approx(want)


def test_member_readers_read_nothing_where_nothing_is_recorded():
    """Without a K3 launch, the spans, the counter or the slice (as a
    program without them, or a run without a trace, leaves the record),
    each member reader returns None and raises nothing."""
    _, ens = _records()
    bare = {"config": ENSEMBLE, "rows_per_launch": 65536, "work": {"draws": 1},
            "trace": _slice([[K2, 0, 1000, "kernel"]], counters={"k3.route.mma": 4},
                            spans=[s for s in _spans() if s.name != "mixture"])}
    for name in MEMBER_METRICS:
        assert read(name, {"config": ENSEMBLE, "rows_per_launch": 65536, "work": {"draws": 1}}) \
            is None
        if name != "mfu_pct.members":  # the rows are the benchmark's own count
            assert read(name, bare) is None
    assert read("k3_roofline.members", ens) is not None
