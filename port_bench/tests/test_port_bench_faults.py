"""The check against faults and against the control, at sizes a test run
holds, on the CPU (the port's plain versions) under each cell's own
limits. A run past the look for a card sees ``correct`` come out false
with the timed path broken underneath: a step that returns its state
unchanged, half of the batch left out with the mean of the rest in its
place, an answer altered where it is produced. The control, the
reference at the lower precision the cell's file names put in the
program's place, fails the same limits on the same walkers or rows."""

import dataclasses

import pytest
import torch

from port_bench import harness

SMALL = {
    "posterior": {"n_walkers": 128, "n_warmup": 20, "n_steps": 20, "checked_chains": 1,
                  "warmup": {"n_warmup": 2, "n_steps": 0}},
    "emulate": {"rows": 2048, "n_batches": 2, "sample_rows": 64, "pick_cycle": 4},
}
SAMPLERS = ["direct-hmc-65k", "ae-hmc-65k", "direct-mh-65k"]
SEED = 2**31 + 11


def small_ctx(cell, seed=SEED):
    torch.set_num_threads(2)
    ctx = harness.load(cell, seed=seed, seconds=0.0, trace=False, device="cpu")
    return dataclasses.replace(ctx, traffic={**ctx.traffic, **SMALL[ctx.traffic["generator"]]})


def correct(cell):
    return harness.run(small_ctx(cell), 0.0)["correct"]


@pytest.mark.parametrize("cell", SAMPLERS + ["direct-predict-1m"])
def test_sound_runs_are_correct(cell):
    assert correct(cell)


def _unchanged(monkeypatch, module, name):
    import importlib

    mod = importlib.import_module(module)
    real = getattr(mod, name)

    def still(*args, **kwargs):
        out = real(*args, **kwargs)
        if name == "hmc_step":  # (logp_and_grad, params, y, lp, glp, …)
            return (args[2], args[3], args[4], out[3])
        return (args[2], args[3], out[2])  # mh_step: (score, params, x, lp, …)

    monkeypatch.setattr(mod, name, still)


@pytest.mark.parametrize("cell", SAMPLERS)
def test_a_step_that_returns_its_state_unchanged(cell, monkeypatch):
    if "hmc" in cell:
        _unchanged(monkeypatch, "tpu21cmvae_torch.sampling.gradient", "hmc_step")
    else:
        _unchanged(monkeypatch, "tpu21cmvae_torch.sampling.mh", "mh_step")
    assert not correct(cell)


def _broken_likelihood(monkeypatch, cell, how):
    """Wrap the likelihood the sampler scores with (its rows' split over
    a mesh is the seam every sampler passes its likelihood through)."""
    import tpu21cmvae_torch.sampling.gradient as gradient
    import tpu21cmvae_torch.sampling.mh as mh

    mod = gradient if "hmc" in cell else mh
    real = mod._shard_rows

    def shard(fn, mesh, n):
        inner = real(fn, mesh, n)

        def broken(params, x):
            out = inner(params, x)
            val, rest = (out[0], out[1:]) if isinstance(out, tuple) else (out, ())
            val = val.clone()
            if how == "half":
                h = val.shape[0] // 2
                val[h:] = val[:h].mean()
                rest = tuple(torch.cat([r[:h], r[:h].mean(0).expand_as(r[h:])]) for r in rest)
            else:  # every 64th row's answer one nat off
                val[::64] = val[::64] + 1.0
            return (val, *rest) if rest else val

        return broken

    monkeypatch.setattr(mod, "_shard_rows", shard)


@pytest.mark.parametrize("how", ["half", "altered"])
@pytest.mark.parametrize("cell", SAMPLERS)
def test_a_broken_likelihood(cell, how, monkeypatch):
    _broken_likelihood(monkeypatch, cell, how)
    assert not correct(cell)


@pytest.mark.parametrize("how", ["half", "altered"])
def test_broken_signals(how, monkeypatch):
    from tpu21cmvae_torch.parallel.inference import ShardedEmulator

    real = ShardedEmulator.device_call

    def broken(self, x):
        out = real(self, x).clone()
        if how == "half":
            h = out.shape[0] // 2
            out[h:] = out[:h].mean(0)
        else:
            out[:, 0] += 1.0  # one mK in the first bin of every signal
        return out

    monkeypatch.setattr(ShardedEmulator, "device_call", broken)
    assert not correct("direct-predict-1m")


@pytest.mark.parametrize("cell", SAMPLERS + ["direct-predict-1m"])
def test_the_control_fails(cell):
    ctx = small_ctx(cell, seed=SEED + 1)
    drv = harness.generator(ctx)
    st = drv.setup(ctx)
    drv.window(ctx, st, 0.0)
    ctrl = harness._json(harness.ROOT, "port_bench", "workloads", cell + ".json")["control"]
    program, control = drv.check(ctx, st, control=ctrl)
    assert harness.passes(harness.compare(program, ctx.limits))
    assert not harness.passes(harness.compare(control, ctx.limits))
