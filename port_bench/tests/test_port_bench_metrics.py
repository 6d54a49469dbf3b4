"""The metric arithmetic on synthetic records and timelines."""

import pytest

from port_bench import harness, readers, trace, yardstick

DIRECT = {"family": "direct", "n_params": 7, "hidden_dims": [288, 352, 288, 224],
          "n_bins": 451}
K3 = "void (anonymous namespace)::fused_gram_mma_kernel<2, 1>(float const*, float*)"
K2 = "void (anonymous namespace)::fused_gram_mma_kernel<2, 0>(float const*, float*)"
K1 = "void fused_mlp_kernel<64>(float const*, float*, int, MlpNet)"


def read(name, record):
    return harness.reader(name)(record)


def test_rate_counts_a_stall_in_the_window():
    # three calls of 1 s and a 2 s stall between two of them: 5 s of window
    rec = {"window_s": 5.0, "work": {"draws": 3 * 1000}, "call_s": [1.0, 1.0, 1.0]}
    assert read("draws_per_s", rec) == pytest.approx(600.0)
    assert read("signals_per_s", rec) is None


def test_p95_over_every_call():
    calls = [0.026] * 95 + [0.040] * 5
    rec = {"work": {"signals": 100}, "call_s": calls}
    # linear interpolation between order statistics 94 and 95 (0-based), of 100
    assert read("predict_ms_p95", rec) == pytest.approx(26.0 + 0.05 * 14.0)
    assert yardstick.quantile([3.0, 1.0, 2.0], 0.5) == 2.0
    assert yardstick.quantile([], 0.95) is None


def _slice(device, lo=0, hi=10_000_000, **extra):
    return {"lo_ns": lo, "hi_ns": hi, "device": device, "rows_value": 0, "rows_valgrad": 0,
            **extra}


def test_idle_share_of_a_timeline():
    # busy 0–2 ms and 3–6 ms (two overlapping kernels and a copy) of 10 ms
    dev = [[K3, 0, 1_500_000, "kernel"], [K3, 1_000_000, 2_000_000, "kernel"],
           ["Memcpy DtoH", 3_000_000, 4_000_000, "copy"], [K2, 4_000_000, 6_000_000, "kernel"]]
    rec = {"work": {"draws": 1}, "trace": _slice(dev, iterations=4)}
    assert read("device_idle_pct.draws", rec) == pytest.approx(50.0)
    assert read("device_idle_pct.signals", rec) is None
    assert read("kernels_per_iter.draws", rec) == pytest.approx(3 / 4)
    assert yardstick.union_seconds([(0, 5), (2, 3), (8, 12)], 0, 10) == pytest.approx(7e-9)
    gaps = trace.idle_gaps(rec["trace"])
    assert [g[0] for g in gaps] == ["end of slice", "before Memcpy DtoH"]
    assert [g[1] for g in gaps] == pytest.approx([4e-3, 1e-3])
    assert trace.device_ops(rec["trace"])[0] == [K3, pytest.approx(2.5e-3)]


def test_rooflines_and_mfu_count_the_models_work():
    rows = 65536
    least = yardstick.least_seconds(DIRECT, "k3", rows)
    dev = [[K3, i * 1_000_000, i * 1_000_000 + int(4 * least * 1e9), "kernel"]
           for i in range(5)]
    rec = {"config": DIRECT, "rows_per_launch": rows, "work": {"draws": 1},
           "trace": _slice(dev, hi=5_000_000, iterations=1, rows_valgrad=5 * rows)}
    assert read("k3_roofline", rec) == pytest.approx(25.0, rel=1e-4)
    assert read("k2_roofline", rec) is None and read("k1_roofline", rec) is None
    flops = 5 * 4 * 370_304 * rows
    assert read("mfu_pct.draws", rec) == pytest.approx(100 * flops / (5e-3 * 989e12))
    # a kernel as fast as the bound reads 100 %, never more
    dev = [[K3, 0, int(round(least * 1e9)), "kernel"]]
    rec["trace"] = _slice(dev, iterations=1)
    assert read("k3_roofline", rec) == pytest.approx(100.0, rel=1e-3)


def test_k1_rows_come_from_the_slice_when_counted():
    rows = 1 << 20
    least = yardstick.least_seconds(DIRECT, "k1", rows // 2)
    dev = [[K1, i * 10**7, i * 10**7 + int(2 * least * 1e9), "kernel"] for i in range(4)]
    rec = {"config": DIRECT, "rows_per_launch": rows, "work": {"signals": 2 * rows},
           "trace": _slice(dev, hi=4 * 10**7, rows_value=2 * rows)}
    # four launches carried the slice's two calls of 2^20 rows: 2^19 rows each
    assert read("k1_roofline", rec) == pytest.approx(50.0, rel=1e-6)


def test_mfu_counts_the_rows_asked_for():
    # 10^9 rows of value in a 1 s slice: 2 · 370,304 · 10^9 FLOP against 989 TFLOP/s
    rec = {"config": DIRECT, "rows_per_launch": 1, "work": {"signals": 1},
           "trace": _slice([], hi=10**9, rows_value=10**9)}
    assert read("mfu_pct.signals", rec) == pytest.approx(100 * 2 * 370_304e9 / 989e12)
    assert read("mfu_pct.draws", rec) is None


def test_setup_and_enqueue():
    assert read("setup_s", {"setup_s": 7.5}) == 7.5
    assert read("enqueue_us.signals", {"enqueue_s": [1e-4, 3e-4]}) == pytest.approx(200.0)
    assert read("enqueue_us.signals", {}) is None


def test_kernel_names():
    assert readers.KERNELS["k3"].search(K3) and not readers.KERNELS["k2"].search(K3)
    assert readers.KERNELS["k2"].search(K2) and not readers.KERNELS["k3"].search(K2)
    assert readers.KERNELS["k2"].search("_ZN12_GLOBAL__N_121fused_gram_mma_kernelILi2ELi0EEvPKf")
    assert readers.KERNELS["k3"].search("void fused_loglik_grad_gram_f32_kernel<32>(float)")
    wide = "void (anonymous namespace)::fused_loglik_grad_gram_kernel<32>(float const*)"
    assert not any(p.search(wide) for p in readers.KERNELS.values())
    assert readers.KERNELS["k1"].search(K1)


def test_the_rows_a_sampler_scores_are_counted():
    # the AE's HMC through its own entry point: every likelihood call is
    # a value and gradient of all the walkers
    import os

    import numpy as np
    import torch

    from tpu21cmvae_torch.models.autoencoder import AutoEncoderEmulator

    torch.set_num_threads(1)
    model = AutoEncoderEmulator.from_checkpoint(
        os.path.join(harness.ROOT, "pretrained/ae_synthetic.npz"), device="cpu")
    obs = model.predict(np.array([0.1, 40.0, 10.0, 0.06, 1.2, 1.0, 30.0]))
    with trace.counted(model, {"value": 0, "valgrad": 0}) as rows, trace.profiled() as tr:
        model.sample_posterior(obs, 25.0, n_walkers=16, n_warmup=2, n_steps=2, thin=1,
                               jitter=False, n_leapfrog=3)
    # the first gradient, then 4 iterations of 3 leapfrog steps
    assert rows == {"value": 0, "valgrad": 16 * (1 + 4 * 3)}
    assert "loglik_fn" not in vars(model) and "loglik_and_grad_fn" not in vars(model)
    assert tr["device"] == [] and tr["hi_ns"] > tr["lo_ns"]
