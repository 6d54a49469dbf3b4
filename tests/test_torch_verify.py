"""The port's verification battery, offline (the targets of
``tests/test_verify.py``): on the synthetic split the structural checks
pass on the CPU and the golden checks (which need the real dataset and
the reference's h5 files) report SKIP."""

import json

import numpy as np
import pytest

from _torch_pair import one_torch_thread  # noqa: F401

from tpu21cmvae_torch.verify import (
    Check,
    _run,
    check_band_mask,
    check_batched_vs_single,
    format_report,
    run_verification,
    write_report,
)


@pytest.fixture(scope="module")
def report(splits):
    return run_verification(splits, quick_epochs=5, dataset_label="synthetic", device="cpu")


def test_structural_checks_pass(report):
    """JAX's battery, check for check: four PASS, the two golden SKIP."""
    by_name = {c["name"]: c for c in report["checks"]}
    assert [c["name"] for c in report["checks"]] == [
        "direct_golden", "ae_golden", "batched_vs_single", "band_mask_consistency",
        "inference_stack", "deploy_artifact"]
    for name in ("batched_vs_single", "band_mask_consistency", "inference_stack",
                 "deploy_artifact"):
        assert by_name[name]["status"] == "PASS", by_name[name]
    assert by_name["direct_golden"]["status"] == by_name["ae_golden"]["status"] == "SKIP"
    assert report["ok"] and (report["pass"], report["fail"], report["skip"]) == (4, 0, 2)
    assert "platforms ('cpu',)" in by_name["deploy_artifact"]["detail"]


def test_report_roundtrip(report, tmp_path):
    path = write_report(report, str(tmp_path / "report.json"))
    assert json.loads(open(path).read()) == report
    text = format_report(report)
    assert "batched_vs_single" in text and "4 passed" in text


def test_failure_detected(splits):
    """A broken model turns a check into FAIL, not a crash."""

    class Broken:
        frequencies = np.linspace(40, 120, splits.n_bins)

        def predict(self, par):
            out = np.zeros((np.atleast_2d(par).shape[0], splits.n_bins))
            out += 1.0 if out.shape[0] > 1 else 0.0  # batched disagrees with single
            return out[0] if np.asarray(par).ndim == 1 else out

    assert check_batched_vs_single(splits, Broken()).status == "FAIL"
    assert check_band_mask(splits, Broken()).status == "PASS"  # model-independent


def test_crash_is_fail_not_exception():
    def boom() -> Check:
        raise RuntimeError("kaput")

    c = _run("boom", boom)
    assert c.status == "FAIL" and "kaput" in c.detail


def test_cli_verify_smoke(capsys, tmp_path):
    from tpu21cmvae_torch.__main__ import main

    main(["verify", "--out", str(tmp_path / "r.json"), "--device", "cpu"])
    assert "verification report" in capsys.readouterr().out
    loaded = json.loads(open(tmp_path / "r.json").read())
    assert loaded["ok"] and loaded["skip"] == 2
