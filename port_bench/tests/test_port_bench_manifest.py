"""The manifest and the files it names: names, units, cells, configs,
traffic, limits and metric readers, each found by name."""

import json
import os
import re

import pytest

from port_bench import harness, yardstick

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(*parts):
    with open(os.path.join(ROOT, *parts)) as fh:
        return json.load(fh)


def test_keys_and_paths():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["port_bench"] and m["command"][1] == "port_bench/run.py"
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    m = manifest()
    names = [e["name"] for e in m[section]]
    assert len(names) == len(set(names))
    for e in m[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_each_cell_finds_its_files():
    m = manifest()
    configs = {c["name"] for c in m["configs"]}
    for w in m["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        traffic = _json("port_bench", "traffic", w["traffic"] + ".json")
        assert os.path.exists(os.path.join(ROOT, "port_bench", "generators",
                                           traffic["generator"] + ".py"))
        limits = _json("port_bench", "workloads", w["name"] + ".json")["limits"]
        assert limits and all(v["limit"] > 0 for v in limits.values())
    for metric in m["end_to_end"] + m["per_layer"]:
        assert callable(harness.reader(metric["name"]))


def test_every_config_has_a_cell_and_its_file():
    m = manifest()
    used = {w["config"] for w in m["workloads"]}
    for c in m["configs"]:
        assert c["name"] in used
        cfg = _json(c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert os.path.exists(os.path.join(ROOT, cfg["checkpoint"]))


def test_layer_metrics_move_what_their_cells_report():
    m = manifest()
    e2e = {e["name"]: e for e in m["end_to_end"]}
    cells = [w["name"] for w in m["workloads"]]
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for metric in m["per_layer"]:
        moved = e2e[metric["moves"]]
        for cell in metric["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", cells)
    for cell in cells:
        assert any(cell in e.get("workloads", cells) for n, e in e2e.items() if n != "setup_s")
        assert any(cell in p["workloads"] for p in m["per_layer"])


def test_at_most_a_quarter_of_cells_take_four_chips():
    cells = manifest()["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_model_work_by_hand():
    m = manifest()
    cfgs = {c["name"]: _json(c["file"]) for c in m["configs"]}
    direct, ae = cfgs["direct_21cmvae"], cfgs["ae_21cmvae"]
    assert yardstick.macs_per_row(direct) == (7 * 288 + 288 * 352 + 352 * 288 + 288 * 224
                                              + 224 * 451) == 370_304
    assert yardstick.macs_per_row(ae) == (7 * 352 + 2 * 352 * 352 + 352 * 224 + 224 * 9
                                          + 9 * 32 + 32 * 352 + 352 * 451) == 501_440
    assert yardstick.kernel_flops(direct, "k3", 65536) == 4 * 370_304 * 65536
    # K1 at 1 M rows is bound by its products: 2 · 370,304 · 2^20 / 989e12
    assert yardstick.least_seconds(direct, "k1", 1 << 20) == pytest.approx(
        2 * 370_304 * (1 << 20) / 989e12)
