"""``run.py`` without a card, and in a checkout that holds only the
benchmark: it fails and prints no result, and never falls back to the
CPU."""

import os
import shutil
import subprocess
import sys

from port_bench import harness


def _run(args, cwd, code=None):
    cmd = [sys.executable] + (["-c", code] if code else args)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    out = _run(["port_bench/run.py", "--workload", "direct-hmc-65k", "--seed", "2147483659",
                "--seconds", "1", "--trace", "0"], harness.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "port_bench"), tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    # past the look for a card, on the CPU: the program is not there to run
    code = ("import sys; sys.path[0] = '.'\n"
            "from port_bench import harness\n"
            "ctx = harness.load('direct-mh-65k', seed=1, seconds=0.0, trace=False, "
            "device='cpu', root='.')\n"
            "print(harness.run(ctx, 0.0))\n")
    out = _run(None, tmp_path, code)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
