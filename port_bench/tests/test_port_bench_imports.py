"""What the benchmark loads: nothing of JAX or of the JAX package in the
process that runs it, compared by whole top-level names, and nothing of
the program in the reference."""

import json
import os
import subprocess
import sys

from port_bench import harness

_LOADED = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(body):
    code = _LOADED.format(root=harness.ROOT, body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_what_it_runs_load_no_jax():
    body = """
import os
from port_bench import harness, calibrate, readers, reference, trace, yardstick
from port_bench.generators import emulate, posterior
for f in os.listdir(os.path.join(harness.ROOT, "port_bench", "metrics")):
    harness.reader(f[:-3])
import tpu21cmvae_torch.models.direct, tpu21cmvae_torch.models.autoencoder
import tpu21cmvae_torch.parallel.inference, tpu21cmvae_torch.sampling.gradient
import tpu21cmvae_torch.sampling.mh
"""
    loaded = _loaded(body)
    assert "tpu21cmvae_torch" in loaded  # the port is there, and is not the JAX package
    assert not loaded & {"jax", "jaxlib", "flax", "tpu21cmvae"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("import port_bench.reference")
    assert not loaded & {"tpu21cmvae_torch", "tpu21cmvae", "jax", "jaxlib", "flax"}


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu21cmvae_torch_fake", sys)
    assert "tpu21cmvae" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu21cmvae.models", sys)
    assert harness.forbidden_modules() == ["tpu21cmvae"]
