"""Two processes, one ``torch.distributed`` group: the port's
``multihost_init`` on the pattern of ``tests/test_multihost.py``.

The parent computes one-process references; two worker processes
(``_torch_multihost_worker.py``) join a gloo group on 127.0.0.1 at a
free port, form the global mesh of four CPU entries, split a batch
through ``ShardedEmulator`` and rerun the same samplers with a mesh
(seed-identical), ``dp_fit`` (rtol 1e-4) and the member-sharded
``fit_scan_stack`` (bit for bit). Each
worker's ``communicate`` has its own timeout, and both are killed when
one expires, so a hang fails the test instead of the suite.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

WORKER = os.path.join(os.path.dirname(__file__), "_torch_multihost_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _references(path):
    """The one-process runs the workers must reproduce, and their inputs."""
    from tpu21cmvae_torch.nested import nested_sampling_batch
    from tpu21cmvae_torch.sampling.mh import sample_mh
    from tpu21cmvae_torch.sampling.pt import sample_pt
    from tpu21cmvae_torch.train.loop import fit
    from tpu21cmvae_torch.train.scan import fit_scan_stack
    from tpu21cmvae_torch.utils.config import TrainConfig

    mu = np.array([0.3, -0.6, 1.2], np.float32)
    sig = np.array([0.5, 0.25, 0.8], np.float32)
    bounds = np.stack([mu - 10 * sig, mu + 10 * sig], axis=1)
    mus2 = np.stack([mu, mu + 0.5 * sig]).astype(np.float32)
    tmu, tsig, tmus2 = map(torch.tensor, (mu, sig, mus2))

    def loglik(params, x):
        z = (x - tmu) / tsig
        return -0.5 * torch.sum(z * z, dim=-1)

    def loglik_multi(params, x):
        z = (x.reshape(2, -1, 3) - tmus2[:, None, :]) / tsig
        return (-0.5 * torch.sum(z * z, dim=-1)).reshape(-1)

    res = sample_mh(loglik, None, n_walkers=16, n_steps=60, n_warmup=40, thin=5,
                    bounds=bounds, seed=5, device="cpu")
    pt = sample_pt(loglik, None, n_rungs=4, n_walkers=8, n_steps=40, n_warmup=30, thin=5,
                   bounds=bounds, seed=7, device="cpu")
    nb = nested_sampling_batch(loglik_multi, None, 2, bounds=bounds, n_live=32, n_batch=4,
                               n_mh=6, max_iters=256, iters_per_chunk=16, seed=9, device="cpu")

    rng = np.random.default_rng(0)
    data = {k: rng.normal(size=shape).astype(np.float32) for k, shape in
            (("x", (200, 7)), ("y", (200, 20)), ("xv", (50, 7)), ("yv", (50, 20)))}
    init = {"w0": rng.normal(0, 0.3, (7, 16)), "b0": np.zeros(16),
            "w1": rng.normal(0, 0.3, (16, 20)), "b1": np.zeros(20)}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    params = tuple({"w": torch.tensor(init[f"w{i}"]), "b": torch.tensor(init[f"b{i}"])}
                   for i in range(2))

    def loss_fn(p, x, y):
        h = torch.relu(x @ p[0]["w"] + p[0]["b"])
        return torch.mean((h @ p[1]["w"] + p[1]["b"] - y) ** 2, dim=-1)

    cfg = TrainConfig(epochs=2, batch_size=64, early_stop_patience=None, plateau_patience=None)
    _, _, hist = fit(params, loss_fn, data["x"], data["y"], data["xv"], data["yv"], cfg)
    stack = tuple({k: torch.tensor(np.stack([init[f"{k}{i}"] * (1 + 0.1 * m) for m in range(4)]))
                   for k in ("w", "b")} for i in range(2))
    _, state, member_hist = fit_scan_stack(stack, loss_fn, data["x"], data["y"], data["xv"],
                                             data["yv"], cfg, seeds=[0, 1, 2, 3])
    np.savez(
        path, mu=mu, sig=sig, bounds=bounds, mus2=mus2,
        mh_chain=res.chain, mh_final=res.final, mh_logp=res.logp, mh_accept_rate=res.accept_rate,
        pt_chain=pt.chain, pt_final=pt.final, pt_swap_rate=pt.swap_rate,
        nb_logz=np.array([r.logz for r in nb]), nb_iters=np.array([r.n_iters for r in nb]),
        fit_loss=np.array(hist.loss), fit_val_loss=np.array(hist.val_loss),
        **{f"fit_w{i}": layer["w"].detach().numpy() for i, layer in enumerate(params)},
        **{f"stack_w{i}": layer["w"].detach().numpy() for i, layer in enumerate(stack)},
        stack_mu0=state.mu[0].numpy(), stack_steps=np.asarray(state.step),
        stack_loss=np.array([h.loss for h in member_hist]),
        **data, **init,
    )


@pytest.mark.distributed
def test_two_process_samplers_and_dp_fit(tmp_path):
    """Two gloo ranks on one host: each rank's sharded ``sample_mh``,
    ``sample_pt`` and ``nested_sampling_batch`` equal the one-process
    runs, its ``dp_fit`` follows the one-process ``fit``, and four
    members trained over the mesh (two per process) are the one-process
    ``fit_scan_stack``'s bit for bit."""
    torch.set_num_threads(1)
    ref = tmp_path / "ref.npz"
    _references(ref)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, str(pid), str(port), str(ref)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail("the two workers did not finish within 120 s")
    for rc, out, err in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{out[-2000:]}\n{err[-3000:]}"
    assert "OK 0" in outs[0][1] and "OK 1" in outs[1][1]


def test_multihost_init_refuses_without_its_addresses():
    """Nothing detects a cluster: the three keywords are required."""
    from tpu21cmvae_torch.parallel import multihost_init

    for kw in ({}, dict(coordinator_address="127.0.0.1:1", num_processes=2)):
        with pytest.raises(ValueError, match="process_id"):
            multihost_init(**kw)
