"""Worker for the port's two-process test (``test_torch_multihost.py``).

Launched twice (process 0 and 1): joins the gloo group through
``multihost_init``, builds the global mesh of two CPU entries per
process, serves a batch through ``ShardedEmulator`` over it, runs
``sample_mh``, ``sample_pt`` and ``nested_sampling_batch``
with the seeds of the one-process reference the parent computed and
asserts them seed-identical (sharding distributes rows, it must not
change them), then ``dp_fit`` over 2 epochs within rtol 1e-4 of the
parent's one-device ``fit``, and four members of ``fit_scan_stack``,
two trained in each process, bit for bit the parent's. Imports torch and the port only.

Usage: python _torch_multihost_worker.py <pid> <port> <ref_npz>
"""

import sys


def main():
    pid, port, ref_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from tpu21cmvae_torch.nested import nested_sampling_batch
    from tpu21cmvae_torch.parallel import dp_fit, make_mesh, multihost_init
    from tpu21cmvae_torch.sampling.mh import sample_mh
    from tpu21cmvae_torch.sampling.pt import sample_pt
    from tpu21cmvae_torch.utils.config import TrainConfig

    multihost_init(coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid,
                   initialization_timeout=60)
    mesh = make_mesh(devices=["cpu", "cpu"])
    assert mesh.size == 4 and mesh.processes == (0, 0, 1, 1), mesh
    assert mesh.process_index == pid and len(mesh.local_devices) == 2

    from tpu21cmvae_torch.parallel import ShardedEmulator

    raw = np.arange(13 * 7, dtype=np.float32).reshape(13, 7)
    served = ShardedEmulator(lambda p, x: torch.cumsum(x, dim=1), (), mesh=mesh)
    np.testing.assert_array_equal(served(raw), np.cumsum(raw, axis=1))

    ref = np.load(ref_path)
    mu, sig = torch.tensor(ref["mu"]), torch.tensor(ref["sig"])
    mus2 = torch.tensor(ref["mus2"])
    bounds = ref["bounds"]

    def loglik(params, x):
        z = (x - mu) / sig
        return -0.5 * torch.sum(z * z, dim=-1)

    def loglik_multi(params, x):
        z = (x.reshape(2, -1, 3) - mus2[:, None, :]) / sig
        return (-0.5 * torch.sum(z * z, dim=-1)).reshape(-1)

    res = sample_mh(loglik, None, n_walkers=16, n_steps=60, n_warmup=40, thin=5,
                    bounds=bounds, seed=5, mesh=mesh, device="cpu")
    for k in ("chain", "final", "logp", "accept_rate"):
        np.testing.assert_array_equal(getattr(res, k), ref[f"mh_{k}"], err_msg=k)
    pt = sample_pt(loglik, None, n_rungs=4, n_walkers=8, n_steps=40, n_warmup=30, thin=5,
                   bounds=bounds, seed=7, mesh=mesh, device="cpu")
    for k in ("chain", "final", "swap_rate"):
        np.testing.assert_array_equal(getattr(pt, k), ref[f"pt_{k}"], err_msg=k)
    nb = nested_sampling_batch(loglik_multi, None, 2, bounds=bounds, n_live=32, n_batch=4,
                               n_mh=6, max_iters=256, iters_per_chunk=16, seed=9, mesh=mesh,
                               device="cpu")
    np.testing.assert_array_equal([r.logz for r in nb], ref["nb_logz"])
    np.testing.assert_array_equal([r.n_iters for r in nb], ref["nb_iters"])

    params = tuple({"w": torch.tensor(ref[f"w{i}"]), "b": torch.tensor(ref[f"b{i}"])}
                   for i in range(2))

    def loss_fn(p, x, y):
        h = torch.relu(x @ p[0]["w"] + p[0]["b"])
        return torch.mean((h @ p[1]["w"] + p[1]["b"] - y) ** 2, dim=-1)

    cfg = TrainConfig(epochs=2, batch_size=64, early_stop_patience=None, plateau_patience=None)
    _, _, hist = dp_fit(params, loss_fn, ref["x"], ref["y"], ref["xv"], ref["yv"], cfg, mesh)
    np.testing.assert_allclose(hist.loss, ref["fit_loss"], rtol=1e-4)
    np.testing.assert_allclose(hist.val_loss, ref["fit_val_loss"], rtol=1e-4)
    for i, layer in enumerate(params):
        np.testing.assert_allclose(layer["w"].detach().numpy(), ref[f"fit_w{i}"], rtol=1e-4,
                                   atol=1e-5)
    from tpu21cmvae_torch.train.scan import fit_scan_stack

    stack = tuple({k: torch.tensor(np.stack([ref[f"{k}{i}"] * (1 + 0.1 * m) for m in range(4)]))
                   for k in ("w", "b")} for i in range(2))
    _, state, member_hist = fit_scan_stack(stack, loss_fn, ref["x"], ref["y"], ref["xv"],
                                             ref["yv"], cfg, seeds=[0, 1, 2, 3], mesh=mesh)
    for i, layer in enumerate(stack):
        np.testing.assert_array_equal(layer["w"].numpy(), ref[f"stack_w{i}"])
    np.testing.assert_array_equal(state.mu[0].numpy(), ref["stack_mu0"])
    np.testing.assert_array_equal(np.asarray(state.step), ref["stack_steps"])
    np.testing.assert_array_equal([h.loss for h in member_hist], ref["stack_loss"])
    print(f"OK {pid}", flush=True)


if __name__ == "__main__":
    main()
