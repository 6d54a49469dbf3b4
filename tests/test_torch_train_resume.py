"""Training checkpoints between the packages: the port resumes a run the
JAX package checkpointed, the JAX package resumes one the port
checkpointed, and both equal the uninterrupted JAX run (the patterns of
``tests/test_resume.py``).

Tolerances: across packages, histories within 2e-6 relative and weights
within 1e-5 relative (1e-6 absolute), the drift measured in
``tests/test_torch_train.py``; learning rates, stop and best epochs
exactly. A port run against a port run, on the same CPU and thread
count, is bit for bit.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from _torch_pair import jax_seam, make_pair, one_torch_thread  # noqa: F401
from test_torch_train import (
    W_ATOL,
    W_RTOL,
    Setup,
    assert_history,
    assert_weights,
    jax_cfg,
    port_cfg,
)
from tpu21cmvae.models.checkpoint import read_checkpoint_meta
from tpu21cmvae.train.loop import fit as jax_fit
from tpu21cmvae_torch.models.checkpoint import load_checkpoint
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.train.adam import adam_state_from_arrays
from tpu21cmvae_torch.train.loop import fit, latest_checkpoint, load_train_checkpoint
from tpu21cmvae_torch.utils.tree import tree_leaves

# tests/test_resume.py's CFG8: the plateau fires, so the rate is restored too
CFG8 = dict(epochs=8, batch_size=64, learning_rate=0.003, early_stop_patience=None,
            plateau_patience=2, plateau_factor=0.5, plateau_min_delta=10.0,
            plateau_min_lr=1e-4)
EARLY = dict(CFG8, early_stop_patience=3, early_stop_min_delta=0.0)


@pytest.fixture(scope="module")
def setup(splits, normalizer):
    return Setup(splits, normalizer, sizes=(7, 24, 451))


@pytest.fixture(scope="module")
def uninterrupted(setup):
    return {name: jax_fit(setup.params, setup.jax_loss, setup.x, setup.y, setup.xv,
                          setup.yv, jax_cfg(**kw))
            for name, kw in (("cfg8", CFG8), ("early", EARLY))}


def port_fit(setup, kw, **fit_kw):
    with jax_seam():
        return fit(setup.port_params(), setup.port_loss, *setup.data(), port_cfg(**kw),
                   **fit_kw)


def jax_run(setup, kw, **fit_kw):
    return jax_fit(setup.params, setup.jax_loss, setup.x, setup.y, setup.xv, setup.yv,
                   jax_cfg(**kw), **fit_kw)


def test_checkpoint_files_match_jax_layout(tmp_path, setup):
    """The port writes the files JAX writes: names, leaf shapes and dtypes,
    structure string and metadata keys."""
    kw = dict(CFG8, epochs=5)
    port_fit(setup, kw, checkpoint_dir=str(tmp_path / "port"), checkpoint_every=2)
    jax_run(setup, kw, checkpoint_dir=str(tmp_path / "jax"), checkpoint_every=2)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "ckpt_000001.npz", "ckpt_000003.npz", "ckpt_000004.npz"]
    assert latest_checkpoint(str(tmp_path / "port")).endswith("ckpt_000004.npz")
    for name in names:
        with np.load(tmp_path / "port" / name) as a, np.load(tmp_path / "jax" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            ha, hb = (json.loads(bytes(f["__header__"]).decode()) for f in (a, b))
            assert {k: ha[k] for k in ("format_version", "treedef", "n_leaves")} == {
                k: hb[k] for k in ("format_version", "treedef", "n_leaves")}
            for k in a.files:
                if k != "__header__":
                    assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        mine = read_checkpoint_meta(str(tmp_path / "port" / name))
        theirs = read_checkpoint_meta(str(tmp_path / "jax" / name))
        assert mine.keys() == theirs.keys() and mine["epoch"] == theirs["epoch"]
        assert mine["history"]["lr"] == theirs["history"]["lr"]


@pytest.mark.parametrize("name,kw", [("cfg8", CFG8), ("early", EARLY)])
def test_port_resumes_a_jax_checkpoint(tmp_path, setup, uninterrupted, name, kw):
    ckpt = str(tmp_path / "ck")
    jax_run(setup, dict(kw, epochs=4), checkpoint_dir=ckpt, checkpoint_every=100)
    tp, state, th = port_fit(setup, kw, checkpoint_dir=ckpt, resume=True)
    jp, js, jh = uninterrupted[name]
    assert_history(th, jh)
    assert_weights(tp, jp)
    assert state.step == int(js.step)


@pytest.mark.parametrize("name,kw", [("cfg8", CFG8), ("early", EARLY)])
def test_jax_resumes_a_port_checkpoint(tmp_path, setup, uninterrupted, name, kw):
    ckpt = str(tmp_path / "ck")
    port_fit(setup, dict(kw, epochs=4), checkpoint_dir=ckpt, checkpoint_every=100)
    jp, js, jh = jax_run(setup, kw, checkpoint_dir=ckpt, resume=True)
    want_p, want_s, want_h = uninterrupted[name]
    np.testing.assert_allclose(jh.loss, want_h.loss, rtol=2e-6)
    np.testing.assert_allclose(jh.val_loss, want_h.val_loss, rtol=2e-6)
    assert jh.lr == want_h.lr
    assert (jh.stopped_epoch, jh.best_epoch) == (want_h.stopped_epoch, want_h.best_epoch)
    assert int(js.step) == int(want_s.step)
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(want_p)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=W_RTOL, atol=W_ATOL)


def test_resume_is_the_uninterrupted_run(tmp_path, setup):
    """Port against port: 4 epochs, a restart, 4 more — bit for bit the
    8-epoch run, the restored weights in the caller's tensors."""
    pa, sa, ha = port_fit(setup, CFG8)
    ckpt = str(tmp_path / "ck")
    port_fit(setup, dict(CFG8, epochs=4), checkpoint_dir=ckpt, checkpoint_every=100)
    params = setup.port_params()
    tensors = tree_leaves(params)
    with jax_seam():
        pb, sb, hb = fit(params, setup.port_loss, *setup.data(), port_cfg(**CFG8),
                         checkpoint_dir=ckpt, resume=True)
    assert hb.loss == ha.loss and hb.val_loss == ha.val_loss and hb.lr == ha.lr
    assert all(a is b for a, b in zip(tree_leaves(pb), tensors))
    for a, b in zip(tree_leaves(pb) + sb.mu + sb.nu, tree_leaves(pa) + sa.mu + sa.nu):
        assert torch.equal(a, b)
    assert sb.step == sa.step


def test_resume_after_early_stop_restores_best_epoch(tmp_path, setup):
    """Resuming a run that already stopped reports the stopped run's best
    epoch and weights (``tests/test_resume.py``'s pattern)."""
    kw = dict(CFG8, epochs=20, early_stop_patience=2, early_stop_min_delta=10.0)
    ckpt = str(tmp_path / "ck")
    pa, _, ha = port_fit(setup, kw, checkpoint_dir=ckpt, checkpoint_every=100)
    assert ha.stopped_epoch is not None and ha.best_epoch is not None
    pb, _, hb = port_fit(setup, kw, checkpoint_dir=ckpt, resume=True)
    assert (hb.stopped_epoch, hb.best_epoch) == (ha.stopped_epoch, ha.best_epoch)
    for a, b in zip(tree_leaves(pa), tree_leaves(pb)):
        assert torch.equal(a, b)


def test_resume_after_completion_is_a_noop_and_without_checkpoint_trains(tmp_path, setup):
    kw = dict(CFG8, epochs=3)
    ckpt = str(tmp_path / "ck")
    pa, _, ha = port_fit(setup, kw, checkpoint_dir=ckpt)
    pb, _, hb = port_fit(setup, kw, checkpoint_dir=ckpt, resume=True)
    assert hb.loss == ha.loss
    for a, b in zip(tree_leaves(pa), tree_leaves(pb)):
        assert torch.equal(a, b)
    _, _, hc = port_fit(setup, dict(CFG8, epochs=2), checkpoint_dir=str(tmp_path / "empty"),
                        resume=True)
    assert len(hc.loss) == 2


def test_checkpoint_rotation(tmp_path, setup):
    """Only the newest ``checkpoint_keep`` files survive; resume works
    from the newest."""
    kw = dict(CFG8, epochs=6)
    ckpt = str(tmp_path / "ck")
    port_fit(setup, kw, checkpoint_dir=ckpt, checkpoint_every=1, checkpoint_keep=2)
    assert sorted(os.listdir(ckpt)) == ["ckpt_000004.npz", "ckpt_000005.npz"]
    _, _, hb = port_fit(setup, kw, checkpoint_dir=ckpt, resume=True)
    assert len(hb.loss) == 6
    port_fit(setup, kw, checkpoint_dir=str(tmp_path / "all"), checkpoint_every=1,
             checkpoint_keep=None)
    assert len(os.listdir(tmp_path / "all")) == 6


def test_loader_takes_jax_state_and_refuses_other_structures(tmp_path, setup):
    """``load_train_checkpoint`` binds a JAX file's leaves to the port's
    params and Adam state; JAX's ``AdamState`` as arrays continues a run
    as JAX's own continuation does; a file of another structure raises."""
    ckpt = str(tmp_path / "ck")
    jp, js, _ = jax_run(setup, dict(CFG8, epochs=2), checkpoint_dir=ckpt)
    params, state, best, meta = load_train_checkpoint(latest_checkpoint(ckpt),
                                                      setup.port_params(), device="cpu")
    assert best is None and meta["epoch"] == 1 and state.step == int(js.step)
    for a, b in zip(tree_leaves(params) + state.mu,
                    jax.tree_util.tree_leaves(jp) + jax.tree_util.tree_leaves(js.mu)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    kw = dict(CFG8, epochs=2, seed=5)
    jq, _, jh = jax_fit(jp, setup.jax_loss, setup.x, setup.y, setup.xv, setup.yv,
                        jax_cfg(**kw), opt_state=js)
    tstate = adam_state_from_arrays(np.asarray(js.step),
                                    jax.tree_util.tree_map(np.asarray, js.mu),
                                    jax.tree_util.tree_map(np.asarray, js.nu), device="cpu")
    with jax_seam():
        tq, _, th = fit(params, setup.port_loss, *setup.data(), port_cfg(**kw),
                        opt_state=tstate)
    assert_history(th, jh)
    assert_weights(tq, jq)

    with pytest.raises(ValueError, match="structure"):
        load_train_checkpoint(latest_checkpoint(ckpt), setup.port_params()[:1], device="cpu")
    leaves, _ = load_checkpoint(latest_checkpoint(ckpt))
    assert len(leaves) == 4 * 4 + 1  # best_weights, step, mu, nu, params


def test_model_train_checkpoints_and_reloads(tmp_path, splits):
    """``DirectEmulator.train(checkpoint_dir=…)`` writes training
    checkpoints, a restart resumes to the uninterrupted history, and the
    saved model reloads to the same predictions."""
    from tpu21cmvae_torch.utils.config import TrainConfig

    cfg = TrainConfig(epochs=4, batch_size=64, early_stop_patience=None, plateau_patience=2)
    _, a = make_pair(splits, (16,))
    a.train(train_config=cfg)
    _, b = make_pair(splits, (16,))
    ckpt = str(tmp_path / "ck")
    b.train(epochs=2, train_config=cfg, checkpoint_dir=ckpt)
    assert latest_checkpoint(ckpt).endswith("ckpt_000001.npz")
    _, c = make_pair(splits, (16,))
    c.train(train_config=cfg, checkpoint_dir=ckpt, resume=True)
    assert c.history.loss == a.history.loss and c.history.lr == a.history.lr
    path = c.save(str(tmp_path / "model.npz"))
    d = DirectEmulator.from_checkpoint(path, device="cpu")
    np.testing.assert_array_equal(d.predict(splits.par_test[:5]), c.predict(splits.par_test[:5]))
    np.testing.assert_array_equal(c.predict(splits.par_test[:5]), a.predict(splits.par_test[:5]))
    assert dataclasses.asdict(c.history)["epoch_time_s"][:2] == b.history.epoch_time_s
