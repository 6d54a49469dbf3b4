"""The port's device-loop trainer semantics (``tpu21cmvae_torch/train/scan.py``):
``fit_scan`` against the port's ``fit`` and against JAX's ``fit_scan``,
``fit_scan_stack`` against per-member ``fit_scan`` and JAX's
``fit_scan_stack`` (the patterns of ``tests/test_scan_fit.py``).

Tolerances: port against port, the same epochs on the same CPU, bit for
bit where the learning rate never changes and within JAX's own
fit-against-scan bound (1e-6 relative) where a plateau scales it (the
host loop's rate is a float64 product, the scan's a float32 one); port
against JAX within 2e-6 (histories) and 1e-5 / 1e-6 (weights), the drift
measured in ``tests/test_torch_train.py``; stop and best epochs exactly.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_pair import jax_seam, make_pair, one_torch_thread  # noqa: F401
from test_torch_train import (
    HIST_RTOL,
    PATTERNS,
    Setup,
    assert_weights,
    jax_cfg,
    port_cfg,
)
from tpu21cmvae.ops.mlp import init_mlp
from tpu21cmvae.train.scan import fit_scan as jax_fit_scan
from tpu21cmvae.train.scan import fit_scan_stack as jax_fit_scan_stack
from tpu21cmvae_torch.train.loop import fit
from tpu21cmvae_torch.train.scan import fit_scan, fit_scan_stack
from tpu21cmvae_torch.utils.tree import tree_leaves


@pytest.fixture(scope="module")
def setup(splits, normalizer):
    return Setup(splits, normalizer, sizes=(7, 24, 451))


def assert_same_run(got, want, rtol):
    assert len(got.loss) == len(want.loss)
    np.testing.assert_allclose(got.loss, want.loss, rtol=rtol)
    np.testing.assert_allclose(got.val_loss, want.val_loss, rtol=rtol)
    np.testing.assert_allclose(got.lr, want.lr, rtol=max(rtol, 1e-7))
    assert got.stopped_epoch == want.stopped_epoch
    assert got.best_epoch == want.best_epoch


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_scan_matches_fit(setup, pattern):
    """The scan semantics against the host loop, both ported."""
    cfg = port_cfg(**PATTERNS[pattern])
    pa, sa, ha = fit(setup.port_params(), setup.port_loss, *setup.data(), cfg)
    pb, sb, hb = fit_scan(setup.port_params(), setup.port_loss, *setup.data(), cfg)
    changes_lr = len(set(ha.lr)) > 1
    assert_same_run(hb, ha, 1e-6 if changes_lr else 0.0)
    assert hb.epoch_time_s == [] and len(ha.epoch_time_s) == len(ha.loss)
    assert sb.step == sa.step
    for a, b in zip(tree_leaves(pb), tree_leaves(pa)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5 if changes_lr else 0.0, atol=1e-7 if changes_lr else 0)
    if pattern == "early_stop":
        assert hb.stopped_epoch is not None


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_scan_matches_jax_scan(setup, pattern):
    """The port's fit_scan against JAX's whole-run program: float32 rates
    and monitors in both."""
    jp, js, jh = jax_fit_scan(setup.params, setup.jax_loss, setup.x, setup.y, setup.xv,
                              setup.yv, jax_cfg(**PATTERNS[pattern]))
    with jax_seam():
        tp, ts, th = fit_scan(setup.port_params(), setup.port_loss, *setup.data(),
                              port_cfg(**PATTERNS[pattern]))
    assert_same_run(th, jh, HIST_RTOL)
    assert th.lr == jh.lr  # the same float32 rates
    assert_weights(tp, jp)
    assert ts.step == int(js.step)


@pytest.fixture(scope="module")
def stack_run():
    """Three members: their seeds, their JAX weights, and the stack."""
    seeds = [0, 3, 11]
    keys = jax.random.split(jax.random.key(5), len(seeds))
    member_params = [init_mlp(k, (7, 24, 451)) for k in keys]
    stack = jax.tree_util.tree_map(lambda *a: np.stack([np.asarray(x) for x in a]),
                                   *member_params)
    return seeds, member_params, stack


def test_scan_stack_matches_members_and_jax(setup, stack_run):
    """Each member of the stack is exactly its own fit_scan, and the stack
    is JAX's vmapped program's."""
    seeds, member_params, stack = stack_run
    cfg = dict(PATTERNS["recipe"], epochs=6, early_stop_patience=2, early_stop_min_delta=5e-3)
    jstack, jstate, jhist = jax_fit_scan_stack(stack, setup.jax_loss, setup.x, setup.y,
                                               setup.xv, setup.yv, jax_cfg(**cfg), seeds=seeds)
    tstack = tuple({k: torch.tensor(v) for k, v in layer.items()} for layer in stack)
    tensors = tree_leaves(tstack)
    with jax_seam():
        tstack, tstate, thist = fit_scan_stack(tstack, setup.port_loss, *setup.data(),
                                               port_cfg(**cfg), seeds=seeds)
        singles = []
        for seed, p in zip(seeds, member_params):
            params = tuple({k: torch.tensor(np.asarray(v)) for k, v in layer.items()}
                           for layer in p)
            singles.append(fit_scan(params, setup.port_loss, *setup.data(),
                                    port_cfg(**dict(cfg, seed=seed))))
    assert all(a is b for a, b in zip(tree_leaves(tstack), tensors))
    assert list(tstate.step) == [s.step for _, s, _ in singles]
    for i, (params, state, hist) in enumerate(singles):
        assert thist[i] == hist
        for a, b in zip(tree_leaves(tstack), tree_leaves(params)):
            assert torch.equal(a[i], b)
        for a, b in zip(tstate.mu, state.mu):
            assert torch.equal(a[i], b)
        assert_same_run(thist[i], jhist[i], HIST_RTOL)
    assert_weights(tstack, jstack)
    np.testing.assert_array_equal(np.asarray(jstate.step), tstate.step)


def test_scan_stack_takes_a_stacked_state_and_refuses_a_mesh(setup, stack_run):
    seeds, _, stack = stack_run
    cfg = port_cfg(**dict(PATTERNS["plain"], epochs=1))
    tstack = tuple({k: torch.tensor(v) for k, v in layer.items()} for layer in stack)
    _, state, _ = fit_scan_stack(tstack, setup.port_loss, *setup.data(), cfg, seeds=seeds)
    _, state2, hist = fit_scan_stack(tstack, setup.port_loss, *setup.data(), cfg, seeds=seeds,
                                     opt_state_stack=state)
    assert list(state2.step) == [8, 8, 8] and len(hist) == 3
    with pytest.raises(TypeError, match="Mesh"):
        fit_scan_stack(tstack, setup.port_loss, *setup.data(), cfg, seeds=seeds, mesh=object())
    with pytest.raises(ValueError, match="leading axes"):
        fit_scan_stack(tstack, setup.port_loss, *setup.data(), cfg, seeds=seeds[:2])
    # a stochastic loss draws through the host loop's seam: the same run
    def noisy(p, x, y, noise):
        return setup.port_loss(p, x, y) * (1.0 + 1e-3 * noise((x.shape[0],)))

    _, _, hs = fit_scan(setup.port_params(), noisy, *setup.data(), cfg, stochastic=True)
    _, _, hf = fit(setup.port_params(), noisy, *setup.data(), cfg, stochastic=True)
    assert hs.loss == hf.loss and hs.val_loss == hf.val_loss


def test_device_loop_in_model_has_no_epoch_times(splits):
    """``DirectEmulator.train(device_loop=True)`` runs the scan trainer."""
    _, model = make_pair(splits, (16,))
    cfg = port_cfg(**dict(PATTERNS["plain"], epochs=3))
    loss, val_loss = model.train(train_config=cfg, device_loop=True)
    assert len(loss) == len(val_loss) == 3
    assert model.history.epoch_time_s == []
    assert model.history.lr == [float(np.float32(0.003))] * 3  # the float32 rate, as in JAX
    with pytest.raises(ValueError, match="host hooks"):
        model.train(train_config=cfg, device_loop=True, checkpoint_dir="unused")
