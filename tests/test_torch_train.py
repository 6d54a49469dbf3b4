"""The port's training path (``tpu21cmvae_torch/train/``, ``ops/losses.py``,
``DirectEmulator.loss_fn`` and ``train``) against the JAX package's.

Both packages start from the same NumPy weights and data, and the port's
shuffle seam (``train.loop._permutation``) returns the permutations JAX
draws from its keys (``_torch_pair.jax_seam``).

Tolerances, and the drift that set them:
- Adam: the moments and the parameters within 1e-6 relative (1e-7
  absolute), the step count exactly. Jitted XLA contracts the moment
  updates into fused multiply-adds (an ulp where ``0.9·m`` and ``0.1·g``
  cancel), and PyTorch's vectorized CPU ``sqrt`` is not correctly
  rounded on a share of elements (63 of 10,824 in one measured step, 1
  ulp), which moves ``p`` by an ulp where XLA's does not. The
  bias-corrected rate is bit for bit.
- Per-step losses of epoch 1 and per-epoch histories: 2e-6 relative.
  The two libraries sum the matmuls and reductions in other orders;
  measured on the 7→24→16→451 net at lr 0.01 over 40 epochs of the
  published recipe, the port's epoch losses stayed within 3.5e-7 of
  JAX's and its weights within 2.4e-6 absolute (1.4e-7 at 10 epochs).
  Weights here: 1e-5 relative, 1e-6 absolute.
- The callbacks' integer decisions (stop epoch, best epoch, the lr
  schedule) exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import jax_seam, jax_shuffles, make_pair, one_torch_thread  # noqa: F401
from tpu21cmvae.ops import losses as jlosses
from tpu21cmvae.ops.mlp import init_mlp, mlp_apply as jax_mlp_apply
from tpu21cmvae.ops.transforms import par_transform as jax_par_transform
from tpu21cmvae.ops.transforms import preproc as jax_preproc
from tpu21cmvae.train import adam as jadam
from tpu21cmvae.train import callbacks as jcallbacks
from tpu21cmvae.train.loop import fit as jax_fit
from tpu21cmvae.utils import config as jconfig
from tpu21cmvae.utils import logging as jlogging
from tpu21cmvae_torch.ops import losses
from tpu21cmvae_torch.ops.mlp import mlp_apply
from tpu21cmvae_torch.train import adam, callbacks, loop
from tpu21cmvae_torch.train.loop import fit
from tpu21cmvae_torch.utils import config
from tpu21cmvae_torch.utils import logging as tlogging
from tpu21cmvae_torch.utils.tree import tree_leaves, treedef

HIST_RTOL = 2e-6
W_RTOL, W_ATOL = 1e-5, 1e-6

# the JAX suite's training patterns (tests/test_resume.py, tests/test_scan_fit.py)
BASE = dict(epochs=6, batch_size=64, learning_rate=0.003,
            early_stop_patience=None, plateau_patience=None)
PATTERNS = {
    "plain": BASE,
    "plateau": dict(BASE, epochs=8, plateau_patience=2, plateau_factor=0.5,
                    plateau_min_delta=10.0, plateau_min_lr=1e-4),
    "early_stop": dict(BASE, epochs=10, early_stop_patience=2, early_stop_min_delta=10.0),
    "recipe": dict(BASE, epochs=10, learning_rate=0.01, early_stop_patience=4,
                   early_stop_min_delta=1e-10, plateau_patience=2, plateau_factor=0.95,
                   plateau_min_delta=5e-9, plateau_min_lr=1e-4),
}


def jax_cfg(**kw):
    return jconfig.TrainConfig(**kw)


def port_cfg(**kw):
    return config.TrainConfig(**kw)


class Setup:
    """The JAX suite's training set-up (``tests/test_resume.py::_setup``):
    a 7→24→16→451 net, 200 training and 64 validation rows."""

    def __init__(self, splits, normalizer, sizes=(7, 24, 16, 451)):
        self.params = init_mlp(jax.random.key(0), sizes)
        sm = normalizer.scaled_mean
        self.sm = np.asarray(sm)

        def jax_loss(p, x, y):
            return jlosses.relative_mse(y, jax_mlp_apply(p, x), sm)

        self.jax_loss = jax_loss
        self.x = jax_par_transform(jnp.asarray(splits.par_train[:200], jnp.float32), normalizer)
        self.y = jax_preproc(jnp.asarray(splits.signal_train[:200], jnp.float32), normalizer)
        self.xv = jax_par_transform(jnp.asarray(splits.par_val[:64], jnp.float32), normalizer)
        self.yv = jax_preproc(jnp.asarray(splits.signal_val[:64], jnp.float32), normalizer)
        sm_t = torch.tensor(self.sm)

        def port_loss(p, x, y):
            return losses.relative_mse(y, mlp_apply(p, x), sm_t)

        self.port_loss = port_loss

    def port_params(self):
        return tuple({k: torch.tensor(np.asarray(v)) for k, v in layer.items()}
                     for layer in self.params)

    def data(self):
        return [np.asarray(a) for a in (self.x, self.y, self.xv, self.yv)]


@pytest.fixture(scope="module")
def setup(splits, normalizer):
    return Setup(splits, normalizer)


def assert_history(got, want):
    assert len(got.loss) == len(want.loss)
    np.testing.assert_allclose(got.loss, want.loss, rtol=HIST_RTOL)
    np.testing.assert_allclose(got.val_loss, want.val_loss, rtol=HIST_RTOL)
    assert got.lr == want.lr
    assert got.stopped_epoch == want.stopped_epoch
    assert got.best_epoch == want.best_epoch


def assert_weights(got, want):
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=W_RTOL, atol=W_ATOL)


def test_config_matches_jax():
    assert dataclasses.asdict(config.TrainConfig()) == dataclasses.asdict(jconfig.TrainConfig())
    for name in ("DIRECT_TRAIN_DEFAULT", "DIRECT_TRAIN_STRONG"):
        assert getattr(config, name) == config.TrainConfig(
            **dataclasses.asdict(getattr(jconfig, name)))


def test_losses_match_jax():
    """mse, relative_mse and kl_divergence, float32, within 1e-6."""
    rng = np.random.default_rng(0)
    yt, yp = rng.normal(size=(2, 9, 451)).astype(np.float32)
    sm = rng.normal(size=451).astype(np.float32)
    mu, lv = rng.normal(size=(2, 9, 5)).astype(np.float32)
    t = torch.tensor
    pairs = [
        (losses.mse(t(yt), t(yp)), jlosses.mse(yt, yp)),
        (losses.relative_mse(t(yt), t(yp), t(sm)), jlosses.relative_mse(yt, yp, sm)),
        (losses.kl_divergence(t(mu), t(lv)), jlosses.kl_divergence(mu, lv)),
    ]
    for got, want in pairs:
        assert got.shape == (9,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_tree_structure_strings_match_jax():
    """The structure strings the port writes into checkpoints are JAX's."""
    for sizes in ((7, 5, 3), (7, 3)):
        p = init_mlp(jax.random.key(0), sizes)
        tree = {"params": p, "opt_state": jadam.adam_init(p), "best_weights": p}
        port_tree = {"params": p, "opt_state": adam.AdamState(0, p, p), "best_weights": p}
        assert treedef(port_tree) == str(jax.tree_util.tree_structure(tree))
        assert len(tree_leaves(port_tree)) == len(jax.tree_util.tree_leaves(tree))
    other = [1, (2,), {"b": 3, "a": 4}]
    assert treedef(other) == str(jax.tree_util.tree_structure(other))
    assert tree_leaves(other) == jax.tree_util.tree_leaves(other)


@pytest.mark.parametrize("n_steps", [1, 25])
def test_adam_matches_jax(n_steps):
    """One and several Keras-Adam steps on the same gradients, the rate
    changing between steps as ReduceLROnPlateau changes it."""
    rng = np.random.default_rng(1)
    shapes = [(24,), (7, 24), (451,), (24, 451)]
    p = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jp, js = [jnp.asarray(a) for a in p], jadam.adam_init([jnp.asarray(a) for a in p])
    tp = [torch.tensor(a, requires_grad=True) for a in p]
    ids, versions = [id(t) for t in tp], [t._version for t in tp]
    ts = adam.adam_init(tp)
    jax_update = jax.jit(jadam.adam_update)
    for k in range(n_steps):
        g = [rng.normal(size=s).astype(np.float32) * np.float32(10.0 ** rng.uniform(-5, 1))
             for s in shapes]
        lr = 0.01 * 0.95 ** (k // 5)
        jp, js = jax_update([jnp.asarray(a) for a in g], jp, js, jnp.float32(lr))
        ts = adam.adam_update([torch.tensor(a) for a in g], tp, ts, lr)
    assert ts.step == int(js.step) == n_steps
    for a, b in zip(ts.mu + ts.nu + tp, list(js.mu) + list(js.nu) + list(jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    # in place: the same tensors, their versions moved (what OperandCache keys on)
    assert [id(t) for t in tp] == ids
    assert all(t._version > v for t, v in zip(tp, versions))


def test_bias_corrected_rate_is_jax_float32():
    """``lr_t`` bit for bit against JAX's float32 expression, steps 1-3000."""
    t = jnp.arange(1, 3001, dtype=jnp.float32)
    want = np.asarray(jax.jit(
        lambda lr, t: lr * jnp.sqrt(1.0 - 0.999**t) / (1.0 - 0.9**t))(jnp.float32(0.0095), t))
    got = np.array([adam.bias_corrected_lr(0.0095, k, 0.9, 0.999) for k in range(1, 3001)],
                   np.float32)
    np.testing.assert_array_equal(got, want)


def test_callbacks_match_jax_on_one_sequence():
    """EarlyStopping and ReduceLROnPlateau of both packages fed one monitor
    sequence (improvements, ties, moves inside min_delta, a NaN): the same
    stop, the same best epoch, the same rates and states, exactly."""
    seq = [1.0, 0.9, 0.9, 0.9 - 1e-11, 0.8, 0.8, 0.8, float("nan"), 0.7,
           0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.69, 0.69, 0.69, 0.69]
    pairs = [(callbacks.EarlyStopping(patience=4, min_delta=1e-10),
              jcallbacks.EarlyStopping(patience=4, min_delta=1e-10)),
             (callbacks.EarlyStopping(patience=30, min_delta=0.0),
              jcallbacks.EarlyStopping(patience=30, min_delta=0.0))]
    for mine, theirs in pairs:
        stops = [(mine.update(e, v, {"w": torch.zeros(1)}), theirs.update(e, v, None))
                 for e, v in enumerate(seq)]
        assert [a for a, _ in stops] == [b for _, b in stops]
        assert mine.state() == theirs.state()
    for kw in (dict(patience=2, factor=0.5, min_delta=1e-3, min_lr=0.02),
               dict(patience=1, factor=0.95), dict(patience=2, cooldown=2, factor=0.9)):
        mine, theirs = callbacks.ReduceLROnPlateau(**kw), jcallbacks.ReduceLROnPlateau(**kw)
        lr_a = lr_b = 0.1
        rates = []
        for v in seq:
            lr_a, lr_b = mine.update(v, lr_a), theirs.update(v, lr_b)
            rates.append((lr_a, lr_b))
        assert [a for a, _ in rates] == [b for _, b in rates]
        assert mine.state() == theirs.state()


def test_restore_best_weights_is_not_aliased():
    """EarlyStopping keeps the best epoch's values, not a reference to the
    tensors the loop goes on updating in place."""
    w = torch.zeros(3)
    es = callbacks.EarlyStopping(patience=2, restore_best_weights=True)
    assert not es.update(0, 1.0, {"w": w})
    w.add_(5.0)
    assert not es.update(1, 2.0, {"w": w})
    w.add_(5.0)
    assert es.update(2, 3.0, {"w": w})
    np.testing.assert_array_equal(es.final_weights({"w": w})["w"].numpy(), np.zeros(3))


def test_fit_restores_the_best_epochs_weights(setup):
    """Through ``fit``: an early stop restores the tensors to the best
    epoch's values (recorded by the epoch callback), in place."""
    cfg = port_cfg(**dict(PATTERNS["recipe"], epochs=12, early_stop_patience=2,
                          early_stop_min_delta=5e-3))
    snaps = []
    params = setup.port_params()
    tensors = tree_leaves(params)
    _, _, h = fit(params, setup.port_loss, *setup.data(), cfg,
                  epoch_callback=lambda e, p, s, h: snaps.append(
                      [t.detach().clone() for t in tree_leaves(p)]))
    assert h.stopped_epoch is not None and h.best_epoch < h.stopped_epoch
    assert tree_leaves(params)[0] is tensors[0]
    for got, want in zip(tree_leaves(params), snaps[h.best_epoch]):
        np.testing.assert_array_equal(got.detach().numpy(), want.numpy())
    assert not all(torch.equal(a, b) for a, b in zip(snaps[-1], snaps[h.best_epoch]))


def test_first_epoch_steps_match_jax(setup):
    """Epoch 1 step by step: each batch's loss and the weights after the
    epoch, on JAX's shuffle, against JAX's value_and_grad + adam_update."""
    cfg = port_cfg(**PATTERNS["recipe"])
    perm = jax_shuffles(0, 1, 200)[0]
    jp, js = setup.params, jadam.adam_init(setup.params)
    tp = setup.port_params()
    leaves = loop._trainable(tp)
    ts = adam.adam_init(tp)
    x, y = setup.data()[:2]
    jx, jy = setup.x[perm], setup.y[perm]

    @jax.jit
    def jax_step(p, s, bx, by):
        loss, grads = jax.value_and_grad(
            lambda p: jnp.sum(setup.jax_loss(p, bx, by)) / bx.shape[0])(p)
        return (loss, *jadam.adam_update(grads, p, s, jnp.float32(cfg.learning_rate)))

    for start in range(0, 200, cfg.batch_size):
        want, jp, js = jax_step(jp, js, jx[start: start + 64], jy[start: start + 64])
        got, ts = loop._train_step(tp, leaves, setup.port_loss,
                                   torch.tensor(x[perm][start: start + 64]),
                                   torch.tensor(y[perm][start: start + 64]),
                                   ts, cfg.learning_rate, cfg)
        np.testing.assert_allclose(float(got), float(want), rtol=HIST_RTOL)
    assert_weights(tp, jp)


@pytest.fixture(scope="module")
def jax_runs(setup):
    return {name: jax_fit(setup.params, setup.jax_loss, setup.x, setup.y, setup.xv, setup.yv,
                          jax_cfg(**kw))
            for name, kw in PATTERNS.items()}


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_fit_matches_jax(setup, jax_runs, pattern):
    """``fit`` on the JAX suite's patterns: the same history and weights."""
    jp, _, jh = jax_runs[pattern]
    with jax_seam():
        tp, state, th = fit(setup.port_params(), setup.port_loss, *setup.data(),
                            port_cfg(**PATTERNS[pattern]))
    assert_history(th, jh)
    assert_weights(tp, jp)
    assert len(th.epoch_time_s) == len(th.loss)
    assert state.step == len(th.loss) * 4  # ceil(200 / 64) steps per epoch


def test_fit_masks_pad_rows_like_jax(setup):
    """Trailing pad rows (``n_train_real``, ``n_val_real``) enter no loss
    and no gradient: the same run as JAX's masked one."""
    kw = PATTERNS["recipe"]
    pad = lambda a, n: jnp.concatenate([a, jnp.full((n, a.shape[1]), 7.0, a.dtype)])  # noqa: E731
    x, y, xv, yv = pad(setup.x[:180], 20), pad(setup.y[:180], 20), pad(setup.xv[:50], 14), \
        pad(setup.yv[:50], 14)
    jp, _, jh = jax_fit(setup.params, setup.jax_loss, x, y, xv, yv, jax_cfg(**kw),
                        n_train_real=180, n_val_real=50)
    with jax_seam():
        tp, _, th = fit(setup.port_params(), setup.port_loss,
                        *(np.asarray(a) for a in (x, y, xv, yv)), port_cfg(**kw),
                        n_train_real=180, n_val_real=50)
    assert_history(th, jh)
    assert_weights(tp, jp)
    with pytest.raises(ValueError, match="n_train_real"):
        fit(setup.port_params(), setup.port_loss, *setup.data(), port_cfg(**kw),
            n_train_real=201)


def test_fit_refuses_stochastic_losses(setup):
    """The refusal is lifted (the VAE family is ported): a stochastic loss
    gets a source of normals before the epoch, fresh for each batch
    through the seam ``loop._normal(seed, epoch, step, …)``, and one fixed
    draw per run for validation (the seed ``seed ^ 0x5EED`` at
    ``EVAL_EPOCH``); a loss without the noise argument is refused by its
    own signature."""
    seen = []

    def loss(p, x, y, noise, epoch):
        eps = noise((x.shape[0], 2))
        seen.append((torch.is_grad_enabled(), epoch, eps))
        return setup.port_loss(p, x, y) + 0.0 * eps.sum(-1)

    cfg = port_cfg(**dict(BASE, epochs=2, seed=5))
    fit(setup.port_params(), loss, *setup.data(), cfg, stochastic=True, pass_epoch=True)
    train = [(e, eps) for grad, e, eps in seen if grad]
    val = [(e, eps) for grad, e, eps in seen if not grad]
    per_epoch = -(-200 // BASE["batch_size"])
    assert [e for e, _ in train] == [0] * per_epoch + [1] * per_epoch
    for i, (e, eps) in enumerate(train):
        assert torch.equal(eps, loop._normal(5, e, i % per_epoch, tuple(eps.shape), "cpu"))
    assert len(val) == 2 and all(e == 1 for e, _ in val)
    assert torch.equal(val[0][1], val[1][1])
    assert torch.equal(val[0][1], loop._normal(5 ^ 0x5EED, loop.EVAL_EPOCH, 0, (64, 2), "cpu"))
    with pytest.raises(TypeError):
        fit(setup.port_params(), setup.port_loss, *setup.data(), port_cfg(**BASE),
            stochastic=True)


def test_pass_epoch_gives_the_epoch_and_the_final_one_to_validation(setup):
    seen = []

    def loss(p, x, y, epoch):
        seen.append((x.shape[0], epoch))
        return setup.port_loss(p, x, y)

    fit(setup.port_params(), loss, *setup.data(), port_cfg(**dict(BASE, epochs=3)),
        pass_epoch=True)
    # per epoch: four training batches (64, 64, 64, 8 rows), then validation
    assert [n for n, _ in seen] == [64, 64, 64, 8, 64] * 3
    assert [e for _, e in seen] == [0, 0, 0, 0, 2, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2]


# -- the direct emulator ---------------------------------------------------------

SMALL = (24, 16)
MODEL_CFG = dict(epochs=5, batch_size=64, learning_rate=0.01, early_stop_patience=3,
                 plateau_patience=2, plateau_factor=0.5)


@pytest.fixture(scope="module")
def trained_pair(splits):
    jm, tm = make_pair(splits, SMALL)
    jm.train(train_config=jax_cfg(**MODEL_CFG))
    with jax_seam():
        tm.train(train_config=port_cfg(**MODEL_CFG))
    return jm, tm


def test_direct_emulator_train_matches_jax(trained_pair, splits):
    """``DirectEmulator.train`` on the small model: the same history, and
    the trained weights predict the same test signals."""
    jm, tm = trained_pair
    assert_history(tm.history, jm.history)
    assert_weights(tm.params, jm.params)
    np.testing.assert_allclose(tm.predict(splits.par_test), jm.predict(splits.par_test),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tm.test_error(), jm.test_error(), rtol=1e-4)


def test_direct_emulator_device_loop_matches_jax(splits):
    jm, tm = make_pair(splits, SMALL)
    jl, jv = jm.train(train_config=jax_cfg(**MODEL_CFG), device_loop=True)
    with jax_seam():
        tl, tv = tm.train(train_config=port_cfg(**MODEL_CFG), device_loop=True)
    np.testing.assert_allclose(tl, jl, rtol=HIST_RTOL)
    np.testing.assert_allclose(tv, jv, rtol=HIST_RTOL)
    assert_history(tm.history, jm.history)
    assert tm.history.epoch_time_s == []
    with pytest.raises(ValueError, match="host hooks"):
        tm.train(epochs=1, device_loop=True, epoch_callback=print)


def test_loss_fn_matches_jax_and_the_tiers(splits):
    """The contract-tier loss is JAX's; the ``"default"`` tier's is
    ``relative_mse`` over the bf16 forward (JAX on the CPU ignores
    ``Precision.DEFAULT``, so the port's own tier is the reference), and
    it trains."""
    jm, tm = make_pair(splits, SMALL)
    norm = tm.normalizer
    x = torch.tensor(np.asarray(jax_par_transform(
        jnp.asarray(splits.par_train[:50], jnp.float32), jm.normalizer)))
    y = torch.tensor(np.asarray(jax_preproc(
        jnp.asarray(splits.signal_train[:50], jnp.float32), jm.normalizer)))
    want = jm.loss_fn()(jm.params, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    np.testing.assert_allclose(tm.loss_fn()(tm.params, x, y).detach().numpy(),
                               np.asarray(want), rtol=1e-5)
    got = tm.loss_fn("default")(tm.params, x, y)
    ref = losses.relative_mse(y, mlp_apply(tm.params, x, "relu", "default"), norm.scaled_mean)
    np.testing.assert_array_equal(got.detach().numpy(), ref.detach().numpy())
    loss, val = tm.train(train_config=port_cfg(**dict(MODEL_CFG, epochs=2)),
                         loss_precision="default")
    assert np.all(np.isfinite(loss + val)) and val[-1] < val[0]


def test_kernel_wrappers_built_before_training_follow_the_weights(splits):
    """Memoized K1, K2 and K3 wrappers built before ``train`` equal fresh
    ones after it (on the CPU each runs its plain version on the operands
    it cached against the weights' versions)."""
    _, tm = make_pair(splits, SMALL)
    rng = np.random.default_rng(2)
    obs = tm.predict(splits.par_test[0]) + rng.normal(0.0, 5.0, 451)
    raw = torch.tensor(splits.par_test[:9], dtype=torch.float32)
    builds = {
        "k3": lambda memo: tm.loglik_and_grad_fn(obs, 25.0, backend="kernel",
                                                 grad_precision="default", memo=memo),
        "k2": lambda memo: tm.loglik_fn(obs, 25.0, backend="kernel", memo=memo),
        "k1": lambda memo: tm.loglik_fn(obs, 25.0, backend="kernel", method="direct",
                                        precision="contract", memo=memo),
    }

    def call(fn):
        with torch.no_grad():
            out = fn(tm.params, raw)
        return [t.numpy() for t in (out if isinstance(out, tuple) else (out,))]

    before = {k: build(True) for k, build in builds.items()}
    first = {k: call(fn) for k, fn in before.items()}
    tm.train(train_config=port_cfg(**dict(MODEL_CFG, epochs=2)))
    for k, build in builds.items():
        assert build(True) is before[k]
        after, fresh = call(before[k]), call(build(False))
        for a, b, c in zip(after, fresh, first[k]):
            np.testing.assert_array_equal(a, b)
            assert not np.allclose(a, c)


# -- metrics files and the dataset file ------------------------------------------


def test_metrics_logger_round_trips(tmp_path, setup):
    """The epoch callback's JSONL, and the History exports, read back by
    both packages' readers; the CSV is JAX's byte for byte."""
    path = str(tmp_path / "m.jsonl")
    with tlogging.MetricsLogger(path) as logger:
        _, _, h = fit(setup.port_params(), setup.port_loss, *setup.data(),
                      port_cfg(**dict(BASE, epochs=3)), epoch_callback=logger.epoch_callback)
        logger.log(note="done")
    rows = tlogging.read_jsonl(path)
    assert rows == jlogging.read_jsonl(path)
    assert [r["epoch"] for r in rows[:3]] == [0, 1, 2] and rows[3] == {"note": "done"}
    assert [r["loss"] for r in rows[:3]] == h.loss
    assert [r["lr"] for r in rows[:3]] == h.lr
    for fn in ("history_to_jsonl", "history_to_csv"):
        a, b = str(tmp_path / f"port_{fn}"), str(tmp_path / f"jax_{fn}")
        getattr(tlogging, fn)(h, a)
        getattr(jlogging, fn)(h, b)
        assert open(a).read() == open(b).read()
    assert [r["val_loss"] for r in tlogging.read_jsonl(str(tmp_path / "port_history_to_jsonl"))] \
        == h.val_loss
    closed = tlogging.MetricsLogger(str(tmp_path / "c.jsonl"))
    closed.close()
    with pytest.raises(ValueError, match="closed"):
        closed.log(a=1)


def test_dataset_file_round_trips(tmp_path, monkeypatch, splits):
    from tpu21cmvae.data import dataset as jdata
    from tpu21cmvae_torch.data import dataset as tdata

    path = tdata.save_dataset(tdata.DataSplits(*splits), str(tmp_path / "d.h5"))
    for got in (tdata.ensure_dataset(path), jdata.load_dataset(path)):
        for a, b in zip(got, splits):
            np.testing.assert_array_equal(a, b)
    monkeypatch.setenv("TPU21CMVAE_CACHE", str(tmp_path / "cache"))
    assert tdata.default_cache_path() == jdata.default_cache_path() == str(
        tmp_path / "cache" / "dataset_21cmVAE.h5")
    with pytest.raises(FileNotFoundError, match="dataset_21cmVAE.h5"):
        tdata.ensure_dataset()
    monkeypatch.delenv("TPU21CMVAE_CACHE")
    assert tdata.default_cache_path() == jdata.default_cache_path()
