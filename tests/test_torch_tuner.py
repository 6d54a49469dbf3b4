"""The port's architecture search against the JAX package's tuner.

Both draw their architectures from ``np.random.Generator`` and score
them by the same validation error. The port's trials start from its own
generators through four seams (``tuner._direct_init``, ``_ae_init``,
``_vae_init``, ``_em_init``); here they return the JAX package's initial
weights for the same seeds, and the training shuffles are JAX's
(``_torch_pair.jax_seam``), so a trial's score is JAX's to the training
loop's rounding: the stated tolerance is rtol 1e-4 on each validation
error (the port's ``fit`` follows JAX's within 3.5e-7 over 40 epochs of
a small net). The VAE trials draw normals JAX cannot hand over here:
their architectures and weight counts are checked, not their scores.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_pair import jax_seam, one_torch_thread  # noqa: F401

import tpu21cmvae.tuner as jt
import tpu21cmvae_torch.tuner as tt
from tpu21cmvae.ops.mlp import init_mlp as jax_init_mlp
from tpu21cmvae.utils import config as jcfg
from tpu21cmvae_torch.parallel import Mesh
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig, TrainConfig

SMALL = dict(min_layers=1, max_layers=2, width_choices=(16, 24, 32))
FAST = dict(epochs=4, early_stop_patience=None, plateau_patience=None, learning_rate=0.005)


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _jax_config(cfg):
    """The JAX package's config class of the same name and fields."""
    return getattr(jcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


@pytest.fixture
def jax_inits(monkeypatch):
    """The port's four initialization seams return the JAX package's
    initial weights for the same seeds."""
    from tpu21cmvae.models.autoencoder import AutoEncoder
    from tpu21cmvae.models.vae import VAE

    monkeypatch.setattr(tt, "_direct_init", lambda cfg, seed, device: _torch_tree(
        jax_init_mlp(jax.random.key(seed), cfg.mlp().sizes)))
    monkeypatch.setattr(tt, "_em_init", lambda cfg, seed, device: _torch_tree(
        jax_init_mlp(jax.random.key(seed), cfg.emulator().sizes)))
    monkeypatch.setattr(tt, "_ae_init", lambda cfg, seed, device: _torch_tree(
        AutoEncoder(_jax_config(cfg), seed=seed).params))
    monkeypatch.setattr(tt, "_vae_init", lambda cfg, seed, device: _torch_tree(
        VAE(_jax_config(cfg), seed=seed).params))


@pytest.fixture
def no_training(monkeypatch):
    """Both packages' training loops replaced by a no-op, so a search
    scores its architectures at their initial weights."""
    from tpu21cmvae.train import loop as jax_loop
    from tpu21cmvae.train import scan as jax_scan
    from tpu21cmvae_torch.train.loop import History

    def jax_stub(params, *args, opt_state=None, **kwargs):
        return params, opt_state, jax_loop.History(loss=[1.0], val_loss=[1.0])

    def port_stub(params, *args, opt_state=None, **kwargs):
        return params, opt_state, History(loss=[1.0], val_loss=[1.0])

    monkeypatch.setattr(jax_loop, "fit", jax_stub)
    monkeypatch.setattr(jax_scan, "fit_scan", jax_stub)
    monkeypatch.setattr(tt, "_fitter", lambda device_loop: port_stub)


def _same_trials(port, ref, rtol):
    assert [dataclasses.asdict(t.config) for t in port.trials] == [
        dataclasses.asdict(t.config) for t in ref.trials]
    assert [t.weight_count for t in port.trials] == [t.weight_count for t in ref.trials]
    assert [t.epochs_ran for t in port.trials] == [t.epochs_ran for t in ref.trials]
    np.testing.assert_allclose([t.val_error for t in port.trials],
                               [t.val_error for t in ref.trials], rtol=rtol)


_SEARCHES = {
    "direct": lambda pkg: dict(n_trials=5, space=pkg.SearchSpace(**SMALL)),
    "direct_halving": lambda pkg: dict(n_initial=6, rungs=3, rung_epochs=1,
                                       space=pkg.SearchSpace(**SMALL)),
    "autoencoder": lambda pkg: dict(n_trials=3, space=pkg.LatentSearchSpace(
        1, 1, (16, 24), (3, 5)), em_space=pkg.SearchSpace(1, 1, (16,))),
    "autoencoder_halving": lambda pkg: dict(n_initial=4, rungs=2, rung_epochs=1,
                                            space=pkg.LatentSearchSpace(1, 1, (16, 24), (3, 5)),
                                            em_space=pkg.SearchSpace(1, 1, (16, 24))),
    "vae": lambda pkg: dict(n_trials=3, space=pkg.VAESearchSpace(
        1, 1, (16, 24), (3, 5), (1e-4, 1e-3)), em_space=pkg.SearchSpace(1, 1, (16,))),
    "vae_halving": lambda pkg: dict(n_initial=4, rungs=2, rung_epochs=1,
                                    space=pkg.VAESearchSpace(1, 1, (16, 24), (3, 5), (1e-4,)),
                                    em_space=pkg.SearchSpace(1, 1, (16, 24))),
}


@pytest.mark.parametrize("name", sorted(_SEARCHES))
def test_same_architectures_as_jax(splits, jax_inits, no_training, name):
    """Every search space and the halving rungs: from one seed the port
    draws JAX's architectures in JAX's order, and, scored at the same
    initial weights, ranks them and halves the rungs as JAX does."""
    ref = getattr(jt, f"tune_{name}")(splits, seed=7, **_SEARCHES[name](jt))
    port = getattr(tt, f"tune_{name}")(splits, seed=7, device="cpu", **_SEARCHES[name](tt))
    _same_trials(port, ref, rtol=1e-4)
    assert all(np.isfinite(t.val_error) for t in port.trials)


def test_trial_scores_match_jax(splits, jax_inits):
    """Trained trials, random search and successive halving: each trial's
    validation error within rtol 1e-4 of JAX's on the same weights and
    shuffles, and JAX's ranking."""
    with jax_seam():
        port = tt.tune_direct(splits, n_trials=3, space=tt.SearchSpace(**SMALL),
                              train_config=TrainConfig(**FAST), seed=0, device="cpu")
    ref = jt.tune_direct(splits, n_trials=3, space=jt.SearchSpace(**SMALL),
                         train_config=jcfg.TrainConfig(**FAST), seed=0)
    _same_trials(port, ref, rtol=1e-4)
    with jax_seam():
        port = tt.tune_direct_halving(splits, n_initial=4, rungs=2, rung_epochs=2,
                                      space=tt.SearchSpace(**SMALL), seed=1, device="cpu")
    ref = jt.tune_direct_halving(splits, n_initial=4, rungs=2, rung_epochs=2,
                                 space=jt.SearchSpace(**SMALL), seed=1)
    _same_trials(port, ref, rtol=1e-4)
    def ae(pkg, train_config):
        return dict(n_trials=2, space=pkg.LatentSearchSpace(1, 1, (16,), (3, 5)),
                    em_space=pkg.SearchSpace(1, 1, (16,)), ae_train_config=train_config,
                    em_train_config=train_config, seed=3)

    with jax_seam():
        port = tt.tune_autoencoder(splits, **ae(tt, TrainConfig(**FAST)), device="cpu")
    ref = jt.tune_autoencoder(splits, **ae(jt, jcfg.TrainConfig(**FAST)))
    _same_trials(port, ref, rtol=1e-4)


def test_tune_is_deterministic(splits):
    """Two searches from one seed give the same trials, scores included,
    on the port's own initial weights; the device loop trains alike; the
    VAE weight count is JAX's."""
    kw = dict(n_trials=2, space=tt.SearchSpace(1, 1, (24, 40)),
              train_config=TrainConfig(**FAST), seed=5, device="cpu")
    a, b = tt.tune_direct(splits, **kw), tt.tune_direct(splits, **kw)
    assert [t.val_error for t in a.trials] == [t.val_error for t in b.trials]
    assert [t.config for t in a.trials] == [t.config for t in b.trials]
    hk = dict(n_initial=3, rungs=2, rung_epochs=2, space=tt.SearchSpace(1, 1, (16, 24, 32)),
              seed=2, device="cpu")
    h1 = tt.tune_direct_halving(splits, **hk)
    h2 = tt.tune_direct_halving(splits, device_loop=True, **hk)
    assert [t.config for t in h1.trials] == [t.config for t in h2.trials]
    np.testing.assert_allclose([t.val_error for t in h1.trials],
                               [t.val_error for t in h2.trials], rtol=1e-5)
    from tpu21cmvae_torch.utils.config import VAEConfig

    for cfg in (jcfg.VAEConfig(), jcfg.VAEConfig(latent_dim=5, enc_hidden_dims=(32, 16))):
        assert tt._vae_weight_count(VAEConfig(**dataclasses.asdict(cfg))) == \
            jt._vae_weight_count(cfg)


def test_best_efficient_prefers_the_cheaper_kernel_within_slack():
    """Within the accuracy slack the trial K1 multiplies least wins;
    outside it, accuracy rules. The cost is the fp32 K1's: fan-ins padded
    to 32, fan-outs to 128-column slabs, the skinny first layer apart."""
    from tpu21cmvae_torch.utils.profiling import padded_flops_per_row

    ref = tt.Trial(DirectEmulatorConfig(), 0.160, 0.0, 10, 1.0, 371907)
    ali = tt.Trial(DirectEmulatorConfig(hidden_dims=(256, 384, 256, 128)), 0.170, 0.0, 10, 1.0,
                   300000)
    # 288→384, 352→384, 224→256 and 451→512 columns; fan-ins already ×32
    assert ref.padded_flops_per_row == 2 * (288 * 384 + 352 * 384 + 288 * 256 + 224 * 512)
    assert ali.padded_flops_per_row == 2 * (256 * 384 + 384 * 256 + 256 * 128 + 128 * 512)
    assert ref.padded_flops_per_row > 1.4 * ali.padded_flops_per_row
    # the bf16 tiers pad to the 16 × 16 fragment grid
    assert padded_flops_per_row((7, 300, 451), "default") == 2 * 304 * 464
    assert padded_flops_per_row((7, 300, 451)) == 2 * 320 * 512
    res = tt.TuneResult([ref, ali])
    assert res.best is ref
    assert res.best_efficient(slack=0.10) is ali
    assert res.best_efficient(slack=0.01) is ref
    with pytest.raises(ValueError):
        res.best_efficient(slack=-0.1)
    rng = np.random.default_rng(3)
    for _ in range(20):
        stack = tt.MXU_ALIGNED_SPACE.sample(rng)
        assert all(w % 128 == 0 for w in stack) and 3 <= len(stack) <= 5


def test_retrain_best_shards_the_seed_axis(splits):
    """``retrain_best(n_seeds=2, mesh=)`` trains the two seed replicas one
    per mesh entry and returns the replica the unsharded run returns,
    weights and all; the seed axis must divide the mesh."""
    res = tt.TuneResult([tt.Trial(DirectEmulatorConfig(hidden_dims=(16,)), 1.0, 0.0, 1, 0.0,
                                  0)])
    tc = TrainConfig(epochs=3, early_stop_patience=None, plateau_patience=None)
    plain = tt.retrain_best(res, splits, train_config=tc, n_seeds=2, device="cpu")
    meshed = tt.retrain_best(res, splits, train_config=tc, n_seeds=2,
                             mesh=Mesh(["cpu", "cpu"]), device="cpu")
    assert plain.history.val_loss == meshed.history.val_loss
    for a, b in zip(plain.params, meshed.params):
        assert torch.equal(a["w"], b["w"])
    with pytest.raises(ValueError, match="shard evenly"):
        tt.retrain_best(res, splits, train_config=tc, n_seeds=3, mesh=Mesh(["cpu", "cpu"]),
                        device="cpu")
    one = tt.retrain_best(res, splits, train_config=tc, device="cpu")
    assert one.config.hidden_dims == (16,) and len(one.history.loss) == 3


@pytest.mark.parametrize("argv", [["--trials", "2"], ["--trials", "2", "--halving"]])
def test_cli_tune(splits, monkeypatch, capsys, argv):
    """``python -m tpu21cmvae_torch tune`` runs a search on the CPU and
    prints its leaderboard (a small dataset in place of the built-in
    synthetic one)."""
    import tpu21cmvae_torch.__main__ as cli

    monkeypatch.setattr(cli, "_get_data", lambda args: splits)
    for name in ("tune_direct", "tune_direct_halving"):
        monkeypatch.setattr(tt, name, functools.partial(
            getattr(tt, name), space=tt.SearchSpace(**SMALL), train_config=TrainConfig(**FAST)))
    assert cli.main(["tune", "--device", "cpu", *argv]) is None
    out = capsys.readouterr().out
    assert out.count("val_err=") >= (1 if "--halving" in argv else 2)
