"""Hyperparameter tuner: architecture search for the emulator families
(the port of ``tpu21cmvae/tuner.py``).

The reference advertises a tuner ("modules for hyperparameter tuning",
reference ``README.rst:13``) used in Bye et al. 2022 to find the
7→288→352→288→224→451 flagship architecture, but the file is absent from
its snapshot (reference ``.gitignore:14``). This module restores it:

* random search over hidden-layer stacks (layer count × width choices),
  scored by mean relative validation error, the paper's figure of merit
  (reference ``emulator.py:53-54``), on real-unit (mK) predictions;
* short-budget trials with early stopping, each through the port's
  training loop (:func:`~tpu21cmvae_torch.train.loop.fit`, or
  :func:`~tpu21cmvae_torch.train.scan.fit_scan` with ``device_loop``);
* throughput-aware selection: :meth:`TuneResult.best_efficient` picks
  the cheapest trial within an accuracy slack of the best, priced by
  what the port's K1 multiplies per row (:attr:`Trial.padded_flops_per_row`,
  the Hopper kernel's padding, not the TPU's 128-lane tiles);
* deterministic: one root seed fans out per-trial seeds, and the
  architectures are drawn from ``np.random.Generator`` exactly as the
  JAX package draws them, so both packages search the same
  architectures from the same seed.

The trials' initial weights come from the port's own generators (the
seams :func:`_direct_init`, :func:`_ae_init`, :func:`_vae_init` and
:func:`_em_init`), so the scores match the JAX package's only when the
weights and shuffles are carried across, as the port's tests do.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from tpu21cmvae_torch.data.dataset import DataSplits
from tpu21cmvae_torch.ops.losses import kl_divergence, mse, relative_mse
from tpu21cmvae_torch.ops.mlp import MLP, mlp_apply
from tpu21cmvae_torch.ops.transforms import Normalizer, par_transform, preproc, unpreproc
from tpu21cmvae_torch.utils.config import (
    AutoEncoderConfig,
    DirectEmulatorConfig,
    TrainConfig,
    VAEConfig,
)
from tpu21cmvae_torch.utils.metrics import error

#: Short-budget trial recipe: the reference training recipe
#: (Training.ipynb cells 4-5) cut down for search throughput.
TRIAL_TRAIN_DEFAULT = TrainConfig(
    epochs=80,
    early_stop_patience=10,
    plateau_patience=4,
)


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Architecture search space for a dense MLP stack."""

    min_layers: int = 2
    max_layers: int = 5
    width_choices: Tuple[int, ...] = (64, 96, 128, 160, 192, 224, 256, 288, 320, 352)

    def sample(self, rng: np.random.Generator) -> Tuple[int, ...]:
        n = int(rng.integers(self.min_layers, self.max_layers + 1))
        return tuple(int(w) for w in rng.choice(self.width_choices, size=n))


#: Widths in multiples of 128: every hidden layer fills the fp32 K1's
#: 128-column slabs (and its 32-deep fan-in padding, and the bf16 tiers'
#: 16 × 16 fragments) exactly, so the padded cost of the hidden stack is
#: its logical cost (the 451-bin output pads regardless). The JAX
#: package's same space, there for the TPU's 128-lane tiles.
MXU_ALIGNED_SPACE = SearchSpace(
    min_layers=3, max_layers=5, width_choices=(128, 256, 384)
)


@dataclasses.dataclass(frozen=True)
class LatentSearchSpace(SearchSpace):
    """AE search space: hidden stacks plus the latent bottleneck width."""

    min_layers: int = 1
    max_layers: int = 3
    latent_choices: Tuple[int, ...] = (5, 7, 9, 11, 13)

    def sample_latent(self, rng: np.random.Generator) -> int:
        return int(rng.choice(self.latent_choices))


@dataclasses.dataclass(frozen=True)
class VAESearchSpace(LatentSearchSpace):
    """VAE search space: latent/hidden widths plus the KL weight β (the
    posterior-collapse cliff sits between 1e-3 and 1e-1 —
    ``utils/config.py::VAEConfig``)."""

    beta_choices: Tuple[float, ...] = (1e-5, 1e-4, 1e-3)

    def sample_beta(self, rng: np.random.Generator) -> float:
        return float(rng.choice(self.beta_choices))


@dataclasses.dataclass
class Trial:
    """One evaluated architecture."""

    config: object  # DirectEmulatorConfig, AutoEncoderConfig or VAEConfig
    val_error: float  # mean relative RMSE (%) on the validation split
    val_loss: float
    epochs_ran: int
    wall_time_s: float
    # total trainable scalars — named like MLPConfig.weight_count to avoid
    # colliding with the configs' n_params (= number of INPUT parameters)
    weight_count: int

    @property
    def padded_flops_per_row(self) -> float:
        """What the port's K1 multiplies per batch row for this
        architecture's forward at the tier ``predict`` runs by default
        (``csrc/fused_mlp.cu``, fp32: each fan-in padded to 32, each
        fan-out to 128-column slabs; the skinny first layer runs apart,
        on the CUDA cores): the throughput cost
        :meth:`TuneResult.best_efficient` ranks by
        (:func:`~tpu21cmvae_torch.utils.profiling.padded_flops_per_row`).
        0.0 for configs without a single ``mlp()`` chain (AE and VAE
        trials span three stacks)."""
        from tpu21cmvae_torch.utils.profiling import padded_flops_per_row

        mlp = getattr(self.config, "mlp", None)
        if mlp is None:
            return 0.0
        return float(padded_flops_per_row(mlp().sizes))

    def describe(self) -> str:
        return (
            f"{self.config!r}: val_err={self.val_error:.4f}% "
            f"({self.weight_count} weights, {self.epochs_ran} epochs, "
            f"{self.wall_time_s:.1f}s)"
        )


@dataclasses.dataclass
class TuneResult:
    """All trials, best first."""

    trials: List[Trial]

    @property
    def best(self) -> Trial:
        return self.trials[0]

    def best_efficient(self, slack: float = 0.10) -> Trial:
        """Throughput-aware selection: among trials whose validation
        error is within ``slack`` (relative) of the best, the one with the
        LOWEST padded K1 cost (ties → better error). Accuracy stays the
        primary objective; the padding breaks the near-ties that pure
        val-error ranking decides by noise. Falls back to :attr:`best`
        when no trial records a cost (AE/VAE trials)."""
        if not 0.0 <= slack:
            raise ValueError(f"slack must be >= 0; got {slack}")
        finite = [t for t in self.trials if np.isfinite(t.val_error)]
        if not finite:
            return self.best
        cutoff = finite[0].val_error * (1.0 + slack)
        pool = [t for t in finite if t.val_error <= cutoff and t.padded_flops_per_row > 0.0]
        if not pool:
            return self.best
        return min(pool, key=lambda t: (t.padded_flops_per_row, t.val_error))

    def leaderboard(self, k: int = 10) -> str:
        return "\n".join(t.describe() for t in self.trials[:k])


def _run_trials(
    n_trials: int,
    sample_config: Callable[[np.random.Generator], object],
    evaluate: Callable[[object, int], Tuple[float, float, int, int]],
    seed: int,
    verbose: bool,
) -> TuneResult:
    rng = np.random.default_rng(seed)
    trials: List[Trial] = []
    seen = set()
    for i in range(n_trials):
        # resample on duplicates (configs are frozen dataclasses →
        # hashable); a small space can exhaust — stop loudly, not short
        cfg = sample_config(rng)
        attempts = 1
        while cfg in seen and attempts < 50:
            cfg = sample_config(rng)
            attempts += 1
        if cfg in seen:
            if verbose:
                print(f"[tune] search space exhausted after {len(trials)} unique "
                      "architectures; stopping early", flush=True)
            break
        seen.add(cfg)
        t0 = time.perf_counter()
        val_error, val_loss, epochs_ran, weight_count = evaluate(cfg, seed + i + 1)
        trial = Trial(config=cfg, val_error=val_error, val_loss=val_loss,
                      epochs_ran=epochs_ran, wall_time_s=time.perf_counter() - t0,
                      weight_count=weight_count)
        trials.append(trial)
        if verbose:
            print(f"[tune {i + 1}/{n_trials}] {trial.describe()}", flush=True)
    _rank(trials)
    return TuneResult(trials)


def _rank(trials: list) -> None:
    """Best validation error first; diverged trials (NaN) last, never
    winning."""
    trials.sort(key=lambda t: (not np.isfinite(t.val_error), t.val_error))


@dataclasses.dataclass
class _Prepared:
    """The splits transformed once for a whole search, on one device."""

    norm: Normalizer
    x_train: torch.Tensor
    y_train: torch.Tensor
    x_val: torch.Tensor
    y_val: torch.Tensor
    signal_val: np.ndarray


def _prep(data: DataSplits, device) -> _Prepared:
    """Transform the splits ONCE for a whole search (the reference
    re-preprocesses per call, ``preprocess.py:88-101``)."""
    norm = Normalizer.from_data(data.par_train, data.signal_train, device=device)

    def rows(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=norm.device)

    return _Prepared(norm, par_transform(rows(data.par_train), norm),
                     preproc(rows(data.signal_train), norm),
                     par_transform(rows(data.par_val), norm),
                     preproc(rows(data.signal_val), norm), np.asarray(data.signal_val))


def _val_error(prep: _Prepared, standardized) -> float:
    """Mean relative validation error (%) of standardized predictions."""
    pred = unpreproc(standardized.detach(), prep.norm).cpu().numpy()
    return float(np.mean(error(prep.signal_val, pred)))


# -- the trials' initial weights: the port's generators (seams for tests) ------


def _direct_init(cfg: DirectEmulatorConfig, seed: int, device):
    """The weights ``DirectEmulator(data, config=cfg, seed=seed)`` starts
    from."""
    return MLP(cfg.mlp().sizes, cfg.activation, device=device, seed=seed).params


def _em_init(cfg: AutoEncoderConfig, seed: int, device):
    """A params → latent MLP's starting weights from ``seed``."""
    return MLP(cfg.emulator().sizes, cfg.activation, device=device, seed=seed).params


def _ae_init(cfg: AutoEncoderConfig, seed: int, device):
    """The autoencoder weights ``AutoEncoder(cfg, seed=seed)`` starts from."""
    from tpu21cmvae_torch.models.autoencoder import AutoEncoder

    return AutoEncoder(cfg, seed=seed, device=device).params


def _vae_init(cfg: VAEConfig, seed: int, device):
    """The VAE weights ``VAE(cfg, seed=seed)`` starts from."""
    from tpu21cmvae_torch.models.vae import VAE

    return VAE(cfg, seed=seed, device=device).params


# -- the losses ----------------------------------------------------------------


def _direct_rel_loss(act, sm):
    """Direct-emulator relative-MSE loss."""

    def loss_fn(p, bx, by):
        return relative_mse(by, mlp_apply(p, bx, act), sm)

    return loss_fn


def _ae_rel_loss(act, sm):
    """Autoencoder reconstruction relative-MSE loss."""

    def ae_loss(p, bx, by):
        return relative_mse(by, mlp_apply(p["dec"], mlp_apply(p["enc"], bx, act), act), sm)

    return ae_loss


def _em_mse_loss(act):
    """Stage-B params → latent loss (plain MSE; normalizer-independent)."""

    def em_loss(p, bx, by):
        return mse(by, mlp_apply(p, bx, act))

    return em_loss


def _vae_loss(cfg: VAEConfig, sm):
    """The stochastic VAE stage-A loss: β-ELBO with the linear KL warm-up
    of ``cfg.kl_anneal_epochs`` in float32, as ``VAEEmulator.train``
    weighs it (``loss(p, x, y, noise, epoch)``)."""
    from tpu21cmvae_torch.models.vae import VAE

    carrier = VAE.__new__(VAE)  # methods only: they read the config, not weights
    carrier.config = cfg
    f32 = np.float32
    anneal = max(0, int(cfg.kl_anneal_epochs))

    def vae_loss(p, bx, by, noise, epoch):
        recon, mu, logvar = carrier.apply(p, bx, noise)
        scale = min(f32(1.0), f32(epoch + 1) / f32(anneal)) if anneal > 0 else f32(1.0)
        return relative_mse(by, recon, sm) + float(f32(cfg.beta) * scale) * kl_divergence(
            mu, logvar)

    return carrier, vae_loss


def _fitter(device_loop: bool):
    from tpu21cmvae_torch.train.loop import fit
    from tpu21cmvae_torch.train.scan import fit_scan

    return fit_scan if device_loop else fit


def tune_direct(
    data: DataSplits,
    n_trials: int = 20,
    space: SearchSpace = SearchSpace(),
    train_config: TrainConfig = TRIAL_TRAIN_DEFAULT,
    seed: int = 0,
    verbose: bool = False,
    device_loop: bool = False,
    *,
    device,
) -> TuneResult:
    """Random search over direct-emulator hidden stacks on ``device``.

    Scores each architecture by mean relative RMSE (%) on the validation
    split — the paper's figure of merit (Eq. 1; reference
    ``emulator.py:133-134``), computed on real-unit (mK) predictions.
    """
    fitter = _fitter(device_loop)
    prep = _prep(data, device)
    sm = prep.norm.scaled_mean

    def sample(rng):
        return DirectEmulatorConfig(n_params=data.n_params, n_bins=data.n_bins,
                                    hidden_dims=space.sample(rng))

    def evaluate(cfg, trial_seed):
        params = _direct_init(cfg, trial_seed, prep.norm.device)
        params, _, hist = fitter(
            params, _direct_rel_loss(cfg.activation, sm), prep.x_train, prep.y_train,
            prep.x_val, prep.y_val, dataclasses.replace(train_config, seed=trial_seed),
        )
        with torch.no_grad():
            val_err = _val_error(prep, mlp_apply(params, prep.x_val, cfg.activation))
        return val_err, float(min(hist.val_loss)), len(hist.val_loss), cfg.mlp().weight_count

    return _run_trials(n_trials, sample, evaluate, seed, verbose)


def _ae_stage_configs(ae_train_config, em_train_config):
    short = dataclasses.replace(TRIAL_TRAIN_DEFAULT, learning_rate=1e-3, plateau_factor=0.9)
    return (ae_train_config or short,
            em_train_config or dataclasses.replace(short, learning_rate=1e-2))


def tune_autoencoder(
    data: DataSplits,
    n_trials: int = 20,
    space: LatentSearchSpace = LatentSearchSpace(),
    em_space: SearchSpace = SearchSpace(),
    ae_train_config: Optional[TrainConfig] = None,
    em_train_config: Optional[TrainConfig] = None,
    seed: int = 0,
    verbose: bool = False,
    device_loop: bool = False,
    *,
    device,
) -> TuneResult:
    """Random search for the AE-based emulator: latent width, encoder /
    decoder stacks, and the params→latent stack (reference architecture
    at ``emulator.py:521-525``). Scored end-to-end (params → decoder →
    mK) on the validation split."""
    fitter = _fitter(device_loop)
    ae_cfg_t, em_cfg_t = _ae_stage_configs(ae_train_config, em_train_config)
    prep = _prep(data, device)
    sm = prep.norm.scaled_mean

    def sample(rng):
        return AutoEncoderConfig(
            n_params=data.n_params, n_bins=data.n_bins, latent_dim=space.sample_latent(rng),
            enc_hidden_dims=space.sample(rng), dec_hidden_dims=space.sample(rng),
            em_hidden_dims=em_space.sample(rng),
        )

    def evaluate(cfg, trial_seed):
        act = cfg.activation
        # AutoEncoderEmulator(..., seed=trial_seed)'s seeds
        ae_params = _ae_init(cfg, trial_seed, prep.norm.device)
        em_params = _em_init(cfg, trial_seed + 1, prep.norm.device)
        ae_params, _, _ = fitter(ae_params, _ae_rel_loss(act, sm), prep.y_train, prep.y_train,
                                 prep.y_val, prep.y_val,
                                 dataclasses.replace(ae_cfg_t, seed=trial_seed))
        # stage B: frozen-encoder latents as labels (emulator.py:753-754)
        with torch.no_grad():
            z_train = mlp_apply(ae_params["enc"], prep.y_train, act)
            z_val = mlp_apply(ae_params["enc"], prep.y_val, act)
        em_params, _, em_hist = fitter(em_params, _em_mse_loss(act), prep.x_train, z_train,
                                       prep.x_val, z_val,
                                       dataclasses.replace(em_cfg_t, seed=trial_seed))
        with torch.no_grad():
            val_err = _val_error(prep, mlp_apply(
                ae_params["dec"], mlp_apply(em_params, prep.x_val, act), act))
        n_par = (cfg.encoder().weight_count + cfg.decoder().weight_count
                 + cfg.emulator().weight_count)
        return val_err, float(min(em_hist.val_loss)), len(em_hist.val_loss), n_par

    return _run_trials(n_trials, sample, evaluate, seed, verbose)


def retrain_best(
    result: TuneResult,
    data: DataSplits,
    train_config: Optional[TrainConfig] = None,
    seed: int = 0,
    n_seeds: int = 1,
    mesh=None,
    *,
    device,
):
    """Train the winning architecture with the full reference recipe
    (350-epoch direct / 250-epoch AE defaults) on ``device`` and return
    the model.

    ``n_seeds > 1`` (direct family) trains that many init/shuffle-seed
    replicas through :func:`~tpu21cmvae_torch.train.scan.fit_scan_stack`
    and returns the replica with the best validation loss; ``mesh=``
    shards the seed axis over devices (``n_seeds`` must divide over it)."""
    cfg = result.best.config
    if isinstance(cfg, DirectEmulatorConfig):
        from tpu21cmvae_torch.models.direct import DirectEmulator

        if n_seeds > 1:
            from tpu21cmvae_torch.models.ensemble import DeepEnsemble

            ens = DeepEnsemble.train(data, n_members=n_seeds, config=cfg,
                                     train_config=train_config,
                                     seeds=[seed + i for i in range(n_seeds)],
                                     parallel=True, mesh=mesh, device=device)
            return min(ens.members, key=lambda m: min(m.history.val_loss))
        model = DirectEmulator(data, config=cfg, seed=seed, device=device)
        model.train(train_config=train_config)
        return model
    # VAEConfig subclasses AutoEncoderConfig — check the subclass first
    if isinstance(cfg, VAEConfig):
        from tpu21cmvae_torch.models.vae import VAEEmulator

        model = VAEEmulator(data, config=cfg, seed=seed, device=device)
        model.train(vae_train_config=train_config, em_train_config=train_config)
        return model
    from tpu21cmvae_torch.models.autoencoder import AutoEncoderEmulator

    model = AutoEncoderEmulator(data, config=cfg, seed=seed, device=device)
    # one recipe supplied → apply to both stages; None keeps the defaults
    model.train(ae_train_config=train_config, em_train_config=train_config)
    return model


def _unique(n_initial: int, draw: Callable[[], object]) -> list:
    """Up to ``n_initial`` distinct draws; an attempts bound (not a
    seen-count check) ends the search when the space has fewer."""
    seen, out = set(), []
    attempts = 0
    while len(out) < n_initial and attempts < n_initial * 50:
        attempts += 1
        cfg = draw()
        if cfg not in seen:
            seen.add(cfg)
            out.append(cfg)
    return out


def _survivor_trials(survivors, weight_count) -> TuneResult:
    trials = [Trial(config=s["cfg"], val_error=s["val_err"], val_loss=float("nan"),
                    epochs_ran=s["epochs"], wall_time_s=time.perf_counter() - s["t0"],
                    weight_count=weight_count(s["cfg"]))
              for s in survivors]
    _rank(trials)
    return TuneResult(trials)


def _halve(survivors, rung, rungs, eta, verbose, label, describe):
    """Rank the survivors; print the rung; keep the best ``1/eta`` before
    every rung but the last."""
    survivors.sort(key=lambda s: (not np.isfinite(s["val_err"]), s["val_err"]))
    if verbose:
        print(f"[{label} rung {rung + 1}/{rungs}] best {survivors[0]['val_err']:.4f}% "
              f"{describe(survivors[0]['cfg'])} ({len(survivors)} candidates)", flush=True)
    if rung < rungs - 1:
        return survivors[: max(1, len(survivors) // eta)]
    return survivors


def tune_direct_halving(
    data: DataSplits,
    n_initial: int = 16,
    rungs: int = 3,
    eta: int = 2,
    rung_epochs: int = 20,
    space: SearchSpace = SearchSpace(),
    train_config: TrainConfig = TRIAL_TRAIN_DEFAULT,
    seed: int = 0,
    verbose: bool = False,
    device_loop: bool = False,
    *,
    device,
) -> TuneResult:
    """Successive-halving architecture search for the direct emulator.

    Classic synchronous SHA: start ``n_initial`` random architectures,
    train each ``rung_epochs`` epochs, keep the best ``1/eta`` fraction,
    and CONTINUE the survivors (weights and Adam moments carry over
    between rungs) for another rung, for ``rungs`` rounds. Scores by mean
    relative validation error (%); the trials carry each survivor's total
    epochs.
    """
    fitter = _fitter(device_loop)
    rng = np.random.default_rng(seed)
    prep = _prep(data, device)
    sm = prep.norm.scaled_mean
    # no early stopping inside a rung: SHA's rung boundary is the
    # early-stopping mechanism; the LR schedule still applies per rung
    rung_cfg = dataclasses.replace(train_config, epochs=rung_epochs, early_stop_patience=None)
    configs = [DirectEmulatorConfig(n_params=data.n_params, n_bins=data.n_bins,
                                    hidden_dims=dims)
               for dims in _unique(n_initial, lambda: space.sample(rng))]
    survivors = [{"cfg": cfg, "params": _direct_init(cfg, seed + k + 1, prep.norm.device),
                  "opt": None, "epochs": 0, "t0": time.perf_counter()}
                 for k, cfg in enumerate(configs)]
    for rung in range(rungs):
        for s in survivors:
            act = s["cfg"].activation
            s["params"], s["opt"], hist = fitter(
                s["params"], _direct_rel_loss(act, sm), prep.x_train, prep.y_train,
                prep.x_val, prep.y_val, rung_cfg, opt_state=s["opt"])
            s["epochs"] += len(hist.loss)
            with torch.no_grad():
                s["val_err"] = _val_error(prep, mlp_apply(s["params"], prep.x_val, act))
        survivors = _halve(survivors, rung, rungs, eta, verbose, "sha",
                           lambda c: c.hidden_dims)
    return _survivor_trials(survivors, lambda c: c.mlp().weight_count)


def tune_autoencoder_halving(
    data: DataSplits,
    n_initial: int = 16,
    rungs: int = 3,
    eta: int = 2,
    rung_epochs: int = 20,
    space: LatentSearchSpace = LatentSearchSpace(),
    em_space: SearchSpace = SearchSpace(),
    seed: int = 0,
    verbose: bool = False,
    device_loop: bool = False,
    *,
    device,
) -> TuneResult:
    """Successive-halving search for the AE-based emulator.

    Each rung continues BOTH stages of every surviving candidate:
    ``rung_epochs`` more autoencoder epochs (Adam state carried), then a
    re-encode of the (moving) latent targets and ``rung_epochs`` more
    params→latent epochs (its Adam state carried too). Scored end-to-end
    in mK on the validation split.
    """
    fitter = _fitter(device_loop)
    rng = np.random.default_rng(seed)
    prep = _prep(data, device)
    sm = prep.norm.scaled_mean
    ae_cfg = TrainConfig(epochs=rung_epochs, learning_rate=1e-3, early_stop_patience=None,
                         plateau_factor=0.9)
    em_cfg = TrainConfig(epochs=rung_epochs, learning_rate=1e-2, early_stop_patience=None,
                         plateau_factor=0.9)

    def draw():
        return AutoEncoderConfig(
            n_params=data.n_params, n_bins=data.n_bins, latent_dim=space.sample_latent(rng),
            enc_hidden_dims=space.sample(rng), dec_hidden_dims=space.sample(rng),
            em_hidden_dims=em_space.sample(rng),
        )

    dev = prep.norm.device
    survivors = [{"cfg": cfg, "ae": _ae_init(cfg, seed + k + 1, dev),
                  "em": _em_init(cfg, seed - k - 1, dev), "ae_opt": None, "em_opt": None,
                  "epochs": 0, "t0": time.perf_counter()}
                 for k, cfg in enumerate(_unique(n_initial, draw))]
    for rung in range(rungs):
        for s in survivors:
            act = s["cfg"].activation
            s["ae"], s["ae_opt"], _ = fitter(s["ae"], _ae_rel_loss(act, sm), prep.y_train,
                                             prep.y_train, prep.y_val, prep.y_val, ae_cfg,
                                             opt_state=s["ae_opt"])
            with torch.no_grad():
                z_train = mlp_apply(s["ae"]["enc"], prep.y_train, act)
                z_val = mlp_apply(s["ae"]["enc"], prep.y_val, act)
            s["em"], s["em_opt"], _ = fitter(s["em"], _em_mse_loss(act), prep.x_train, z_train,
                                             prep.x_val, z_val, em_cfg, opt_state=s["em_opt"])
            s["epochs"] += 2 * rung_epochs
            with torch.no_grad():
                s["val_err"] = _val_error(prep, mlp_apply(
                    s["ae"]["dec"], mlp_apply(s["em"], prep.x_val, act), act))
        survivors = _halve(survivors, rung, rungs, eta, verbose, "ae-sha",
                           lambda c: f"latent {c.latent_dim}")
    return _survivor_trials(survivors, lambda c: (c.encoder().weight_count
                                                  + c.decoder().weight_count
                                                  + c.emulator().weight_count))


def _vae_weight_count(cfg: VAEConfig) -> int:
    """Trainable scalars of the full VAE emulator: trunk + two latent
    heads (mu, logvar) + decoder + params→latent MLP. Differs from the
    deterministic AE count — the VAE encoder ends in TWO linear heads
    (:class:`tpu21cmvae_torch.models.vae.VAE`)."""
    trunk_sizes = (cfg.n_bins, *cfg.enc_hidden_dims)
    trunk = sum(trunk_sizes[i] * trunk_sizes[i + 1] + trunk_sizes[i + 1]
                for i in range(len(trunk_sizes) - 1))
    heads = 2 * (trunk_sizes[-1] * cfg.latent_dim + cfg.latent_dim)
    return trunk + heads + cfg.decoder().weight_count + cfg.emulator().weight_count


def _vae_stages(fitter, prep, s, vae_cfg, em_cfg):
    """One round of both VAE stages for survivor/trial ``s`` (its weights
    and Adam states carried in it); returns the stage-B history and sets
    ``s["val_err"]``."""
    cfg = s["cfg"]
    act = cfg.activation
    carrier, loss = _vae_loss(cfg, prep.norm.scaled_mean)
    s["vae"], s["vae_opt"], _ = fitter(s["vae"], loss, prep.y_train, prep.y_train, prep.y_val,
                                       prep.y_val, vae_cfg, opt_state=s.get("vae_opt"),
                                       stochastic=True, pass_epoch=True)
    with torch.no_grad():
        z_train, _ = carrier.encode(s["vae"], prep.y_train)
        z_val, _ = carrier.encode(s["vae"], prep.y_val)
    s["em"], s["em_opt"], hist = fitter(s["em"], _em_mse_loss(act), prep.x_train, z_train,
                                        prep.x_val, z_val, em_cfg, opt_state=s.get("em_opt"))
    with torch.no_grad():
        s["val_err"] = _val_error(prep, carrier.decode(
            s["vae"], mlp_apply(s["em"], prep.x_val, act)))
    return hist


def tune_vae(
    data: DataSplits,
    n_trials: int = 20,
    space: VAESearchSpace = VAESearchSpace(),
    em_space: SearchSpace = SearchSpace(),
    vae_train_config: Optional[TrainConfig] = None,
    em_train_config: Optional[TrainConfig] = None,
    kl_anneal_epochs: int = 20,
    seed: int = 0,
    verbose: bool = False,
    device_loop: bool = False,
    *,
    device,
) -> TuneResult:
    """Random search for the VAE-based emulator: latent width, trunk /
    decoder / params→latent stacks, AND the KL weight β. Scored
    end-to-end (params → z_mean emulator → decoder → mK) on the
    validation split — the same figure of merit as the other families,
    so β trades reconstruction fidelity against latent regularity on
    equal footing."""
    fitter = _fitter(device_loop)
    vae_cfg_t, em_cfg_t = _ae_stage_configs(vae_train_config, em_train_config)
    prep = _prep(data, device)

    def sample(rng):
        return VAEConfig(
            n_params=data.n_params, n_bins=data.n_bins, latent_dim=space.sample_latent(rng),
            enc_hidden_dims=space.sample(rng), dec_hidden_dims=space.sample(rng),
            em_hidden_dims=em_space.sample(rng), beta=space.sample_beta(rng),
            kl_anneal_epochs=kl_anneal_epochs,
        )

    def evaluate(cfg, trial_seed):
        # VAEEmulator(..., seed=trial_seed)'s seeds
        s = {"cfg": cfg, "vae": _vae_init(cfg, trial_seed, prep.norm.device),
             "em": _em_init(cfg, trial_seed + 1, prep.norm.device)}
        hist = _vae_stages(fitter, prep, s, dataclasses.replace(vae_cfg_t, seed=trial_seed),
                           dataclasses.replace(em_cfg_t, seed=trial_seed))
        return s["val_err"], float(min(hist.val_loss)), len(hist.val_loss), _vae_weight_count(cfg)

    return _run_trials(n_trials, sample, evaluate, seed, verbose)


def tune_vae_halving(
    data: DataSplits,
    n_initial: int = 16,
    rungs: int = 3,
    eta: int = 2,
    rung_epochs: int = 20,
    space: VAESearchSpace = VAESearchSpace(),
    em_space: SearchSpace = SearchSpace(),
    seed: int = 0,
    verbose: bool = False,
    device_loop: bool = False,
    *,
    device,
) -> TuneResult:
    """Successive-halving search for the VAE-based emulator.

    Each rung continues BOTH stages of every survivor (VAE epochs with
    Adam state carried, then re-encoded z_mean targets and more
    params→latent epochs). Within-rung KL annealing is disabled (full β
    from the first epoch): the warm-up schedule is epoch-indexed per
    call and would restart every rung, under-weighting the KL term for
    short rungs — candidates instead compete at their final-β objective
    from the start.
    """
    fitter = _fitter(device_loop)
    rng = np.random.default_rng(seed)
    prep = _prep(data, device)
    vae_cfg = TrainConfig(epochs=rung_epochs, learning_rate=1e-3, early_stop_patience=None,
                          plateau_factor=0.9, seed=seed)
    em_cfg = TrainConfig(epochs=rung_epochs, learning_rate=1e-2, early_stop_patience=None,
                         plateau_factor=0.9, seed=seed)

    def draw():
        return VAEConfig(
            n_params=data.n_params, n_bins=data.n_bins, latent_dim=space.sample_latent(rng),
            enc_hidden_dims=space.sample(rng), dec_hidden_dims=space.sample(rng),
            em_hidden_dims=em_space.sample(rng), beta=space.sample_beta(rng),
            kl_anneal_epochs=0,  # see docstring: no within-rung warm-up
        )

    dev = prep.norm.device
    survivors = [{"cfg": cfg, "vae": _vae_init(cfg, seed + k + 1, dev),
                  "em": _em_init(cfg, seed - k - 1, dev), "vae_opt": None, "em_opt": None,
                  "epochs": 0, "t0": time.perf_counter()}
                 for k, cfg in enumerate(_unique(n_initial, draw))]
    for rung in range(rungs):
        for s in survivors:
            _vae_stages(fitter, prep, s, vae_cfg, em_cfg)
            s["epochs"] += 2 * rung_epochs
        survivors = _halve(survivors, rung, rungs, eta, verbose, "vae-sha",
                           lambda c: f"latent {c.latent_dim} beta {c.beta:g}")
    return _survivor_trials(survivors, _vae_weight_count)
