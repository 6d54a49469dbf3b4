"""Autoencoder-based emulator family (the port of
``tpu21cmvae/models/autoencoder.py``; reference ``emulator.py:445-518,
528-842``): a deterministic signal autoencoder (451 → latent 9 → 451)
trained on the relative-MSE reconstruction loss, then a params → latent
MLP trained by plain MSE on the frozen encoder's latents, composed with
the decoder for prediction (Appendix A of Bye et al. 2022).

The three networks are :class:`~tpu21cmvae_torch.ops.mlp.MLP` modules on
the device the caller names. Prediction is plain PyTorch, and so are the
likelihoods: the JAX package builds this family's likelihood with
``make_loglik_from_predict`` under ``jax.jit`` and reaches no Pallas
kernel, so the port runs the same function with autograd for its
gradient (:class:`PredictFamily`, which the VAE family shares). Both
training stages run the port's training loop
(:mod:`tpu21cmvae_torch.train`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from tpu21cmvae_torch.data.dataset import DataSplits
from tpu21cmvae_torch.models.checkpoint import load_checkpoint, save_checkpoint, unflatten_like
from tpu21cmvae_torch.models.direct import PAR_LABELS, _host, _resolve_axes
from tpu21cmvae_torch.models.io_keras import load_keras_mlp
from tpu21cmvae_torch.ops.losses import mse, relative_mse
from tpu21cmvae_torch.ops.mlp import MLP, init_mlp, mlp_apply, mlp_sizes, mlp_template
from tpu21cmvae_torch.ops.transforms import (
    Normalizer,
    par_transform,
    preproc,
    resolve_normalizer,
    unpreproc,
)
from tpu21cmvae_torch.train.loop import fit
from tpu21cmvae_torch.utils.config import (
    AE_EMULATOR_TRAIN_DEFAULT,
    AE_TRAIN_DEFAULT,
    AutoEncoderConfig,
    TrainConfig,
)
from tpu21cmvae_torch.utils.metrics import error
from tpu21cmvae_torch.utils.profiling import SAMPLER, span
from tpu21cmvae_torch.utils.tree import tree_leaves, treedef


def _make_stage_runner(device_loop, verbose, checkpoint_dir, checkpoint_every, resume):
    """One training-stage entry for the two-stage families: the host loop
    with a checkpoint subdirectory per stage, or the device-loop trainer
    (which has no host hooks)."""
    if device_loop:
        if checkpoint_dir is not None:
            raise ValueError(
                "device_loop=True runs without host hooks; drop "
                "checkpoint_dir or use the host loop."
            )
        from tpu21cmvae_torch.train.scan import fit_scan

        def run_stage(stage, *args, **kw):
            return fit_scan(*args, **kw)

    else:

        def run_stage(stage, *args, **kw):
            return fit(
                *args,
                verbose=verbose,
                checkpoint_dir=os.path.join(checkpoint_dir, stage) if checkpoint_dir else None,
                checkpoint_every=checkpoint_every,
                resume=resume,
                **kw,
            )

    return run_stage


def _rows(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _read_checkpoint(path: str, template):
    """``(tree, metadata)`` of a checkpoint bound to ``template``'s
    structure (its stored structure string must match)."""
    leaves, meta = load_checkpoint(path, treedef=treedef(template))
    return unflatten_like(template, leaves, source=path), meta


def _save_tree(path: str, tree, meta: dict) -> str:
    return save_checkpoint(path, [_host(t) for t in tree_leaves(tree)], treedef(tree), meta)


@torch.no_grad()
def _copy_into(dst, src) -> None:
    for a, b in zip(tree_leaves(dst), tree_leaves(src)):
        a.copy_(torch.as_tensor(b))


class PredictFamily:
    """What the two-stage families share: every likelihood, sampler, fit
    and evidence entry point over their ``(weights, raw) → signals``
    function (:meth:`predict_fn`), in plain PyTorch on the model's device
    with autograd for the gradient. Subclasses set ``device``,
    ``normalizer``, ``frequencies`` and ``params`` and define
    :meth:`predict_fn`. Each entry point has the contract of its
    :class:`~tpu21cmvae_torch.models.direct.DirectEmulator` namesake."""

    par_labels = PAR_LABELS

    def replica(self, device):
        """This model on ``device``, for a mesh that serves it there:
        itself on its own device, else a shallow copy, with no memo,
        whose normalizer sits on ``device`` (the weights are passed to
        every call and are not copied)."""
        from tpu21cmvae_torch.models._memo import replica_on

        return replica_on(self, device)

    def _on_each_device(self, make):
        """``make(self)``, a likelihood over this model's functions, with a
        ``replica(device)`` that is ``make`` of the model's replica there
        (:func:`~tpu21cmvae_torch.parallel.mesh.replicable`), for a mesh."""
        from tpu21cmvae_torch.parallel.mesh import replicable

        return replicable(lambda d: make(self.replica(d)), self.device)

    def predict(self, params) -> np.ndarray:
        """Emulated signal(s) in mK: one 7-vector gives (n_bins,), an
        (n, 7) batch (n, n_bins)."""
        raw = torch.atleast_2d(torch.as_tensor(np.asarray(params, np.float32),
                                               device=self.device))
        with torch.no_grad():
            pred = self.predict_fn()(self.params, raw).cpu().numpy()
        return pred[0] if pred.shape[0] == 1 else pred

    def loglik_fn(self, obs, noise_var=1.0, *, memo: bool = True):
        """Gaussian log-likelihood ``(weights, raw) → (B,)`` over the
        emulator → decoder pipeline
        (:func:`~tpu21cmvae_torch.ops.loglik.make_loglik_from_predict`;
        every noise spec of ``DirectEmulator.loglik_fn``), memoized on the
        value of ``(obs, noise_var)``."""
        from tpu21cmvae_torch.models._memo import memo_program, noise_key
        from tpu21cmvae_torch.ops.loglik import make_loglik_from_predict

        return memo_program(
            self, ("loglik", _host(obs), noise_key(noise_var)),
            lambda: self._on_each_device(lambda m: make_loglik_from_predict(
                m.predict_fn(), obs, noise_var, device=m.device)),
            memo=memo,
        )

    def loglik_and_grad_fn(self, obs, noise_var=1.0, *, memo: bool = True):
        """``(weights, raw) → (logL, dlogL/draw)`` by autograd through
        :meth:`loglik_fn`'s function: the gradient samplers' and the fits'
        inner loop for this family."""
        from tpu21cmvae_torch.models._memo import memo_program, noise_key
        from tpu21cmvae_torch.ops.loglik import make_loglik_and_grad_from_predict

        return memo_program(
            self, ("valgrad", _host(obs), noise_key(noise_var)),
            lambda: self._on_each_device(lambda m: make_loglik_and_grad_from_predict(
                m.predict_fn(), obs, noise_var, device=m.device)),
            memo=memo,
        )

    def loglik_multi_fn(self, obs_batch, noise_var=1.0, *, memo: bool = True):
        """Stacked-observation likelihood ``(weights, (O·W, 7)) → (O·W,)``
        (:func:`~tpu21cmvae_torch.ops.loglik.make_loglik_multi_from_predict`)."""
        from tpu21cmvae_torch.models._memo import memo_program, noise_key
        from tpu21cmvae_torch.ops.loglik import make_loglik_multi_from_predict

        return memo_program(
            self, ("multi", _host(obs_batch), noise_key(noise_var)),
            lambda: self._on_each_device(lambda m: make_loglik_multi_from_predict(
                m.predict_fn(), obs_batch, noise_var, device=m.device)),
            memo=memo,
        )

    def marginalize_foreground(self, noise_var=1.0, *, n_terms: int = 5, basis="linlog",
                               prior_var=None, nu_ref=None):
        """Foreground-marginalized noise model on this emulator's
        frequency axis (:mod:`tpu21cmvae_torch.foregrounds`)."""
        from tpu21cmvae_torch.foregrounds import foreground_basis, marginalize_foreground

        f = (foreground_basis(self.frequencies, n_terms, basis, nu_ref=nu_ref)
             if isinstance(basis, str) else basis)
        return marginalize_foreground(
            f, noise_var, n_bins=int(self.frequencies.shape[0]), prior_var=prior_var,
        )

    def sample_posterior(self, obs, noise_var=1.0, *, sampler: str = "hmc", bounds=None,
                         **kwargs):
        """Posterior sampling over this family's likelihood: ``"mh"``
        (``target_ess=`` runs ``sample_to_ess``), ``"ensemble"``, ``"pt"``
        and ``"smc"`` score through :meth:`loglik_fn`; ``"hmc"``,
        ``"chees"`` and ``"nuts"`` through :meth:`loglik_and_grad_fn`."""
        with span("sample_posterior", SAMPLER):
            if sampler in ("mh", "ensemble", "pt", "smc"):
                from tpu21cmvae_torch.sampling.driver import sample_to_ess
                from tpu21cmvae_torch.sampling.mh import sample_ensemble, sample_mh
                from tpu21cmvae_torch.sampling.pt import sample_pt
                from tpu21cmvae_torch.sampling.smc import sample_smc

                if sampler == "mh" and "target_ess" in kwargs:
                    run = sample_to_ess
                else:
                    run = {"mh": sample_mh, "ensemble": sample_ensemble, "pt": sample_pt,
                           "smc": sample_smc}[sampler]
                return run(self.loglik_fn(obs, noise_var), self.params, bounds=bounds,
                           device=self.device, **kwargs)
            if sampler not in ("hmc", "chees", "nuts"):
                raise ValueError(
                    "sampler must be 'mh', 'ensemble', 'hmc', 'chees', 'nuts', "
                    f"'pt' or 'smc'; got {sampler!r}"
                )
            from tpu21cmvae_torch.sampling import gradient

            run = {"hmc": gradient.sample_hmc, "chees": gradient.sample_chees,
                   "nuts": gradient.sample_nuts}[sampler]
            return run(self.loglik_and_grad_fn(obs, noise_var), self.params, bounds=bounds,
                       device=self.device, **kwargs)

    def sample_posterior_batch(self, obs_batch, noise_var=1.0, *, sampler: str = "mh",
                               n_walkers: int = 256, bounds=None, **kwargs):
        """Posteriors for ``O`` observed spectra in one chain over the
        stacked-observation likelihood (``n_walkers`` per observation)."""
        from tpu21cmvae_torch.ops.loglik import make_loglik_multi_from_predict, per_row_grad
        from tpu21cmvae_torch.sampling.driver import run_batched_chain

        obs_batch = np.atleast_2d(np.asarray(obs_batch, np.float32))
        base = self._on_each_device(lambda m: make_loglik_multi_from_predict(
            m.predict_fn(), obs_batch, noise_var, device=m.device))
        return run_batched_chain(
            sampler, self.params, obs_batch.shape[0], n_walkers,
            loglik_builder=lambda: base,
            valgrad_builder=lambda: per_row_grad(base, device=self.device),
            bounds=bounds, device=self.device, **kwargs,
        )

    def fit_params(self, obs, noise_var=1.0, *, bounds=None, **kwargs):
        """Multi-start maximum-likelihood fit
        (:func:`~tpu21cmvae_torch.sampling.fit.fit_map`)."""
        from tpu21cmvae_torch.sampling.fit import fit_map

        return fit_map(self.loglik_and_grad_fn(obs, noise_var), self.params, bounds=bounds,
                       device=self.device, **kwargs)

    def profile_likelihood(self, obs, noise_var, index, grid, *, bounds=None, **kwargs):
        """Profile likelihood of parameter ``index`` over ``grid``
        (:func:`~tpu21cmvae_torch.sampling.fit.profile_likelihood`)."""
        from tpu21cmvae_torch.sampling.fit import profile_likelihood

        return profile_likelihood(self.loglik_and_grad_fn(obs, noise_var), self.params,
                                  index, grid, bounds=bounds, device=self.device, **kwargs)

    def fit_advi(self, obs, noise_var=1.0, *, bounds=None, **kwargs):
        """Full-rank Gaussian ADVI (:func:`~tpu21cmvae_torch.vi.fit_advi`)."""
        from tpu21cmvae_torch.vi import fit_advi

        return fit_advi(self.loglik_and_grad_fn(obs, noise_var), self.params, bounds=bounds,
                        device=self.device, **kwargs)

    def fit_flow(self, obs, noise_var=1.0, *, bounds=None, **kwargs):
        """Normalizing-flow posterior fit
        (:func:`~tpu21cmvae_torch.flows.fit_flow`)."""
        from tpu21cmvae_torch.flows import fit_flow

        return fit_flow(self.loglik_and_grad_fn(obs, noise_var), self.params, bounds=bounds,
                        device=self.device, **kwargs)

    def log_evidence(self, obs, noise_var=1.0, *, bounds=None, method="nested",
                     warm_start=True, **kwargs):
        """Bayesian evidence ``log Z``: ``method="nested"`` (default),
        ``"smc"``, ``"laplace"`` (its Hessian by double autograd), ``"flow"``
        or ``"ladder"`` (``warm_start``: every rung seeded from a
        ``max(1024, n_walkers)``-start :meth:`fit_params` of 500 steps)."""
        loglik = self.loglik_fn(obs, noise_var)
        if method == "nested":
            from tpu21cmvae_torch.nested import nested_sampling

            return nested_sampling(loglik, self.params, bounds=bounds, device=self.device,
                                   **kwargs)
        if method == "smc":
            from tpu21cmvae_torch.sampling.smc import sample_smc

            return sample_smc(loglik, self.params, bounds=bounds, device=self.device, **kwargs)
        if method == "laplace":
            from tpu21cmvae_torch.sampling.evidence import laplace_evidence

            return laplace_evidence(loglik, self.params, bounds=bounds, device=self.device,
                                    **kwargs)
        if method == "flow":
            from tpu21cmvae_torch.flows import evidence_with_flow

            return evidence_with_flow(loglik, self.loglik_and_grad_fn(obs, noise_var),
                                      self.params, bounds=bounds, device=self.device, **kwargs)
        if method != "ladder":
            raise ValueError(
                f"method must be 'nested', 'smc', 'laplace', 'flow' or 'ladder'; got {method!r}"
            )
        from tpu21cmvae_torch.sampling.evidence import log_evidence

        if warm_start and "x0" not in kwargs:
            fit_res = self.fit_params(
                obs, noise_var, bounds=bounds, n_starts=max(1024, kwargs.get("n_walkers", 256)),
                n_steps=500, seed=kwargs.get("seed", 0) + 101, log_prior=kwargs.get("log_prior"),
            )
            kwargs.setdefault("n_walkers", 256)
            kwargs["x0"] = fit_res.top(kwargs["n_walkers"])[0]
        return log_evidence(loglik, self.params, bounds=bounds, device=self.device, **kwargs)

    def log_evidence_batch(self, obs_batch, noise_var=1.0, *, bounds=None, method="auto",
                           khat_threshold=0.7, flow_kwargs=None, final=None,
                           final_kwargs=None, **kwargs):
        """Batched Laplace + IS evidences with the khat escalation
        (:func:`~tpu21cmvae_torch.sampling.evidence.laplace_evidence_multi_auto`)
        over the stacked-observation likelihood."""
        from tpu21cmvae_torch.ops.loglik import per_row_grad
        from tpu21cmvae_torch.sampling.evidence import laplace_evidence_multi_auto

        obs_batch = np.atleast_2d(np.asarray(obs_batch, np.float32))
        return laplace_evidence_multi_auto(
            self.loglik_multi_fn(obs_batch, noise_var), self.params, obs_batch.shape[0],
            bounds=bounds, method=method, khat_threshold=khat_threshold,
            flow_kwargs=flow_kwargs, final=final, final_kwargs=final_kwargs,
            row_loglik=lambda i: self.loglik_fn(obs_batch[i], noise_var),
            row_valgrad=lambda i: self.loglik_and_grad_fn(obs_batch[i], noise_var),
            rows_loglik=lambda idx: self.loglik_multi_fn(obs_batch[np.asarray(idx)], noise_var),
            rows_valgrad=lambda idx: per_row_grad(
                self.loglik_multi_fn(obs_batch[np.asarray(idx)], noise_var), device=self.device),
            device=self.device, **kwargs,
        )

    def goodness_of_fit(self, obs, noise_var=25.0, draws=None, **kwargs):
        """Posterior predictive model check
        (:func:`tpu21cmvae_torch.calibration.goodness_of_fit`)."""
        from tpu21cmvae_torch.calibration import goodness_of_fit

        return goodness_of_fit(self, obs, noise_var, draws, **kwargs)

    def goodness_of_fit_batch(self, obs_batch, noise_var=25.0, draws=None, **kwargs):
        """Posterior predictive checks of ``O`` observations
        (:func:`tpu21cmvae_torch.calibration.goodness_of_fit_batch`)."""
        from tpu21cmvae_torch.calibration import goodness_of_fit_batch

        return goodness_of_fit_batch(self, obs_batch, noise_var, draws, **kwargs)

    def posterior_predictive(self, samples, **kwargs):
        """Signal-space credible bands of posterior samples
        (:func:`tpu21cmvae_torch.sampling.predictive.posterior_predictive`)."""
        from tpu21cmvae_torch.sampling.predictive import posterior_predictive

        return posterior_predictive(self.predict, samples, **kwargs)

    def _meta(self, kind: str) -> dict:
        """The checkpoint metadata both families write (the architecture)."""
        cfg = self.config
        return {
            "kind": kind, "n_params": cfg.n_params, "n_bins": cfg.n_bins,
            "latent_dim": cfg.latent_dim, "enc_hidden_dims": list(cfg.enc_hidden_dims),
            "dec_hidden_dims": list(cfg.dec_hidden_dims),
            "em_hidden_dims": list(cfg.em_hidden_dims), "activation": cfg.activation,
            "redshifts": [float(z) for z in self.redshifts],
        }

    @staticmethod
    def _config(path: str, kind: str, config_cls=AutoEncoderConfig, **extra):
        """The architecture a ``kind`` checkpoint's header gives, and the
        header (another family's checkpoint is refused)."""
        from tpu21cmvae_torch.models.checkpoint import read_checkpoint_meta

        meta = read_checkpoint_meta(path)
        if meta.get("kind") != kind:
            raise ValueError(f"{path} holds a {meta.get('kind')!r}; expected {kind!r}")
        extra = {k: meta.get(k, v) for k, v in extra.items()}
        return config_cls(
            n_params=meta["n_params"], n_bins=meta["n_bins"], latent_dim=meta["latent_dim"],
            enc_hidden_dims=tuple(meta["enc_hidden_dims"]),
            dec_hidden_dims=tuple(meta["dec_hidden_dims"]),
            em_hidden_dims=tuple(meta["em_hidden_dims"]),
            activation=meta.get("activation", "relu"), **extra,
        )

    def _test_error(self, pred, relative, flow, fhigh) -> np.ndarray:
        return error(self.data.signal_test, pred, relative=relative, nu_arr=self.frequencies,
                     flow=flow, fhigh=fhigh)

    def _require_data(self):
        if self.data is None:
            raise ValueError("No dataset attached; construct with `data=`.")
        return self.data


class AutoEncoder:
    """Deterministic signal autoencoder, encoder then decoder, over
    standardized signals (reference ``emulator.py:445-518``), its two
    MLPs on ``device``. Without weights they are Glorot-initialized from
    one generator seeded with ``seed``, the encoder's first."""

    def __init__(self, config: AutoEncoderConfig = AutoEncoderConfig(), *, enc_params=None,
                 dec_params=None, seed: int = 0, device):
        self.config = config
        g = torch.Generator().manual_seed(seed)
        if enc_params is None:
            enc_params = init_mlp(g, config.encoder().sizes, device="cpu")
        if dec_params is None:
            dec_params = init_mlp(g, config.decoder().sizes, device="cpu")
        self.enc = MLP(config.encoder().sizes, config.activation, device=device,
                       params=enc_params)
        self.dec = MLP(config.decoder().sizes, config.activation, device=device,
                       params=dec_params)

    def encode(self, params, x):
        return mlp_apply(params["enc"], x, self.config.activation)

    def decode(self, params, z):
        return mlp_apply(params["dec"], z, self.config.activation)

    def apply(self, params, x):
        """Reconstruction ``decode(encode(x))`` (reference
        ``emulator.py:502-518``)."""
        return self.decode(params, self.encode(params, x))

    @property
    def params(self):
        return {"enc": self.enc.params, "dec": self.dec.params}

    @params.setter
    def params(self, value):
        _copy_into(self.params, value)

    @property
    def enc_params(self):
        return self.enc.params

    @property
    def dec_params(self):
        return self.dec.params


class AutoEncoderEmulator(PredictFamily):
    """Two-stage autoencoder-based emulator (reference
    ``emulator.py:528-842``) on an explicit ``device``. Without weights
    the autoencoder is initialized from ``seed`` and the params → latent
    MLP from ``seed + 1``."""

    def __init__(
        self,
        data: Optional[DataSplits] = None,
        *,
        config: AutoEncoderConfig = AutoEncoderConfig(),
        normalizer: Optional[Normalizer] = None,
        enc_params=None,
        dec_params=None,
        em_params=None,
        redshifts=None,
        frequencies=None,
        seed: int = 0,
        device,
    ):
        self.device = torch.empty(0, device=device).device
        self.normalizer = resolve_normalizer(data, normalizer, device=self.device)
        self.data = data
        self.config = config
        self.redshifts, self.frequencies = _resolve_axes(redshifts, frequencies)
        self.autoencoder = AutoEncoder(config, enc_params=enc_params, dec_params=dec_params,
                                       seed=seed, device=self.device)
        self.em = MLP(config.emulator().sizes, config.activation, device=self.device,
                      params=em_params, seed=seed + 1)
        self.history = None

    @property
    def em_params(self):
        return self.em.params

    @property
    def params(self):
        """The weights :meth:`predict_fn` takes: ``{"em", "dec"}``."""
        return {"em": self.em.params, "dec": self.autoencoder.dec.params}

    # -- construction ------------------------------------------------------

    @classmethod
    def from_keras_h5(cls, emulator_path: str, encoder_path: str, decoder_path: str,
                      data: Optional[DataSplits] = None,
                      normalizer: Optional[Normalizer] = None, *, device,
                      **kwargs) -> "AutoEncoderEmulator":
        """Import the reference's three pretrained h5 files (reference
        ``emulator.py:667-699``; needs ``h5py``)."""
        em, enc, dec = (load_keras_mlp(p) for p in (emulator_path, encoder_path, decoder_path))
        enc_sizes, dec_sizes, em_sizes = mlp_sizes(enc), mlp_sizes(dec), mlp_sizes(em)
        cfg = AutoEncoderConfig(
            n_params=em_sizes[0], n_bins=enc_sizes[0], latent_dim=enc_sizes[-1],
            enc_hidden_dims=tuple(enc_sizes[1:-1]), dec_hidden_dims=tuple(dec_sizes[1:-1]),
            em_hidden_dims=tuple(em_sizes[1:-1]),
        )
        return cls(data, config=cfg, normalizer=normalizer, enc_params=enc, dec_params=dec,
                   em_params=em, device=device, **kwargs)

    def save(self, path: str) -> str:
        """Weights, normalizer and architecture in one atomic ``.npz`` that
        the JAX package's ``from_checkpoint`` reads."""
        meta = self._meta("AutoEncoderEmulator")
        tree = {"enc": self.autoencoder.enc.params, "dec": self.autoencoder.dec.params,
                "em": self.em.params, "normalizer": self.normalizer}
        return _save_tree(path, tree, meta)

    @classmethod
    def from_checkpoint(cls, path: str, data: Optional[DataSplits] = None, *,
                        device) -> "AutoEncoderEmulator":
        """Restore a model saved by either package."""
        cfg = cls._config(path, "AutoEncoderEmulator")
        template = {"enc": mlp_template(cfg.encoder().sizes),
                    "dec": mlp_template(cfg.decoder().sizes),
                    "em": mlp_template(cfg.emulator().sizes),
                    "normalizer": Normalizer.template(cfg.n_bins, cfg.n_params)}
        tree, meta = _read_checkpoint(path, template)
        return cls(
            data, config=cfg, normalizer=Normalizer.from_arrays(tree["normalizer"], device=device),
            enc_params=tree["enc"], dec_params=tree["dec"], em_params=tree["em"],
            redshifts=np.asarray(meta["redshifts"]) if "redshifts" in meta else None,
            device=device,
        )

    # -- inference ---------------------------------------------------------

    def predict_fn(self):
        """``(weights {"em", "dec"}, raw) → signals (B, n_bins)`` in mK, on
        tensors, differentiable by autograd: par_transform → emulator →
        decoder → unpreproc (reference ``emulator.py:770-795``)."""
        norm, act = self.normalizer, self.config.activation

        def predict(weights, raw):
            z = mlp_apply(weights["em"], par_transform(raw, norm), act)
            return unpreproc(mlp_apply(weights["dec"], z, act), norm)

        return predict

    def reconstruct(self, signals) -> np.ndarray:
        """The autoencoder's round trip of raw (mK) signals."""
        sig = torch.atleast_2d(_rows(signals, self.device))
        with torch.no_grad():
            rec = self.autoencoder.apply(self.autoencoder.params, preproc(sig, self.normalizer))
            rec = unpreproc(rec, self.normalizer).cpu().numpy()
        return rec[0] if rec.shape[0] == 1 else rec

    # -- training ----------------------------------------------------------

    def train(self, epochs: Optional[int] = None, ae_train_config: Optional[TrainConfig] = None,
              em_train_config: Optional[TrainConfig] = None, verbose: bool = False,
              checkpoint_dir: Optional[str] = None, checkpoint_every: int = 10,
              resume: bool = False, device_loop: bool = False) -> Tuple[list, list, list, list]:
        """Stage A: the autoencoder on standardized signals (relative
        MSE); stage B: the params → latent MLP on the frozen encoder's
        latents (MSE) — reference ``emulator.py:701-768``. The weights
        train in place on the model's device. Returns ``(ae_loss,
        ae_val_loss, loss, val_loss)``; ``checkpoint_dir`` checkpoints
        each stage in its own subdirectory (``stage_ae``, ``stage_em``),
        so ``resume=True`` continues inside the stage a run stopped in."""
        data = self._require_data()
        ae_cfg = ae_train_config or AE_TRAIN_DEFAULT
        em_cfg = em_train_config or AE_EMULATOR_TRAIN_DEFAULT
        if epochs is not None:
            ae_cfg = dataclasses.replace(ae_cfg, epochs=epochs)
            em_cfg = dataclasses.replace(em_cfg, epochs=epochs)
        norm, act = self.normalizer, self.config.activation
        scaled_mean = norm.scaled_mean
        y_train, y_val = (preproc(_rows(s, self.device), norm)
                          for s in (data.signal_train, data.signal_val))
        ae = self.autoencoder

        def ae_loss_fn(params, x, y):
            return relative_mse(y, ae.apply(params, x), scaled_mean)

        run_stage = _make_stage_runner(device_loop, verbose, checkpoint_dir, checkpoint_every,
                                       resume)
        _, _, ae_hist = run_stage("stage_ae", ae.params, ae_loss_fn, y_train, y_train, y_val,
                                  y_val, ae_cfg)

        # stage B: the encoder frozen, its latents the labels
        # (reference emulator.py:753-754)
        with torch.no_grad():
            z_train, z_val = (ae.encode(ae.params, y) for y in (y_train, y_val))
        x_train, x_val = (par_transform(_rows(p, self.device), norm)
                          for p in (data.par_train, data.par_val))

        def em_loss_fn(params, x, y):
            return mse(y, mlp_apply(params, x, act))

        _, _, em_hist = run_stage("stage_em", self.em.params, em_loss_fn, x_train, z_train,
                                  x_val, z_val, em_cfg)
        self.history = {"autoencoder": ae_hist, "emulator": em_hist}
        return ae_hist.loss, ae_hist.val_loss, em_hist.loss, em_hist.val_loss

    # -- evaluation --------------------------------------------------------

    def test_error(self, use_autoencoder: bool = False, relative: bool = True, flow=None,
                   fhigh=None) -> np.ndarray:
        """Test-set error of the emulator pipeline, or of the pure
        autoencoder round trip with ``use_autoencoder=True`` (reference
        ``emulator.py:797-842``)."""
        data = self._require_data()
        pred = (self.reconstruct(data.signal_test) if use_autoencoder
                else self.predict(data.par_test))
        return self._test_error(pred, relative, flow, fhigh)
