"""Variational autoencoder emulator family (the port of
``tpu21cmvae/models/vae.py``).

The reference repository is named 21cmVAE but its v3.1.0 snapshot ships
a deterministic autoencoder only (reference ``emulator.py:445-518``);
the JAX package restores the variational model, and this is its port:

* an encoder trunk → (z_mean, z_logvar) heads;
* reparameterized sampling ``z = mu + exp(logvar/2)·ε`` whose normals ε
  come from an explicit ``torch.Generator``, a tensor, or the training
  loop's draw seam (``tpu21cmvae_torch.train.loop._normal``) — no hidden
  random state;
* the loss: relative-MSE reconstruction + β·KL(q(z|x) ‖ N(0, I)), β
  warmed up linearly over ``kl_anneal_epochs``;
* latent traversals for the parameter-importance analysis.

Prediction decodes the emulated z_mean (no sampling), so inference,
likelihoods and samplers are the autoencoder family's
(:class:`~tpu21cmvae_torch.models.autoencoder.PredictFamily`), in plain
PyTorch on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tpu21cmvae_torch.data.dataset import DataSplits
from tpu21cmvae_torch.models.autoencoder import (
    PredictFamily,
    _copy_into,
    _make_stage_runner,
    _read_checkpoint,
    _rows,
    _save_tree,
)
from tpu21cmvae_torch.models.direct import _resolve_axes
from tpu21cmvae_torch.ops.losses import kl_divergence, mse, relative_mse
from tpu21cmvae_torch.ops.mlp import MLP, init_mlp, mlp_apply, mlp_template, resolve_activation
from tpu21cmvae_torch.ops.transforms import (
    Normalizer,
    par_transform,
    preproc,
    resolve_normalizer,
    unpreproc,
)
from tpu21cmvae_torch.utils.config import (
    AE_EMULATOR_TRAIN_DEFAULT,
    AE_TRAIN_DEFAULT,
    TrainConfig,
    VAEConfig,
)


def _normals(noise, shape, device) -> torch.Tensor:
    """Standard normals of ``shape`` on ``device`` from ``noise``: a
    ``torch.Generator`` (drawn on its own device, then moved), a tensor of
    the normals themselves, or a ``shape → normals`` source (the training
    loop's)."""
    if isinstance(noise, torch.Generator):
        return torch.randn(tuple(shape), generator=noise, device=noise.device).to(device)
    if isinstance(noise, torch.Tensor):
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"normals of shape {tuple(noise.shape)}; need {tuple(shape)}")
        return noise.to(device=device, dtype=torch.float32)
    return noise(shape)


class VAE:
    """Signal VAE over standardized signals, its weights on ``device``.

    Weights: ``{"trunk": layers, "mu": layer, "logvar": layer, "dec":
    layers}``. The trunk applies the activation after every layer (the
    heads are linear); the decoder has the autoencoder's decoder shape.
    Without ``params`` they are Glorot-initialized from one generator
    seeded with ``seed``, in that order.
    """

    def __init__(self, config: VAEConfig = VAEConfig(), *, params=None, seed: int = 0,
                 device):
        self.config = config
        trunk_sizes = (config.n_bins, *config.enc_hidden_dims)
        width = trunk_sizes[-1]
        if params is None:
            g = torch.Generator().manual_seed(seed)
            params = {
                "trunk": init_mlp(g, trunk_sizes, device="cpu"),
                "mu": init_mlp(g, (width, config.latent_dim), device="cpu")[0],
                "logvar": init_mlp(g, (width, config.latent_dim), device="cpu")[0],
                "dec": init_mlp(g, config.decoder().sizes, device="cpu"),
            }
        act = config.activation
        self.trunk = MLP(trunk_sizes, act, device=device, params=params["trunk"])
        self.mu = MLP((width, config.latent_dim), act, device=device, params=(params["mu"],))
        self.logvar = MLP((width, config.latent_dim), act, device=device,
                          params=(params["logvar"],))
        self.dec = MLP(config.decoder().sizes, act, device=device, params=params["dec"])

    @property
    def params(self):
        return {"trunk": self.trunk.params, "mu": self.mu.params[0],
                "logvar": self.logvar.params[0], "dec": self.dec.params}

    @params.setter
    def params(self, value):
        _copy_into(self.params, value)

    # the functions of the weights ------------------------------------------

    def encode(self, params, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(mu, logvar)`` of standardized signals ``x``."""
        act = resolve_activation(self.config.activation)
        h = x
        for layer in params["trunk"]:
            h = act(h @ layer["w"] + layer["b"])
        return (h @ params["mu"]["w"] + params["mu"]["b"],
                h @ params["logvar"]["w"] + params["logvar"]["b"])

    def reparameterize(self, noise, mu, logvar) -> torch.Tensor:
        """``mu + exp(logvar/2)·ε``, ε from ``noise`` (a generator, a
        tensor of normals or a source; see the module docstring)."""
        return mu + torch.exp(0.5 * logvar) * _normals(noise, mu.shape, mu.device)

    def decode(self, params, z) -> torch.Tensor:
        return mlp_apply(params["dec"], z, self.config.activation)

    def apply(self, params, x, noise=None):
        """``(reconstruction, mu, logvar)``: with ``noise``, decoded from a
        posterior sample; without, from the posterior mean."""
        mu, logvar = self.encode(params, x)
        z = mu if noise is None else self.reparameterize(noise, mu, logvar)
        return self.decode(params, z), mu, logvar

    def loss_fn(self, scaled_mean):
        """Per-sample β-ELBO on standardized signals at constant β:
        ``loss(params, x, y, noise)``, the training loop's ``stochastic=True``
        signature (:meth:`VAEEmulator.train` builds the annealed one)."""
        beta = self.config.beta

        def loss(params, x, y, noise):
            recon, mu, logvar = self.apply(params, x, noise)
            return relative_mse(y, recon, scaled_mean) + beta * kl_divergence(mu, logvar)

        return loss


class VAEEmulator(PredictFamily):
    """Two-stage VAE-based emulator on an explicit ``device``: the VAE on
    signals, then a params → z_mean MLP; prediction decodes the emulated
    latent. The variational analogue of
    :class:`~tpu21cmvae_torch.models.autoencoder.AutoEncoderEmulator`."""

    def __init__(
        self,
        data: Optional[DataSplits] = None,
        *,
        config: VAEConfig = VAEConfig(),
        normalizer: Optional[Normalizer] = None,
        vae_params=None,
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
        self.vae = VAE(config, params=vae_params, seed=seed, device=self.device)
        self.em = MLP(config.emulator().sizes, config.activation, device=self.device,
                      params=em_params, seed=seed + 1)
        self.history = None

    @property
    def em_params(self):
        return self.em.params

    @property
    def params(self):
        """The weights :meth:`predict_fn` takes: ``{"em", "vae"}``."""
        return {"em": self.em.params, "vae": self.vae.params}

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> str:
        """Weights, normalizer and architecture in one atomic ``.npz`` that
        the JAX package's ``from_checkpoint`` reads."""
        meta = dict(self._meta("VAEEmulator"), beta=self.config.beta,
                    kl_anneal_epochs=self.config.kl_anneal_epochs)
        return _save_tree(path, {"vae": self.vae.params, "em": self.em.params,
                                 "normalizer": self.normalizer}, meta)

    @classmethod
    def from_checkpoint(cls, path: str, data: Optional[DataSplits] = None, *,
                        device) -> "VAEEmulator":
        """Restore a model saved by either package."""
        cfg = cls._config(path, "VAEEmulator", VAEConfig, beta=1.0, kl_anneal_epochs=0)
        trunk = (cfg.n_bins, *cfg.enc_hidden_dims)
        head = mlp_template((trunk[-1], cfg.latent_dim))[0]
        template = {"vae": {"trunk": mlp_template(trunk), "mu": head, "logvar": head,
                            "dec": mlp_template(cfg.decoder().sizes)},
                    "em": mlp_template(cfg.emulator().sizes),
                    "normalizer": Normalizer.template(cfg.n_bins, cfg.n_params)}
        tree, meta = _read_checkpoint(path, template)
        return cls(
            data, config=cfg, normalizer=Normalizer.from_arrays(tree["normalizer"], device=device),
            vae_params=tree["vae"], em_params=tree["em"],
            redshifts=np.asarray(meta["redshifts"]) if "redshifts" in meta else None,
            device=device,
        )

    # -- inference -----------------------------------------------------------

    def predict_fn(self):
        """``(weights {"em", "vae"}, raw) → signals (B, n_bins)`` in mK, on
        tensors, differentiable by autograd: the emulated z_mean,
        decoded."""
        norm, act, vae = self.normalizer, self.config.activation, self.vae

        def predict(weights, raw):
            z = mlp_apply(weights["em"], par_transform(raw, norm), act)
            return unpreproc(vae.decode(weights["vae"], z), norm)

        return predict

    def reconstruct(self, signals) -> np.ndarray:
        """The VAE's deterministic round trip (posterior mean) of raw
        (mK) signals."""
        sig = torch.atleast_2d(_rows(signals, self.device))
        with torch.no_grad():
            rec, _, _ = self.vae.apply(self.vae.params, preproc(sig, self.normalizer))
            rec = unpreproc(rec, self.normalizer).cpu().numpy()
        return rec[0] if rec.shape[0] == 1 else rec

    @torch.no_grad()
    def sample_signals(self, noise, n: int) -> np.ndarray:
        """``n`` signals from the prior: z ~ N(0, I) from ``noise`` (a
        generator or an (n, latent_dim) tensor of normals) → decoder →
        mK."""
        z = _normals(noise, (n, self.config.latent_dim), self.device)
        return unpreproc(self.vae.decode(self.vae.params, z), self.normalizer).cpu().numpy()

    @torch.no_grad()
    def latent_traversal(self, dim: int, values, base_params=None) -> np.ndarray:
        """Signals decoded along latent dimension ``dim`` at ``values``;
        the other dimensions at the emulated z_mean of ``base_params``
        (raw astrophysical parameters), else at 0."""
        values = _rows(values, self.device)
        if base_params is not None:
            x = par_transform(torch.atleast_2d(_rows(base_params, self.device)),
                              self.normalizer)
            base = mlp_apply(self.em.params, x, self.config.activation)[0]
        else:
            base = torch.zeros(self.config.latent_dim, device=self.device)
        z = base.repeat(values.shape[0], 1)
        z[:, dim] = values
        return unpreproc(self.vae.decode(self.vae.params, z), self.normalizer).cpu().numpy()

    # -- training ------------------------------------------------------------

    def kl_weight(self, epoch: int) -> float:
        """β at ``epoch`` under the linear warm-up, ``β·min(1, (t+1)/T)``,
        in float32 as the JAX package computes it."""
        f32 = np.float32
        anneal = max(0, int(self.config.kl_anneal_epochs))
        scale = min(f32(1.0), f32(epoch + 1) / f32(anneal)) if anneal > 0 else f32(1.0)
        return float(f32(self.config.beta) * f32(scale))

    def train(self, epochs: Optional[int] = None, vae_train_config: Optional[TrainConfig] = None,
              em_train_config: Optional[TrainConfig] = None, verbose: bool = False,
              checkpoint_dir: Optional[str] = None, checkpoint_every: int = 10,
              resume: bool = False, device_loop: bool = False) -> Tuple[list, list, list, list]:
        """Stage A: the VAE with reconstruction + β·KL (fresh normals for
        every batch through the training loop's draw seam, the warm-up
        :meth:`kl_weight`); stage B: the params → z_mean MLP by MSE.
        Returns ``(vae_loss, vae_val_loss, loss, val_loss)``;
        ``checkpoint_dir`` checkpoints each stage in ``stage_vae`` /
        ``stage_em``."""
        data = self._require_data()
        vae_cfg = vae_train_config or AE_TRAIN_DEFAULT
        em_cfg = em_train_config or AE_EMULATOR_TRAIN_DEFAULT
        if epochs is not None:
            vae_cfg = dataclasses.replace(vae_cfg, epochs=epochs)
            em_cfg = dataclasses.replace(em_cfg, epochs=epochs)
        norm, act, vae = self.normalizer, self.config.activation, self.vae
        scaled_mean = norm.scaled_mean
        y_train, y_val = (preproc(_rows(s, self.device), norm)
                          for s in (data.signal_train, data.signal_val))

        def vae_loss_fn(params, x, y, noise, epoch):
            recon, mu, logvar = vae.apply(params, x, noise)
            return (relative_mse(y, recon, scaled_mean)
                    + self.kl_weight(epoch) * kl_divergence(mu, logvar))

        run_stage = _make_stage_runner(device_loop, verbose, checkpoint_dir, checkpoint_every,
                                       resume)
        _, _, vae_hist = run_stage("stage_vae", vae.params, vae_loss_fn, y_train, y_train,
                                   y_val, y_val, vae_cfg, stochastic=True, pass_epoch=True)

        with torch.no_grad():
            z_train, z_val = (vae.encode(vae.params, y)[0] for y in (y_train, y_val))
        x_train, x_val = (par_transform(_rows(p, self.device), norm)
                          for p in (data.par_train, data.par_val))

        def em_loss_fn(params, x, y):
            return mse(y, mlp_apply(params, x, act))

        _, _, em_hist = run_stage("stage_em", self.em.params, em_loss_fn, x_train, z_train,
                                  x_val, z_val, em_cfg)
        self.history = {"vae": vae_hist, "emulator": em_hist}
        return vae_hist.loss, vae_hist.val_loss, em_hist.loss, em_hist.val_loss

    # -- evaluation ----------------------------------------------------------

    def test_error(self, use_vae: bool = False, relative: bool = True, flow=None,
                   fhigh=None) -> np.ndarray:
        """Test-set error of the emulator pipeline, or of the VAE's round
        trip with ``use_vae=True``."""
        data = self._require_data()
        pred = self.reconstruct(data.signal_test) if use_vae else self.predict(data.par_test)
        return self._test_error(pred, relative, flow, fhigh)
