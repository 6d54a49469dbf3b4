"""The flagship direct emulator: 7 astrophysical parameters → δT(z),
inference subset (the port of ``tpu21cmvae/models/direct.py``; reference
``emulator.py:207-442``; 7 → 288 → 352 → 288 → 224 → 451, ReLU hidden
layers, linear output).

The model is an :class:`~tpu21cmvae_torch.ops.mlp.MLP` plus a
:class:`~tpu21cmvae_torch.ops.transforms.Normalizer`, both on the device
the caller names. Training, the other samplers, evidence, VI, flows and
serving are not ported yet (ROADMAP).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpu21cmvae_torch.data.dataset import DataSplits
from tpu21cmvae_torch.models.checkpoint import load_checkpoint, save_checkpoint
from tpu21cmvae_torch.ops.mlp import MLP, mlp_apply
from tpu21cmvae_torch.ops.transforms import FIELDS, Normalizer, par_transform, unpreproc
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig
from tpu21cmvae_torch.utils.frequency import (
    default_redshifts,
    freq2redshift,
    redshift2freq,
)
from tpu21cmvae_torch.utils.metrics import error

PAR_LABELS = ["fstar", "Vc", "fx", "tau", "alpha", "nu_min", "Rmfp"]


def _resolve_axes(redshifts, frequencies):
    """Reference axis logic (``emulator.py:311-317``): derive whichever of
    (redshifts, frequencies) is missing from the other."""
    if redshifts is None and frequencies is None:
        redshifts = default_redshifts()
    if frequencies is None and redshifts is not None:
        frequencies = redshift2freq(redshifts)
    elif redshifts is None and frequencies is not None:
        redshifts = freq2redshift(frequencies)
    return np.asarray(redshifts), np.asarray(frequencies)


def checkpoint_treedef(n_layers: int) -> str:
    """The ``treedef`` string JAX writes for a DirectEmulator checkpoint
    (``{"normalizer": Normalizer, "params": (layer dicts)}``): its leaves
    are the four Normalizer fields, then each layer's ``b`` before its
    ``w`` (dict keys flatten sorted)."""
    layers = ", ".join(["{'b': *, 'w': *}"] * n_layers)
    if n_layers == 1:
        layers += ","
    return (
        "PyTreeDef({'normalizer': CustomNode(Normalizer[()], [*, *, *, *]), "
        f"'params': ({layers})}})"
    )


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


class DirectEmulator:
    """Params → signal dense MLP emulator on an explicit ``device``.

    ``params``: layer dicts ``{"w": (in, out), "b": (out,)}`` (arrays or
    tensors); without them the weights are Glorot-initialized from
    ``seed``. ``normalizer``: a Normalizer, or computed from ``data``.
    """

    par_labels = PAR_LABELS

    def __init__(
        self,
        data: Optional[DataSplits] = None,
        *,
        config: DirectEmulatorConfig = DirectEmulatorConfig(),
        normalizer: Optional[Normalizer] = None,
        params=None,
        redshifts=None,
        frequencies=None,
        seed: int = 0,
        device,
    ):
        self.device = torch.empty(0, device=device).device
        if normalizer is None:
            if data is None:
                raise ValueError(
                    "Provide `data` (to compute normalization constants) or "
                    "an explicit `normalizer`."
                )
            normalizer = Normalizer.from_data(
                data.par_train, data.signal_train, device=self.device
            )
        self.data = data
        self.config = config
        self.normalizer = normalizer
        self.redshifts, self.frequencies = _resolve_axes(redshifts, frequencies)
        self.net = MLP(config.mlp().sizes, config.activation, device=self.device,
                       params=params, seed=seed)
        # advisory inference tier this checkpoint was trained FOR (e.g.
        # "default" after bf16-native fine-tuning); None = the contract
        # path. Carried through save/from_checkpoint.
        self.native_precision: Optional[str] = None
        self._predict = self.predict_fn()

    @property
    def params(self):
        """The weights as layer dicts (the ``params`` argument of every
        function this model builds)."""
        return self.net.params

    # -- construction ------------------------------------------------------

    @classmethod
    def from_numpy(cls, params, normalizer, *,
                   config: DirectEmulatorConfig = DirectEmulatorConfig(),
                   device, **kwargs) -> "DirectEmulator":
        """From the JAX package's weights as NumPy arrays (layer dicts)
        and its Normalizer fields (a mapping or an object with
        ``signal_mean``, ``signal_std``, ``par_min``, ``par_max``)."""
        return cls(
            config=config,
            normalizer=Normalizer.from_arrays(normalizer, device=device),
            params=params,
            device=device,
            **kwargs,
        )

    @classmethod
    def from_checkpoint(cls, path: str, data: Optional[DataSplits] = None, *,
                        device) -> "DirectEmulator":
        """Restore a model saved by either package — weights AND
        normalization constants, no training data needed."""
        leaves, meta = load_checkpoint(path)
        cfg = DirectEmulatorConfig(
            n_params=meta["n_params"],
            n_bins=meta["n_bins"],
            hidden_dims=tuple(meta["hidden_dims"]),
            activation=meta.get("activation", "relu"),
        )
        sizes = cfg.mlp().sizes
        n_layers = len(sizes) - 1
        shapes = [(cfg.n_bins,), (), (cfg.n_params,), (cfg.n_params,)]
        for d_in, d_out in zip(sizes[:-1], sizes[1:]):
            shapes += [(d_out,), (d_in, d_out)]
        if len(leaves) != len(shapes):
            raise ValueError(
                f"{path} has {len(leaves)} leaves; a {n_layers}-layer "
                f"DirectEmulator has {len(shapes)}"
            )
        for i, (leaf, shape) in enumerate(zip(leaves, shapes)):
            if leaf.shape != shape:
                raise ValueError(
                    f"{path}: leaf_{i} has shape {leaf.shape}; expected {shape}"
                )
        normalizer = dict(zip(FIELDS, leaves[:4]))
        params = tuple(
            {"b": leaves[4 + 2 * i], "w": leaves[5 + 2 * i]} for i in range(n_layers)
        )
        model = cls.from_numpy(
            params, normalizer, config=cfg, device=device, data=data,
            redshifts=np.asarray(meta["redshifts"]) if "redshifts" in meta else None,
        )
        model.native_precision = meta.get("native_precision")
        return model

    def save(self, path: str) -> str:
        """Save weights + normalizer + architecture metadata atomically,
        in the format the JAX package's ``from_checkpoint`` reads."""
        meta = {
            "kind": "DirectEmulator",
            "n_params": self.config.n_params,
            "n_bins": self.config.n_bins,
            "hidden_dims": list(self.config.hidden_dims),
            "activation": self.config.activation,
            "redshifts": [float(z) for z in self.redshifts],
        }
        if self.native_precision is not None:
            meta["native_precision"] = str(self.native_precision)
        norm = self.normalizer.to_numpy()
        leaves = [norm[name] for name in FIELDS]
        for layer in self.params:
            leaves += [_host(layer["b"]), _host(layer["w"])]
        return save_checkpoint(path, leaves, checkpoint_treedef(len(self.params)), meta)

    # -- inference ---------------------------------------------------------

    def predict_fn(self, precision=None):
        """``(params, raw) → signals (B, n_bins)`` in mK, on tensors.
        ``precision``: matmul tier, default the exact-fp32 contract path;
        ``"native"`` resolves to the checkpoint's ``native_precision``."""
        if precision == "native":
            precision = self.native_precision
        tier = "highest" if precision is None else precision
        norm = self.normalizer
        activation = self.config.activation

        @torch.no_grad()
        def predict(params, raw_params):
            x = par_transform(raw_params, norm)
            return unpreproc(mlp_apply(params, x, activation, tier), norm)

        return predict

    def predict(self, params) -> np.ndarray:
        """Emulate global signal(s) from raw astrophysical parameters: a
        single 7-vector gives shape (451,), an (n, 7) batch (n, 451)
        (reference ``emulator.py:383-407``)."""
        raw = torch.atleast_2d(
            torch.as_tensor(params, dtype=torch.float32, device=self.device)
        )
        pred = self._predict(self.params, raw).cpu().numpy()
        return pred[0] if pred.shape[0] == 1 else pred

    def loglik_fn(self, obs, noise_var=1.0, *, backend: str = "torch",
                  method: str = "gram", precision=None, memo: bool = True):
        """Gaussian log-likelihood ``(params, raw) → (B,)`` against an
        observed signal (see :func:`tpu21cmvae_torch.ops.loglik.make_loglik`);
        ``precision="contract"`` for absolute log-densities."""
        from tpu21cmvae_torch.models._memo import memo_program, noise_key
        from tpu21cmvae_torch.ops.loglik import make_loglik

        return memo_program(
            self,
            ("loglik", _host(obs), noise_key(noise_var), backend, method,
             str(precision)),
            lambda: torch.no_grad()(make_loglik(
                self.config, self.normalizer, obs, noise_var,
                backend=backend, method=method, precision=precision,
            )),
            memo=memo,
        )

    def loglik_and_grad_fn(self, obs, noise_var=1.0, *, backend: str = "torch",
                           method: str = "gram", precision=None,
                           grad_precision=None, memo: bool = True):
        """``(params, raw) → (logL, dlogL/draw)`` — the HMC inner loop
        (see :func:`tpu21cmvae_torch.ops.loglik.make_loglik_and_grad`).
        Value-identical calls return the SAME object, so the fused
        kernel's folded weights and launch counter persist across
        sampling calls on one observation."""
        from tpu21cmvae_torch.models._memo import memo_program, noise_key
        from tpu21cmvae_torch.ops.loglik import make_loglik_and_grad

        return memo_program(
            self,
            ("valgrad", _host(obs), noise_key(noise_var), backend, method,
             str(precision), str(grad_precision)),
            lambda: make_loglik_and_grad(
                self.config, self.normalizer, obs, noise_var,
                backend=backend, method=method, precision=precision,
                grad_precision=grad_precision,
            ),
            memo=memo,
        )

    def sample_posterior(self, obs, noise_var=1.0, *, sampler: str = "hmc",
                         bounds=None, **kwargs):
        """Sample the posterior over the 7 parameters given an observed
        spectrum with HMC (:func:`tpu21cmvae_torch.sampling.gradient.sample_hmc`;
        kwargs forward to it). On a CUDA model every leapfrog step runs
        the fused value+gradient kernel K3, on the CPU its plain version;
        the backward runs at the single-pass bf16 tier, which only costs
        acceptance rate. Returns a
        :class:`~tpu21cmvae_torch.sampling.results.SampleResult`."""
        if sampler != "hmc":
            raise NotImplementedError(
                f"sampler={sampler!r} is not ported yet (ROADMAP queue 6); "
                "the port samples with 'hmc'"
            )
        from tpu21cmvae_torch.sampling.gradient import sample_hmc

        backend = "kernel" if self.device.type == "cuda" else "torch"
        valgrad = self.loglik_and_grad_fn(
            obs, noise_var, backend=backend, grad_precision="default"
        )
        return sample_hmc(valgrad, self.params, bounds=bounds,
                          device=self.device, **kwargs)

    # -- evaluation --------------------------------------------------------

    def test_error(self, relative: bool = True, flow=None, fhigh=None) -> np.ndarray:
        """Per-signal test-set error (reference ``emulator.py:409-439``)."""
        if self.data is None:
            raise ValueError("No dataset attached; construct with `data=`.")
        return error(
            self.data.signal_test,
            self.predict(self.data.par_test),
            relative=relative,
            nu_arr=self.frequencies,
            flow=flow,
            fhigh=fhigh,
        )
