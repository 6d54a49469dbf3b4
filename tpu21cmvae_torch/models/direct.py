"""The flagship direct emulator: 7 astrophysical parameters → δT(z),
inference subset (the port of ``tpu21cmvae/models/direct.py``; reference
``emulator.py:207-442``; 7 → 288 → 352 → 288 → 224 → 451, ReLU hidden
layers, linear output).

The model is an :class:`~tpu21cmvae_torch.ops.mlp.MLP` plus a
:class:`~tpu21cmvae_torch.ops.transforms.Normalizer`, both on the device
the caller names. Every likelihood entry point takes the JAX package's
noise specs (a scalar or per-bin variance, a foreground-marginalized
:class:`~tpu21cmvae_torch.foregrounds.MarginalizedNoise` from
:meth:`DirectEmulator.marginalize_foreground`, a
:class:`~tpu21cmvae_torch.noisescale.ScaleMarginalNoise` over either) and
every sampler, fit and variational fit a ``log_prior``. :meth:`train`
runs the reference recipe on the model's device (:mod:`tpu21cmvae_torch.train`);
:mod:`tpu21cmvae_torch.serve` puts it behind HTTP.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tpu21cmvae_torch.data.dataset import DataSplits
from tpu21cmvae_torch.models.checkpoint import load_checkpoint, save_checkpoint
from tpu21cmvae_torch.ops.losses import relative_mse
from tpu21cmvae_torch.models.io_keras import load_keras_mlp
from tpu21cmvae_torch.ops.mlp import MLP, mlp_apply, mlp_sizes
from tpu21cmvae_torch.ops.transforms import (
    FIELDS,
    Normalizer,
    par_transform,
    preproc,
    resolve_normalizer,
    unpreproc,
)
from tpu21cmvae_torch.train.loop import fit
from tpu21cmvae_torch.train.scan import fit_scan
from tpu21cmvae_torch.utils.config import (
    DIRECT_TRAIN_DEFAULT,
    DirectEmulatorConfig,
    TrainConfig,
)
from tpu21cmvae_torch.utils.frequency import (
    default_redshifts,
    freq2redshift,
    redshift2freq,
)
from tpu21cmvae_torch.utils.metrics import error
from tpu21cmvae_torch.utils.profiling import SAMPLER, span

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
        normalizer = resolve_normalizer(data, normalizer, device=self.device)
        self.data = data
        self.config = config
        self.normalizer = normalizer
        self.redshifts, self.frequencies = _resolve_axes(redshifts, frequencies)
        self.net = MLP(config.mlp().sizes, config.activation, device=self.device,
                       params=params, seed=seed)
        self.history = None
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
    def from_keras_h5(cls, path: str, data: Optional[DataSplits] = None,
                      normalizer: Optional[Normalizer] = None, *, device,
                      **kwargs) -> "DirectEmulator":
        """Import the reference's pretrained ``models/emulator.h5``
        (reference ``emulator.py:319-337``; needs ``h5py``). The
        normalization constants are NOT in the h5: supply the dataset or a
        Normalizer."""
        params = load_keras_mlp(path)
        sizes = mlp_sizes(params)
        cfg = DirectEmulatorConfig(n_params=sizes[0], n_bins=sizes[-1],
                                   hidden_dims=tuple(sizes[1:-1]))
        return cls(data, config=cfg, normalizer=normalizer, params=params, device=device,
                   **kwargs)

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

    def replica(self, device) -> "DirectEmulator":
        """This model on ``device``, for a mesh that serves it there:
        itself on its own device, else a shallow copy, with no memo,
        whose normalizer sits on ``device`` (the weights are passed to
        every call and are not copied)."""
        from tpu21cmvae_torch.models._memo import replica_on

        return replica_on(self, device)

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
        ``noise_var``: a scalar or per-bin σ², a ``MarginalizedNoise``
        (:meth:`marginalize_foreground`) or a ``ScaleMarginalNoise``
        (:func:`~tpu21cmvae_torch.noisescale.marginalize_noise_scale`),
        keyed by value; ``precision="contract"`` for absolute
        log-densities. The function
        is differentiable by ``torch.autograd`` with respect to ``raw``
        and the weights on both backends (call it under
        ``torch.no_grad()`` when only values are wanted). Value-identical
        calls return the SAME object, so with ``backend="kernel"`` its
        ``launches`` count (K2 for ``method="gram"``, K1 for
        ``"direct"``) persists across sampling calls."""
        from tpu21cmvae_torch.models._memo import memo_program, noise_key
        from tpu21cmvae_torch.ops.loglik import make_loglik

        return memo_program(
            self,
            ("loglik", _host(obs), noise_key(noise_var), backend, method,
             str(precision)),
            lambda: make_loglik(
                self.config, self.normalizer, obs, noise_var,
                backend=backend, method=method, precision=precision,
            ),
            memo=memo,
        )

    def loglik_and_grad_fn(self, obs, noise_var=1.0, *, backend: str = "torch",
                           method: str = "gram", precision=None,
                           grad_precision=None, memo: bool = True):
        """``(params, raw) → (logL, dlogL/draw)`` — the HMC inner loop
        (see :func:`tpu21cmvae_torch.ops.loglik.make_loglik_and_grad`);
        ``noise_var`` as in :meth:`loglik_fn`. Under a
        ``ScaleMarginalNoise`` the object is the chain-rule wrap of the
        base spec's function and passes its ``launches`` through.
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

    def loglik_multi_fn(self, obs_batch, noise_var=1.0, *, method: str = "gram",
                        precision=None, memo: bool = True):
        """Stacked-observation likelihood ``(params, (O·W, 7)) → (O·W,)``:
        ``O`` observations scored in one call, observation-major rows
        (see :func:`tpu21cmvae_torch.ops.loglik.make_loglik_multi`; the
        gram structure is shared across observations). Memoized like
        :meth:`loglik_fn`."""
        from tpu21cmvae_torch.models._memo import memo_program, noise_key
        from tpu21cmvae_torch.ops.loglik import make_loglik_multi

        return memo_program(
            self,
            ("multi", _host(obs_batch), noise_key(noise_var), method, str(precision)),
            lambda: make_loglik_multi(
                self.config, self.normalizer, obs_batch, noise_var,
                method=method, precision=precision,
            ),
            memo=memo,
        )

    def marginalize_foreground(self, noise_var=1.0, *, n_terms: int = 5,
                               basis="linlog", prior_var=None, nu_ref=None):
        """Foreground-marginalized noise model on this emulator's
        frequency axis (:mod:`tpu21cmvae_torch.foregrounds`): pass the
        result anywhere ``noise_var`` is accepted (``loglik_fn``,
        ``loglik_and_grad_fn``, ``sample_posterior``, ``fisher_forecast``
        …) to infer the 21-cm parameters with a linear foreground ``F·a``
        integrated out of the likelihood EXACTLY. The projection folds
        into the output layer, so the gram form and the kernels keep
        their widths. ``basis``: ``"linlog"`` (Hills et al. 2018),
        ``"powerlaw"`` (EDGES-style linearized, Bowman et al. 2018),
        ``"polynomial"`` (Legendre), or an explicit ``(n_bins, k)``
        design matrix. ``prior_var``: per-coefficient Gaussian prior
        variances; None = improper flat (then the likelihood is exactly
        invariant to any ``F·a`` added to the observation). Use the
        returned object's ``coeff_posterior(obs − predict(θ))`` to
        reconstruct the best-fit foreground afterwards."""
        from tpu21cmvae_torch.foregrounds import foreground_basis, marginalize_foreground

        f = (foreground_basis(self.frequencies, n_terms, basis, nu_ref=nu_ref)
             if isinstance(basis, str) else basis)
        return marginalize_foreground(
            f, noise_var, n_bins=int(self.frequencies.shape[0]), prior_var=prior_var,
        )

    def _backend(self) -> str:
        """The likelihood backend of the samplers and fits: the kernels on
        a CUDA model, their plain versions on the CPU."""
        return "kernel" if self.device.type == "cuda" else "torch"

    def _hmc_valgrad(self, obs, noise_var):
        """The memoized value+gradient function of the gradient samplers
        and the fits: K3 at (high, default) on a CUDA model."""
        return self.loglik_and_grad_fn(obs, noise_var, backend=self._backend(),
                                       grad_precision="default")

    def sample_posterior(self, obs, noise_var=1.0, *, sampler: str = "hmc",
                         bounds=None, **kwargs):
        """Sample the posterior over the 7 parameters given an observed
        spectrum; kwargs forward to the sampler, and the result is a
        :class:`~tpu21cmvae_torch.sampling.results.SampleResult`.

        * ``sampler="hmc"`` (default,
          :func:`~tpu21cmvae_torch.sampling.gradient.sample_hmc`),
          ``"chees"`` (the trajectory length adapted too,
          :func:`~tpu21cmvae_torch.sampling.gradient.sample_chees`) and
          ``"nuts"`` (:func:`~tpu21cmvae_torch.sampling.gradient.sample_nuts`):
          every leapfrog step runs the fused value+gradient kernel K3 on a
          CUDA model, its plain version on the CPU, all three through the
          same memoized wrapper; the backward runs at the single-pass bf16
          tier, which only costs acceptance rate.
        * ``sampler="mh"`` (random-walk Metropolis,
          :func:`~tpu21cmvae_torch.sampling.mh.sample_mh`) and
          ``"ensemble"`` (the stretch move,
          :func:`~tpu21cmvae_torch.sampling.mh.sample_ensemble`) score
          every proposal batch through ``loglik_fn(obs, noise_var,
          backend=…)`` — the gram form at the bf16x3 tier — which on a
          CUDA model is ``backend="kernel"`` (K2) and on the CPU its
          plain version. The JAX package defaults these samplers to its
          XLA path because that measured fastest on a TPU v5e; that
          measurement says nothing about this port, so the port takes
          the kernel, as it does for HMC (PERF.md). ``sampler="mh"`` with
          ``target_ess=N`` runs
          :func:`~tpu21cmvae_torch.sampling.driver.sample_to_ess`: MH
          chunks until the smallest bulk and tail ESS reach ``N``.
        * ``sampler="pt"`` (parallel tempering,
          :func:`~tpu21cmvae_torch.sampling.pt.sample_pt`: replica
          exchange carries states between modes, so the β=1 rung gets the
          mode weights right) and ``"smc"`` (the adaptive tempered anneal,
          :func:`~tpu21cmvae_torch.sampling.smc.sample_smc`: mode weights
          kept by resampling, the evidence in ``result.logz``) score
          through the same K2 wrapper as MH, for multimodal posteriors
          where the single-temperature samplers go metastable.

        ``noise_var`` takes every spec :meth:`loglik_fn` does, and
        ``log_prior=`` (a log-density over the raw parameters, e.g.
        :meth:`tpu21cmvae_torch.priors.GaussianBoxPrior.log_prior`)
        passes through the kwargs to every sampler, on top of the flat
        box; the gradient samplers' force takes its gradient by autograd.
        Neither changes which kernel runs or how often. ``mesh=`` passes
        through to the sampler, which splits its likelihood's rows over the
        mesh's devices (one replica of the wrapper per device).
        """
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
                return run(self.loglik_fn(obs, noise_var, backend=self._backend()), self.params,
                           bounds=bounds, device=self.device, **kwargs)
            if sampler not in ("hmc", "chees", "nuts"):
                raise ValueError(
                    "sampler must be 'mh', 'ensemble', 'hmc', 'chees', 'nuts', "
                    f"'pt' or 'smc'; got {sampler!r}"
                )
            from tpu21cmvae_torch.sampling import gradient

            run = {"hmc": gradient.sample_hmc, "chees": gradient.sample_chees,
                   "nuts": gradient.sample_nuts}[sampler]
            return run(self._hmc_valgrad(obs, noise_var), self.params, bounds=bounds,
                       device=self.device, **kwargs)

    def sample_posterior_batch(self, obs_batch, noise_var=1.0, *, sampler: str = "mh",
                               n_walkers: int = 256, bounds=None, method: str = "gram",
                               precision=None, **kwargs):
        """Posteriors for ``O`` observed spectra in one chain: the walkers
        of every observation stack observation-major into one ``(O ·
        n_walkers)`` batch (``n_walkers`` is per observation), scored by
        the stacked-observation likelihood (:meth:`loglik_multi_fn`; HMC
        and NUTS by its autograd value+gradient), in plain PyTorch on
        both devices as the JAX package's stacked forms are plain XLA.
        ``sampler``: ``"mh"``, ``"hmc"`` or ``"nuts"``; each observation's
        slab adapts its own step (``adapt_blocks=n_obs``), and under NUTS
        its own ensemble metric. Returns a
        :class:`~tpu21cmvae_torch.sampling.results.BatchSampleResult`."""
        from tpu21cmvae_torch.ops.loglik import make_loglik_and_grad_multi
        from tpu21cmvae_torch.sampling.driver import run_batched_chain

        obs_batch = np.atleast_2d(np.asarray(obs_batch, np.float32))
        return run_batched_chain(
            sampler, self.params, obs_batch.shape[0], n_walkers,
            loglik_builder=lambda: self.loglik_multi_fn(
                obs_batch, noise_var, method=method, precision=precision),
            valgrad_builder=lambda: make_loglik_and_grad_multi(
                self.config, self.normalizer, obs_batch, noise_var, method=method,
                precision=precision),
            bounds=bounds, device=self.device, **kwargs,
        )

    def fit_params(self, obs, noise_var=1.0, *, bounds=None, **kwargs):
        """Maximum-likelihood fit of the 7 parameters to an observed
        spectrum: multi-start Adam ascent
        (:func:`~tpu21cmvae_torch.sampling.fit.fit_map`) through the same
        memoized value+gradient function as HMC (K3 on a CUDA model).
        Returns a :class:`~tpu21cmvae_torch.sampling.fit.FitResult`; seed a
        sampler with ``sample_posterior(..., x0=result.params)``."""
        from tpu21cmvae_torch.sampling.fit import fit_map

        return fit_map(self._hmc_valgrad(obs, noise_var), self.params, bounds=bounds,
                       device=self.device, **kwargs)

    def profile_likelihood(self, obs, noise_var, index, grid, *, bounds=None, **kwargs):
        """Profile likelihood of parameter ``index`` over ``grid`` from
        batched constrained refits
        (:func:`~tpu21cmvae_torch.sampling.fit.profile_likelihood`), through
        the same value+gradient function as HMC. Returns a
        :class:`~tpu21cmvae_torch.sampling.fit.ProfileResult`;
        ``result.interval(0.68)`` and ``.interval(0.95)``."""
        from tpu21cmvae_torch.sampling.fit import profile_likelihood

        return profile_likelihood(self._hmc_valgrad(obs, noise_var), self.params, index, grid,
                                  bounds=bounds, device=self.device, **kwargs)

    def log_evidence(self, obs, noise_var=1.0, *, bounds=None, method="nested",
                     warm_start=True, **kwargs):
        """Bayesian evidence ``log Z`` of this model given an observed
        spectrum, under the flat box prior (or a ``log_prior``/
        ``prior_transform`` in the kwargs): compare models by their
        ``logz`` on the same ``obs`` and ``bounds``. kwargs forward to the
        estimator.

        * ``method="nested"`` (default,
          :func:`~tpu21cmvae_torch.nested.nested_sampling`; a
          :class:`~tpu21cmvae_torch.nested.NestedResult`), ``"smc"``
          (:func:`~tpu21cmvae_torch.sampling.smc.sample_smc`) and
          ``"ladder"`` (the stepping-stone ladder,
          :func:`~tpu21cmvae_torch.sampling.evidence.log_evidence`; check
          its ``logz_err`` and ``ladder_drift``) score through the same
          K2 wrapper as MH (``loglik_fn(obs, noise_var, backend=…)``, the
          bf16x3 tier). ``warm_start`` (ladder only) seeds every rung
          from the best of a ``max(1024, n_walkers)``-start
          :meth:`fit_params` of 500 steps (K3 at (high, default)).
        * ``method="laplace"``
          (:func:`~tpu21cmvae_torch.sampling.evidence.laplace_evidence`)
          runs at the exact tier, as a fast-tier value error near the
          mode would bias ``logz`` by as much: its ascent on the fp32 K3
          (the likelihood it is handed carries the memoized contract-tier
          K3 wrapper as its ``valgrad`` route), its Hessian by double
          autograd through the plain likelihood, its importance-sampling
          rounds on the fp32 K2. Blind to multimodality.
        * ``method="flow"``
          (:func:`~tpu21cmvae_torch.flows.evidence_with_flow`; a
          :class:`~tpu21cmvae_torch.flows.FlowEvidenceResult`) fits a
          RealNVP flow through the same value+gradient function as HMC
          (K3 at (high, default): the fit's tier shapes only the
          proposal), warm-started by ADVI, then importance-samples the
          evidence through it on the contract-tier value (the fp32 K2).
          For curved or skewed posteriors, where Laplace's khat fails;
          check ``khat < 0.7`` all the same. ``flow=`` reuses a
          :meth:`fit_flow` result.

        On a CUDA model every route is a kernel wrapper, on the CPU its
        plain version."""
        from tpu21cmvae_torch.sampling._common import RoutedLoglik

        backend = self._backend()
        if method == "nested":
            from tpu21cmvae_torch.nested import nested_sampling

            return nested_sampling(self.loglik_fn(obs, noise_var, backend=backend),
                                   self.params, bounds=bounds, device=self.device, **kwargs)
        if method == "smc":
            from tpu21cmvae_torch.sampling.smc import sample_smc

            return sample_smc(self.loglik_fn(obs, noise_var, backend=backend), self.params,
                              bounds=bounds, device=self.device, **kwargs)
        if method == "laplace":
            from tpu21cmvae_torch.sampling.evidence import laplace_evidence

            loglik = RoutedLoglik(
                self.loglik_fn(obs, noise_var, backend=backend, precision="contract"),
                valgrad=self.loglik_and_grad_fn(obs, noise_var, backend=backend,
                                                precision="contract"),
                plain=self.loglik_fn(obs, noise_var, precision="contract"),
            )
            return laplace_evidence(loglik, self.params, bounds=bounds, device=self.device,
                                    **kwargs)
        if method == "flow":
            from tpu21cmvae_torch.flows import evidence_with_flow

            return evidence_with_flow(
                self.loglik_fn(obs, noise_var, backend=backend, precision="contract"),
                self._hmc_valgrad(obs, noise_var), self.params, bounds=bounds,
                device=self.device, **kwargs)
        if method != "ladder":
            raise ValueError(
                f"method must be 'nested', 'smc', 'laplace', 'flow' or 'ladder'; got {method!r}"
            )
        from tpu21cmvae_torch.sampling.evidence import log_evidence

        if warm_start and "x0" not in kwargs:
            fit = self.fit_params(
                obs, noise_var, bounds=bounds,
                n_starts=max(1024, kwargs.get("n_walkers", 256)),
                n_steps=500, seed=kwargs.get("seed", 0) + 101,
                log_prior=kwargs.get("log_prior"),
            )
            kwargs.setdefault("n_walkers", 256)
            kwargs["x0"] = fit.top(kwargs["n_walkers"])[0]
        return log_evidence(self.loglik_fn(obs, noise_var, backend=backend), self.params,
                            bounds=bounds, device=self.device, **kwargs)

    def log_evidence_batch(self, obs_batch, noise_var=1.0, *, bounds=None, method="auto",
                           khat_threshold=0.7, flow_kwargs=None, final=None,
                           final_kwargs=None, **kwargs):
        """Evidences of a batch of observed spectra: Laplace + adaptive IS
        with every stage batched over the observations
        (:func:`~tpu21cmvae_torch.sampling.evidence.laplace_evidence_multi`
        over the stacked gram likelihood at the contract tier, in plain
        PyTorch), then the khat escalation
        (:func:`~tpu21cmvae_torch.sampling.evidence.laplace_evidence_multi_auto`):
        under ``method="auto"`` every row whose khat is not below
        ``khat_threshold`` is re-estimated through a flow proposal
        (``"laplace"`` skips it, ``"flow"`` escalates every row;
        ``flow_kwargs`` go to the flow fit and sweep). Several flagged rows
        fit together on the stacked value+gradient function
        (:meth:`_rows_valgrad`, plain PyTorch); a lone one through the
        model's own wrappers, as :meth:`log_evidence` (``method="flow"``)
        runs. ``final="nested"``/``"smc"`` settles the rows that still fail
        (several nested rows as one
        :func:`~tpu21cmvae_torch.nested.nested_sampling_batch` on the
        stacked likelihood). Returns one
        :class:`~tpu21cmvae_torch.sampling.evidence.LaplaceResult` per row,
        ``method_used`` naming its estimator."""
        from tpu21cmvae_torch.sampling.evidence import laplace_evidence_multi_auto

        obs_batch = np.atleast_2d(np.asarray(obs_batch, np.float32))
        backend = self._backend()
        return laplace_evidence_multi_auto(
            self.loglik_multi_fn(obs_batch, noise_var, precision="contract"),
            self.params, obs_batch.shape[0], bounds=bounds, method=method,
            khat_threshold=khat_threshold, flow_kwargs=flow_kwargs, final=final,
            final_kwargs=final_kwargs,
            row_loglik=lambda i: self.loglik_fn(obs_batch[i], noise_var, backend=backend,
                                                precision="contract"),
            row_valgrad=lambda i: self._hmc_valgrad(obs_batch[i], noise_var),
            rows_loglik=lambda idx: self.loglik_multi_fn(obs_batch[np.asarray(idx)], noise_var,
                                                         precision="contract"),
            rows_valgrad=self._rows_valgrad(obs_batch, noise_var),
            device=self.device, **kwargs,
        )

    def _rows_valgrad(self, obs_batch, noise_var):
        """A function of observation indices ``idx`` that returns the
        stacked value+gradient function over those observations: the
        batched flow escalation's fit (its sweep scores through the
        contract-tier stacked value)."""
        from tpu21cmvae_torch.ops.loglik import make_loglik_and_grad_multi

        def build(idx):
            return make_loglik_and_grad_multi(self.config, self.normalizer,
                                              obs_batch[np.asarray(idx)], noise_var)

        return build

    def fit_advi(self, obs, noise_var=1.0, *, bounds=None, **kwargs):
        """Full-rank Gaussian ADVI of the posterior
        (:func:`~tpu21cmvae_torch.vi.fit_advi`) through the same
        value+gradient function as HMC (K3 at (high, default) on a CUDA
        model, one launch per step). Returns an
        :class:`~tpu21cmvae_torch.vi.ADVIResult` (``.sample(n)``,
        ``.mean()``, ``.std()``); prefer :meth:`fit_flow` or a chain when
        the posterior may be non-Gaussian."""
        from tpu21cmvae_torch.vi import fit_advi

        return fit_advi(self._hmc_valgrad(obs, noise_var), self.params, bounds=bounds,
                        device=self.device, **kwargs)

    def fit_flow(self, obs, noise_var=1.0, *, bounds=None, **kwargs):
        """Normalizing-flow posterior fit
        (:func:`~tpu21cmvae_torch.flows.fit_flow`): a RealNVP coupling
        stack trained by reparameterized ELBO ascent through the same
        value+gradient function as HMC (K3 at (high, default) on a CUDA
        model: ``warm_steps + n_steps`` launches). Returns a
        :class:`~tpu21cmvae_torch.flows.FlowResult` (``.sample(n)``, exact
        ``.log_q``); pass it to ``log_evidence(method="flow", flow=...)``."""
        from tpu21cmvae_torch.flows import fit_flow

        return fit_flow(self._hmc_valgrad(obs, noise_var), self.params, bounds=bounds,
                        device=self.device, **kwargs)

    def goodness_of_fit(self, obs, noise_var=25.0, draws=None, **kwargs):
        """Posterior predictive model check of ``obs`` over posterior
        ``draws`` (see :func:`tpu21cmvae_torch.calibration.goodness_of_fit`)."""
        from tpu21cmvae_torch.calibration import goodness_of_fit

        return goodness_of_fit(self, obs, noise_var, draws, **kwargs)

    def goodness_of_fit_batch(self, obs_batch, noise_var=25.0, draws=None, **kwargs):
        """Posterior predictive checks of ``O`` observations in one batched
        predict (see :func:`tpu21cmvae_torch.calibration.goodness_of_fit_batch`)."""
        from tpu21cmvae_torch.calibration import goodness_of_fit_batch

        return goodness_of_fit_batch(self, obs_batch, noise_var, draws, **kwargs)

    def posterior_predictive(self, samples, **kwargs):
        """Signal-space credible bands implied by posterior parameter
        samples (``SampleResult.flat``): the reconstructed-signal plot
        21-cm analyses publish. See
        :func:`tpu21cmvae_torch.sampling.predictive.posterior_predictive`
        for the ``quantiles`` / ``noise_var`` options; returns a
        :class:`~tpu21cmvae_torch.sampling.predictive.PredictiveBand`."""
        from tpu21cmvae_torch.sampling.predictive import posterior_predictive

        return posterior_predictive(self.predict, samples, **kwargs)

    def fisher_fn(self, noise_var=1.0):
        """Batched Fisher-matrix function ``(params, thetas (n, 7)) →
        (n, 7, 7)`` on tensors on the model's device (see
        :mod:`tpu21cmvae_torch.ops.fisher`), detached."""
        from tpu21cmvae_torch.ops.fisher import make_fisher

        batched = torch.func.vmap(
            make_fisher(self.config, self.normalizer, noise_var), in_dims=(None, 0)
        )
        return torch.no_grad()(batched)

    def fisher_forecast(self, theta, noise_var=1.0):
        """Fisher matrix and 1-σ marginalized forecast errors at raw
        fiducial parameter vector(s) (see :mod:`tpu21cmvae_torch.ops.fisher`;
        Cramér–Rao bound for a Gaussian-noise global-signal experiment).

        Returns ``(F, sigma)`` as arrays: shapes ``(7, 7), (7,)`` for a
        single fiducial or ``(n, 7, 7), (n, 7)`` for a batch. The Fisher
        function is cached per noise spec (bounded LRU, 8 entries), with
        the spec's whitening already on the device.
        """
        from tpu21cmvae_torch.models._memo import noise_key
        from tpu21cmvae_torch.ops.fisher import forecast_errors

        nk = noise_key(noise_var)
        key = (nk.shape, nk.tobytes()) if isinstance(nk, np.ndarray) else nk
        cache = self.__dict__.setdefault("_fisher_cache", collections.OrderedDict())
        fn = cache.get(key)
        if fn is None:
            fn = cache[key] = self.fisher_fn(noise_var)
            if len(cache) > 8:
                cache.popitem(last=False)
        else:
            cache.move_to_end(key)
        th = torch.atleast_2d(torch.as_tensor(np.asarray(theta, np.float32), device=self.device))
        F = fn(self.params, th).cpu().numpy()
        sig = forecast_errors(F)
        return (F[0], sig[0]) if np.ndim(theta) == 1 else (F, sig)

    # -- training ----------------------------------------------------------

    def loss_fn(self, precision=None):
        """Per-sample relative-MSE loss ``(params, x, y) → (B,)`` over the
        forward pass, on standardized signals, with the amplitude
        constant folded once.

        ``precision``: matmul tier of the training forward, default the
        exact-fp32 contract path. ``"default"`` trains through the
        single-pass bf16 forward, its gradients at the same tier
        (quantization-aware fine-tuning: the weights converge to a point
        whose bf16 forward minimizes the loss, what a tier-native
        checkpoint needs)."""
        activation = self.config.activation
        scaled_mean = self.normalizer.scaled_mean
        tier = "highest" if precision is None else precision

        def loss(params, x, y):
            return relative_mse(y, mlp_apply(params, x, activation, tier), scaled_mean)

        return loss

    def train(
        self,
        epochs: Optional[int] = None,
        train_config: Optional[TrainConfig] = None,
        verbose: bool = False,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 10,
        resume: bool = False,
        epoch_callback=None,
        device_loop: bool = False,
        loss_precision=None,
    ) -> Tuple[list, list]:
        """Train on the attached dataset, on the model's device, with the
        reference recipe (Adam lr=0.01, batch 256, EarlyStopping +
        ReduceLROnPlateau — ``Training.ipynb`` cells 4-5). Returns
        ``(loss, val_loss)`` per epoch (reference ``emulator.py:379-381``);
        the full record lands in ``self.history``. The weights train in
        place, so every likelihood wrapper built before refolds on its
        next call.

        ``checkpoint_dir``/``resume``: preemption-safe training (see
        :func:`tpu21cmvae_torch.train.loop.fit`). ``device_loop=True``
        trains with the JAX whole-run program's semantics
        (:func:`tpu21cmvae_torch.train.scan.fit_scan`); it takes no
        checkpoint directory or epoch callback. ``loss_precision``: the
        training forward's tier (see :meth:`loss_fn`)."""
        if self.data is None:
            raise ValueError("No dataset attached; construct with `data=`.")
        cfg = train_config or DIRECT_TRAIN_DEFAULT
        if epochs is not None:
            cfg = dataclasses.replace(cfg, epochs=epochs)
        norm = self.normalizer

        def rows(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        data = self.data
        x_train, x_val = (par_transform(rows(p), norm) for p in (data.par_train, data.par_val))
        y_train, y_val = (preproc(rows(s), norm) for s in (data.signal_train, data.signal_val))
        loss = self.loss_fn(precision=loss_precision)
        if device_loop:
            if checkpoint_dir is not None or epoch_callback is not None:
                raise ValueError(
                    "device_loop=True runs without host hooks; drop "
                    "checkpoint_dir/epoch_callback or use the host loop."
                )
            _, _, self.history = fit_scan(self.params, loss, x_train, y_train, x_val,
                                          y_val, cfg)
        else:
            _, _, self.history = fit(
                self.params, loss, x_train, y_train, x_val, y_val, cfg,
                verbose=verbose, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, resume=resume,
                epoch_callback=epoch_callback,
            )
        return self.history.loss, self.history.val_loss

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
