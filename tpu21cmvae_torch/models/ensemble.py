"""Deep-ensemble emulation: predictive uncertainty from seed replicas (the
port of ``tpu21cmvae/models/ensemble.py``).

N :class:`~tpu21cmvae_torch.models.direct.DirectEmulator` replicas of one
architecture and one normalizer, trained from different seeds. Their
weights are stacked along a leading member axis (layer dicts of ``(M,
in, out)`` tensors, :attr:`DeepEnsemble.params`), the argument every
function of the ensemble takes, so the ensemble plugs into the samplers
as a single model does.

The likelihood is the equal-weight member mixture ``log p(obs | θ) =
logsumexp_m l_m(θ) − log M`` (:class:`MixtureLoglik`), its gradient
``Σ_m softmax(l)_m ∇l_m`` (:class:`MixtureValGrad`). With
``backend="kernel"`` every member has its own kernel wrapper (K1, K2 or
K3), built once from that member's likelihood factory, so a mixture call
launches M kernels; each wrapper is handed the same per-member views of
the stacked weights on every call (:meth:`DeepEnsemble.member_params`),
so its folded operands are built once, not once per call. The JAX package
instead vmaps one ``pallas_call`` over the members, which puts the member
axis on the kernel's grid: one launch. A member-batched launch is not
ported yet (ROADMAP queue 2).
"""

from __future__ import annotations

import dataclasses
import glob
import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu21cmvae_torch.data.dataset import DataSplits
from tpu21cmvae_torch.models.direct import DirectEmulator, _host
from tpu21cmvae_torch.ops.transforms import FIELDS
from tpu21cmvae_torch.utils.config import DIRECT_TRAIN_DEFAULT, DirectEmulatorConfig, TrainConfig
from tpu21cmvae_torch.utils.metrics import error


def _operand_cache(fn):
    """The operand cache behind a kernel wrapper — through a noise-level
    wrap (``base``), K1's and K2's autograd shells (``fused``) and K1's
    likelihood (``mlp``) — or None for a plain function."""
    for name in ("base", "fused", "mlp"):
        inner = getattr(fn, name, None)
        if inner is not None:
            return _operand_cache(inner)
    return getattr(fn, "operands", None)


class MixtureLoglik:
    """``(stacked, raw) → (B,)``: ``logsumexp_m l_m(raw) − log M``, member
    ``m`` scored by ``members[m]`` on its views of ``stacked``
    (``views(stacked)``). :attr:`launches` is the sum of the members'
    kernel launches, :attr:`folds` each member's operand folds."""

    def __init__(self, members, views):
        self.members = list(members)
        self._views = views
        self._log_m = math.log(len(self.members))

    @property
    def launches(self) -> int:
        return sum(getattr(f, "launches", 0) for f in self.members)

    @launches.setter
    def launches(self, n: int):
        for f in self.members:
            if hasattr(f, "launches"):
                f.launches = n

    @property
    def folds(self) -> list:
        """Each member's operand folds (None for a plain member)."""
        caches = [_operand_cache(f) for f in self.members]
        return [None if c is None else c.folds for c in caches]

    def _outputs(self, stacked, raw):
        return [f(p, raw) for f, p in zip(self.members, self._views(stacked))]

    def __call__(self, stacked, raw):
        return torch.logsumexp(torch.stack(self._outputs(stacked, raw)), dim=0) - self._log_m


class MixtureValGrad(MixtureLoglik):
    """``(stacked, raw) → (logL (B,), ∇logL (B, P))`` of the mixture: the
    value as :class:`MixtureLoglik`, the gradient the member gradients
    weighted by the member posterior at θ, ``softmax_m(l_m)`` (exact:
    ∇ logsumexp = Σ softmax·∇l)."""

    def __call__(self, stacked, raw):
        out = self._outputs(stacked, raw)
        lm = torch.stack([o[0] for o in out])
        gm = torch.stack([o[1] for o in out])
        w = torch.softmax(lm, dim=0)
        return torch.logsumexp(lm, dim=0) - self._log_m, torch.sum(w[..., None] * gm, dim=0)


class DeepEnsemble:
    """N :class:`DirectEmulator` replicas behind one stacked-weight
    interface, on the members' device."""

    def __init__(self, members: Sequence[DirectEmulator]):
        if not members:
            raise ValueError("ensemble needs at least one member")
        cfg = members[0].config
        for m in members[1:]:
            if m.config != cfg:
                raise ValueError(
                    f"ensemble members must share one architecture; got {m.config} vs {cfg}"
                )
            if m.device != members[0].device:
                raise ValueError(f"ensemble members on {m.device} and {members[0].device}")
        # every function below folds member 0's Normalizer, so every member
        # must share the same normalization constants
        n0 = members[0].normalizer.to_numpy()
        for i, m in enumerate(members[1:], start=1):
            ni = m.normalizer.to_numpy()
            if not all(np.allclose(n0[k], ni[k]) for k in FIELDS):
                raise ValueError(
                    f"member {i}'s normalization constants differ from member 0's — "
                    "ensemble members must be trained against the same training-set "
                    "statistics"
                )
        self.members: List[DirectEmulator] = list(members)
        self.config = cfg
        self.device = members[0].device
        self.normalizer = members[0].normalizer
        self.frequencies = members[0].frequencies
        self.redshifts = members[0].redshifts
        self.par_labels = members[0].par_labels
        with torch.no_grad():
            self.stacked_params = tuple(
                {k: torch.stack([m.params[i][k].detach() for m in members]) for k in ("w", "b")}
                for i in range(len(members[0].params))
            )
        self._views = None

    @property
    def params(self):
        """The stacked member weights: the first argument of every
        function the ensemble builds."""
        return self.stacked_params

    def replica(self, device) -> "DeepEnsemble":
        """The ensemble on ``device``, for a mesh that serves it there:
        itself on its own device, else a shallow copy, with no memo and no
        member views, whose normalizer and members sit on ``device`` (the
        stacked weights are passed to every call and are not copied)."""
        from tpu21cmvae_torch.models._memo import replica_on

        rep = replica_on(self, device)
        if rep is not self:
            rep.members = [m.replica(device) for m in self.members]
            rep._views = None
        return rep

    def member_params(self, stacked) -> list:
        """Member ``m``'s layer dicts as views of ``stacked``, one list per
        member. The views are built once per stacked tree (keyed on its
        tensors' identity), so a kernel wrapper that caches its folded
        operands against its weights' identity folds once."""
        leaves = [t for layer in stacked for t in (layer["w"], layer["b"])]
        hit = self._views
        if hit is None or len(hit[0]) != len(leaves) or any(
                a is not b for a, b in zip(hit[0], leaves)):
            n = int(leaves[0].shape[0])
            views = [tuple({"w": layer["w"][i], "b": layer["b"][i]} for layer in stacked)
                     for i in range(n)]
            hit = self._views = (leaves, views)
        return hit[1]

    # -- construction ------------------------------------------------------

    @classmethod
    def train(
        cls,
        data: DataSplits,
        n_members: int = 5,
        config: DirectEmulatorConfig = DirectEmulatorConfig(),
        train_config: Optional[TrainConfig] = None,
        seeds: Optional[Sequence[int]] = None,
        device_loop: bool = True,
        verbose: bool = False,
        parallel: bool = False,
        mesh=None,
        *,
        device,
    ) -> "DeepEnsemble":
        """Train ``n_members`` replicas from different init and shuffle
        seeds (the same data and recipe) on ``device``. ``parallel=True``
        trains the stacked weights through
        :func:`~tpu21cmvae_torch.train.scan.fit_scan_stack` (one member
        after another in the port, each exactly as it trains alone);
        ``mesh`` is refused (the port trains on one device)."""
        seeds = list(seeds) if seeds is not None else list(range(n_members))
        cfg = train_config or DIRECT_TRAIN_DEFAULT
        members = [DirectEmulator(data, config=config, seed=s, device=device) for s in seeds]
        if not parallel:
            from tpu21cmvae_torch.sampling._common import _refuse_mesh

            _refuse_mesh(mesh)
            for s, m in zip(seeds, members):
                # the member seed drives the shuffles too, as in fit_scan_stack
                m.train(train_config=dataclasses.replace(cfg, seed=s),
                        device_loop=device_loop, verbose=verbose)
            return cls(members)
        if not device_loop:
            raise ValueError("parallel=True requires device_loop=True")
        from tpu21cmvae_torch.ops.transforms import par_transform, preproc
        from tpu21cmvae_torch.train.scan import fit_scan_stack

        norm = members[0].normalizer

        def rows(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=members[0].device)

        x, xv = (par_transform(rows(p), norm) for p in (data.par_train, data.par_val))
        y, yv = (preproc(rows(s), norm) for s in (data.signal_train, data.signal_val))
        ens = cls(members)
        _, _, hists = fit_scan_stack(ens.params, members[0].loss_fn(), x, y, xv, yv, cfg,
                                     seeds=seeds, mesh=mesh)  # trains the stack in place
        with torch.no_grad():
            for m, views, history in zip(members, ens.member_params(ens.params), hists):
                for dst, src in zip(m.params, views):
                    dst["w"].copy_(src["w"])
                    dst["b"].copy_(src["b"])
                m.history = history
        return ens

    @classmethod
    def from_checkpoints(cls, paths: Sequence[str], data: Optional[DataSplits] = None, *,
                         device) -> "DeepEnsemble":
        return cls([DirectEmulator.from_checkpoint(p, data, device=device) for p in paths])

    def save(self, directory: str) -> List[str]:
        """One checkpoint per member, ``member_00.npz`` … (atomic)."""
        os.makedirs(directory, exist_ok=True)
        return [m.save(os.path.join(directory, f"member_{i:02d}.npz"))
                for i, m in enumerate(self.members)]

    @classmethod
    def load(cls, directory: str, data: Optional[DataSplits] = None, *,
             device) -> "DeepEnsemble":
        paths = sorted(glob.glob(os.path.join(directory, "member_*.npz")))
        if not paths:
            raise FileNotFoundError(f"no member_*.npz under {directory}")
        return cls.from_checkpoints(paths, data, device=device)

    # -- inference ---------------------------------------------------------

    def _backend(self) -> str:
        """The likelihood backend of the samplers and fits: the kernels on
        a CUDA ensemble, their plain versions on the CPU."""
        return "kernel" if self.device.type == "cuda" else "torch"

    def _members_of(self, build, backend: str):
        """One likelihood function per member: one plain function shared by
        every member, or with ``backend="kernel"`` a wrapper of its own
        each (its own operand cache and launch count)."""
        if backend == "kernel":
            return [build() for _ in self.members]
        return [build()] * len(self.members)

    def predict_fn(self, precision=None):
        """``(stacked, raw) → (B, n_bins)``: the members' mean prediction
        (``precision`` as :meth:`DirectEmulator.predict_fn`)."""
        base = self.members[0].predict_fn(precision=precision)

        def mean_predict(stacked, raw):
            return torch.stack([base(p, raw) for p in self.member_params(stacked)]).mean(dim=0)

        return mean_predict

    def loglik_fn(self, obs, noise_var=1.0, *, backend: str = "torch", method: str = "gram",
                  precision=None, memo: bool = True):
        """The mixture log-likelihood ``(stacked, raw) → (B,)``
        (:class:`MixtureLoglik`) over the members' ``make_loglik``
        (``backend``, ``method``, ``precision`` and the noise specs as
        :meth:`DirectEmulator.loglik_fn`): where members disagree the
        mixture is flatter than any member's likelihood, so the posterior
        widens by the emulation error. ``logsumexp`` is 1-Lipschitz in the
        max norm, so the members' tier bounds carry to the mixture.
        Memoized like :meth:`DirectEmulator.loglik_fn`."""
        from tpu21cmvae_torch.models._memo import memo_program, noise_key
        from tpu21cmvae_torch.ops.loglik import make_loglik

        def build():
            return MixtureLoglik(self._members_of(
                lambda: make_loglik(self.config, self.normalizer, obs, noise_var,
                                    backend=backend, method=method, precision=precision),
                backend), self.member_params)

        return memo_program(
            self, ("loglik", _host(obs), noise_key(noise_var), backend, method, str(precision)),
            build, memo=memo,
        )

    def loglik_and_grad_fn(self, obs, noise_var=1.0, *, backend: str = "torch",
                           method: str = "gram", precision=None, grad_precision=None,
                           memo: bool = True):
        """The mixture's ``(stacked, raw) → (logL, dlogL/draw)``
        (:class:`MixtureValGrad`) over the members'
        ``make_loglik_and_grad``: with ``backend="kernel"`` one K3 wrapper
        per member. Memoized like :meth:`loglik_fn`."""
        from tpu21cmvae_torch.models._memo import memo_program, noise_key
        from tpu21cmvae_torch.ops.loglik import make_loglik_and_grad

        def build():
            return MixtureValGrad(self._members_of(
                lambda: make_loglik_and_grad(
                    self.config, self.normalizer, obs, noise_var, backend=backend,
                    method=method, precision=precision, grad_precision=grad_precision),
                backend), self.member_params)

        return memo_program(
            self, ("valgrad", _host(obs), noise_key(noise_var), backend, method,
                   str(precision), str(grad_precision)),
            build, memo=memo,
        )

    def loglik_multi_fn(self, obs_batch, noise_var=1.0, *, method: str = "gram",
                        precision=None, memo: bool = True):
        """The stacked-observation mixture ``(stacked, (O·W, 7)) → (O·W,)``
        over the members' ``make_loglik_multi`` (plain PyTorch)."""
        from tpu21cmvae_torch.models._memo import memo_program, noise_key

        return memo_program(
            self, ("multi", _host(obs_batch), noise_key(noise_var), method, str(precision)),
            lambda: self._multi(obs_batch, noise_var, method, precision, grad=False),
            memo=memo,
        )

    def _multi(self, obs_batch, noise_var, method, precision, grad: bool):
        from tpu21cmvae_torch.ops.loglik import make_loglik_and_grad_multi, make_loglik_multi

        build = make_loglik_and_grad_multi if grad else make_loglik_multi
        fn = build(self.config, self.normalizer, obs_batch, noise_var, method=method,
                   precision=precision)
        return (MixtureValGrad if grad else MixtureLoglik)([fn] * len(self.members),
                                                           self.member_params)

    def _hmc_valgrad(self, obs, noise_var):
        """The gradient samplers' and the fits' mixture: per member K3 at
        (high, default) on a CUDA ensemble."""
        return self.loglik_and_grad_fn(obs, noise_var, backend=self._backend(),
                                       grad_precision="default")

    def marginalize_foreground(self, noise_var=1.0, *, n_terms: int = 5, basis="linlog",
                               prior_var=None, nu_ref=None):
        """Foreground-marginalized noise model on the ensemble's frequency
        axis (:meth:`DirectEmulator.marginalize_foreground`)."""
        return self.members[0].marginalize_foreground(noise_var, n_terms=n_terms, basis=basis,
                                                      prior_var=prior_var, nu_ref=nu_ref)

    def sample_posterior(self, obs, noise_var=1.0, *, sampler: str = "hmc", bounds=None,
                         **kwargs):
        """Uncertainty-aware posterior sampling: the chain targets the
        mixture likelihood, so its credible regions include the emulation
        error the member spread measures. Samplers and kwargs as
        :meth:`DirectEmulator.sample_posterior`; on a CUDA ensemble MH, the
        stretch ensemble, PT and SMC run K2 at bf16x3 once per member per
        proposal batch, HMC, ChEES and NUTS K3 at (high, default) once per
        member per leapfrog step."""
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
        """Posteriors for ``O`` observed spectra under the mixture in one
        chain (``n_walkers`` per observation; plain PyTorch), as
        :meth:`DirectEmulator.sample_posterior_batch`."""
        from tpu21cmvae_torch.sampling.driver import run_batched_chain

        obs_batch = np.atleast_2d(np.asarray(obs_batch, np.float32))
        return run_batched_chain(
            sampler, self.params, obs_batch.shape[0], n_walkers,
            loglik_builder=lambda: self._multi(obs_batch, noise_var, method, precision, False),
            valgrad_builder=lambda: self._multi(obs_batch, noise_var, method, precision, True),
            bounds=bounds, device=self.device, **kwargs,
        )

    def fit_params(self, obs, noise_var=1.0, *, bounds=None, **kwargs):
        """Maximum-likelihood fit under the mixture
        (:func:`~tpu21cmvae_torch.sampling.fit.fit_map`)."""
        from tpu21cmvae_torch.sampling.fit import fit_map

        return fit_map(self._hmc_valgrad(obs, noise_var), self.params, bounds=bounds,
                       device=self.device, **kwargs)

    def profile_likelihood(self, obs, noise_var, index, grid, *, bounds=None, **kwargs):
        """Profile likelihood of parameter ``index`` under the mixture
        (:func:`~tpu21cmvae_torch.sampling.fit.profile_likelihood`)."""
        from tpu21cmvae_torch.sampling.fit import profile_likelihood

        return profile_likelihood(self._hmc_valgrad(obs, noise_var), self.params, index, grid,
                                  bounds=bounds, device=self.device, **kwargs)

    def fit_advi(self, obs, noise_var=1.0, *, bounds=None, **kwargs):
        """Full-rank Gaussian ADVI under the mixture
        (:func:`~tpu21cmvae_torch.vi.fit_advi`)."""
        from tpu21cmvae_torch.vi import fit_advi

        return fit_advi(self._hmc_valgrad(obs, noise_var), self.params, bounds=bounds,
                        device=self.device, **kwargs)

    def fit_flow(self, obs, noise_var=1.0, *, bounds=None, **kwargs):
        """Normalizing-flow posterior fit under the mixture
        (:func:`~tpu21cmvae_torch.flows.fit_flow`)."""
        from tpu21cmvae_torch.flows import fit_flow

        return fit_flow(self._hmc_valgrad(obs, noise_var), self.params, bounds=bounds,
                        device=self.device, **kwargs)

    def log_evidence(self, obs, noise_var=1.0, *, bounds=None, method="nested",
                     warm_start=True, **kwargs):
        """Bayesian evidence under the mixture; methods and routes as
        :meth:`DirectEmulator.log_evidence` (``"laplace"`` and ``"flow"``
        read absolute log-densities at the contract tier)."""
        from tpu21cmvae_torch.sampling._common import RoutedLoglik, _refuse_mesh

        _refuse_mesh(kwargs.get("mesh"))
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
            fit_res = self.fit_params(
                obs, noise_var, bounds=bounds, n_starts=max(1024, kwargs.get("n_walkers", 256)),
                n_steps=500, seed=kwargs.get("seed", 0) + 101, log_prior=kwargs.get("log_prior"),
            )
            kwargs.setdefault("n_walkers", 256)
            kwargs["x0"] = fit_res.top(kwargs["n_walkers"])[0]
        return log_evidence(self.loglik_fn(obs, noise_var, backend=backend), self.params,
                            bounds=bounds, device=self.device, **kwargs)

    def log_evidence_batch(self, obs_batch, noise_var=1.0, *, bounds=None, method="auto",
                           khat_threshold=0.7, flow_kwargs=None, final=None,
                           final_kwargs=None, **kwargs):
        """Batched Laplace + IS evidences under the mixture at the contract
        tier, with the khat escalation, as
        :meth:`DirectEmulator.log_evidence_batch`."""
        from tpu21cmvae_torch.ops.loglik import per_row_grad
        from tpu21cmvae_torch.sampling.evidence import laplace_evidence_multi_auto

        obs_batch = np.atleast_2d(np.asarray(obs_batch, np.float32))
        backend = self._backend()

        def rows_loglik(idx):
            return self.loglik_multi_fn(obs_batch[np.asarray(idx)], noise_var,
                                        precision="contract")

        return laplace_evidence_multi_auto(
            self.loglik_multi_fn(obs_batch, noise_var, precision="contract"), self.params,
            obs_batch.shape[0], bounds=bounds, method=method, khat_threshold=khat_threshold,
            flow_kwargs=flow_kwargs, final=final, final_kwargs=final_kwargs,
            row_loglik=lambda i: self.loglik_fn(obs_batch[i], noise_var, backend=backend,
                                                precision="contract"),
            row_valgrad=lambda i: self._hmc_valgrad(obs_batch[i], noise_var),
            rows_loglik=rows_loglik,
            rows_valgrad=lambda idx: per_row_grad(rows_loglik(idx), device=self.device),
            device=self.device, **kwargs,
        )

    def goodness_of_fit(self, obs, noise_var=25.0, draws=None, **kwargs):
        """Posterior predictive model check of the ensemble-mean predictor
        (:func:`tpu21cmvae_torch.calibration.goodness_of_fit`)."""
        from tpu21cmvae_torch.calibration import goodness_of_fit

        return goodness_of_fit(self, obs, noise_var, draws, **kwargs)

    def goodness_of_fit_batch(self, obs_batch, noise_var=25.0, draws=None, **kwargs):
        """Posterior predictive checks of ``O`` observations
        (:func:`tpu21cmvae_torch.calibration.goodness_of_fit_batch`)."""
        from tpu21cmvae_torch.calibration import goodness_of_fit_batch

        return goodness_of_fit_batch(self, obs_batch, noise_var, draws, **kwargs)

    def member_predictions(self, params) -> np.ndarray:
        """(n_members, n, n_bins) member signals for raw parameter rows."""
        raw = torch.atleast_2d(torch.as_tensor(np.asarray(params, np.float32),
                                               device=self.device))
        base = self.members[0].predict_fn()
        return torch.stack([base(p, raw) for p in self.member_params(self.params)]).cpu().numpy()

    def predict(self, params) -> np.ndarray:
        """Ensemble-mean signal(s); a single row squeezes to (n_bins,)."""
        mean = self.member_predictions(params).mean(axis=0)
        return mean[0] if mean.shape[0] == 1 else mean

    def predict_with_uncertainty(self, params) -> Tuple[np.ndarray, np.ndarray]:
        """(mean, std) over the members, per frequency bin."""
        preds = self.member_predictions(params)
        mean, std = preds.mean(axis=0), preds.std(axis=0)
        if mean.shape[0] == 1:
            return mean[0], std[0]
        return mean, std

    def posterior_predictive(self, samples, **kwargs):
        """The mixture's posterior predictive: every member's prediction of
        every draw enters the pool, so the band carries the emulation
        uncertainty on top of the parameter uncertainty
        (:func:`tpu21cmvae_torch.sampling.predictive.posterior_predictive`)."""
        from tpu21cmvae_torch.sampling.predictive import posterior_predictive

        def pooled(raw):
            preds = self.member_predictions(raw)
            return preds.reshape(-1, preds.shape[-1])

        return posterior_predictive(pooled, samples, **kwargs)

    # -- evaluation --------------------------------------------------------

    def test_error(self, relative: bool = True, flow=None, fhigh=None) -> np.ndarray:
        """Per-signal test error of the ensemble-mean prediction."""
        data = self.members[0].data
        if data is None:
            raise ValueError("No dataset attached; construct members with `data=`.")
        return error(data.signal_test, self.predict(data.par_test), relative=relative,
                     nu_arr=self.frequencies, flow=flow, fhigh=fhigh)
