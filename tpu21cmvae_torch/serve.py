"""A warm emulator behind HTTP (the port of ``tpu21cmvae/serve.py``).

A saved checkpoint loads once onto a device; ragged request sizes pad to
a bounded set of batch buckets
(:class:`~tpu21cmvae_torch.parallel.inference.ShardedEmulator`); any
client speaks JSON over HTTP:

    python -m tpu21cmvae_torch serve pretrained/direct_synthetic.npz \\
        --port 8765 --warmup 1024

Endpoints (all JSON), with the JAX service's schemas and status codes:

* ``GET  /health``     → model kind, parameter labels, devices, bins.
* ``POST /predict``    ``{"params": [[7 floats], …]}`` → ``{"signals":
  [[451 floats], …]}`` (mK).
* ``POST /loglik``     ``{"params": …, "obs": [451 floats],
  "noise_var": scalar-or-[451]}`` → ``{"loglik": [floats]}``. The
  likelihood functions are built once per (obs, noise spec) value and
  kept in a bounded LRU; ``warmup_loglik`` / ``--warmup-obs`` builds and
  runs them before the first request. ``/loglik``, ``/sample``, ``/fit``,
  ``/evidence`` and ``/gof`` also accept ``"fg_terms": K`` (+
  ``"fg_basis"``, ``"fg_prior_var"``: a K-term linear foreground
  marginalized out, :mod:`tpu21cmvae_torch.foregrounds`) and
  ``"noise_scale_marginal": true`` (+ ``"noise_alpha"``/``"noise_beta"``:
  the noise level marginalized, :mod:`tpu21cmvae_torch.noisescale`).
* ``POST /sample``     ``{"obs": …, "sampler": "mh"|"pt", "n_walkers": …,
  "n_steps": …, "target_ess": …, …}`` → posterior summary (moments,
  16/50/84 quantiles, ESS, R-hat, acceptance, a thinned sample block; PT
  adds swap rates and the ladder).
* ``POST /fit``        → multi-start maximum-likelihood fit (best row and
  a ranked top block).
* ``POST /evidence``   ``{"method": "laplace"|"smc"|"nested", …}`` →
  ``log Z`` (Laplace: MAP and covariance; smc and nested: an error bar
  and a posterior block).
* ``POST /gof``        ``{"draws": [[7 floats], …], …}`` → posterior
  predictive goodness of fit of the draws against the observation.

``/sample``, ``/fit``, ``/evidence`` and ``/gof`` honor ``"async": true``
→ 202 + ``GET /result/<id>`` (a bounded job queue, one worker), and
``/sample`` takes ``"busy_timeout_s"`` → 503 + retry hint instead of
waiting behind a busy device. Bodies over :data:`MAX_BODY_BYTES` get 413,
malformed requests 400.

**Routing.** The service scores through the backend the model's own
sampler entry points take on its device (``DirectEmulator._backend()``,
``DeepEnsemble._backend()``): the kernels on a CUDA model, their plain
versions on the CPU. On a CUDA direct model ``/predict`` runs K1 at the
exact-fp32 contract tier (``csrc/fused_mlp.cu``, ``predict_fn()``'s
tier); ``/loglik``, ``/sample`` and ``/evidence`` run K2 at
``loglik_fn``'s default tier, bf16x3 (``csrc/fused_gram_mma.cu``);
``/fit`` and Laplace's ascent take K3 at the same value tier through the
likelihood's ``valgrad`` route
(:class:`~tpu21cmvae_torch.sampling._common.RoutedLoglik`; a K2 value
has no derivative in the kernel), Laplace's Hessian the plain version.
The JAX service calls XLA instead, because on a TPU XLA is its compiled
path; the port's compiled path on the card is its kernels. The
autoencoder and VAE serve through plain autograd (JAX runs no Pallas
kernel for them either); the ensemble through its per-member mixture.
A served ``logz`` carries the bf16x3 tier's value error near the mode:
for absolute Bayes factors run ``model.log_evidence`` in process, which
pins the exact tier for Laplace.

Device work runs under ``torch.no_grad()`` in the thread that does it
(grad mode is thread-local, and every request runs in its own thread),
on that thread's current CUDA stream, serialized by one lock; the server
itself is threading, so ``GET /health`` answers during a long call.
The default mesh is the model's own device; a larger mesh splits
``/predict`` and ``/loglik`` batches over its devices, and ``/sample``,
``/fit`` and ``/evidence`` pass it to their samplers, fits and
estimators, which split each likelihood call's rows over it (one
replica of the routed wrapper per device), as JAX's service shards its
walkers.
"""

from __future__ import annotations

import hashlib
import json
import queue
import threading
import uuid
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

#: Largest accepted POST body (16 MB of JSON, ~10^5 predict rows);
#: everything larger is refused with 413 before any of it is read.
MAX_BODY_BYTES = 16 << 20


class DeviceBusyError(RuntimeError):
    """The device lock could not be taken within the caller's
    ``busy_timeout_s`` (or the job queue is full): HTTP 503 with a retry
    hint."""


def _backend(model) -> str:
    """The likelihood backend the model's sampler entry points take on its
    device ("kernel" on a CUDA direct model or ensemble, else "torch")."""
    pick = getattr(model, "_backend", None)
    return pick() if callable(pick) else "torch"


class EmulatorService:
    """The request-independent core: the warm model and its likelihood
    cache, testable and embeddable without HTTP."""

    def __init__(self, model, mesh=None, loglik_cache: int = 8):
        from tpu21cmvae_torch.models.direct import DirectEmulator
        from tpu21cmvae_torch.parallel.inference import ShardedEmulator
        from tpu21cmvae_torch.parallel.mesh import Mesh

        self.model = model
        self.backend = _backend(model)
        mesh = mesh if mesh is not None else Mesh([model.device])
        predict_backend = ("kernel" if self.backend == "kernel"
                           and isinstance(model, DirectEmulator) else "torch")
        self._sharded = ShardedEmulator.for_model(model, mesh=mesh, backend=predict_backend)
        self._mesh = self._sharded.mesh
        # values: (ShardedEmulator for /loglik, the likelihood the samplers,
        # fits and evidences take); the LRU is their only owner
        self._loglik: "OrderedDict[str, tuple]" = OrderedDict()
        self._loglik_cap = loglik_cache
        # device work is serialized; holding the lock only around it lets
        # /health answer during long calls
        self._device_lock = threading.Lock()
        # the LRU is mutated from every handler thread: guard all dict ops
        self._cache_lock = threading.Lock()
        # async jobs (202 + /result/<id>): one worker, a bounded queue and
        # a bounded history, the worker started on the first submission
        self._jobs: "OrderedDict[str, dict]" = OrderedDict()
        self._job_lock = threading.Lock()
        self._job_queue: "queue.Queue" = queue.Queue(maxsize=32)
        self._job_worker: Optional[threading.Thread] = None
        self.JOB_HISTORY = 64

    # -- async jobs ----------------------------------------------------------

    #: endpoints that honor ``"async": true``
    ASYNC_KINDS = ("sample", "evidence", "fit", "gof")

    def submit_sample(self, obs, noise_var=1.0, **opts) -> str:
        """Queue a ``/sample`` request (see :meth:`submit_job`)."""
        return self.submit_job("sample", obs, noise_var, **opts)

    def submit_job(self, kind: str, obs, noise_var=1.0, **opts) -> str:
        """Queue a long request (``kind`` in :data:`ASYNC_KINDS`) and return
        its job id at once; poll :meth:`job_status`. Raises
        :class:`DeviceBusyError` when the queue is full. The request is
        validated in the worker: a bad one ends as the job's ``error``."""
        if kind not in self.ASYNC_KINDS:
            raise ValueError(f"async kind must be one of {self.ASYNC_KINDS}; got {kind!r}")
        job_id = uuid.uuid4().hex[:16]
        with self._job_lock:
            self._jobs[job_id] = {"status": "queued"}
            while len(self._jobs) > self.JOB_HISTORY:
                # drop the oldest FINISHED job; never a live one
                for k, r in self._jobs.items():
                    if r["status"] in ("done", "error"):
                        del self._jobs[k]
                        break
                else:
                    break
        try:
            self._job_queue.put_nowait((job_id, kind, obs, noise_var, opts))
        except queue.Full:
            with self._job_lock:
                del self._jobs[job_id]
            raise DeviceBusyError(
                f"job queue full ({self._job_queue.maxsize} pending); "
                "retry after a /result poll shows capacity"
            ) from None
        with self._job_lock:
            # checked under the lock: two submissions must not start two
            # workers (they would run jobs concurrently and out of order)
            if self._job_worker is None or not self._job_worker.is_alive():
                self._job_worker = threading.Thread(target=self._job_loop, daemon=True)
                self._job_worker.start()
        return job_id

    def job_status(self, job_id: str) -> dict:
        """``{"status": "queued"|"running"}`` while in flight, the
        endpoint's payload with ``status="done"``, or ``{"status":
        "error", "error": …}``; an unknown id raises ``KeyError``."""
        with self._job_lock:
            if job_id not in self._jobs:
                raise KeyError(f"unknown job id {job_id!r}")
            return dict(self._jobs[job_id])

    def _job_loop(self):
        while True:
            job_id, kind, obs, noise_var, opts = self._job_queue.get()
            with self._job_lock:
                self._jobs[job_id]["status"] = "running"
            try:
                out = getattr(self, kind)(obs, noise_var, **opts)
                out["status"] = "done"
            except Exception as e:  # surfaced to the poller, job by job
                out = {"status": "error", "error": f"{type(e).__name__}: {e}"}
            with self._job_lock:
                self._jobs[job_id] = out

    # -- warmup --------------------------------------------------------------

    def _bucket_sizes(self, batch_sizes, up_to: Optional[int]):
        if up_to is None:
            return batch_sizes
        sizes, b = [], self._sharded.quantum
        while b < up_to:
            sizes.append(b)
            b *= 2
        return sizes + [b]

    def warmup(self, batch_sizes=(1, 256, 1024), up_to: Optional[int] = None) -> None:
        """Run one predict call per bucket; ``up_to=N`` covers every bucket
        a request of ≤ N rows can hit. On the card the first call builds
        the kernel library and folds the weights, so no request pays
        that."""
        with self._device_lock, torch.no_grad():
            self._sharded.warmup(self._bucket_sizes(batch_sizes, up_to),
                                 n_params=self.model.config.n_params)

    def warmup_loglik(self, specs, batch_sizes=(1, 256, 1024),
                      up_to: Optional[int] = None) -> None:
        """Build and run the likelihood of known observations before their
        first request. ``specs``: ``(obs, noise_var)`` pairs (or bare
        observations, noise 1.0); CLI ``--warmup-obs``. Warmed entries
        count against the LRU cap."""
        sizes = self._bucket_sizes(batch_sizes, up_to)
        for spec in specs:
            obs, nv = spec if isinstance(spec, tuple) else (spec, 1.0)
            key, entry = self._loglik_lookup(np.asarray(obs, np.float32),
                                             np.asarray(nv, np.float32))
            with self._device_lock, torch.no_grad():
                entry[0].warmup(sizes, n_params=self.model.config.n_params)
            self._loglik_commit(key, entry)

    # -- requests ------------------------------------------------------------

    def health(self) -> dict:
        return {
            "status": "ok",
            "kind": type(self.model).__name__,
            "n_params": self.model.config.n_params,
            "n_bins": self.model.config.n_bins,
            "par_labels": list(getattr(self.model, "par_labels", [])),
            "devices": [str(d) for d in self._mesh.devices.ravel()],
        }

    def predict(self, params) -> np.ndarray:
        with self._device_lock, torch.no_grad():
            return np.atleast_2d(self._sharded(np.asarray(params, np.float32)))

    def _noise_spec(self, noise_var, opts):
        """The request's noise spec: the per-bin array, foreground-
        marginalized when it carries ``fg_terms`` (+ ``fg_basis``,
        ``fg_prior_var``), level-marginalized when it carries
        ``noise_scale_marginal: true`` (+ ``noise_alpha``,
        ``noise_beta``). Rebuilt per request; the cache keys on its
        value."""
        fg_terms = opts.pop("fg_terms", None)
        fg_basis = opts.pop("fg_basis", "linlog")
        fg_prior_var = opts.pop("fg_prior_var", None)
        scale_marginal = bool(opts.pop("noise_scale_marginal", False))
        noise_alpha = opts.pop("noise_alpha", None)
        noise_beta = opts.pop("noise_beta", None)
        nv = np.asarray(noise_var, np.float32)
        if fg_terms is not None:
            nv = self.model.marginalize_foreground(nv, n_terms=int(fg_terms), basis=fg_basis,
                                                   prior_var=fg_prior_var)
        if scale_marginal:
            from tpu21cmvae_torch.noisescale import marginalize_noise_scale

            nv = marginalize_noise_scale(nv, alpha=noise_alpha, beta=noise_beta)
        elif noise_alpha is not None or noise_beta is not None:
            raise ValueError("noise_alpha/noise_beta require noise_scale_marginal")
        return nv

    def _build_loglik(self, model, obs, nv):
        """The likelihood the samplers take for (obs, spec) on ``model``'s
        device, built with ``memo=False`` so that this LRU is its only
        owner: on the kernel backend a :class:`RoutedLoglik` whose value
        is K2 (bf16x3), whose ``valgrad`` is K3 at the same value tier and
        whose ``plain`` is the plain version (Laplace's Hessian); on the
        plain backend the plain likelihood alone (autograd for the
        gradient, as in the JAX service)."""
        from tpu21cmvae_torch.sampling._common import RoutedLoglik

        if self.backend != "kernel":
            return model.loglik_fn(obs, nv, memo=False)
        return RoutedLoglik(
            model.loglik_fn(obs, nv, backend="kernel", memo=False),
            valgrad=model.loglik_and_grad_fn(obs, nv, backend="kernel", memo=False),
            plain=model.loglik_fn(obs, nv, memo=False),
        )

    def _loglik_lookup(self, obs: np.ndarray, nv):
        """Validated (obs, noise spec) → (cache key, entry), the entry
        built when absent; the caller commits it after a first success."""
        from tpu21cmvae_torch.foregrounds import MarginalizedNoise
        from tpu21cmvae_torch.noisescale import ScaleMarginalNoise
        from tpu21cmvae_torch.parallel.inference import ShardedEmulator

        n_bins = self.model.config.n_bins
        if obs.shape != (n_bins,):
            raise ValueError(f"obs must be a flat list of {n_bins} floats; got shape {obs.shape}")
        base = nv.base if isinstance(nv, ScaleMarginalNoise) else nv
        if isinstance(base, MarginalizedNoise):
            if base.whiten.shape != (n_bins, n_bins):
                raise ValueError(
                    f"MarginalizedNoise built for {base.whiten.shape[0]} bins; the model has "
                    f"{n_bins}"
                )
        else:
            shape = np.shape(base)
            if shape not in ((), (n_bins,)):
                raise ValueError(
                    f"noise_var must be a scalar or {n_bins} per-bin values; got shape {shape}"
                )
        mk = getattr(nv, "memo_key", None)
        nv_key = repr(mk()).encode() if callable(mk) else nv.tobytes() + repr(nv.shape).encode()
        key = hashlib.sha256(obs.tobytes() + nv_key).hexdigest()
        with self._cache_lock:
            entry = self._loglik.get(key)
            if entry is not None:
                self._loglik.move_to_end(key)
        if entry is None:
            fn = self._build_loglik(self.model, obs, nv)
            fns = [fn if d == self.model.device
                   else self._build_loglik(self.model.replica(d), obs, nv)
                   for d in self._mesh.device_list]
            entry = (ShardedEmulator(fns, self.model.params, mesh=self._mesh), fn)
        return key, entry

    def _loglik_commit(self, key: str, entry) -> None:
        with self._cache_lock:
            if key not in self._loglik:
                self._loglik[key] = entry
                if len(self._loglik) > self._loglik_cap:
                    self._loglik.popitem(last=False)  # evict the oldest

    def loglik(self, params, obs, noise_var=1.0, **opts) -> np.ndarray:
        nv = self._noise_spec(noise_var, opts)
        if opts:
            raise ValueError(f"unknown loglik options: {sorted(opts)}")
        key, entry = self._loglik_lookup(np.asarray(obs, np.float32), nv)
        with self._device_lock, torch.no_grad():
            out = np.atleast_1d(entry[0](np.asarray(params, np.float32)))
        # cache only after a successful call: a request that fails cannot
        # poison the key for later valid ones
        self._loglik_commit(key, entry)
        return out

    #: request caps: what one request can make the device chew on and how
    #: much JSON it can ask back
    SAMPLE_MAX_WALKERS = 8192
    SAMPLE_MAX_STEPS = 5000
    SAMPLE_MAX_RUNGS = 256
    SAMPLE_MAX_RETURN = 4096

    def _on_device(self, run, busy_timeout_s=None):
        """``run()`` under the device lock and ``torch.no_grad()``, in this
        thread; with ``busy_timeout_s`` a lock not free in time raises
        :class:`DeviceBusyError`."""
        if busy_timeout_s is None:
            self._device_lock.acquire()
        elif not self._device_lock.acquire(timeout=busy_timeout_s):
            raise DeviceBusyError(
                f"device busy for > {busy_timeout_s:.1f}s (a long chain is in flight); "
                "retry, raise busy_timeout_s, or submit with async=true and poll "
                "/result/<id>"
            )
        try:
            with torch.no_grad():
                return run()
        finally:
            self._device_lock.release()

    def _check_bounds(self, opts):
        bounds = opts.pop("bounds", None)
        if bounds is None:
            return {}
        bounds = np.asarray(bounds, np.float64)
        if bounds.shape != (self.model.config.n_params, 2):
            raise ValueError(f"bounds must be ({self.model.config.n_params}, 2)")
        return {"bounds": bounds}

    def _max_samples(self, opts) -> int:
        max_samples = int(opts.pop("max_samples", 1000))
        if not 1 <= max_samples <= self.SAMPLE_MAX_RETURN:
            raise ValueError(f"max_samples must be in [1, {self.SAMPLE_MAX_RETURN}]")
        return max_samples

    def sample(self, obs, noise_var=1.0, **opts) -> dict:
        """Posterior sampling as a service: one request, one chain on the
        device, a JSON summary back, through the same cached likelihood
        ``/loglik`` uses (a repeat request on a known observation folds
        nothing anew). Options: ``sampler`` (``"mh"`` default, or
        ``"pt"`` with ``n_rungs``), ``n_walkers``/``n_steps``/
        ``n_warmup``/``thin``/``seed``, ``bounds``, ``target_ess`` (mh
        only: chunks until the smallest bulk and tail ESS reach it),
        ``max_samples`` (returned rows, default 1,000),
        ``busy_timeout_s``."""
        from tpu21cmvae_torch.sampling.driver import sample_to_ess
        from tpu21cmvae_torch.sampling.mh import sample_mh
        from tpu21cmvae_torch.sampling.pt import sample_pt

        noise_var = self._noise_spec(noise_var, opts)
        sampler = opts.pop("sampler", "mh")
        max_samples = self._max_samples(opts)
        busy_timeout_s = opts.pop("busy_timeout_s", None)
        if busy_timeout_s is not None:
            busy_timeout_s = float(busy_timeout_s)
            if busy_timeout_s < 0:
                raise ValueError("busy_timeout_s must be >= 0")
        kwargs = dict(
            n_walkers=int(opts.pop("n_walkers", 1024)),
            n_steps=int(opts.pop("n_steps", 300)),
            n_warmup=int(opts.pop("n_warmup", 200)),
            thin=int(opts.pop("thin", 10)),
            seed=int(opts.pop("seed", 0)),
        )
        if kwargs["n_walkers"] > self.SAMPLE_MAX_WALKERS:
            raise ValueError(f"n_walkers capped at {self.SAMPLE_MAX_WALKERS}")
        if max(kwargs["n_steps"], kwargs["n_warmup"]) > self.SAMPLE_MAX_STEPS:
            raise ValueError(f"n_steps/n_warmup capped at {self.SAMPLE_MAX_STEPS}")
        if kwargs["thin"] <= 0:
            raise ValueError("thin must be positive")
        kwargs.update(self._check_bounds(opts))
        if sampler == "pt":
            n_rungs = int(opts.pop("n_rungs", 32))
            if n_rungs > self.SAMPLE_MAX_RUNGS:
                raise ValueError(f"n_rungs capped at {self.SAMPLE_MAX_RUNGS}")
            fn_run, extra = sample_pt, {"n_rungs": n_rungs}
        elif sampler == "mh":
            if "target_ess" in opts:
                fn_run = sample_to_ess
                extra = {"target_ess": float(opts.pop("target_ess")),
                         "max_chunks": min(int(opts.pop("max_chunks", 25)), 50)}
            else:
                fn_run, extra = sample_mh, {}
        else:
            raise ValueError(f"sampler must be 'mh' or 'pt' over HTTP; got {sampler!r}")
        if opts:
            raise ValueError(f"unknown sample options: {sorted(opts)}")

        key, entry = self._loglik_lookup(np.asarray(obs, np.float32), noise_var)
        res = self._on_device(lambda: fn_run(
            entry[1], self.model.params, mesh=self._mesh, device=self.model.device,
            **kwargs, **extra), busy_timeout_s)
        self._loglik_commit(key, entry)

        flat = res.flat
        if flat.shape[0] == 0:  # thin too coarse for the step count
            raise ValueError("no stored samples: raise n_steps or lower thin")
        stride = max(1, flat.shape[0] // max_samples)
        enough = res.chain.shape[0] >= 4  # autocorrelation needs ≥ 4 kept steps
        out = {
            "sampler": sampler,
            "par_labels": list(getattr(self.model, "par_labels", [])),
            "mean": flat.mean(0).tolist(),
            "std": flat.std(0).tolist(),
            "quantiles": {q: np.percentile(flat, 100 * q, axis=0).tolist()
                          for q in (0.16, 0.5, 0.84)},
            # NaN (a parameter that never moved) → None: NaN is not JSON
            "ess": ([None if not np.isfinite(v) else float(v) for v in res.ess()]
                    if enough else None),
            "ess_tail": ([None if not np.isfinite(v) else float(v) for v in res.ess_tail()]
                         if enough else None),
            "rhat": res.rhat().tolist() if enough else None,
            "accept_rate": float(np.mean(res.accept_rate)),
            "n_samples": int(flat.shape[0]),
            "samples": flat[::stride][:max_samples].tolist(),
        }
        if sampler == "pt":
            out["swap_rate"] = res.swap_rate.tolist()
            out["betas"] = res.betas.tolist()
        return out

    def gof(self, obs, noise_var=1.0, **opts) -> dict:
        """Posterior predictive goodness of fit
        (:func:`tpu21cmvae_torch.calibration.goodness_of_fit` on the model):
        ``draws`` (required: posterior rows in raw units, e.g. a
        ``/sample`` response's ``samples``), ``max_draws`` (default 512),
        ``seed`` and the noise options (``noise_scale_marginal`` is
        refused). Returns the p-value, q/dof and the worst bin."""
        from tpu21cmvae_torch.calibration import goodness_of_fit

        noise_var = self._noise_spec(noise_var, opts)
        draws = opts.pop("draws", None)
        if draws is None:
            raise ValueError(
                "gof needs 'draws': posterior rows in raw parameter units (e.g. the "
                "samples block /sample returns)"
            )
        max_draws = int(opts.pop("max_draws", 512))
        seed = int(opts.pop("seed", 0))
        if opts:
            raise ValueError(f"unknown gof options: {sorted(opts)}")
        res = self._on_device(lambda: goodness_of_fit(
            self.model, np.asarray(obs, np.float64), noise_var,
            np.asarray(draws, np.float32), max_draws=max_draws, seed=seed))
        worst = int(np.argmax(np.abs(res.bin_z)))
        return {
            "p_value": float(res.p_value),
            "dof": float(res.dof),
            "q_over_dof": float(np.mean(res.q) / res.dof),
            "n_draws": int(res.q.shape[0]),
            "max_bin_z": float(np.abs(res.bin_z).max()),
            "worst_bin": worst,
            "summary": res.summary(),
        }

    def fit(self, obs, noise_var=1.0, **opts) -> dict:
        """Maximum-likelihood fit as a service: multi-start Adam ascent
        (:func:`tpu21cmvae_torch.sampling.fit.fit_map`) over the cached
        likelihood's gradient (K3 on a CUDA direct model). Options:
        ``n_starts`` (default 1,024, capped at ``SAMPLE_MAX_WALKERS``),
        ``n_steps`` (default 300), ``seed``, ``bounds``, ``top`` (ranked
        starts returned, default 16)."""
        from tpu21cmvae_torch.sampling._common import valgrad_from_loglik
        from tpu21cmvae_torch.sampling.fit import fit_map

        noise_var = self._noise_spec(noise_var, opts)
        kwargs = dict(n_starts=int(opts.pop("n_starts", 1024)),
                      n_steps=int(opts.pop("n_steps", 300)),
                      seed=int(opts.pop("seed", 0)))
        top = int(opts.pop("top", 16))
        if kwargs["n_starts"] > self.SAMPLE_MAX_WALKERS:
            raise ValueError(f"n_starts capped at {self.SAMPLE_MAX_WALKERS}")
        if kwargs["n_steps"] > self.SAMPLE_MAX_STEPS:
            raise ValueError(f"n_steps capped at {self.SAMPLE_MAX_STEPS}")
        if not 1 <= top <= min(kwargs["n_starts"], self.SAMPLE_MAX_RETURN):
            raise ValueError("top out of range")
        kwargs.update(self._check_bounds(opts))
        if opts:
            raise ValueError(f"unknown fit options: {sorted(opts)}")
        key, entry = self._loglik_lookup(np.asarray(obs, np.float32), noise_var)
        res = self._on_device(lambda: fit_map(
            valgrad_from_loglik(entry[1]), self.model.params, mesh=self._mesh,
            device=self.model.device, **kwargs))
        self._loglik_commit(key, entry)
        order = np.argsort(-np.nan_to_num(res.logp, nan=-np.inf))[:top]
        return {
            "par_labels": list(getattr(self.model, "par_labels", [])),
            "best": res.best.tolist(),
            "best_logp": float(res.best_logp),
            "top": res.params[order].tolist(),
            "top_logp": res.logp[order].tolist(),
        }

    #: /evidence caps (nested): live points and constrained-MH steps
    EVIDENCE_MAX_LIVE = 4096
    EVIDENCE_MAX_MH = 64

    def evidence(self, obs, noise_var=1.0, **opts) -> dict:
        """Bayesian evidence as a service: ``method="laplace"`` (default:
        deterministic, MAP and covariance), ``"smc"`` (the adaptive
        tempered anneal: a replication ``logz_err`` and posterior
        particles) or ``"nested"`` (``n_live``/``n_mh`` capped). Served at
        the likelihood's default tier (bf16x3), whose value error near the
        mode bounds a served ``logz``'s absolute accuracy: fine for
        screening; for Bayes factors run ``model.log_evidence`` in
        process."""
        noise_var = self._noise_spec(noise_var, opts)
        method = opts.pop("method", "laplace")
        seed = int(opts.pop("seed", 0))
        bkw = self._check_bounds(opts)
        key, entry = self._loglik_lookup(np.asarray(obs, np.float32), noise_var)
        common = dict(seed=seed, mesh=self._mesh, device=self.model.device, **bkw)
        if method == "laplace":
            from tpu21cmvae_torch.sampling.evidence import laplace_evidence

            n_starts = int(opts.pop("n_starts", 4096))
            n_steps = int(opts.pop("n_steps", 2000))
            if n_starts > self.SAMPLE_MAX_WALKERS:
                raise ValueError(f"n_starts capped at {self.SAMPLE_MAX_WALKERS}")
            if n_steps > self.SAMPLE_MAX_STEPS:
                raise ValueError(f"n_steps capped at {self.SAMPLE_MAX_STEPS}")
            if opts:
                raise ValueError(f"unknown evidence options: {sorted(opts)}")
            res = self._on_device(lambda: laplace_evidence(
                entry[1], self.model.params, n_starts=n_starts, n_steps=n_steps, **common))
            self._loglik_commit(key, entry)
            return {
                "method": "laplace",
                "logz": float(res.logz),
                "pd": bool(res.pd),
                "map_params": res.map_params.tolist(),
                "map_logp": float(res.map_logp),
                "cov": res.cov.tolist(),
            }
        if method == "smc":
            from tpu21cmvae_torch.sampling.smc import sample_smc

            n_particles = int(opts.pop("n_particles", 4096))
            n_mh = int(opts.pop("n_mh", 8))
            if n_particles > self.SAMPLE_MAX_WALKERS:
                raise ValueError(f"n_particles capped at {self.SAMPLE_MAX_WALKERS}")
            if n_mh > self.EVIDENCE_MAX_MH:
                raise ValueError(f"n_mh capped at {self.EVIDENCE_MAX_MH}")
            max_samples = self._max_samples(opts)
            if opts:
                raise ValueError(f"unknown evidence options: {sorted(opts)}")
            res = self._on_device(lambda: sample_smc(
                entry[1], self.model.params, n_particles=n_particles, n_mh=n_mh, **common))
            self._loglik_commit(key, entry)
            take = np.random.default_rng(seed).permutation(res.final.shape[0])[:max_samples]
            return {
                "method": "smc",
                "logz": float(res.logz),
                "logz_err": float(res.logz_err),
                "n_stages": int(res.n_stages),
                "accept_rate": float(res.accept_rate.mean()),
                "posterior": res.final[take].tolist(),
            }
        if method != "nested":
            raise ValueError(
                f"method must be 'laplace', 'smc' or 'nested' over HTTP; got {method!r}"
            )
        from tpu21cmvae_torch.nested import nested_sampling

        n_live = int(opts.pop("n_live", 1024))
        n_mh = int(opts.pop("n_mh", 16))
        if n_live > self.EVIDENCE_MAX_LIVE:
            raise ValueError(f"n_live capped at {self.EVIDENCE_MAX_LIVE}")
        if n_mh > self.EVIDENCE_MAX_MH:
            raise ValueError(f"n_mh capped at {self.EVIDENCE_MAX_MH}")
        max_samples = self._max_samples(opts)
        if opts:
            raise ValueError(f"unknown evidence options: {sorted(opts)}")
        res = self._on_device(lambda: nested_sampling(
            entry[1], self.model.params, n_live=n_live, n_mh=n_mh, **common))
        self._loglik_commit(key, entry)
        return {
            "method": "nested",
            "logz": float(res.logz),
            "logz_err": float(res.logz_err),
            "h": float(res.h),
            "ess": float(res.ess),
            "truncated": bool(res.truncated),
            "posterior": res.posterior(max_samples, seed=seed).tolist(),
        }


def _make_handler(service: EmulatorService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # device work serializes on the service lock, so keep-alive buys
        # nothing: close after every response, and bound reads so a
        # half-open connection cannot pin its handler thread
        timeout = 30

        def log_message(self, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)
            self.close_connection = True

        def _device_post(self, kind, req):
            """The long POSTs: each honors ``"async": true`` (202 + a
            /result/<id> to poll)."""
            obs = req.pop("obs")
            nv = req.pop("noise_var", 1.0)
            if req.pop("async", False):
                job_id = service.submit_job(kind, obs, nv, **req)
                self._reply(202, {"job_id": job_id, "result_path": f"/result/{job_id}"})
            else:
                self._reply(200, getattr(service, kind)(obs, nv, **req))

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, service.health())
            elif self.path.startswith("/result/"):
                try:
                    self._reply(200, service.job_status(self.path[len("/result/"):]))
                except KeyError as e:
                    self._reply(400, {"error": str(e)})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > MAX_BODY_BYTES:
                    self._reply(413, {
                        "error": f"request body {n} bytes exceeds the {MAX_BODY_BYTES}-byte "
                        "limit; split the batch"
                    })
                    return
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/predict":
                    self._reply(200, {"signals": service.predict(req["params"]).tolist()})
                elif self.path == "/loglik":
                    params = req.pop("params")
                    obs = req.pop("obs")
                    nv = req.pop("noise_var", 1.0)
                    self._reply(200, {"loglik": service.loglik(params, obs, nv, **req).tolist()})
                elif self.path in ("/sample", "/fit", "/evidence", "/gof"):
                    self._device_post(self.path[1:], req)
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except DeviceBusyError as e:
                # the device is legitimately busy: tell the client to come back
                self._reply(503, {"error": str(e), "retry_after_s": 5})
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # device or runtime failure: JSON 500, not a dropped socket
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def make_server(model, host: str = "127.0.0.1", port: int = 8765,
                mesh=None) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; ``serve_forever()`` it, or
    drive it from a thread. ``port=0`` picks a free port
    (``server.server_address[1]``); ``server.service`` is the
    :class:`EmulatorService`."""
    service = EmulatorService(model, mesh=mesh)
    server = ThreadingHTTPServer((host, port), _make_handler(service))
    server.daemon_threads = True
    server.service = service
    return server


def load_obs_specs(path: str):
    """``--warmup-obs`` / ``--obs`` file → ``[(obs, noise_var), …]``.

    ``.json``: one object or a list of objects ``{"obs": [n_bins floats],
    "noise_var": scalar-or-[n_bins]}`` (``noise_var`` defaults to 1.0).
    ``.npz``: array ``obs`` of shape (n_bins,) or (k, n_bins) plus an
    optional ``noise_var``: a scalar, one per observation (k,), one
    per-bin curve shared by all (n_bins,), or (k, n_bins).
    """
    if path.endswith(".npz"):
        blob = np.load(path)
        obs = np.atleast_2d(np.asarray(blob["obs"], np.float32))
        nv = (np.asarray(blob["noise_var"], np.float32) if "noise_var" in blob
              else np.float32(1.0))
        if nv.ndim == 2:
            nvs = nv
        elif nv.ndim == 1 and nv.shape[0] == obs.shape[1]:
            nvs = np.broadcast_to(nv, (obs.shape[0],) + nv.shape)
        elif nv.ndim == 1 and nv.shape[0] == obs.shape[0]:
            nvs = nv
        elif nv.ndim == 0:
            nvs = np.broadcast_to(nv, (obs.shape[0],))
        else:
            raise ValueError(
                f"noise_var shape {nv.shape} matches neither the {obs.shape[0]} observations "
                f"nor the {obs.shape[1]} bins"
            )
        return [(o, n) for o, n in zip(obs, nvs)]
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        doc = [doc]
    return [(np.asarray(d["obs"], np.float32), np.asarray(d.get("noise_var", 1.0), np.float32))
            for d in doc]


def main(model_path: str, host: str, port: int, warmup: Optional[int],
         warmup_obs: Optional[str] = None, *, device):
    """Load ``model_path`` onto ``device``, warm it, and serve forever."""
    from tpu21cmvae_torch.models import load_model

    model = load_model(model_path, device=device)
    server = make_server(model, host=host, port=port)
    if warmup:
        print(f"warming every predict bucket up to {warmup} rows...", flush=True)
        server.service.warmup(up_to=warmup)
    if warmup_obs:
        specs = load_obs_specs(warmup_obs)
        print(f"warming the likelihood of {len(specs)} observation(s) from {warmup_obs}...",
              flush=True)
        server.service.warmup_loglik(specs, up_to=warmup or None)
    host, port = server.server_address[:2]
    print(f"serving {model_path} on http://{host}:{port} "
          "(GET /health, POST /predict, POST /loglik)", flush=True)
    server.serve_forever()
