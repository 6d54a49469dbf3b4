"""Deployment artifacts: serialized ``torch.export`` programs (the port of
``tpu21cmvae/deploy.py``).

An artifact is one self-contained file: :func:`torch.export.export`
traces the whole chain — ``par_transform → MLP → unpreproc`` for
predict, the folded likelihood for loglik, the likelihood with its
gradient for valgrad — with the trained weights and every normalization
constant captured as constants, over a **dynamic batch dimension**
(``torch.export.Dim``), and :func:`torch.export.save` writes it. It
replays in any process that has a compatible ``torch``::

    import torch
    fn = torch.export.load("emulator.pt2").module()
    signals = fn(params_batch)          # any batch size, float32 (B, 7)

— no ``tpu21cmvae_torch`` import, no checkpoint file, no dataset.

What an artifact holds, and where it replays:

- **The plain chain, never a kernel.** The port's kernels are called
  through ``ctypes`` and cannot be traced, as the JAX package's Pallas
  custom calls cannot be exported. So an artifact holds the plain
  PyTorch version of each function at its tier; the value+gradient
  artifact holds the family's plain analytic backward
  (``loglik_and_grad_fn(backend="torch")``, the function JAX exports
  too): autograd itself does not export (a gradient taken inside the
  traced function leaves fake tensors among the constants, and the tier
  matmul's custom ``autograd.Function`` has no functorch rule). A
  family with no analytic backward (the autoencoder, the VAE) has no
  value+gradient artifact.
- **Platforms.** The program is saved with its constants on the CPU;
  :func:`load_artifact` moves it to the device it replays on
  (``torch.export.passes.move_to_device_pass``). ``platforms`` lists the
  device types the artifact was replayed on at export time and matched
  the in-process function (the CPU, and the model's own device: an
  artifact exported on the CPU is checked there only, and one meant for
  the card is exported on the card, where both are checked). TF32 stays
  off while an :class:`ExportedFn` replays.
- **Reduction order.** The replay runs the same operations as the
  in-process plain function and differs from it in summation order
  only. The check at export holds each platform's replay to the
  kernel-vs-plain tolerances of the artifact's tier (see
  ``_AMPLITUDE_RTOL``): at fp32, predict within 1e-5 of the amplitude
  and the likelihood within 1e-6 of its value scale, so a replay that
  ran TF32 products, or a drifted constant, is refused. On the same
  device predict matches the model's own ``predict`` within 5e-5, the
  tolerance ``verify`` asserts.
- **Compatibility.** ``torch.export``'s serialized format follows the
  ``torch`` release that wrote it; checkpoints
  (:mod:`tpu21cmvae_torch.models.checkpoint`) stay the durable format.
"""

from __future__ import annotations

import json
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu21cmvae_torch.foregrounds import MarginalizedNoise
from tpu21cmvae_torch.noisescale import ScaleMarginalNoise
from tpu21cmvae_torch.ops.fold import resolve_tier
from tpu21cmvae_torch.utils.io import atomic_write
from tpu21cmvae_torch.utils.metrics import GRAD_MAX_REL, GRAD_RTOL, grad_rel_error
from tpu21cmvae_torch.utils.tree import tree_map

#: Device types an artifact can be checked on.
PLATFORMS: Tuple[str, ...] = ("cpu", "cuda")
_META = "tpu21cmvae_torch.json"
# The replay check at export, by the artifact's arithmetic tier. Replay
# and in-process function compute the same products and differ in
# summation order only. Two summation orders of one plain chain (fp32
# against float64 accumulation, flagship checkpoint, chip_smoke.py's
# AMPLITUDE_RTOL and VALUE_RTOL) differ by up to 4.3e-7, 2.1e-5 and
# 7.2e-4 of the amplitude in predict at f32, bf16x3 and bf16, and by
# 6.2e-7, 3.2e-5 and 1.2e-3 of the value scale c/2. predict:
# |Δ| ≤ rtol·max|in-process|. loglik and valgrad: |Δ logL| ≤
# rtol·(|logL| + s) + atol, s = ½·Σ obs²/σ², the size of the terms the
# Gaussian value cancels (2.3 c/2 on the flagship at σ² = 25); the
# gradient per row relative to its norm plus the rms norm
# (utils.metrics.grad_rel_error), ≤ 1e-4 at f32 and within the two-part
# gradient gate at the bf16 tiers. The f32 value limit is 1e-6, not the
# kernels' 1e-5: a replay whose products ran at TF32 (operands rounded
# to 10 mantissa bits) moves the value by ~6e-6 of s on the small test
# model, since the rounding errors of a wide product average out, and
# the limit must refuse it (tests/test_torch_deploy.py). The bf16 tiers'
# operands are bf16, which TF32 holds exactly.
_AMPLITUDE_RTOL = {"f32": 1e-5, "bf16x3": 1e-4, "bf16": 5e-3}
_VALUE_RTOL = {"f32": 1e-6, "bf16x3": 1e-4, "bf16": 5e-3}
_VALUE_ATOL = 1e-2
_GRAD_MAX_REL_F32 = 1e-4


class _Gate(NamedTuple):
    """What an artifact's replay is held to: its kind, value tier,
    gradient tier (valgrad) and value scale s (loglik, valgrad)."""

    kind: str
    tier: str
    grad_tier: Optional[str] = None
    scale: float = 0.0


class Exported(NamedTuple):
    """An exported function: the program (constants on ``device``), its
    input width, the device types its replay was checked on, and its
    kind (``"predict"``, ``"loglik"`` or ``"valgrad"``)."""

    program: torch.export.ExportedProgram
    n_in: int
    platforms: Tuple[str, ...]
    kind: str


class _Program(torch.nn.Module):
    def __init__(self, fn, weights):
        super().__init__()
        self.fn = fn
        self.weights = weights

    def forward(self, raw):
        return self.fn(self.weights, raw)


def _to_host(out) -> list:
    return [o.detach().cpu().numpy() for o in (out if isinstance(out, tuple) else (out,))]


class _NoTF32:
    """TF32 off for matmuls while the block runs (the fp32 contract)."""

    def __enter__(self):
        self._prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self._prev


def _move(program, device):
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(program, torch.device(device))


def _probe(n_in: int, device) -> torch.Tensor:
    """Rows inside the default prior box (the log columns positive)."""
    from tpu21cmvae_torch.data.synthetic import PAR_RANGES

    box = np.asarray(PAR_RANGES, np.float32)[:n_in] if n_in == len(PAR_RANGES) else None
    u = np.random.default_rng(0).uniform(0.1, 0.9, (5, n_in)).astype(np.float32)
    rows = box[:, 0] + u * (box[:, 1] - box[:, 0]) if box is not None else u
    return torch.as_tensor(rows, device=device)


def _value_scale(obs, noise_var) -> float:
    """s = ½·Σ obs²/σ², σ² the per-bin noise of ``noise_var`` (a scale
    marginal's σ² shape, a marginalized spec's per-bin σ²)."""
    if isinstance(noise_var, ScaleMarginalNoise):
        noise_var = noise_var.base
    if isinstance(noise_var, MarginalizedNoise):
        noise_var = noise_var.noise_var
    obs = np.asarray(obs, np.float64)
    return 0.5 * float(np.sum(obs**2 / np.asarray(noise_var, np.float64)))


def _loglik_gate(model, kind, obs, noise_var, kwargs) -> _Gate:
    """The gate of a loglik or valgrad artifact: the families with
    kernels (``_backend``) take ``precision=`` and default to bf16x3;
    the two-stage families' chain is fp32."""
    default = "high" if hasattr(model, "_backend") else "highest"
    tier = resolve_tier(kwargs.get("precision"), default=default)
    grad = kwargs.get("grad_precision")
    grad_tier = tier if grad is None else resolve_tier(grad)
    return _Gate(kind, tier, grad_tier if kind == "valgrad" else None,
                 _value_scale(obs, noise_var))


def _replay_worst(got, want, gate: _Gate) -> float:
    """The replay's worst |Δ| over its limit (≤ 1 passes; inf when a
    shape differs): ``got`` and ``want`` the outputs as host arrays."""
    if len(got) != len(want) or any(g.shape != w.shape for g, w in zip(got, want)):
        return float("inf")
    g = [np.asarray(a, np.float64) for a in got]
    w = [np.asarray(a, np.float64) for a in want]
    if not w[0].size:
        return 0.0
    if gate.kind == "predict":
        amp = max(float(np.abs(w[0]).max()), np.finfo(np.float32).tiny)
        return float(np.abs(g[0] - w[0]).max() / (_AMPLITUDE_RTOL[gate.tier] * amp))
    tol = _VALUE_RTOL[gate.tier] * (np.abs(w[0]) + gate.scale) + _VALUE_ATOL
    worst = float((np.abs(g[0] - w[0]) / tol).max())
    if gate.kind == "valgrad":
        rel = grad_rel_error(g[1], w[1])
        if gate.grad_tier == "f32":
            worst = max(worst, float(rel.max()) / _GRAD_MAX_REL_F32)
        else:
            worst = max(worst, float(np.quantile(rel, 0.999)) / GRAD_RTOL,
                        float(rel.max()) / GRAD_MAX_REL)
    return worst


def _check_platforms(program, x, want, platforms, gate: _Gate) -> Tuple[str, ...]:
    """Replay ``program`` on each requested device type on the probe rows
    ``x`` against ``want``, the in-process function's outputs there;
    return the types that matched within ``gate``'s limits."""
    checked = []
    for p in platforms:
        if p not in PLATFORMS:
            raise ValueError(f"platforms must be a subset of {PLATFORMS}; got {p!r}")
        if p == "cuda" and not torch.cuda.is_available():
            raise ValueError(
                "cannot check a replay on cuda without a CUDA device: export on the card "
                "(or leave cuda out of platforms)"
            )
        moved = _move(program, p)
        with torch.no_grad(), _NoTF32():
            got = _to_host(moved.module()(x.to(p)))
        worst = _replay_worst(got, want, gate)
        if not worst <= 1.0:
            raise RuntimeError(
                f"the artifact's replay on {p} disagrees with the in-process function "
                f"({gate.kind} at {gate.tier}: worst |Δ|/limit {worst:.3g})"
            )
        checked.append(p)
    return tuple(checked)


def _export_batched(fn, weights, n_in: int, device, platforms, gate: _Gate) -> Exported:
    """Export ``raw (b, n_in) → out`` with a dynamic batch dimension and
    check its replay (see the module docstring)."""
    device = torch.empty(0, device=device).device
    weights = tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor) else t, weights)
    if platforms is None:
        platforms = tuple(dict.fromkeys(("cpu", device.type)))
    x = _probe(n_in, device)
    with torch.no_grad(), _NoTF32():
        # in process first: tracing may leave caches keyed on these weights
        # (the ensemble's member views) holding traced tensors
        want = _to_host(fn(weights, x))
        program = torch.export.export(_Program(fn, weights), (x,),
                                      dynamic_shapes=({0: torch.export.Dim("b", min=0)},),
                                      strict=False)
    checked = _check_platforms(program, x, want, tuple(platforms), gate)
    return Exported(program, n_in, checked, gate.kind)


def export_predict(model, *, platforms: Optional[Sequence[str]] = None, precision=None):
    """Export a model's batched predict (every family with ``predict_fn()``
    + ``params``: direct, the two-stage families, the ensemble's mean):
    ``(b, n_params) float32 → (b, n_bins)``. ``precision`` forwards to
    ``predict_fn`` where the family takes a tier (direct, ensemble);
    None keeps the exact-fp32 contract path."""
    fn = model.predict_fn() if precision is None else model.predict_fn(precision=precision)
    if precision == "native":  # the ensemble's members carry it
        precision = getattr(model, "members", [model])[0].native_precision
    return _export_batched(fn, model.params, int(model.config.n_params), model.device,
                           platforms, _Gate("predict", resolve_tier(precision, "highest")))


def _plain(kwargs: dict) -> dict:
    if kwargs.get("backend", "torch") != "torch":
        raise ValueError(
            "an artifact holds the plain chain: the kernels (backend='kernel') cannot be "
            "exported; leave backend at 'torch'"
        )
    return kwargs


def export_loglik(model, obs, noise_var=1.0, *, platforms: Optional[Sequence[str]] = None,
                  **loglik_kwargs):
    """Export a model's Gaussian log-likelihood for one observation,
    ``(b, n_params) float32 → (b,)``, the observation and noise spec
    folded in. ``loglik_kwargs`` forward to the family's ``loglik_fn``
    (``method=``, ``precision=``, …) on its plain backend."""
    ll = model.loglik_fn(obs, noise_var, memo=False, **_plain(loglik_kwargs))
    return _export_batched(ll, model.params, int(model.config.n_params), model.device,
                           platforms, _loglik_gate(model, "loglik", obs, noise_var,
                                                   loglik_kwargs))


def export_valgrad(model, obs, noise_var=1.0, *, platforms: Optional[Sequence[str]] = None,
                   **valgrad_kwargs):
    """Export the value+gradient likelihood, ``(b, n_params) float32 →
    ((b,) logL, (b, n_params) dlogL/draw)``: the HMC/NUTS inner loop for
    external gradient-based samplers. ``valgrad_kwargs`` forward to the
    family's ``loglik_and_grad_fn`` on its plain backend, whose analytic
    backward is what the artifact holds (direct, ensemble)."""
    if not hasattr(model, "_backend"):
        raise NotImplementedError(
            f"{type(model).__name__} has no analytic backward: its gradient is autograd's, "
            "which torch.export does not trace, so it has no value+gradient artifact"
        )
    vg = model.loglik_and_grad_fn(obs, noise_var, memo=False, **_plain(valgrad_kwargs))
    return _export_batched(vg, model.params, int(model.config.n_params), model.device,
                           platforms, _loglik_gate(model, "valgrad", obs, noise_var,
                                                   valgrad_kwargs))


def save_artifact(exported: Exported, path: str) -> str:
    """Write ``exported`` to ``path`` atomically (write then rename), its
    constants on the CPU, with its input width, platforms and kind in the
    file's extra entry ``tpu21cmvae_torch.json``."""
    program = exported.program
    if any(t.device.type != "cpu" for t in program.constants.values()
           if isinstance(t, torch.Tensor)):
        program = _move(program, "cpu")
    meta = {"n_in": exported.n_in, "platforms": list(exported.platforms),
            "kind": exported.kind}
    with atomic_write(path) as fh:
        torch.export.save(program, fh, extra_files={_META: json.dumps(meta)})
    return path


def save_predict_artifact(model, path: str, **kwargs) -> str:
    """:func:`export_predict` + :func:`save_artifact` in one call."""
    return save_artifact(export_predict(model, **kwargs), path)


def save_loglik_artifact(model, path: str, obs, noise_var=1.0, **kwargs) -> str:
    """:func:`export_loglik` + :func:`save_artifact` in one call."""
    return save_artifact(export_loglik(model, obs, noise_var, **kwargs), path)


def save_valgrad_artifact(model, path: str, obs, noise_var=1.0, **kwargs) -> str:
    """:func:`export_valgrad` + :func:`save_artifact` in one call."""
    return save_artifact(export_valgrad(model, obs, noise_var, **kwargs), path)


class ExportedFn:
    """Callable wrapper over a loaded artifact, with the package's input
    convention: lists and 1-D single rows accepted, float32 in, NumPy
    out, the batch axis squeezed back out for a 1-D input (as
    ``DirectEmulator.predict``). A valgrad artifact returns the
    ``(logL, grad)`` pair, each squeezed. Consumers that want none of
    this call ``torch.export.load(path).module()`` directly."""

    def __init__(self, program, meta: dict, device):
        self.program = program
        self.meta = meta
        self.device = torch.device(device)
        self._module = program.module()

    @property
    def platforms(self) -> Tuple[str, ...]:
        return tuple(self.meta["platforms"])

    @property
    def n_in(self) -> int:
        return int(self.meta["n_in"])

    def __call__(self, raw_params):
        raw = np.asarray(raw_params, dtype=np.float32)
        single = raw.ndim == 1
        x = torch.as_tensor(np.atleast_2d(raw), device=self.device)
        with torch.no_grad(), _NoTF32():
            out = _to_host(self._module(x))
        out = [o[0] if single else o for o in out]
        return tuple(out) if self.meta.get("kind") == "valgrad" else out[0]


def load_artifact(path: str, *, device) -> ExportedFn:
    """Load an artifact written by :func:`save_artifact` onto ``device``,
    which has no default (the caller names the card or the CPU, as for
    the model loaders); a device type the artifact was not checked on
    raises."""
    extra = {_META: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META])
    device = torch.device(device)
    if device.type not in meta["platforms"]:
        raise ValueError(
            f"this artifact was checked on {meta['platforms']}, not on {device.type}"
        )
    if device.type != "cpu":
        program = _move(program, device)
    return ExportedFn(program, meta, device)
