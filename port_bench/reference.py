"""The plain reference of the benchmark's configurations, in float64
PyTorch: the checkpoint read from its ``.npz`` leaves, the parameter and
signal transforms, every layer to the signal, the diagonal Gaussian
log-likelihood and its gradient with respect to the raw parameters by a
written-out backward pass.

It imports nothing of the program and takes nothing the program made.
Its products can also run at a lower precision (``mode``): each product's
operands rounded to TF32, bfloat16 or float8 (e4m3, scaled per tensor),
summed in float32. That is the control a benchmark cell's check must fail.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

MODES = ("f64", "f32", "tf32", "bf16", "fp8")
_E4M3_MAX = 448.0


def read_leaves(path: str):
    """A checkpoint's leaves as float64 arrays and its metadata."""
    with np.load(path) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        leaves = [data[f"leaf_{i}"].astype(np.float64) for i in range(header["n_leaves"])]
    return leaves, header["metadata"]


def _take(it, n_layers):
    """``n_layers`` layers of ``(w, b)``, each stored b before w."""
    layers = []
    for _ in range(n_layers):
        b = next(it)
        layers.append((next(it), b))
    return layers


def _round(t: torch.Tensor, mode: str) -> torch.Tensor:
    """``t`` rounded to ``mode``'s format, as float32."""
    f = t.float()
    if mode == "f32":
        return f
    if mode == "tf32":  # 10 stored mantissa bits, round to nearest even
        bits = f.view(torch.int32)
        bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
        return bits.view(torch.float32)
    if mode == "bf16":
        return f.to(torch.bfloat16).float()
    if mode == "fp8":
        amax = float(f.abs().max()) if f.numel() else 0.0
        scale = _E4M3_MAX / amax if amax > 0 else 1.0
        return (f * scale).to(torch.float8_e4m3fn).float() / scale
    raise ValueError(f"mode must be one of {MODES}; got {mode!r}")


def _mm(a: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """``a @ w`` in float64, or with ``mode``'s operands summed in float32
    (TF32 is switched off for the sum, whatever the process set)."""
    if mode == "f64":
        return a @ w
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return (_round(a, mode) @ _round(w, mode)).double()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class Reference:
    """One configuration's network, from its checkpoint, on ``device``.

    ``layers``: every ``(w, b, relu)`` from parameters to signal (the
    autoencoder-based emulator's params → latent MLP, then its decoder;
    ReLU after every layer of each MLP but its last)."""

    def __init__(self, checkpoint: str, *, device):
        leaves, meta = read_leaves(checkpoint)
        kind = meta["kind"]
        if kind == "DirectEmulator":
            mean, std, pmin, pmax = leaves[:4]
            mlps = [_take(iter(leaves[4:]), len(meta["hidden_dims"]) + 1)]
        elif kind == "AutoEncoderEmulator":
            it = iter(leaves)  # sorted keys: dec, em, enc, normalizer
            dec = _take(it, len(meta["dec_hidden_dims"]) + 1)
            em = _take(it, len(meta["em_hidden_dims"]) + 1)
            _take(it, len(meta["enc_hidden_dims"]) + 1)
            mean, std, pmin, pmax = (next(it) for _ in range(4))
            mlps = [em, dec]
        else:
            raise ValueError(f"{checkpoint}: no reference for kind {kind!r}")

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=device)

        self.device = torch.empty(0, device=device).device
        self.layers = [(t(w), t(b), i < len(mlp) - 1)
                       for mlp in mlps for i, (w, b) in enumerate(mlp)]
        self.mean, self.std, self.pmin, self.pmax = t(mean), t(std), t(pmin), t(pmax)

    def _inputs(self, raw):
        """Network inputs of raw rows (log10 of columns 0-2, fx == 0
        clamped to 1e-6, then the affine map of the training range onto
        [-1, 1]) and their derivative with respect to each raw column."""
        x = torch.as_tensor(raw, device=self.device).double().clone()
        x[:, 2] = torch.where(x[:, 2] == 0.0, torch.full_like(x[:, 2], 1e-6), x[:, 2])
        dlog = torch.ones_like(x)
        dlog[:, :3] = 1.0 / (x[:, :3] * math.log(10.0))
        dlog[:, 2] = torch.where(torch.as_tensor(raw, device=self.device)[:, 2] == 0.0,
                                 torch.zeros_like(dlog[:, 2]), dlog[:, 2])
        x[:, :3] = torch.log10(x[:, :3])
        span = self.pmax - self.pmin
        return 2.0 * (x - self.pmin) / span - 1.0, dlog * (2.0 / span)

    def _forward(self, h, mode):
        masks = []
        for w, b, relu in self.layers:
            h = _mm(h, w, mode) + b
            masks.append(h > 0 if relu else None)
            if relu:
                h = torch.clamp(h, min=0.0)
        return h * self.std + self.mean, masks

    def forward(self, raw, mode: str = "f64") -> torch.Tensor:
        """Signals (B, n_bins) in mK, float64."""
        return self._forward(self._inputs(raw)[0], mode)[0]

    def loglik(self, raw, obs, noise_var: float, mode: str = "f64") -> torch.Tensor:
        """``-½ Σ (signal − obs)² / σ²`` per row, float64."""
        r = self.forward(raw, mode) - torch.as_tensor(obs, device=self.device).double()
        return -0.5 * torch.sum(r * r, dim=-1) / noise_var

    def loglik_and_grad(self, raw, obs, noise_var: float, mode: str = "f64",
                        grad_mode=None):
        """The log-likelihood and its gradient with respect to the raw
        parameters (B, n_params): the backward products at ``grad_mode``
        (default ``mode``), the ReLU masks from the forward at ``mode``."""
        x, dx = self._inputs(raw)
        pred, masks = self._forward(x, mode)
        r = pred - torch.as_tensor(obs, device=self.device).double()
        ll = -0.5 * torch.sum(r * r, dim=-1) / noise_var
        e = -r * (self.std / noise_var)
        for (w, _, _), m in zip(reversed(self.layers), reversed(masks)):
            if m is not None:
                e = e * m
            e = _mm(e, w.T, grad_mode or mode)
        return ll, e * dx


def jacobian_logdet(x, lo, hi) -> torch.Tensor:
    """``Σ log f(1 − f)``, ``f = (x − lo) / (hi − lo)``: the log-Jacobian
    of the sigmoid map from the whitened space to the box, which the
    gradient samplers add to the log-likelihood."""
    f = (x - lo) / (hi - lo)
    return torch.sum(torch.log(f) + torch.log1p(-f), dim=-1)


def in_blocks(fn, rows, block: int = 65536):
    """``fn`` over ``rows`` (a host array or tensor) in blocks of
    ``block`` rows; each of ``fn``'s outputs concatenated on the host."""
    outs = []
    for i in range(0, rows.shape[0], block):
        out = fn(rows[i:i + block])
        outs.append([o.cpu() for o in (out if isinstance(out, tuple) else (out,))])
    cat = [torch.cat(parts) for parts in zip(*outs)]
    return cat[0] if len(cat) == 1 else tuple(cat)
