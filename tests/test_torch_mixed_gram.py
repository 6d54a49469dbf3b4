"""K3 at an fp32 value tier with a bf16 backward tier ((highest, high) and
(highest, default)): ``csrc/fused_gram_mixed.cu``, held on the CPU
through an emulation of its arithmetic, and its wrapper's routing.

The kernel runs K2's register-tiled fp32 forward over K2's slabs
(``tests/_torch_f32.py::_gram_forward``), then the backward on the tensor
cores over ``W_iᵀ``'s packed ``mma`` fragments at the backward tier
(``tests/_torch_mma.py::mma_product``, as
``test_torch_fused_loglik.py::_emulate_gram``'s backward), the ReLU masks
taken from the fp32 pre-activations and read by the mma epilogue's rows.
:func:`_torch_f32.emulate_mixed_grad_gram` is that arithmetic. It is held
to :func:`loglik_grad_gram_reference` (the plain version, which the card
holds the kernel to in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``) and to the JAX package's Pallas K3 in interpret mode.

Tolerances: against the plain version, which differs only in fp32
summation order, values within 1e-5 of |logL| + c/2 (the gram form's
cancellation scale) and gradients under ``bench_mcmc.py``'s gate (an ulp
of difference in the signal can move its bf16 part by a bf16 step);
against the Pallas kernel, ``test_gram_mma_emulation_matches_pallas``'s
(values rtol 2e-4, atol 2e-3·max|v|; gradients rtol 2e-3, atol
2e-3·max|g|) at bf16x3. At bf16 the Pallas kernel's DEFAULT backward runs
in full fp32 under XLA on the CPU (``test_bf16_backward_passes_the_
gradient_gate``), so there the gradient is held to it by the gradient
gate.
"""

import numpy as np
import pytest
import torch
from _torch_f32 import emulate_f32_gram, emulate_mixed_grad_gram, unpack_slabs
from _torch_mma import unpack
from test_torch_fused_loglik import FLAGSHIP, GRAM_WIDTHS, _pallas, _raw, pair, port_model  # noqa: F401

from tpu21cmvae_torch.models.ensemble import DeepEnsemble
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.ops.fold import _split_hi_lo, bf16_round, gram_fold, noise_scale, obs_tensor
from tpu21cmvae_torch.ops.kernels._common import MASK_COL_BYTES, member_of
from tpu21cmvae_torch.ops.kernels.fused_loglik import (
    MIXED_TILE_ROWS,
    loglik_grad_gram_members_reference,
    loglik_grad_gram_reference,
    make_fused_loglik_grad_gram,
    make_fused_loglik_gram,
)
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig
from tpu21cmvae_torch.utils.metrics import grad_gate_violation

MIXED = [("highest", "high"), ("highest", "default")]
WIDTHS = [*GRAM_WIDTHS, FLAGSHIP[1:]]


def _mixed(m, obs, tiers, **kw):
    fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                     grad_precision=tiers[1], device="cpu", **kw)
    assert fn.mixed and not fn.tensor_cores and not fn.register_tiled
    return fn


def _k2_f32(m, obs):
    return make_fused_loglik_gram(m.config, m.normalizer, obs, 25.0, precision="highest",
                                  device="cpu")


def _close(got, want, c):
    """Within 1e-5 of |logL| + c/2: fp32 summation order alone."""
    return bool(((got - want).abs() <= 1e-5 * (want.abs() + 0.5 * abs(float(c)))).all())


@pytest.mark.parametrize("hidden", WIDTHS)
@pytest.mark.parametrize("tiers", MIXED)
def test_mixed_operands_are_k2s_stream_and_the_backward_fragments(port_model, hidden, tiers):
    """The wrapper packs what the kernel reads and nothing else: K2's
    fp32 stream (trunk layers 1 … n−1, then ``G`` with ``u`` in its bias
    slot) bit for bit, and ``W_iᵀ`` for i = 1 … n−1 as ``mma`` B
    fragments holding the backward tier's parts, zero-padded to 16."""
    m, obs = port_model(hidden)
    ops = _mixed(m, obs, tiers).operands(m.params)
    k2 = _k2_f32(m, obs).operands(m.params).slabs
    assert torch.equal(ops.slabs.w, k2.w) and torch.equal(ops.slabs.b, k2.b)
    trunk, G, u, _ = gram_fold(m.params, m.normalizer, obs_tensor(obs, 451, device="cpu"),
                               noise_scale(25.0, 451, device="cpu"))
    shapes = [tuple(layer["w"].shape) for layer in trunk[1:]] + [tuple(G.shape)]
    (_, bias_g), = unpack_slabs(ops.slabs, shapes)[-1:]
    assert torch.equal(bias_g[: u.shape[0]], u)
    p = ops.packed
    assert p.w == p.b == () and p.g is None and p.u is None
    assert len(p.wt) == len(hidden) - 1
    for packed, layer in zip(p.wt, trunk[1:], strict=True):
        w = layer["w"].T
        k, n = w.shape
        got = unpack(packed)
        parts = _split_hi_lo(w) if ops.grad_tier == "bf16x3" else (bf16_round(w),)
        assert packed.dtype == torch.bfloat16 and got.shape[1:] == (-(-k // 16) * 16,
                                                                    -(-n // 16) * 16)
        for part, want in zip(got, parts, strict=True):
            assert torch.equal(part[:k, :n], want)
        assert not got[:, k:].any() and not got[:, :, n:].any()


@pytest.mark.parametrize("hidden", WIDTHS)
@pytest.mark.parametrize("tiers", MIXED)
def test_mixed_emulation_matches_plain(port_model, splits, hidden, tiers):
    """Through K2's stream and the backward's fragments, the kernel's
    arithmetic equals :func:`loglik_grad_gram_reference` within the fp32
    tolerance and the gradient gate (37 rows, one with fx == 0, whose
    slot-2 gradient is exactly 0), at narrow widths, a lone skinny layer
    and the flagship's; its value equals the register-tiled fp32 K2's bit
    for bit: the same forward over the same slabs."""
    m, obs = port_model(hidden)
    ops = _mixed(m, obs, tiers).operands(m.params)
    x = _raw(splits)
    (got, g), (want, gp) = emulate_mixed_grad_gram(ops, x), loglik_grad_gram_reference(ops, x)
    assert got.shape == (37,) and g.shape == (37, 7)
    assert torch.isfinite(got).all() and torch.isfinite(g).all()
    assert _close(got, want, ops.c)
    assert grad_gate_violation(g.numpy(), gp.numpy()) <= 0.0
    assert g[5, 2] == 0.0
    assert torch.equal(got, emulate_f32_gram(_k2_f32(m, obs).operands(m.params), x))


@pytest.mark.parametrize("tiers", MIXED)
def test_mixed_emulation_matches_pallas(pair, tiers):
    """The emulation against the JAX package's Pallas K3 at the same tier
    pair (interpret mode; the same checkpoint, 37 NumPy-seeded rows, one
    with fx == 0): values at ``test_gram_mma_emulation_matches_pallas``'s
    tolerance; gradients at it where both backwards are bf16x3, under the
    gradient gate where JAX's DEFAULT backward runs in fp32 on the CPU."""
    _, tm, obs, raw = pair
    vj, gj = _pallas(pair, tiers)
    ops = _mixed(tm, obs, tiers).operands(tm.params)
    vt, gt = (t.numpy() for t in emulate_mixed_grad_gram(ops, torch.as_tensor(raw)))
    np.testing.assert_allclose(vt, vj, rtol=2e-4, atol=2e-3 * np.abs(vj).max())
    if tiers[1] == "high":
        np.testing.assert_allclose(gt, gj, rtol=2e-3, atol=2e-3 * np.abs(gj).max())
    else:
        assert grad_gate_violation(gt, gj) <= 0.0
        assert not np.array_equal(gt, gj)  # the bf16 tier really rounds
    assert gt[5, 2] == 0.0 and gj[5, 2] == 0.0


@pytest.mark.parametrize("tiers", MIXED)
def test_mixed_rows_do_not_mix(port_model, splits, tiers):
    """A row's value and gradient depend on no other row: with a NaN row
    in the batch every other row comes out bit for bit as without it (the
    masks are selects, false for NaN; a product mixes no rows), the NaN
    row's value is NaN, and an fx == 0 row's slot-2 gradient is exactly
    0."""
    m, obs = port_model((32, 48, 32, 24))
    ops = _mixed(m, obs, tiers).operands(m.params)
    x = _raw(splits)
    v, g = emulate_mixed_grad_gram(ops, x)
    bad = x.clone()
    bad[11, 4] = float("nan")
    vb, gb = emulate_mixed_grad_gram(ops, bad)
    keep = torch.arange(37) != 11
    assert torch.equal(vb[keep], v[keep]) and torch.equal(gb[keep], g[keep])
    assert torch.isnan(vb[11]) and torch.isfinite(v).all() and torch.isfinite(g).all()
    assert g[5, 2] == 0.0 and gb[5, 2] == 0.0


@pytest.mark.parametrize("tiers", MIXED)
def test_mixed_three_members_equal_three_single_models(splits, tiers):
    """M = 3 stacked: each member's slice of the stacked operands, read at
    its member stride, gives the emulation bit for bit the member's own
    packing, and the member-batched plain version equals each single
    model's."""
    hidden = (32, 48)
    members = [DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=hidden), seed=s,
                              device="cpu") for s in (11, 12, 13)]
    ens = DeepEnsemble(members)
    sig = members[0].predict(splits.par_test[0])
    obs = (sig + np.random.default_rng(5).normal(0, 5.0, sig.shape)).astype(np.float32)
    x = _raw(splits)
    stacked = _mixed(ens, obs, tiers, members=3)
    ops = stacked.operands(ens.params)
    assert ops.members == 3 and ops.packed.wt[0].shape[0] == 3
    v3, g3 = stacked(ens.params, x)
    vp, gp = loglik_grad_gram_members_reference(ops, x)
    assert torch.equal(v3, vp) and torch.equal(g3, gp)
    for m, params in enumerate(ens.member_params(ens.params)):
        single = _mixed(ens, obs, tiers)
        own = single.operands(params)
        mine = member_of(ops, m)
        for got, want in zip(emulate_mixed_grad_gram(mine, x), emulate_mixed_grad_gram(own, x)):
            assert torch.equal(got, want)
        v1, g1 = single(params, x)
        assert torch.equal(v3[m], v1) and torch.equal(g3[m], g1)


def _relu_mask_store_bits(rows):
    """(row, byte, bit) of each row of one column as ``relu_mask_store``
    (``csrc/tile_f32.cuh``) stores it: warp half w & 1, lane & 3 = q of
    the four lanes sharing the column, TM = rows/8 rows t.row + i with
    t.row = (4·half + q)·TM, bit q·TM + i of the half's kHalfBytes bytes
    at byte offset half·kHalfBytes."""
    tm = rows // 8
    half_bytes = max(tm // 2, 1)
    out = []
    for half in range(2):
        for q in range(4):
            for i in range(tm):
                bit = q * tm + i
                out.append(((4 * half + q) * tm + i, half * half_bytes + bit // 8, bit % 8))
    return out


def _skinny_hidden_masked_bits(rows):
    """(row, byte, bit) as ``skinny_hidden_masked`` stores them: byte b
    holds rows b·kRowsPerByte … in order."""
    per_byte = rows // MASK_COL_BYTES[rows]
    return [(b * per_byte + i, b, i) for b in range(MASK_COL_BYTES[rows]) for i in range(per_byte)]


@pytest.mark.parametrize("rows", MIXED_TILE_ROWS)
def test_mask_rows_read_the_mma_rows(rows):
    """``fused_gram_mixed.cu::mask_rows`` reads a column's kColBytes mask
    bytes as one little-endian word and the mma epilogue takes bit r for
    tile row r = mma_row(mt, h) = 16·mt + 8·h + lane/4. Both writers of the
    masks put row r's bit exactly there, at both tile heights, and the
    epilogue's rows cover the tile once."""
    assert MASK_COL_BYTES[rows] * 8 == rows
    for writer in (_relu_mask_store_bits, _skinny_hidden_masked_bits):
        placed = sorted(writer(rows))
        assert [r for r, _, _ in placed] == list(range(rows))
        for r, byte, bit in placed:
            assert 8 * byte + bit == r  # bit r of the little-endian word
    mma_rows = sorted(16 * mt + 8 * h + lane // 4 for mt in range(rows // 16) for h in range(2)
                      for lane in range(0, 32, 4))
    assert mma_rows == list(range(rows))


@pytest.mark.parametrize("n_rows, sm_count, members, want", [
    (65_536, 132, 1, 32),  # several waves at either height: the tallest
    (4_096, 132, 1, 32),  # the HMC batch: 128 blocks of 32 rows
    (4_096, 132, 3, 32),  # 384 blocks: more than the SMs at either height
    (2_112, 132, 1, 16),
    (2_113, 132, 1, 32),
    (37, 132, 1, 16),
    (1, 132, 3, 16),
    (4_096, None, 1, 32),  # no card: the tallest
])
def test_mixed_tile_height_follows_the_batch(port_model, n_rows, sm_count, members, want):
    """The mixed wrapper runs the shortest of its two heights that still
    runs the batch as at most one block per SM, else the taller; a forced
    height holds for every batch."""
    m, obs = port_model((32, 48, 32, 24))
    fn = _mixed(m, obs, MIXED[0])
    assert fn.heights == MIXED_TILE_ROWS and fn.tile_rows is None
    fn.sm_count, fn.members = sm_count, members if members > 1 else None
    assert fn.rows_for(n_rows) == want
    assert _mixed(m, obs, MIXED[1], tile_rows=16).rows_for(n_rows) == 16
