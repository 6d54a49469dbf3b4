"""K3 at the reverse tier pairs, a bf16 value tier with an fp32 backward
((high, highest) and (default, highest)): the reverse mode of
``csrc/fused_gram_mma.cu``, held on the CPU through an emulation of its
arithmetic, and its wrapper's routing.

The kernel runs the tensor-core forward of K2 at the value tier over the
packed ``mma`` fragments (``tests/_torch_f32.py::_mma_forward``, as
``test_torch_fused_loglik.py::_emulate_gram``), takes the backward's
first signal e in fp32 from the gram head, then runs the backward
register-tiled over the fp32 slabs of ``W_iᵀ``
(``tests/_torch_f32.py::slab_layer``, as the fp32 K3's backward), the
ReLU masks taken from the fp32 pre-activations and read at a 4-byte
column stride. :func:`_torch_f32.emulate_reverse_grad_gram` is that
arithmetic. It is held to :func:`loglik_grad_gram_reference` (the plain
version, which the card holds the kernel to in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``) at both pairs and to
the JAX package's Pallas K3 in interpret mode at (high, highest).

Tolerances: against the plain version, which differs only in fp32
summation order, values within 1e-5 of |logL| + c/2 (the gram form's
cancellation scale; ``test_gram_mma_emulation_matches_plain``'s) and
gradients under ``bench_mcmc.py``'s gate; against the Pallas kernel,
``test_gram_mma_emulation_matches_pallas``'s (values rtol 2e-4, atol
2e-3·max|v|; gradients rtol 2e-3, atol 2e-3·max|g|). (default, highest)
is not held to the Pallas kernel: JAX's DEFAULT forward runs in full
fp32 under XLA on the CPU (``test_bf16_backward_passes_the_gradient_
gate``), while the port's rounds every activation to bf16.
"""

import numpy as np
import pytest
import torch
from _torch_f32 import emulate_reverse_grad_gram, unpack_slabs
from test_torch_fused_loglik import (  # noqa: F401
    FLAGSHIP,
    GRAM_WIDTHS,
    _emulate_gram,
    _pallas,
    _raw,
    pair,
    port_model,
)

from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.models.ensemble import DeepEnsemble
from tpu21cmvae_torch.ops.fold import gram_fold, noise_scale, obs_tensor
from tpu21cmvae_torch.ops.kernels._common import (
    MAX_SHARED_BYTES,
    TIER_CODE,
    member_of,
    padk,
)
from tpu21cmvae_torch.ops.kernels.fused_loglik import (
    REVERSE_NET_BYTES,
    _kernel,
    gram_reverse,
    grad_reverse_bytes,
    loglik_grad_gram_members_reference,
    loglik_grad_gram_reference,
    make_fused_loglik_grad_gram,
    make_fused_loglik_gram,
    shared_bytes,
)
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig
from tpu21cmvae_torch.utils.metrics import grad_gate_violation

REVERSE = [("high", "highest"), ("default", "highest")]
WIDTHS = [*GRAM_WIDTHS, FLAGSHIP[1:]]


def _reverse(m, obs, tiers, **kw):
    fn = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                     grad_precision=tiers[1], device="cpu", **kw)
    assert fn.reverse and not (fn.tensor_cores or fn.mixed or fn.register_tiled)
    return fn


def _k2(m, obs, tier):
    fn = make_fused_loglik_gram(m.config, m.normalizer, obs, 25.0, precision=tier, device="cpu")
    assert fn.tensor_cores
    return fn


def _close(got, want, c):
    """Within 1e-5 of |logL| + c/2: fp32 summation order alone."""
    return bool(((got - want).abs() <= 1e-5 * (want.abs() + 0.5 * abs(float(c)))).all())


@pytest.mark.parametrize("hidden", WIDTHS)
@pytest.mark.parametrize("tiers", REVERSE)
def test_reverse_operands_are_k2s_fragments_and_the_backward_slabs(port_model, hidden, tiers):
    """The wrapper packs what the kernel reads and nothing else: the
    tensor-core K2's fragments, biases, ``G`` and ``u`` at the value tier
    bit for bit, no backward fragments, and ``W_iᵀ`` for i = n−1 … 1 as
    fp32 slabs (``tile_f32.cuh``'s layout, zero-padded), the tail of the
    fp32 K3's stream; no biases for them."""
    m, obs = port_model(hidden)
    ops = _reverse(m, obs, tiers).operands(m.params)
    k2 = _k2(m, obs, tiers[0]).operands(m.params).packed
    p = ops.packed
    assert p.wt == () and len(p.w) == len(p.b) == len(hidden) - 1
    for got, want in zip([*p.w, *p.b, p.g, p.u], [*k2.w, *k2.b, k2.g, k2.u], strict=True):
        assert torch.equal(got, want)
    assert ops.slabs.b.numel() == 0 and ops.slabs.w.dtype == torch.float32
    trunk, _, _, _ = gram_fold(m.params, m.normalizer, obs_tensor(obs, 451, device="cpu"),
                               noise_scale(25.0, 451, device="cpu"))
    backward = [layer["w"].T for layer in reversed(trunk[1:])]
    shapes = [tuple(w.shape) for w in backward]
    padded = unpack_slabs(ops.slabs._replace(b=torch.zeros(sum(
        -(-n // 128) * 128 for _, n in shapes))), shapes)
    for (w, _), want in zip(padded, backward, strict=True):
        k, n = want.shape
        assert torch.equal(w[:k, :n], want) and not w[k:].any() and not w[:, n:].any()
    f32 = make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision="highest",
                                      grad_precision="highest", device="cpu")
    stream = f32.operands(m.params).slabs.w
    assert torch.equal(ops.slabs.w, stream[stream.numel() - ops.slabs.w.numel():])


@pytest.mark.parametrize("hidden", WIDTHS)
@pytest.mark.parametrize("tiers", REVERSE)
def test_reverse_emulation_matches_plain(port_model, splits, hidden, tiers):
    """Through the forward's fragments and the backward's slabs, the
    kernel's arithmetic equals :func:`loglik_grad_gram_reference` within
    the fp32 tolerance and the gradient gate (37 rows, one with fx == 0,
    whose slot-2 gradient is exactly 0), at narrow widths, a lone skinny
    layer and the flagship's; its value equals the tensor-core K2's
    emulation at the value tier bit for bit: the same forward."""
    m, obs = port_model(hidden)
    ops = _reverse(m, obs, tiers).operands(m.params)
    x = _raw(splits)
    (got, g), (want, gp) = emulate_reverse_grad_gram(ops, x), loglik_grad_gram_reference(ops, x)
    assert got.shape == (37,) and g.shape == (37, 7)
    assert torch.isfinite(got).all() and torch.isfinite(g).all()
    assert _close(got, want, ops.c)
    assert grad_gate_violation(g.numpy(), gp.numpy()) <= 0.0
    assert g[5, 2] == 0.0
    k2 = _k2(m, obs, tiers[0]).operands(m.params)
    assert torch.equal(got, _emulate_gram(k2, x, grad=False))


def test_reverse_emulation_matches_pallas(pair):
    """The emulation at (high, highest) against the JAX package's Pallas
    K3 at the same pair (interpret mode; the same checkpoint, 37
    NumPy-seeded rows, one with fx == 0), at
    ``test_gram_mma_emulation_matches_pallas``'s tolerance."""
    _, tm, obs, raw = pair
    vj, gj = _pallas(pair, REVERSE[0])
    ops = _reverse(tm, obs, REVERSE[0]).operands(tm.params)
    vt, gt = (t.numpy() for t in emulate_reverse_grad_gram(ops, torch.as_tensor(raw)))
    np.testing.assert_allclose(vt, vj, rtol=2e-4, atol=2e-3 * np.abs(vj).max())
    np.testing.assert_allclose(gt, gj, rtol=2e-3, atol=2e-3 * np.abs(gj).max())
    assert gt[5, 2] == 0.0 and gj[5, 2] == 0.0


@pytest.mark.parametrize("tiers", REVERSE)
def test_reverse_rows_do_not_mix(port_model, splits, tiers):
    """A row's value and gradient depend on no other row: with a NaN row
    in the batch every other row comes out bit for bit as without it (the
    masks are selects, false for NaN; the backward sums each output in
    one accumulator over k), the NaN row's value is NaN, and an fx == 0
    row's slot-2 gradient is exactly 0."""
    m, obs = port_model((32, 48, 32, 24))
    ops = _reverse(m, obs, tiers).operands(m.params)
    x = _raw(splits)
    v, g = emulate_reverse_grad_gram(ops, x)
    bad = x.clone()
    bad[11, 4] = float("nan")
    vb, gb = emulate_reverse_grad_gram(ops, bad)
    keep = torch.arange(37) != 11
    assert torch.equal(vb[keep], v[keep]) and torch.equal(gb[keep], g[keep])
    assert torch.isnan(vb[11]) and torch.isfinite(v).all() and torch.isfinite(g).all()
    assert g[5, 2] == 0.0 and gb[5, 2] == 0.0


@pytest.mark.parametrize("tiers", REVERSE)
def test_reverse_three_members_equal_three_single_models(splits, tiers):
    """M = 3 stacked: each member's slice of the stacked operands, read at
    its member stride, gives the emulation bit for bit the member's own
    packing, and the member-batched plain version equals each single
    model's."""
    members = [DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=(32, 48)),
                              seed=s, device="cpu") for s in (11, 12, 13)]
    ens = DeepEnsemble(members)
    sig = members[0].predict(splits.par_test[0])
    obs = (sig + np.random.default_rng(5).normal(0, 5.0, sig.shape)).astype(np.float32)
    x = _raw(splits)
    stacked = _reverse(ens, obs, tiers, members=3)
    ops = stacked.operands(ens.params)
    assert ops.members == 3 and ops.slabs.w.shape[0] == 3 and ops.packed.g.shape[0] == 3
    v3, g3 = stacked(ens.params, x)
    vp, gp = loglik_grad_gram_members_reference(ops, x)
    assert torch.equal(v3, vp) and torch.equal(g3, gp)
    for m, params in enumerate(ens.member_params(ens.params)):
        single = _reverse(ens, obs, tiers)
        own = single.operands(params)
        mine = member_of(ops, m)
        for got, want in zip(emulate_reverse_grad_gram(mine, x),
                             emulate_reverse_grad_gram(own, x)):
            assert torch.equal(got, want)
        v1, g1 = single(params, x)
        assert torch.equal(v3[m], v1) and torch.equal(g3[m], g1)


def _mma_mask_bits():
    """(row, bit) of one column's mask word as ``fused_gram_mma.cu``'s
    forward writes it: the hidden layers' mma epilogue ORs bit r of tile
    row r = mma_row(0, h) = 8·h + lane/4 over the 8 lanes sharing a
    column, the skinny layer ``1u << r``; one 32-bit word per column."""
    rows = sorted({8 * h + lane // 4 for h in range(2) for lane in range(32)})
    return [(r, r) for r in rows]


def _masked_store_reads(col_bytes):
    """(row, byte offset, bit) of each row of a column as
    ``masked_store<16, col_bytes>`` (``csrc/tile_f32.cuh``) reads it for
    the column at index 1 of its chunk: warp half w & 1, lane & 3 = q,
    TM = 2 rows t.row + i with t.row = (4·half + q)·2; it loads
    kHalfBytes = 1 byte at column·col_bytes + half and shifts by q·TM."""
    out = []
    for half in range(2):
        for q in range(4):
            for i in range(2):
                row = (4 * half + q) * 2 + i
                out.append((row, 1 * col_bytes + half, q * 2 + i))
    return out


def test_mask_words_read_as_mask_bits_at_a_4_byte_stride():
    """The reverse mode's backward reads the tensor-core forward's mask
    words through ``masked_store<16, 4>``: column c's word at byte 4·c,
    little-endian, and each of the 16 rows finds its own bit r there,
    exactly once; at ``MaskBits<16>``'s own 2-byte stride the same reads
    would land in the next column's word."""
    written = dict(_mma_mask_bits())
    assert sorted(written) == list(range(16))
    reads = _masked_store_reads(4)
    assert sorted(r for r, _, _ in reads) == list(range(16))
    for row, byte, bit in reads:
        assert byte // 4 == 1  # column 1's word
        assert 8 * (byte % 4) + bit == written[row]
    # at MaskBits<16>'s 2-byte stride, column 1's reads fall in column 0's word
    assert all(byte // 4 == 0 for _, byte, _ in _masked_store_reads(2))


def test_reverse_routing_bytes_and_the_too_wide_network(port_model):
    """Routing by tiers and shape, chosen when the wrapper is built: a
    reverse pair runs ``k3_fused_loglik_grad_gram_reverse`` with the
    forward's fragments, then the backward's fp32 stream, and the value
    tier's code alone, where the network fits its shared memory
    (:func:`grad_reverse_bytes`: two blocks per SM at the flagship); a
    network too wide for it runs the wide route
    (``fused_loglik_grad_gram.cu``), with its program, stream and
    fragment buffer, and its A tile's parts (the value tier's code), the
    height and the plan's sizes; one too wide for both spills to the
    workspace."""
    assert gram_reverse("bf16x3", "f32") and gram_reverse("bf16", "f32")
    assert not any(gram_reverse(t, g) for t, g in [("f32", "f32"), ("bf16x3", "bf16"),
                                                   ("f32", "bf16"), ("bf16", "bf16x3")])
    for tier, want in (("bf16x3", 91_496), ("bf16", 68_456)):
        assert grad_reverse_bytes(FLAGSHIP, tier) == shared_bytes(FLAGSHIP, tier, "f32") == want
        assert 2 * (want + 1024) <= 233_472
    # the mask words, e, and the backward's tile and ring where they are larger
    widths = (7, 40)
    tile = 4 * 18 * padk(40)
    assert grad_reverse_bytes(widths, "bf16") == tile + tile + 4 * 3 * 8 * 128 + REVERSE_NET_BYTES

    m, obs = port_model((32, 48, 32, 24))
    for tiers in REVERSE:
        fn = _reverse(m, obs, tiers)
        assert fn.rows_for(4096) is None and fn.tile_rows is None
        ops = fn.operands(m.params)
        entry, tensors, ints = _kernel(ops, True)
        assert entry == "k3_fused_loglik_grad_gram_reverse"
        assert ints == [TIER_CODE[ops.tier]] and ops.grad_tier == "f32"
        assert len(tensors) == 2 + 2 * 3 + 3 and tensors[-1] is ops.slabs.w

    wide = DirectEmulatorConfig(hidden_dims=(1500,))
    assert grad_reverse_bytes((7, 1500), "bf16") > MAX_SHARED_BYTES
    for tiers in REVERSE:
        fn = make_fused_loglik_grad_gram(wide, m.normalizer, obs, precision=tiers[0],
                                         grad_precision=tiers[1], device="cpu")
        assert fn.wide and not (fn.reverse or fn.tensor_cores or fn.mixed or fn.register_tiled)
        ops = fn.operands(DirectEmulator(config=wide, normalizer=m.normalizer, seed=1,
                                         device="cpu").params)
        entry, tensors, ints = _kernel(ops, True, rows=fn.rows_for(4096))
        assert entry == "k3_fused_loglik_grad_gram" and ints[:2] == [TIER_CODE[ops.tier], 32]
        assert tensors[2:5] == [ops.slabs.b, ops.slabs.w, ops.program]
        assert tensors[5:] == [ops.frags] and ops.packed is None
    # a lone skinny layer streams its e_0 into dx: no held tile, so a
    # layer the first, 16-row kernel refused (every activation at its own width) fits
    assert 4 * 16 * (7 + 2 * 1900) > MAX_SHARED_BYTES
    fn = make_fused_loglik_grad_gram(DirectEmulatorConfig(hidden_dims=(1900,)), m.normalizer,
                                     obs, precision="high", grad_precision="highest", device="cpu")
    assert fn.wide
    # too wide for every tile of shared memory: the wide route spills its
    # held vectors to the workspace, and refuses nothing
    wider = DirectEmulatorConfig(hidden_dims=(3000, 3000))
    fn = make_fused_loglik_grad_gram(wider, m.normalizer, obs, precision="high",
                                     grad_precision="highest", device="cpu")
    assert fn.wide and fn.plan.spilled and fn.plan.heights == (32, 16)
