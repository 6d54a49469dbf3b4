"""K3's wide-network route (``csrc/fused_loglik_grad_gram.cu``): the
plan a network's widths give it, the op program the kernel runs, the
operands packed in the order it reads them, and its shared memory.

The route takes K3 at (fp32, fp32) and at the reverse pairs (a bf16 or
bf16x3 value tier, an fp32 backward) on a network too wide for the
kernels that hold two full-width activation buffers. No activation wider
than a 128-column chunk (``SLAB_N``) has to be held whole:

* Layer 0, the skinny layer, is never stored: each 128-column chunk of
  its activation is recomputed from the input tile (≤ 8 products an
  element) where the next layer reads it.
* Every dense layer is summed k-outer: for each 128-row chunk of its
  input, the chunk's products are added to the output's accumulators,
  which wait in the output's shared-memory tile between chunks. Each
  output element is still one fp32 sum over k ascending (the
  register-tiled layers' order, ``csrc/tile_f32.cuh``), or, at a bf16
  value tier, each k-step's ``mma`` products added to it in k-step order
  (``csrc/mma.cuh``'s).
* A wide activation between two layers is *streamed*: produced one chunk
  at a time (the chunk's full k-sum waits in a chunk buffer), then its
  bias, ReLU and mask bits, then consumed at once as one k-chunk of the
  next layer. The backward streams the same way; its last signal
  ``e_0`` always goes chunk by chunk into ``dx``, summed across threads.
* A narrow output (≤ 64 columns) of a wide input (≥ 256 rows) on the
  CUDA cores is *split*: the column quarters that would idle take the
  upper 64 rows of each 128-row chunk into 64 more accumulators, added
  to the lower ones in the epilogue, so every thread works.

The plan (:func:`wide_plan`) is a list of ops, the same for every tile
height and for every member of an ensemble; the wrapper ships it to the
card as an int32 table (:func:`program_table`) and the kernel runs it op
by op. ``tests/_torch_f32.py::emulate_wide_grad_gram`` runs the same
table on the CPU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpu21cmvae_torch.ops.kernels._common import (
    MASK_COL_BYTES,
    MAX_SHARED_BYTES,
    RED_FLOATS,
    SLAB_N,
    Slabs,
    padk,
    tile_stride,
)

# the tile heights the kernel is built for (at 65,536 rows of hidden (3200,
# 64, 64) 32-row tiles, two CTAs per SM, ran faster than 64-row ones, one
# per SM: PERF.md), and its slab ring by height (WideRing: k rows per
# slab, slots; four slots hide the L2 latency of short 16- and 8-deep
# slabs)
WIDE_TILE_ROWS = (32, 16)
WIDE_RING = {32: (16, 4), 16: (8, 4)}
A_STRIDE = 136  # bf16 elements per row of the A-chunk tile: 128 + 8 (kAStride)
MAX_IN = 8  # k rows of the input tile: the widest skinny input (kMaxIn)
WIDE_NET_BYTES = 272  # sizeof(WideNet) in the source: its static shared copy
OP_INTS = 12  # ints per op of the program table (kOpInts)
# A layer is split when its output is at most SPLIT_MAX_N wide and its
# input at least SPLIT_MIN_K deep: the output fills at most two of the
# four 32-column quarters of a chunk, and the input has at least two
# chunks to share out.
SPLIT_MAX_N, SPLIT_MIN_K = 64, 256

# op codes (kOp* in the source) and buffer ids
OP_SKINNY, OP_MM, OP_FIN, OP_GRAM, OP_DX, OP_DX_WRITE, OP_RING, OP_QUAD_WRITE = range(1, 9)
CA, CB, P, Q, R = range(5)  # the input chunk, the streamed chunk, three held tiles
HELD = (P, Q, R)
MM_SPLIT, MM_FIRST = 1, 2  # OP_MM flags


def chunks(n: int) -> int:
    return -(-n // SLAB_N)


def pad16(n: int) -> int:
    return -(-n // 16) * 16


class Block(NamedTuple):
    """One fp32 ``OP_MM``'s weights as the stream holds them: rows
    ``row0 …`` (``rows`` of them, zero past the layer's fan-in) of
    ``matrix`` (``"w"``: trunk layer ``layer``'s W; ``"wt"``: its Wᵀ;
    ``"g"``: G), output chunks ``d0 … d1 − 1``; a split block is 64 rows
    of the lower half beside 64 of the upper."""

    matrix: str
    layer: int
    row0: int
    rows: int
    d0: int
    d1: int
    split: bool


class WidePlan(NamedTuple):
    """What :func:`wide_plan` gives a network: the ops (tuples, see
    :func:`program_table`), the fp32 stream's blocks in the order the ops
    read them, the k rows of the three held tiles, the mask columns (every
    activation but the last, padded to 32), the stream's rows, and the
    streamed and split activations (for the record)."""

    ops: tuple
    blocks: tuple
    cols: tuple
    mask_cols: int
    stream_rows: int
    streamed_forward: frozenset
    streamed_backward: frozenset
    split: frozenset


# the op fields that name a buffer, by op code; placeholders of held
# vectors start at _HELD0 until _assign_tiles places them
_ID_FIELDS = {OP_MM: (1, 7), OP_FIN: (1,), OP_GRAM: (1, 2), OP_DX: (1,)}
_HELD0 = 100


def _assign_tiles(held):
    """Each held vector's tile (P, Q or R) and the tiles' k rows: every
    vector in a tile as wide as it, no two consecutive vectors in one
    tile (an op reads the one and writes the next), the three widths'
    sum least. The widths are tried from the smallest sum up; a pass
    over the vectors finds whether the next may go where."""
    if not held:
        return [], (0, 0, 0)
    sizes = sorted({0, *held})
    best = None
    for a in sizes:
        for b in sizes:
            for c in sizes:
                if not a >= b >= c or a < max(held):
                    continue
                if best is not None and a + b + c >= sum(best[1]):
                    continue
                caps = (a, b, c)
                # reach[r]: a placement of the vectors so far that ends in tile r
                reach = {r: [r] for r in range(3) if caps[r] >= held[0]}
                for w in held[1:]:
                    reach = {r: reach[q] + [r] for r in range(3) if caps[r] >= w
                             for q in reach if q != r}
                if reach:
                    best = (next(iter(reach.values())), caps)
    tiles, caps = best
    return [HELD[t] for t in tiles], caps


def _streamed(widths, first: int, n: int, always=()) -> frozenset:
    """Activations first … n−2 that are streamed: widest first, those
    wider than a chunk (and those in ``always``), no two neighbours (a
    streamed activation is produced from a held one and consumed into
    another)."""
    chosen = set()
    for i in sorted(range(first, n - 1), key=lambda i: (-widths[i], i)):
        if (widths[i] > SLAB_N or i in always) and not {i - 1, i + 1} & chosen:
            chosen.add(i)
    return frozenset(chosen)


@functools.lru_cache(maxsize=64)
def wide_plan(trunk: tuple, mma: bool) -> WidePlan:
    """The op program of ``trunk`` = (n_in, W_0 … W_{n−1}) (activation i
    is W_i wide; trunk layer i ≥ 1 maps W_{i−1} → W_i, the skinny layer
    0 n_in → W_0; the gram head H × H, H = W_{n−1}). ``mma``: the
    forward runs on the tensor cores (a reverse pair), whose layers read
    fragments rather than the fp32 stream and are never split.

    Ops, in order (buffer ids ``CA``, ``CB``, ``P``, ``Q``, ``R``; rows and
    columns in the layer's own coordinates):

    * ``(OP_SKINNY, κ, cols, valid, mask_col)``: chunk κ of activation
      0 into CA from the input tile: columns 128κ … of relu(skinny),
      ``cols`` of them written (0 from ``valid`` on); its mask bits at
      ``mask_col`` (−1: not written).
    * ``(OP_MM, src, src_row, k, d0, d1, flags, dst, dst_col0, frag,
      kstep0, n)``: the next ``k`` rows of ``src`` from row ``src_row``
      times the layer's rows for output chunks d0 … d1 − 1 (a layer
      ``n`` wide), added to the accumulators in ``dst`` (column c of the
      layer at c − ``dst_col0``), from 0 with ``MM_FIRST``. ``frag``
      −1: the fp32 stream's next block, on the CUDA cores; else the
      fragments of trunk layer ``frag`` (n_layers: G) from k-step
      ``kstep0``, ``src`` split or rounded into the A-chunk tile first.
    * ``(OP_FIN, dst, cols, valid, bias, split, mask_col, masked)``: the
      epilogue of ``dst``'s first ``cols`` columns (0 from ``valid`` on):
      the split's upper sums added, then the forward's bias (offset
      ``bias`` into the biases), ReLU and mask bits at ``mask_col``
      (−1: none), or (``masked``) the backward's mask from ``mask_col``.
    * ``(OP_GRAM, h, e, H, col0, cols, u)``: columns col0 … col0 + cols
      − 1 of the gram head: quad partials Σ (hg + 2u)·h from hg in ``e``
      (its column c at c − col0) and h in ``h`` (−1: recomputed from the
      input tile), then e ← h > 0 ? hg + u : 0 in place;
      ``(OP_QUAD_WRITE,)`` sums the partials across threads and writes
      the quad.
    * ``(OP_DX, src, src_row, valid, w0_col)``: dx partials from ``valid``
      columns of e_0 in ``src`` from ``src_row``, w0's columns ``w0_col
      …``; ``(OP_DX_WRITE,)`` sums them across threads and writes dx.
    * ``(OP_RING,)``: starts the slab ring (the mma forward streams
      nothing, so its backward starts it).
    """
    n_in, W = trunk[0], trunk[1:]
    n = len(W)
    sf = _streamed(W, 1, n)  # activation 0 is recomputed, never held
    # e_0 goes into dx unless e_1 is streamed; e_{n−1} may be streamed too
    sb = _streamed(W, 0, n + 1, always=(0,))
    ops, blocks, split_set = [], [], set()
    mask_at, at = [], 0
    for i in range(n - 1):
        mask_at.append(at)
        at += padk(W[i])
    bias_at, at = [0] * n, 0
    for i in range(1, n):
        bias_at[i] = at
        at += chunks(W[i]) * SLAB_N
    u_at = at
    held = []  # the k rows of each held vector, in the order they are made
    region = {}

    def alloc(key, c):
        """A placeholder for the next held vector's tile
        (:func:`_assign_tiles` picks it once every one is known)."""
        held.append(c)
        region[key] = _HELD0 + len(held) - 1
        return region[key]

    def kr(K, kappa, on_mma):
        return min(SLAB_N, (pad16(K) if on_mma else padk(K)) - SLAB_N * kappa)

    def fwd_src(i_in, kappa, write_mask):
        if i_in == 0:
            ops.append((OP_SKINNY, kappa, min(SLAB_N, padk(W[0]) - SLAB_N * kappa),
                        min(SLAB_N, W[0] - SLAB_N * kappa),
                        mask_at[0] + SLAB_N * kappa if write_mask and n > 1 else -1))
            return CA, 0
        return region[("a", i_in)], SLAB_N * kappa

    def mm(src, k_in, kappa, matrix, layer, d0, d1, split, dst, col0, n_out, on_mma):
        src_id, src_row = src
        first = MM_FIRST if kappa == 0 else 0
        k = kr(k_in, kappa, on_mma)
        if on_mma:
            ops.append((OP_MM, src_id, src_row, k, d0, d1, first, dst, col0,
                        n if matrix == "g" else layer, 8 * kappa, n_out))
        else:
            ops.append((OP_MM, src_id, src_row, k, d0, d1, first | (MM_SPLIT if split else 0),
                        dst, col0, -1, 0, n_out))
            blocks.append(Block(matrix, layer, SLAB_N * kappa, k, d0, d1, split))

    def splits(n_out, k_in, on_mma):
        return not on_mma and n_out <= SPLIT_MAX_N and k_in >= SPLIT_MIN_K

    # forward: trunk layers 1 … n−1, each into a held tile
    for i in range(1, n):
        if i in sf:
            continue
        split = splits(W[i], W[i - 1], mma)
        if split:
            split_set.add(("a", i))
        dst = alloc(("a", i), SLAB_N if split else padk(W[i]))
        d1 = chunks(W[i])
        if i - 1 in sf:  # activation s = i − 1 streamed, chunk by chunk
            s = i - 1
            for c in range(chunks(W[s])):
                for kappa in range(chunks(W[s - 1])):
                    mm(fwd_src(s - 1, kappa, c == 0), W[s - 1], kappa, "w", s, c, c + 1,
                       False, CB, SLAB_N * c, W[s], mma)
                ops.append((OP_FIN, CB, min(SLAB_N, padk(W[s]) - SLAB_N * c),
                            min(SLAB_N, W[s] - SLAB_N * c), bias_at[s] + SLAB_N * c, 0,
                            mask_at[s] + SLAB_N * c, 0))
                mm((CB, 0), W[s], c, "w", i, 0, d1, split, dst, 0, W[i], mma)
        else:
            for kappa in range(chunks(W[i - 1])):
                mm(fwd_src(i - 1, kappa, True), W[i - 1], kappa, "w", i, 0, d1, split, dst, 0,
                   W[i], mma)
        ops.append((OP_FIN, dst, padk(W[i]), W[i], bias_at[i], int(split),
                    mask_at[i] if i < n - 1 else -1, 0))

    # gram head, hg = h @ G, then the quad and e_{n−1} = h > 0 ? hg + u : 0:
    # into a held tile, or (streamed) chunk by chunk where the backward
    # reads it; the backward is fp32 on the CUDA cores throughout
    H = W[-1]
    h_id = -1 if n == 1 else region[("a", n - 1)]
    if mma:
        ops.append((OP_RING,))

    def gram_into(dst, col0, c0, c1):
        for kappa in range(chunks(H)):
            src = fwd_src(0, kappa, False) if n == 1 else (h_id, SLAB_N * kappa)
            mm(src, H, kappa, "g", n, c0, c1, False, dst, col0, H, mma)
        ops.append((OP_GRAM, h_id, dst, H, col0, min(SLAB_N * c1, padk(H)) - col0, u_at))

    if n - 1 not in sb:
        gram_into(alloc(("e", n - 1), padk(H)), 0, 0, chunks(H))

    def e_chunk(s_, c):
        """Chunk c of the streamed e_s into CB: from the gram head, or from
        the held e_{s+1}, masked by activation s."""
        if s_ == n - 1:
            gram_into(CB, SLAB_N * c, c, c + 1)
            return
        for kappa in range(chunks(W[s_ + 1])):
            mm((region[("e", s_ + 1)], SLAB_N * kappa), W[s_ + 1], kappa, "wt", s_ + 1, c, c + 1,
               False, CB, SLAB_N * c, W[s_], False)
        ops.append((OP_FIN, CB, min(SLAB_N, padk(W[s_]) - SLAB_N * c),
                    min(SLAB_N, W[s_] - SLAB_N * c), -1, 0, mask_at[s_] + SLAB_N * c, 1))

    def dx_chunks(src, width):
        for c in range(chunks(width)):
            ops.append((OP_DX, src, SLAB_N * c, min(SLAB_N, width - SLAB_N * c), SLAB_N * c))

    # e_t = mask_t ⊙ (e_{t+1} @ W_{t+1}ᵀ) for t = n−2 … 0, then dx from e_0
    for t in range(n - 1, -1, -1):
        if t == 0 and t in sb:  # e_0 chunk by chunk into dx
            for c in range(chunks(W[0])):
                e_chunk(0, c)
                ops.append((OP_DX, CB, 0, min(SLAB_N, W[0] - SLAB_N * c), SLAB_N * c))
            continue
        if t == n - 1:  # e_{n−1}: the gram head's (above, or streamed)
            continue
        if t in sb:
            continue
        split = splits(W[t], W[t + 1], False)
        if split:
            split_set.add(("e", t))
        dst = alloc(("e", t), SLAB_N if split else padk(W[t]))
        d1 = chunks(W[t])
        if t + 1 in sb:  # e_s streamed, s = t + 1, each chunk consumed at once
            s = t + 1
            for c in range(chunks(W[s])):
                e_chunk(s, c)
                mm((CB, 0), W[s], c, "wt", s, 0, d1, split, dst, 0, W[t], False)
        else:
            for kappa in range(chunks(W[t + 1])):
                mm((region[("e", t + 1)], SLAB_N * kappa), W[t + 1], kappa, "wt", t + 1, 0, d1,
                   split, dst, 0, W[t], False)
        ops.append((OP_FIN, dst, padk(W[t]), W[t], -1, int(split), mask_at[t], 1))
        if t == 0:  # e_0 held (e_1 was streamed into it): dx chunk by chunk
            dx_chunks(dst, W[0])
    ops.append((OP_QUAD_WRITE,))
    ops.append((OP_DX_WRITE,))

    stream_rows = sum((64 if b.split else b.rows) * (b.d1 - b.d0) for b in blocks)
    tiles, cols = _assign_tiles(held)
    ops = [tuple(tiles[v - _HELD0] if k in _ID_FIELDS.get(op[0], ()) and v >= _HELD0 else v
                 for k, v in enumerate(op)) for op in ops]
    return WidePlan(ops=tuple(ops), blocks=tuple(blocks), cols=cols,
                    mask_cols=sum(padk(w) for w in W[:-1]), stream_rows=stream_rows,
                    streamed_forward=sf, streamed_backward=sb, split=frozenset(split_set))


def program_table(plan: WidePlan) -> torch.Tensor:
    """The ops as the kernel reads them: (n_ops, ``OP_INTS``) int32, each
    op's fields after its code, zero-filled."""
    table = torch.zeros((len(plan.ops), OP_INTS), dtype=torch.int32)
    for i, op in enumerate(plan.ops):
        table[i, : len(op)] = torch.tensor(op, dtype=torch.int32)
    return table


def wide_bytes(trunk, rows: int, parts: int) -> int:
    """Shared memory of one block of ``rows`` rows (``launch_wide`` in the
    source): the slab ring (``WIDE_RING``), the A-chunk tile (bf16, hi and
    lo at bf16x3; ``parts`` 0 with the fp32 forward), the per-row
    partials, a staged chunk of the skinny layer's weights (over the
    A-chunk tile where there is one), the input tile (8 k rows), the two
    chunk buffers, the three held tiles, the mask bits and the static
    copy of the net."""
    plan = wide_plan(tuple(trunk), parts > 0)
    s = tile_stride(rows)
    depth, slots = WIDE_RING[rows]
    floats = (slots * depth * SLAB_N + RED_FLOATS + (0 if parts else MAX_IN * SLAB_N)
              + s * (MAX_IN + 2 * SLAB_N + sum(plan.cols)))
    return (4 * floats + 2 * parts * rows * A_STRIDE
            + MASK_COL_BYTES[rows] * plan.mask_cols + WIDE_NET_BYTES)


def wide_heights(trunk, parts: int) -> tuple:
    """The tile heights, tallest first, at which ``trunk`` fits the
    kernel's shared memory (``parts``: as :func:`wide_bytes`)."""
    return tuple(r for r in WIDE_TILE_ROWS if wide_bytes(trunk, r, parts) <= MAX_SHARED_BYTES)


def _block(w: torch.Tensor, b: Block) -> torch.Tensor:
    """``b``'s rows of ``w`` (K, N) as the stream holds them, fp32."""
    k, n = w.shape
    cols = (b.d1 - b.d0) * SLAB_N
    out = w.new_zeros((b.d1 - b.d0, 64 if b.split else b.rows, SLAB_N))
    if b.split:
        for half in range(2):
            lo = b.row0 + 64 * half
            rows = w[lo: min(lo + 64, k), :SLAB_N // 2]
            out[0, : rows.shape[0], 64 * half: 64 * half + rows.shape[1]] = rows
        return out.reshape(-1)
    part = w.new_zeros((b.rows, cols))
    rows = w[b.row0: min(b.row0 + b.rows, k), b.d0 * SLAB_N: min(b.d1 * SLAB_N, n)]
    part[: rows.shape[0], : rows.shape[1]] = rows
    return part.reshape(b.rows, b.d1 - b.d0, SLAB_N).transpose(0, 1).reshape(-1)


def pack_wide_slabs(ops, plan: WidePlan) -> Slabs:
    """The fp32 stream of ``plan``'s blocks in the order its ops read them
    (each output chunk's rows k-major, as ``csrc/tile_f32.cuh`` streams
    a chunk), and the biases: trunk layers 1 … n−1, each zero-padded to
    128·chunks, then u. ``ops``: the layer's :class:`GramOperands` (fp32
    ``w``/``wt`` where the stream reads them)."""
    mats = {"w": lambda i: ops.w[i - 1], "wt": lambda i: ops.wt[i - 1], "g": lambda i: ops.g}
    parts = [_block(mats[b.matrix](b.layer), b) for b in plan.blocks]
    biases = []
    for b in (*ops.b, ops.u):
        padded = b.new_zeros(chunks(b.shape[0]) * SLAB_N)
        padded[: b.shape[0]] = b
        biases.append(padded)
    w = torch.cat(parts) if parts else ops.w0.new_zeros(0)
    assert w.numel() == plan.stream_rows * SLAB_N
    return Slabs(w=w.contiguous(), b=torch.cat(biases).contiguous())
