"""The wide route of K1, K2 and K3 (``csrc/fused_loglik_grad_gram.cu``):
the plan a network's widths give it, the op program the kernel runs, the
operands packed in the order it reads them, its shared memory, its
workspace and its launches (:class:`WideLaunch`).

The route takes every network no dedicated kernel holds: K1 (its head
the linear output layer, the signal or each row's Σy²) and K2 at every
tier and K3 at every (value, backward) tier pair, at any width, any
depth and any fan-in. No activation wider than a 128-column chunk
(``SLAB_N``) has to be held whole:

* Layer 0, where it is skinny (fan-in ≤ 8), is never stored: each
  128-column chunk of its activation is recomputed from the input tile
  (≤ 8 products an element) where the next layer reads it. A dense layer
  0 is an ordinary layer whose input, the log-clamped rows, is read from
  device memory a chunk at a time where a product needs it; its backward
  (K3) is one more product, a chunk of dx at a time.
* A *held* vector waits in one of three shared-memory tiles (P, Q, R),
  its layer summed k-outer: for each 128-row chunk of the input, the
  chunk's products are added to the output's accumulators, which wait in
  the tile between chunks. Each output element is one fp32 sum over k
  ascending (the register-tiled layers' order, ``csrc/tile_f32.cuh``),
  or, on the tensor cores, each k-step's ``mma`` products added to it in
  k-step order (``csrc/mma.cuh``'s).
* A *streamed* vector is produced one chunk at a time (the chunk's full
  k-sum waits in a chunk buffer), then its bias, ReLU and mask bits, then
  consumed at once as one k-chunk of the next layer. The backward's last
  signal ``e_0`` goes chunk by chunk into ``dx``, summed across threads.
* A *spilled* vector lives in the CTA's region of a global workspace:
  it is summed n-outer, one output chunk at a time over every input
  chunk into a chunk buffer, finished there and stored (``OP_STORE``);
  a reader loads a chunk of it into a chunk buffer (``OP_LOAD``,
  ``cp.async``) and multiplies from there. A vector is spilled, widest
  first, only where the plan does not fit the shared-memory budget at
  the tallest tile height; the mask bits go to the workspace next.
* A narrow output (≤ 64 columns) of a wide input (≥ 256 rows) on the
  CUDA cores is *split*: the column quarters that would idle take the
  upper 64 rows of each 128-row chunk into 64 more accumulators, added
  to the lower ones in the epilogue, so every thread works.

None of these choices moves a sum: each element is summed over the same
products in the same order whatever is held, streamed or spilled (a
split layer is split in every plan), so a workspace plan's results are
the all-shared plan's bit for bit. Each ``OP_MM`` carries its own tier
parts: 0, the fp32 stream on the CUDA cores; 1 or 2, the bf16 or bf16x3
``mma`` fragments of its matrix, so a forward and a backward at
different tiers share one program.

The plan (:func:`wide_plan`) is a list of ops, the same for every tile
height and for every member of an ensemble; the wrapper ships it to the
card as an int32 table (:func:`program_table`) and the kernel runs it op
by op. ``tests/_torch_f32.py::emulate_wide`` runs the same table on the
CPU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

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
WIDE_NET_BYTES = 152  # sizeof(WideNet) in the source: its static shared copy
OP_INTS = 16  # ints per op of the program table (kOpInts)
WS_ALIGN = 256  # a CTA's workspace starts on this many bytes
SM_BYTES = 233_472  # an H100 SM's shared memory; each CTA also takes 1 KB
# A layer is split when its output is at most SPLIT_MAX_N wide and its
# input at least SPLIT_MIN_K deep: the output fills at most two of the
# four 32-column quarters of a chunk, and the input has at least two
# chunks to share out.
SPLIT_MAX_N, SPLIT_MIN_K = 64, 256

# op codes (kOp* in the source) and buffer ids
(OP_SKINNY, OP_MM, OP_FIN, OP_GRAM, OP_DX, OP_DX_WRITE, OP_RING, OP_QUAD_WRITE, OP_LOAD,
 OP_STORE, OP_INPUT, OP_OUT) = range(1, 13)
CA, CB, P, Q, R = range(5)  # the input chunk, the streamed chunk, three held tiles
HELD = (P, Q, R)
MM_SPLIT, MM_FIRST = 1, 2  # OP_MM flags
FIN_RELU, FIN_MASKED, FIN_LINEAR = range(3)  # OP_FIN's kinds
OUT_SIGNAL, OUT_SUMSQ, OUT_DX = range(3)  # OP_OUT's modes


def chunks(n: int) -> int:
    return -(-n // SLAB_N)


def pad16(n: int) -> int:
    return -(-n // 16) * 16


def frag_words(k: int, n: int, parts: int) -> int:
    """32-bit words of a (k, n) matrix's ``mma`` fragments at ``parts``
    (``fused_mlp.py::pack_mma_operands``: n8 tiles × k-steps × 32 lanes ×
    parts × 4 bf16)."""
    return pad16(n) // 8 * (pad16(k) // 16) * 64 * parts


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
    :func:`wide_plan`); the fp32 stream's blocks in the order the ops
    read them; the fragment buffer's matrices, ``(matrix, layer, k, n,
    parts, word offset)``; the k rows of the three held tiles; the mask
    columns (every activation but the last, padded to 32; none for K2)
    and whether they lie in the workspace; the workspace's fp32 k rows
    per CTA; the stream's rows; the A-chunk tile's parts (the most any op
    takes); the tile heights at which the plan fits its budget; for the
    record, the streamed, split and spilled vectors; and whether layer 0
    is dense (no input tile: the input is read a chunk at a time)."""

    ops: tuple
    blocks: tuple
    frags: tuple
    cols: tuple
    mask_cols: int
    masks_in_ws: bool
    ws_cols: int
    stream_rows: int
    a_parts: int
    heights: tuple
    streamed_forward: frozenset
    streamed_backward: frozenset
    split: frozenset
    spilled: frozenset
    dense: bool = False

    @property
    def frag_words(self) -> int:
        return sum(frag_words(k, n, parts) for _, _, k, n, parts, _ in self.frags)


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


def _streamed(widths, first: int, n: int, always=()) -> set:
    """Activations first … n−2 that are streamed: widest first, those
    wider than a chunk (and those in ``always``), no two neighbours (a
    streamed activation is produced from a held one and consumed into
    another)."""
    chosen = set()
    for i in sorted(range(first, n - 1), key=lambda i: (-widths[i], i)):
        if (widths[i] > SLAB_N or i in always) and not {i - 1, i + 1} & chosen:
            chosen.add(i)
    return chosen


class _Net(NamedTuple):
    """A network as the planner sees it: the input's width, the ReLU
    activations' widths, the forward's and the backward's parts (None:
    value only), and K1's linear output layer ``n_out`` wide (its Σy²
    where ``sumsq``) in place of the gram head. The vectors: ``("a", i)``
    activation i (``("a", -1)``: the log-clamped input), ``("e", t)`` the
    backward's signal t (``("e", -1)``: dx, where the first layer is
    dense), ``("y", n)`` K1's output."""

    n_in: int
    W: tuple
    fwd: int
    bwd: Optional[int]
    n_out: Optional[int] = None
    sumsq: bool = False

    @property
    def n(self) -> int:
        return len(self.W)

    @property
    def dense(self) -> bool:
        """Layer 0 is an ordinary layer (fan-in above ``MAX_IN``), not the
        skinny one recomputed from the input tile."""
        return self.n_in > MAX_IN

    @property
    def k1(self) -> bool:
        return self.n_out is not None

    @property
    def mask_cols(self) -> int:
        return 0 if self.bwd is None else sum(padk(w) for w in self.W[:-1])

    def width(self, v) -> int:
        kind, i = v
        if kind == "y":
            return self.n_out
        return self.n_in if i < 0 else self.W[i]

    def source(self, v):
        """The vector v is summed from, its matrix, its layer and its parts."""
        kind, i = v
        n = self.n
        if kind == "a":
            return ("a", i - 1), "w", i, self.fwd
        if kind == "y":
            return ("a", n - 1), "o", n, self.fwd
        if i == n - 1:
            return ("a", n - 1), "g", n, self.fwd
        return ("e", i + 1), "wt", i + 1, self.bwd


def _splits(net: _Net, v) -> bool:
    """Whether layer v is split (only where it is held)."""
    u, _, _, parts = net.source(v)
    return (not parts and v != ("e", net.n - 1) and net.width(v) <= SPLIT_MAX_N
            and net.width(u) >= SPLIT_MIN_K)


def _held(net: _Net, sf, sb, spilled) -> list:
    """The vectors a layer sums into a held tile, in the order they are
    made."""
    n = net.n
    vs = [("a", i) for i in range(0 if net.dense else 1, n) if i not in sf]
    if net.bwd is not None:
        vs += [("e", t) for t in range(n - 1, -1, -1) if t not in sb]
    return [v for v in vs if v not in spilled]


def _a_parts(net: _Net) -> int:
    """The most parts an op of the plan takes: the forward's (the head is
    always there), the backward's where it has a product."""
    return max(net.fwd, (net.bwd or 0) if net.n > 1 or net.dense else 0)


def _bytes(net: _Net, sf, sb, spilled, masks_in_ws, rows) -> int:
    """:func:`plan_bytes` of the plan :func:`_emit` would make, without
    making it."""
    held = [SLAB_N if _splits(net, v) else padk(net.width(v))
            for v in _held(net, sf, sb, spilled)]
    return _shared_bytes(_assign_tiles(held)[1], _a_parts(net),
                         0 if masks_in_ws else net.mask_cols, rows, net.dense)


def _emit(net: _Net, sf, sb, spilled, masks_in_ws: bool) -> WidePlan:
    """The plan of ``net`` with activations ``sf`` and signals ``sb``
    streamed, the vectors ``spilled`` (``("a", i)``: activation i;
    ``("e", t)``: the backward's signal t) in the workspace. A held tile
    is named ``("tile", k)`` and a workspace column ``("ws", k, col)``
    (the k-th held or spilled vector) until the tiles and regions are laid
    out."""
    n_in, W, fwd, bwd = net.n_in, net.W, net.fwd, net.bwd
    n = net.n
    value_only = bwd is None
    dense = net.dense
    first = 0 if dense else 1  # the first activation a layer sums
    ops, blocks = [], []
    held, spill_order, split_set = [], [], set()
    place = {}
    mask_at, at = [], 0
    for i in range(n - 1):
        mask_at.append(at)
        at += padk(W[i])
    # the biases: layers first … n−1, then the head's (u, or K1's output bias)
    bias_at, at = [0] * n, 0
    for i in range(first, n):
        bias_at[i] = at
        at += chunks(W[i]) * SLAB_N
    u_at = at
    # the fragment buffer: the forward's layers and head at fwd parts, then
    # the backward's Wᵢᵀ at bwd parts, i = n−1 … 1 (… 0 where layer 0 is dense)
    frags, words = [], 0
    head = (("o", n, net.width(("a", n - 1)), net.n_out, fwd) if net.k1
            else ("g", n, W[-1], W[-1], fwd))
    mats = ([("w", i, net.width(("a", i - 1)), W[i], fwd) for i in range(first, n)] + [head]
            if fwd else [])
    mats += ([("wt", i, W[i], net.width(("a", i - 1)), bwd) for i in range(n - 1, first - 1, -1)]
             if bwd else [])
    for matrix, layer, k, n_out, parts in mats:
        frags.append((matrix, layer, k, n_out, parts, words))
        words += frag_words(k, n_out, parts)
    frag_at = {(f[0], f[1]): f[5] for f in frags}
    masked0 = set()  # chunks of activation 0 whose mask bits are written

    def streamed(v):
        return v[0] != "y" and v[1] >= 0 and v[1] in (sf if v[0] == "a" else sb)

    def mm(src, v, kappa, d0, d1, split, dst, col0):
        u, matrix, layer, parts = net.source(v)
        K, N = net.width(u), net.width(v)
        first_k = MM_FIRST if kappa == 0 else 0
        k = min(SLAB_N, (pad16(K) if parts else padk(K)) - SLAB_N * kappa)
        if parts:
            ops.append((OP_MM, *src, k, d0, d1, first_k, dst, col0, parts,
                        frag_at[(matrix, layer)], pad16(K) // 16, 8 * kappa, N))
        else:
            ops.append((OP_MM, *src, k, d0, d1, first_k | (MM_SPLIT if split else 0), dst, col0,
                        0, 0, 0, 0, N))
            blocks.append(Block(matrix, layer, SLAB_N * kappa, k, d0, d1, split))

    def ws(v, col):
        return ("ws", place[v][1], col)

    def src_chunk(u, kappa):
        """Chunk κ of vector u where a product can read it: (buffer, row)."""
        if u == ("a", -1):  # the input, from device memory
            ops.append((OP_INPUT, kappa, CA))
            return CA, 0
        if u == ("a", 0) and not dense:
            write = not value_only and n > 1 and kappa not in masked0
            masked0.add(kappa)
            ops.append((OP_SKINNY, kappa, min(SLAB_N, padk(W[0]) - SLAB_N * kappa),
                        min(SLAB_N, W[0] - SLAB_N * kappa),
                        mask_at[0] + SLAB_N * kappa if write else -1))
            return CA, 0
        if streamed(u):
            produce_chunk(u, kappa)
            return CB, 0
        if u in spilled:
            ops.append((OP_LOAD, ws(u, SLAB_N * kappa), CA))
            return CA, 0
        return place[u], SLAB_N * kappa

    def h_chunk(d):
        """The gram head's h for its chunk d: (buffer, its first column)."""
        h = ("a", n - 1)
        if n == 1 and not dense:
            return -1, 0
        if h in spilled:
            ops.append((OP_LOAD, ws(h, SLAB_N * d), CA))
            return CA, SLAB_N * d
        return place[h], 0

    def epilogue(v, dst, c0, cols, valid, split):
        """Bias, ReLU and mask bits (an activation), the mask (a signal),
        the gram head's epilogue or K1's output bias, on v's columns c0 …
        in dst; dx has none."""
        kind, i = v
        if kind == "y":
            ops.append((OP_FIN, dst, cols, valid, u_at + c0, 0, -1, FIN_LINEAR))
        elif v == ("e", -1):
            pass
        elif v == ("e", n - 1):
            e0 = c0 if dst == CB else 0
            if dst != CB and n > 1 and ("a", n - 1) in spilled:
                for d in range(chunks(W[i])):  # h a chunk at a time
                    ops.append((OP_GRAM, *h_chunk(d), dst, e0, W[i], SLAB_N * d,
                                min(SLAB_N, padk(W[i]) - SLAB_N * d), u_at))
            else:
                ops.append((OP_GRAM, *h_chunk(c0 // SLAB_N), dst, e0, W[i], c0, cols, u_at))
        elif kind == "a":
            mask = mask_at[i] + c0 if i < n - 1 and not value_only else -1
            ops.append((OP_FIN, dst, cols, valid, bias_at[i] + c0, int(split), mask, FIN_RELU))
        else:
            ops.append((OP_FIN, dst, cols, valid, -1, int(split), mask_at[i] + c0, FIN_MASKED))

    def produce_chunk(v, d):
        """Chunk d of v, summed over every input chunk, into CB, finished."""
        u, w = net.source(v)[0], net.width(v)
        for kappa in range(chunks(net.width(u))):
            mm(src_chunk(u, kappa), v, kappa, d, d + 1, False, CB, SLAB_N * d)
        epilogue(v, CB, SLAB_N * d, min(SLAB_N, padk(w) - SLAB_N * d),
                 min(SLAB_N, w - SLAB_N * d), False)

    def produce(v):
        """v whole: into the workspace chunk by chunk, or k-outer into a
        held tile."""
        w = net.width(v)
        if v in spilled:
            place[v] = ("ws", len(spill_order))
            spill_order.append(w)
            for d in range(chunks(w)):
                produce_chunk(v, d)
                ops.append((OP_STORE, CB, ws(v, SLAB_N * d)))
            return
        split = _splits(net, v)
        if split:
            split_set.add(v)
        place[v] = ("tile", len(held))
        held.append(SLAB_N if split else padk(w))
        u = net.source(v)[0]
        for kappa in range(chunks(net.width(u))):
            mm(src_chunk(u, kappa), v, kappa, 0, chunks(w), split, place[v], 0)
        epilogue(v, place[v], 0, padk(w), w, split)

    def write_chunks(v, width, mode):
        """v a chunk at a time into CB, each chunk's valid columns out
        (``OP_OUT``)."""
        for d in range(chunks(width)):
            produce_chunk(v, d)
            ops.append((OP_OUT, CB, SLAB_N * d, min(SLAB_N, width - SLAB_N * d), mode))

    for i in range(first, n):
        if i not in sf:
            produce(("a", i))
    if net.k1:  # the output layer chunk by chunk: the signal, or each row's Σy²
        write_chunks(("y", n), net.n_out, OUT_SUMSQ if net.sumsq else OUT_SIGNAL)
        if net.sumsq:
            ops.append((OP_QUAD_WRITE,))
    elif value_only:  # h@G chunk by chunk, each chunk's quad partials at once
        for d in range(chunks(W[-1])):
            produce_chunk(("e", n - 1), d)
        ops.append((OP_QUAD_WRITE,))
    else:
        for t in range(n - 1, -1, -1):
            v = ("e", t)
            if t == 0 and not dense:  # e_0 into dx, chunk by chunk
                if streamed(v):
                    for c in range(chunks(W[0])):
                        produce_chunk(v, c)
                        ops.append((OP_DX, CB, 0, min(SLAB_N, W[0] - SLAB_N * c), SLAB_N * c))
                else:
                    produce(v)
                    for c in range(chunks(W[0])):
                        ops.append((OP_DX, place[v], SLAB_N * c, min(SLAB_N, W[0] - SLAB_N * c),
                                    SLAB_N * c))
            elif not streamed(v):
                produce(v)
        ops.append((OP_QUAD_WRITE,))
        if dense:  # dx = e_0 @ W_0ᵀ a chunk at a time, times the log-clamp's derivative
            write_chunks(("e", -1), n_in, OUT_DX)
        else:
            ops.append((OP_DX_WRITE,))
    if blocks:  # the ring's first slabs: at the start, or where the backward's fp32 begins
        first_mm = next(k for k, op in enumerate(ops) if op[0] == OP_MM and not op[9])
        mma_before = any(op[0] == OP_MM and op[9] for op in ops[:first_mm])
        ops.insert(first_mm if mma_before else 0, (OP_RING,))

    # the workspace: two regions, spilled vectors alternating between them
    # (a spilled vector and the next one are read and written at once)
    region = [chunks(max(spill_order[r::2], default=0)) * SLAB_N for r in (0, 1)]
    tiles, cols = _assign_tiles(held)

    def resolve(v):
        if isinstance(v, tuple) and v[0] == "tile":
            return tiles[v[1]]
        if isinstance(v, tuple):  # ("ws", k, col)
            return (0 if v[1] % 2 == 0 else region[0]) + v[2]
        return v

    ops = tuple(tuple(resolve(v) for v in op) for op in ops)
    mask_cols = net.mask_cols
    return WidePlan(
        ops=ops, blocks=tuple(blocks), frags=tuple(frags), cols=cols, mask_cols=mask_cols,
        masks_in_ws=masks_in_ws and mask_cols > 0, ws_cols=sum(region),
        stream_rows=sum((64 if b.split else b.rows) * (b.d1 - b.d0) for b in blocks),
        a_parts=_a_parts(net), heights=(),
        streamed_forward=frozenset(sf), streamed_backward=frozenset(sb),
        split=frozenset(split_set), spilled=frozenset(spilled), dense=dense)


def _shared_bytes(cols, a_parts: int, mask_cols: int, rows: int, dense: bool = False) -> int:
    s = tile_stride(rows)
    depth, slots = WIDE_RING[rows]
    in_rows = 0 if dense else MAX_IN
    w0 = 0 if a_parts or dense else MAX_IN * SLAB_N
    floats = slots * depth * SLAB_N + RED_FLOATS + w0 + s * (in_rows + 2 * SLAB_N + sum(cols))
    return (4 * floats + 2 * a_parts * rows * A_STRIDE + MASK_COL_BYTES[rows] * mask_cols
            + WIDE_NET_BYTES)


def plan_bytes(plan: WidePlan, rows: int) -> int:
    """Shared memory of one block of ``rows`` rows (``launch_wide`` in the
    source): the slab ring (``WIDE_RING``), the A-chunk tile (bf16, hi and
    lo at bf16x3; none where no op runs on the tensor cores), the per-row
    partials, a staged chunk of the skinny layer's weights (over the
    A-chunk tile where there is one), the input tile (8 k rows), the two
    chunk buffers, the three held tiles, the mask bits (unless they lie
    in the workspace) and the static copy of the net. A dense layer 0
    needs neither the staged chunk nor the input tile."""
    return _shared_bytes(plan.cols, plan.a_parts,
                         0 if plan.masks_in_ws else plan.mask_cols, rows, plan.dense)


def ws_cta_bytes(plan: WidePlan, rows: int) -> int:
    """One CTA's workspace at ``rows`` rows (``ws_cta_bytes`` in the
    source): the spilled vectors' k-major fp32 tiles, then the mask bits
    where they lie there, rounded up to ``WS_ALIGN``; 0 without one."""
    masks = MASK_COL_BYTES[rows] * plan.mask_cols if plan.masks_in_ws else 0
    size = 4 * tile_stride(rows) * plan.ws_cols + masks
    return -(-size // WS_ALIGN) * WS_ALIGN


def resident_ctas(plan: WidePlan, rows: int, sm_count: int) -> int:
    """The CTAs of ``rows`` rows the card holds at once (at most two per
    SM, the kernel's launch bounds): the persistent grid's width where the
    plan uses the workspace."""
    per_sm = max(1, min(2, SM_BYTES // (plan_bytes(plan, rows) + 1024)))
    return sm_count * per_sm


@functools.lru_cache(maxsize=256)
def wide_plan(trunk: tuple, parts: int, grad_parts: Optional[int] = 0,
              budget: int = MAX_SHARED_BYTES, n_out: Optional[int] = None,
              sumsq: bool = False) -> WidePlan:
    """The op program of ``trunk`` = (n_in, W_0 … W_{n−1}) (activation i
    is W_i wide; trunk layer i ≥ 1 maps W_{i−1} → W_i, layer 0 n_in →
    W_0: the skinny layer, recomputed from the input tile, where n_in ≤
    ``MAX_IN``, else an ordinary layer whose input is read from device
    memory a chunk at a time; the gram head H × H, H = W_{n−1}), with the
    forward's products at ``parts`` (0 the fp32 stream, 1 bf16, 2 bf16x3
    fragments) and the backward's at ``grad_parts`` (None: K2, the value
    alone). K1 (``n_out``, value only): the gram head is replaced by the
    linear output layer W_{n−1} → ``n_out`` with its bias, each output
    chunk written as the signal or (``sumsq``) added to each row's Σy²;
    its trunk may be the input alone (n = 0) where that is dense. A dense
    layer 0's backward (K3) is one more product, e_0 @ W_0ᵀ, a chunk of dx
    at a time. Everything is held or streamed where that fits ``budget``
    bytes of shared memory at some tile height; else vectors are spilled
    to the workspace, widest first (a vector whose input was streamed
    takes its input's place in the stream order, and a skinny network's
    ``e_0`` is streamed rather than spilled), then the mask bits, until
    the plan fits at the tallest height.

    Ops, in order (buffer ids ``CA``, ``CB``, ``P``, ``Q``, ``R``; rows and
    columns in the layer's own coordinates):

    * ``(OP_SKINNY, κ, cols, valid, mask_col)``: chunk κ of activation
      0 into CA from the input tile: columns 128κ … of relu(skinny),
      ``cols`` of them written (0 from ``valid`` on); its mask bits at
      ``mask_col`` (−1: not written).
    * ``(OP_INPUT, κ, dst)``: columns 128κ … 128κ + 127 of the input
      rows, log-clamped (0 past n_in), into the chunk buffer ``dst``.
    * ``(OP_MM, src, src_row, k, d0, d1, flags, dst, dst_col0, parts,
      frag, ksteps, kstep0, n)``: the next ``k`` rows of ``src`` from row
      ``src_row`` times the layer's rows for output chunks d0 … d1 − 1 (a
      layer ``n`` wide), added to the accumulators in ``dst`` (column c of
      the layer at c − ``dst_col0``), from 0 with ``MM_FIRST``. ``parts``
      0: the fp32 stream's next block, on the CUDA cores; else the
      fragments at word ``frag`` of the fragment buffer (a matrix of
      ``ksteps`` k-steps) from k-step ``kstep0``, ``src`` split (2) or
      rounded (1) once into the A-chunk tile first.
    * ``(OP_FIN, dst, cols, valid, bias, split, mask_col, kind)``: the
      epilogue of ``dst``'s first ``cols`` columns (0 from ``valid`` on):
      the split's upper sums added, then (``FIN_RELU``) the forward's bias
      (offset ``bias`` into the biases), ReLU and mask bits at
      ``mask_col`` (−1: none), (``FIN_MASKED``) the backward's mask from
      ``mask_col``, or (``FIN_LINEAR``) K1's output bias alone.
    * ``(OP_GRAM, h, h_col0, e, e_col0, H, j0, cols, u)``: columns j0 … j0
      + cols − 1 of the gram head: quad partials Σ (hg + 2u)·h from hg in
      ``e`` (column j at j − ``e_col0``) and h in ``h`` (at j −
      ``h_col0``; −1: recomputed from the input tile), then e ← h > 0 ?
      hg + u : 0 in place; ``(OP_QUAD_WRITE,)`` sums the partials across
      threads and writes the quad (K1: each row's Σy²).
    * ``(OP_OUT, src, col0, valid, mode)``: ``valid`` columns of the chunk
      buffer ``src``, columns col0 … of a row's output: ``OUT_SIGNAL``
      K1's signal, ``OUT_SUMSQ`` added to its Σy² partials (column j to
      slice j mod 8, as the quad), ``OUT_DX`` dx times the log-clamp's
      derivative.
    * ``(OP_DX, src, src_row, valid, w0_col)``: dx partials from ``valid``
      columns of e_0 in ``src`` from ``src_row``, w0's columns ``w0_col
      …`` (the skinny layer's backward); ``(OP_DX_WRITE,)`` sums them
      across threads and writes dx.
    * ``(OP_LOAD, col, dst)``: the workspace's k rows col … col + 127 into
      the chunk buffer ``dst``; ``(OP_STORE, src, col)``: the chunk
      buffer ``src`` into them.
    * ``(OP_RING,)``: starts the slab ring, before the first fp32
      product.

    A skinny network's K2 and K3 programs are those of the planner before
    K1 and the dense layer were added, op for op.
    """
    net = _Net(trunk[0], tuple(trunk[1:]), parts, grad_parts, n_out, sumsq)
    W, n = net.W, net.n
    if net.k1 and grad_parts is not None:
        raise ValueError("K1's program is value only: grad_parts must be None")
    if not (n or net.k1 and net.dense):
        raise ValueError(f"trunk {trunk} has no activation (only K1's dense layer may be alone)")
    # activation 0 is recomputed where it is skinny, never held
    sf = _streamed(W, 0 if net.dense else 1, n)
    if grad_parts is None:
        sb = set()
    elif net.dense:  # dx is summed a chunk at a time over e_0: e_0 stays whole
        sb = _streamed(W, 1, n + 1)
    else:  # e_0 goes into dx unless e_1 is streamed; e_{n−1} may be streamed too
        sb = _streamed(W, 0, n + 1, always=(0,))
    heights = tuple(r for r in WIDE_TILE_ROWS if _bytes(net, sf, sb, (), False, r) <= budget)
    if heights:
        return _emit(net, sf, sb, frozenset(), False)._replace(heights=heights)
    spilled, masks_in_ws = set(), False
    rows = WIDE_TILE_ROWS[0]
    while _bytes(net, sf, sb, spilled, masks_in_ws, rows) > budget:
        # the held vectors, widest first; a split one stays (its sums'
        # order is its own)
        held = sorted((v for v in _held(net, sf, sb, spilled) if not _splits(net, v)),
                      key=lambda v: (-net.width(v), v))
        if held and (net.width(held[0]) > SLAB_N or masks_in_ws or not net.mask_cols):
            v = held[0]
        elif not masks_in_ws and net.mask_cols:
            masks_in_ws = True
            continue
        else:
            raise ValueError(f"no plan of trunk {trunk} fits {budget} bytes of shared memory")
        if v == ("e", 0) and not net.dense:  # into dx chunk by chunk, its input held instead
            sb = (sb - {1}) | {0}
            continue
        u = net.source(v)[0]  # a spilled vector's input is not streamed
        (sf if u[0] == "a" else sb).discard(u[1])
        spilled.add(v)
    plan = _emit(net, sf, sb, frozenset(spilled), masks_in_ws)
    return plan._replace(heights=tuple(r for r in WIDE_TILE_ROWS
                                       if plan_bytes(plan, r) <= budget))


def program_table(plan: WidePlan) -> torch.Tensor:
    """The ops as the kernel reads them: (n_ops, ``OP_INTS``) int32, each
    op's fields after its code, zero-filled."""
    table = torch.zeros((len(plan.ops), OP_INTS), dtype=torch.int32)
    for i, op in enumerate(plan.ops):
        table[i, : len(op)] = torch.tensor(op, dtype=torch.int32)
    return table


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


def pack_wide_slabs(matrix, biases, plan: WidePlan) -> Slabs:
    """The fp32 stream of ``plan``'s blocks in the order its ops read them
    (each output chunk's rows k-major, as ``csrc/tile_f32.cuh`` streams
    a chunk), and the biases (``biases``: layers 1 … n−1, or 0 … n−1
    where layer 0 is dense, then u or K1's output bias), each zero-padded
    to 128·chunks. ``matrix(name, layer)``: the ``(w, tier)`` of a matrix
    of the plan (fp32 where the stream reads it)."""
    parts = [_block(matrix(b.matrix, b.layer)[0], b) for b in plan.blocks]
    padded = []
    for b in biases:
        p = b.new_zeros(chunks(b.shape[0]) * SLAB_N)
        p[: b.shape[0]] = b
        padded.append(p)
    w = torch.cat(parts) if parts else biases[0].new_zeros(0)
    assert w.numel() == plan.stream_rows * SLAB_N
    return Slabs(w=w.contiguous(), b=torch.cat(padded).contiguous())


def pack_wide_frags(matrix, plan: WidePlan, pack) -> Optional[torch.Tensor]:
    """The fragment buffer of ``plan``: each matrix's ``mma`` fragments
    (``pack(w, tier)``, bf16, ``fused_mlp.py::pack_mma_operands``'s
    layout, of ``matrix(name, layer)``'s prepared operand at its tier)
    back to back at its word offset; None where no op reads one."""
    if not plan.frags:
        return None
    out = []
    for name, layer, _, _, _, word in plan.frags:
        assert 2 * word == sum(t.numel() for t in out)
        out.append(pack(*matrix(name, layer)).reshape(-1))
    return torch.cat(out).contiguous()


def wide_ints(plan: WidePlan) -> list:
    """The plan's sizes a C entry takes after the tile height: the three
    held tiles' k rows, the mask columns, the stream's rows, the
    program's length, the workspace's k rows per CTA and whether the mask
    bits lie there."""
    return [*plan.cols, plan.mask_cols, plan.stream_rows, len(plan.ops), plan.ws_cols,
            int(plan.masks_in_ws)]


def wide_tail(plan: WidePlan, rows: int, members: Optional[int],
              workspace: Optional[torch.Tensor], ctas: int) -> list:
    """A wide entry's ints and workspace: the A-chunk tile's parts, the
    height ``rows``, :func:`wide_ints`, then the persistent grid's CTAs
    per member and the ``workspace``'s address where the plan spills
    (refused unless it holds ``ctas`` · members regions), else 0 and
    null."""
    if plan.ws_cols or plan.masks_in_ws:
        need = ctas * (members or 1) * ws_cta_bytes(plan, rows)
        if workspace is None or ctas < 1 or workspace.numel() < need:
            raise ValueError(f"the wide route's plan needs a workspace of {need} bytes "
                             f"for {ctas} CTAs")
    else:
        workspace, ctas = None, 0
    return [plan.a_parts, rows, *wide_ints(plan), ctas,
            None if workspace is None else workspace.data_ptr()]


class WideLaunch:
    """Launches of operands packed under ``plan`` by ``launch_fn(ops, x,
    rows, workspace, ctas, plan)`` on a card of ``sm_count`` SMs: where
    the plan spills, a persistent grid of the CTAs per member the card
    holds at the call's height (:meth:`ctas`) and the workspace they need
    at the height that needs the most, allocated at the first launch and
    reused by every one after (:attr:`workspace`, None where the plan does
    not spill). The wrappers launch the route through it, and so do direct
    launches of its operands."""

    def __init__(self, plan: WidePlan, launch_fn, sm_count: int, device, members=None):
        self.plan, self.launch_fn, self.sm_count = plan, launch_fn, sm_count
        self.device, self.members = device, members
        self.spills = bool(plan.ws_cols or plan.masks_in_ws)
        self.workspace = None

    def ctas(self, rows: int) -> int:
        """The persistent grid's CTAs per member at ``rows`` rows
        (:func:`resident_ctas`) where the plan spills; else 0."""
        return resident_ctas(self.plan, rows, self.sm_count) if self.spills else 0

    def __call__(self, ops, x: torch.Tensor, rows: int, ctas: Optional[int] = None):
        """Launch ``ops`` on ``x`` at tile height ``rows`` (one of the
        plan's), on :meth:`ctas` CTAs per member, or on ``ctas`` (at most
        that many) where given."""
        if self.spills and self.workspace is None:
            size = max(self.ctas(r) * ws_cta_bytes(self.plan, r) for r in self.plan.heights)
            self.workspace = torch.empty(size * (self.members or 1), dtype=torch.uint8,
                                         device=self.device)
        return self.launch_fn(ops, x, rows, self.workspace,
                              self.ctas(rows) if ctas is None else ctas, self.plan)
