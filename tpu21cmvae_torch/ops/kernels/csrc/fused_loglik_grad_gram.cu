// K1, K2 and K3 for Hopper on every network the dedicated kernels cannot
// hold: the MLP's signal or its Σy², the gram-form Gaussian
// log-likelihood, and (K3) its gradient with respect to the raw
// parameters, for a batch of rows, in one kernel. It takes K1 and K2 at
// every tier and K3 at every (value, backward) tier pair, at any width,
// any depth and any fan-in: a network too wide for the kernels that hold
// two full-width activation buffers or a row tile's bf16 activations, e.g.
// hidden (3200, 64, 64), (1536, 1536, 1536) or (4096, 4096), deeper than
// their kMaxLayers, e.g. (256,)×12, or (K2, K3) with a first layer of
// fan-in above kMaxIn. Other networks run fused_mlp.cu, fused_mlp_mma.cu,
// fused_loglik_gram.cu, fused_loglik_grad_gram_f32.cu, fused_gram_mma.cu
// and fused_gram_mixed.cu.
//
// Replaces: tpu21cmvae/ops/pallas/fused_loglik.py::make_fused_loglik_grad_gram
// (kernel body _loglik_grad_gram_kernel) and make_fused_loglik_gram
// (_loglik_gram_kernel), and tpu21cmvae/ops/pallas/fused_mlp.py::
// make_fused_mlp (_mlp_kernel), on such a network. Same contract: per row
// it writes
//   quad = ‖r‖² − c = Σ_j (h@G + 2u)_j · h_j
//   dx   = ½ · d‖r‖²/dx_raw                      (K3)
// where h is the last ReLU trunk activation of the folded network and
// (G, u, c) come from ops/fold.py::gram_fold; the caller returns
// −½·(quad + c) + log_norm (and −dx). K1 writes y = h@W + b (the linear
// output layer) or its Σ_j y_j², summed as the quad is.
//
// What bounds it on an H100: fp32 FMA throughput on the CUDA cores where
// a tier is fp32, the tensor cores' bf16 rate where it is bf16 or bf16x3.
// On hidden (3200, 64, 64) a row needs 0.213 M products forward, 0.209 M
// backward and 22,400 each way in the skinny layer: 0.93 MFLOP, 0.91 ms
// per 65,536 rows at 67 TFLOP/s. The first design (one thread per output
// column of a 16-row tile, every activation held at its own width, 217 KB
// of shared memory, one CTA per SM) left 3/4 of the threads idle on 3200
// → 64 and walked 3200 columns in one thread per (row, input) in the
// skinny backward: 4.8 % of the bound.
//
// What the design does about it (ops/kernels/wide.py, which builds the
// program this kernel runs; tests/_torch_f32.py runs the same program on
// the CPU):
// - Row tiles of BM = 32 or 16 rows to CTAs of 256 threads, the height
//   picked per call as the fp32 K3 picks its own (32-row tiles, two CTAs
//   per SM, ran faster than 64-row ones at every batch measured:
//   PERF.md). Every fp32 product runs on tile_f32.cuh's register tiles: a
//   thread holds BM/8 × 4 sums, fed from a four-slot cp.async slab ring
//   (WideRing), the weights packed once per fold in the order the
//   program reads them.
// - No wide activation is held whole. Layer 0, where it is skinny, is
//   recomputed chunk by chunk from the input tile wherever it is read
//   (n_in ≤ 8 products an element); a dense layer 0 is an ordinary layer
//   whose input is read from device memory a 128-column chunk at a time,
//   log-clamped (OP_INPUT, no input tile), and whose backward is one more
//   product, each chunk of dx written with the log-clamp's derivative
//   (OP_OUT). K1's head is its output layer, each 128-column chunk of y
//   finished with its bias and no ReLU, then written or squared into the
//   per-row partials (OP_OUT). A held layer is summed k-outer: a
//   128-row input chunk at a time, its products added to accumulators
//   that wait in the output's tile between chunks, so a layer's output
//   is one fp32 sum over k ascending per element, as in the other
//   register-tiled kernels. A wide activation between two layers is
//   produced one 128-column chunk at a time (bias, ReLU, mask bits) and
//   consumed at once as one k-chunk of the next layer.
// - What shared memory cannot hold goes to a per-CTA region of a global
//   workspace: such a vector is summed n-outer, a 128-column chunk at a
//   time over every input chunk, finished in a chunk buffer and stored
//   (OP_STORE); its readers load a chunk at a time by cp.async (OP_LOAD).
//   The mask bits go there too where they do not fit; they are read and
//   written in place. Then the grid is persistent: as many CTAs as the
//   card holds at once per member, each looping over row tiles, so the
//   workspace is bounded by resident CTAs, not by the batch.
// - Masks are bits, one per (row, column) of every activation but the
//   last (tile_f32.cuh's MaskBits layout: 12.8 KB for 3200 columns at 32
//   rows). The backward mirrors the forward: each chunk of e is produced
//   from the narrower signal after it, masked by the stored bits and
//   consumed at once; e_0's chunks go straight into dx, each CTA's
//   threads splitting a chunk's columns and summing their partials in a
//   fixed order at the end.
// - A narrow output of a wide input (≤ 64 columns, ≥ 256 rows: 3200 →
//   64) would leave two of a chunk's four column quarters idle; there
//   the upper quarters take the upper 64 rows of every input chunk into
//   sums of their own, added to the lower ones in the epilogue.
// - Every product carries its own tier parts: an fp32 one runs as above;
//   a bf16 or bf16x3 one on the tensor cores (mma.cuh's fragment loads
//   and mma.sync, B as pack_mma_operands packs it, from one fragment
//   buffer): its input chunk is split (bf16x3) or rounded (bf16) once
//   into an A-chunk tile, and each k-step's products are added to the
//   waiting sums in k-step order, so at a bf16 value tier hg and every
//   activation are the tensor-core K2's bit for bit, and a bf16 backward
//   computes fused_gram_mixed.cu's products.
// No placement moves a sum: whatever is held, streamed or spilled, each
// element is summed over the same products in the same order, so the
// results do not depend on the plan, the tile height or the member count.
// Shared memory (hidden (3200, 64, 64), fp32, 32 rows): the ring 32 KB,
// the input tile, two chunk buffers and two held tiles (the split 64-wide
// layer's 128 columns and 64) 57 KB, the staged w0 chunk 4 KB, the masks
// 12.8 KB: 109,464 bytes with the static copy of the net, two CTAs per
// SM (114,584 at bf16x3, with the A-chunk tile over the w0 chunk).
//
// Members: grid y runs an ensemble's M members in one launch, each CTA on
// one member's stacked operands (trunk.cuh, member_at). Nothing else
// changes with M, so a member's rows come out bit for bit as from a
// launch of that member alone.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tpu21cmvae_torch/ops/kernels/_build.py).

#include <cstdint>

#include "mma.cuh"
#include "tile_f32.cuh"

namespace {

// the op program (ops/kernels/wide.py): kOpInts ints per op, code first
constexpr int kOpInts = 16;
enum WideOp : int {
  kOpSkinny = 1,
  kOpMM = 2,
  kOpFin = 3,
  kOpGram = 4,
  kOpDx = 5,
  kOpDxWrite = 6,
  kOpRing = 7,
  kOpQuadWrite = 8,
  kOpLoad = 9,
  kOpStore = 10,
  kOpInput = 11,
  kOpOut = 12,
};
enum WideBuf : int { kCA = 0, kCB = 1, kP = 2, kQ = 3, kR = 4 };
constexpr int kMMSplit = 1, kMMFirst = 2;
enum FinKind : int { kFinRelu = 0, kFinMasked = 1, kFinLinear = 2 };  // OP_FIN
enum OutMode : int { kOutSignal = 0, kOutSumsq = 1, kOutDx = 2 };      // OP_OUT
constexpr int kAStride = kSlabN + 8;  // bf16 per row of the A-chunk tile
constexpr int kWideNTiles = 2;        // n8 tiles a warp carries at once (mma.cuh: kNTiles)
constexpr int kInRows = kMaxIn;       // k rows of the input tile (none where layer 0 is dense)
constexpr int kWsAlign = 256;         // a CTA's workspace starts on this many bytes
// The quad and dx are summed per row by kSlices threads, thread (row r,
// slice p) over columns p, p + kSlices, …, then the slices in order: the
// same at every tile height (the first kSlices·BM threads take part: all
// of them at 32 rows), so a row's result does not depend on the height,
// nor on the member count through it.
constexpr int kSlices = 8;
// A staged chunk of w0 (kMaxIn rows of kSlabN columns). Where any product
// runs on the tensor cores it lies over the A-chunk tile (at least 4352
// bytes), which only an mma OP_MM uses, from its own conversion on; the
// passes that stage w0 (OP_SKINNY, OP_DX) never overlap one.
constexpr int kW0Floats = kSlabN * kMaxIn;

// The slab ring by tile height: tile_f32.cuh's depths (16 k rows at 32
// rows, 8 at 16) in four slots, so three slabs are in flight while one is
// read (a layer's chunk here is 4 to 16 such short slabs, between other
// ops).
template <int BM>
struct WideRing {
  static constexpr int kDepth = Ring<BM>::kDepth;
  static constexpr int kSlots = 4;
  static constexpr int kFloats = kDepth * kSlabN;
};

struct WideNet {
  int n_in;                 // layer 0's fan-in (skinny where ≤ kMaxIn) …
  int n1;                   // … and width: a skinny w0 is (n_in, n1)
  int n_ops;
  int cols[3];              // k rows of the held tiles P, Q, R
  int total;                // slabs in the fp32 stream at this tile height
  int ws_cols;              // k rows of a CTA's workspace tiles
  int ws_masks;             // the mask bits lie in the workspace (after its tiles)
  int n_tiles;              // row tiles of the batch
  long long ws_cta_bytes;   // a CTA's workspace
  const float* w0;          // (n_in, n1), exact fp32
  const float* b0;          // (n1,)
  const float* bias;        // trunk layers 1 … n−1 padded to 128·chunks, then u
  const float* slabs;       // the fp32 stream, in the program's order
  const int4* prog;         // n_ops · kOpInts ints
  const uint32_t* frags;    // the fragment buffer (mma operands), or null
  uint8_t* ws;              // the workspace (every CTA's region), or null
  long long s_w0, s_b0, s_bias, s_slabs, s_prog, s_frags;
};
static_assert(sizeof(WideNet) == 152, "ops/kernels/wide.py's WIDE_NET_BYTES");
static_assert(2 * 16 * kAStride >= 4 * kSlabN * kMaxIn, "w0's chunk fits the smallest A tile");

// The net of member m: every operand moved by m times its stride.
__device__ __forceinline__ void to_member(WideNet& net, int m) {
  net.w0 = member_at(net.w0, net.s_w0, m);
  net.b0 = member_at(net.b0, net.s_b0, m);
  net.bias = member_at(net.bias, net.s_bias, m);
  net.slabs = member_at(net.slabs, net.s_slabs, m);
  net.prog = member_at(net.prog, net.s_prog, m);
  net.frags = member_at(net.frags, net.s_frags, m);
}

// One CTA's workspace: its k-major fp32 tiles (ws_cols k rows of stride
// S), then (ws_masks) the mask bits, rounded up to kWsAlign bytes
// (ops/kernels/wide.py::ws_cta_bytes).
template <int BM>
__host__ __device__ long long ws_cta_bytes(int ws_cols, int mask_bytes) {
  const long long size = 4LL * tile_stride(BM) * ws_cols + mask_bytes;
  return (size + kWsAlign - 1) / kWsAlign * kWsAlign;
}

// ---------------------------------------------------------------- fp32 MM

// acc[j, r] (+)= Σ_{k < kr} in[k, r] · W[k, j] for the layer's output
// chunks d0 … d1−1 (n columns), k ascending in one fp32 sum per element
// by fmaf, from the next slabs of the stream. The sums wait in `out`
// (k-major, stride S; the layer's column c at c − col0) between calls:
// loaded unless `first`, stored after. Split (n ≤ 64, one chunk): the
// upper two column quarters take rows 64 … 127 of the chunk into columns
// 64 … 127 of `out`, from the slab's upper 64 columns; a quarter skips a
// slab whose rows lie at or past kr.
template <int BM, class R>
__device__ __forceinline__ void mm_f32(const float* in, int kr, int n, bool split, float* out,
                                       int col0, int d0, int d1, bool first,
                                       const float* __restrict__ slabs, int total, float* ring,
                                       int& g) {
  constexpr int TM = BM / 8;
  constexpr int S = tile_stride(BM);
  const TileThread<BM> t;
  const bool upper = split && t.quarter >= 2;
  const int steps = (split ? kSlabN / 2 : kr) / R::kDepth;
  const int valid = split ? (upper ? kr - kSlabN / 2 : min(kr, kSlabN / 2)) : kr;
  const float* a_base = in + t.row + (upper ? (kSlabN / 2) * S : 0);
  for (int d = d0; d < d1; ++d) {
    const bool active = split ? (t.quarter & 1) * 32 < n : d * kSlabN + t.quarter * 32 < n;
    float* o = out + (d * kSlabN + t.col - col0) * S + t.row;
    float acc[TM][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v[TM];
      if (active && !first) {
        load_rows<TM>(v, o + q * S);
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) acc[i][q] = v[i];
    }
    for (int s = 0; s < steps; ++s, ++g) {
      cp_async_wait<R::kSlots - 2>();  // slab g has landed (this thread's copies)
      pair_sync();                     // … the pair's; its part of slot g − 1 is free
      issue_slab<BM, R>(ring, slabs, g + R::kSlots - 1, total);
      if (active && s * R::kDepth < valid) {
        const float* w = ring + (g % R::kSlots) * R::kFloats + t.col;
        const float* a = a_base + s * R::kDepth * S;
#pragma unroll
        for (int kk = 0; kk < R::kDepth; ++kk) {
          const float4 wv = *reinterpret_cast<const float4*>(w + kk * kSlabN);
          float av[TM];
          load_rows<TM>(av, a + kk * S);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            acc[i][0] = fmaf(av[i], wv.x, acc[i][0]);
            acc[i][1] = fmaf(av[i], wv.y, acc[i][1]);
            acc[i][2] = fmaf(av[i], wv.z, acc[i][2]);
            acc[i][3] = fmaf(av[i], wv.w, acc[i][3]);
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) v[i] = acc[i][q];
        store_rows<TM>(o + q * S, v);
      }
    }
  }
}

// ---------------------------------------------------------------- mma MM

// The first kr16 k rows of a k-major fp32 tile `in` into the A-chunk
// tile (row-major, kAStride), split (PF 2) or rounded (PF 1) once.
template <int BM, int PF>
__device__ __forceinline__ void to_a_chunk(const float* in, int kr16, __nv_bfloat16* at) {
  constexpr int S = tile_stride(BM);
  for (int t = threadIdx.x; t < BM * kr16 / 2; t += blockDim.x) {
    const int r = t % BM;
    const int k = 2 * (t / BM);
    store_pair<PF>(at, BM * kAStride, r * kAStride + k, in[k * S + r], in[(k + 1) * S + r]);
  }
}

// acc[j, r] (+)= the A chunk's kr16 k rows times k-steps kstep0 … of the
// layer's packed fragments w (ksteps k-steps in all), for the n8 tiles
// t0 … t1−1, on the tensor cores: each k-step's products summed by the
// mma from zero and added to the running sum by an IEEE add (mma.cuh).
// The sums wait in `out` as in mm_f32. The warps split the tiles evenly
// and carry up to kWideNTiles at once (fewer than mma_layer's kNTiles:
// the interpreter keeps more live, and four spilled).
template <int BM, int PF>
__device__ __forceinline__ void mm_mma(const __nv_bfloat16* at, int kr16,
                                       const uint32_t* __restrict__ w, int ksteps, int kstep0,
                                       int t0, int t1, float* out, int col0, bool first) {
  constexpr int MT = BM / 16;
  constexpr int S = tile_stride(BM);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tig = lane & 3;
  const int tiles = t1 - t0;
  const int t_begin = t0 + warp * tiles / kMmaWarps;
  const int mine = t0 + (warp + 1) * tiles / kMmaWarps - t_begin;
  const int steps = kr16 / 16;
  const size_t tile_words = static_cast<size_t>(ksteps) * 32 * 2 * PF;
  constexpr int kstep_words = 32 * 2 * PF;
  const __nv_bfloat16* a_row = at + (lane & 15) * kAStride + (lane >> 4) * 8;
  for (int c = 0; c < mine; c += kWideNTiles) {
    const int cnt = min(kWideNTiles, mine - c);
    const int tf = t_begin + c;
    const uint32_t* wt = w + tf * tile_words + kstep0 * kstep_words + lane * 2 * PF;
    float acc[kWideNTiles][MT][4];
#pragma unroll
    for (int j = 0; j < kWideNTiles; ++j)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = (tf + j) * 8 + 2 * tig - col0;
          const int r = mma_row(mt, h);
          const bool load = j < cnt && !first;
          acc[j][mt][2 * h] = load ? out[col * S + r] : 0.f;
          acc[j][mt][2 * h + 1] = load ? out[(col + 1) * S + r] : 0.f;
        }
    uint32_t bc[kWideNTiles][2 * PF];
    uint32_t bn[kWideNTiles][2 * PF];
#pragma unroll
    for (int j = 0; j < kWideNTiles; ++j)
      if (j < cnt) load_b<PF>(bc[j], wt + j * tile_words);
    for (int s = 0; s < steps; ++s) {
      if (s + 1 < steps) {
#pragma unroll
        for (int j = 0; j < kWideNTiles; ++j)
          if (j < cnt) load_b<PF>(bn[j], wt + j * tile_words + (s + 1) * kstep_words);
      }
      uint32_t a[MT][PF][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int p = 0; p < PF; ++p)
          ldmatrix_x4(a[mt][p], a_row + p * BM * kAStride + mt * 16 * kAStride + s * 16);
#pragma unroll
      for (int j = 0; j < kWideNTiles; ++j) {
        if (j < cnt) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float p4[4] = {0.f, 0.f, 0.f, 0.f};  // this k-step's products alone
            mma_bf16(p4, a[mt][0], bc[j][0], bc[j][1]);  // hi·w_hi (bf16: a·w)
            if constexpr (PF == 2) {
              mma_bf16(p4, a[mt][0], bc[j][2], bc[j][3]);  // hi·w_lo
              mma_bf16(p4, a[mt][1], bc[j][0], bc[j][1]);  // lo·w_hi
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[j][mt][q] += p4[q];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kWideNTiles; ++j)
#pragma unroll
        for (int q = 0; q < 2 * PF; ++q) bc[j][q] = bn[j][q];
    }
#pragma unroll
    for (int j = 0; j < kWideNTiles; ++j)
      if (j < cnt) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = (tf + j) * 8 + 2 * tig - col0;
            const int r = mma_row(mt, h);
            out[col * S + r] = acc[j][mt][2 * h];
            out[(col + 1) * S + r] = acc[j][mt][2 * h + 1];
          }
      }
  }
}

// ---------------------------------------------------------- elementwise

// The elementwise passes give each thread one row of the tile (lane r =
// threadIdx.x mod BM, so a warp's loads and stores of a k-major column
// meet no bank conflict) and kThreads/BM columns at a time; a column's
// ReLU mask is one __ballot_sync of its rows, bit r for row r
// (tile_f32.cuh's MaskBits layout at 16 and 32 rows), stored by the lane
// of row 0.
template <int BM>
__device__ __forceinline__ void store_mask(uint8_t* mask, int j, unsigned ballot) {
  const int lane = threadIdx.x & 31;
  if (lane % BM == 0) {
    const unsigned bits = BM == 32 ? ballot : (ballot >> lane) & ((1u << (BM % 32)) - 1u);
    store_bits<BM / 8>(mask + j * (BM / 8), bits);
  }
}

// w0's columns col0 … col0 + valid − 1 into `ws` (input column c's at
// ws[c·kSlabN …], 0 past valid and past n_in), each warp reading 32
// consecutive weights: a chunk of the skinny layer read once from
// device memory by the pass that needs it. The caller syncs after.
__device__ __forceinline__ void stage_w0(const WideNet& net, int col0, int valid, float* w0s) {
  const int n_in = net.n_in;
  const int n1 = net.n1;
  for (int t = threadIdx.x; t < kSlabN * kMaxIn; t += blockDim.x) {
    const int c = t / kSlabN;
    const int jj = t % kSlabN;
    w0s[t] = jj < valid && c < n_in ? __ldg(net.w0 + c * n1 + col0 + jj) : 0.f;
  }
}

// Input column c's staged weights of the four columns j … j + 3.
__device__ __forceinline__ float4 staged4(const float* w0s, int c, int j) {
  return *reinterpret_cast<const float4*>(w0s + c * kSlabN + j);
}

// Forward (bias ≠ null): v = (j < valid ? acc (+ the split's upper acc at
// j + 64) + bias[j] : 0), out = relu(v) (v itself where `linear`: K1's
// output layer), the mask bit v > 0 stored where `mask` is not null.
// Backward (bias null): out = the mask bit ? acc : 0. Columns j < cols (a
// multiple of 32).
template <int BM>
__device__ __forceinline__ void finish(float* out, int cols, int valid,
                                       const float* __restrict__ bias, bool split,
                                       uint8_t* mask, bool linear) {
  constexpr int S = tile_stride(BM);
  constexpr int P = kThreads / BM;
  const int r = threadIdx.x % BM;
  const bool masked = bias == nullptr;
  for (int j = static_cast<int>(threadIdx.x) / BM; j < cols; j += P) {
    float v = 0.f;
    if (j < valid) {
      v = out[j * S + r];
      if (split) v = v + out[(j + kSlabN / 2) * S + r];
    }
    if (masked) {
      const unsigned bits = load_bits<BM / 8>(mask + j * (BM / 8));
      out[j * S + r] = (bits >> r) & 1u ? v : 0.f;
    } else {
      v = v + (j < valid ? __ldg(bias + j) : 0.f);
      out[j * S + r] = linear ? v : relu(v);
      if (mask != nullptr) store_mask<BM>(mask, j, __ballot_sync(0xffffffffu, v > 0.f));
    }
  }
}

// Chunk kappa of activation 0 into `out`: relu(skinny) on its first cols
// columns (0 from `valid` on), its mask bits where `mask` is not null;
// each element trunk.cuh::skinny_dot's sum, in its order, from the
// thread's row of the input tile in registers and the chunk's weights
// staged in `w0s`. A thread carries four consecutive columns (one float4
// of weights per input column), the block 4·kThreads/BM columns a pass.
template <int BM>
__device__ __forceinline__ void skinny_chunk(const float* xl, const WideNet& net, int kappa,
                                             int cols, int valid, float* out, uint8_t* mask,
                                             float* w0s) {
  constexpr int S = tile_stride(BM);
  constexpr int P = kThreads / BM;
  stage_w0(net, kappa * kSlabN, valid, w0s);
  __syncthreads();
  const int n_in = net.n_in;
  const int r = threadIdx.x % BM;
  float x[kMaxIn];
#pragma unroll
  for (int c = 0; c < kMaxIn; ++c) x[c] = c < n_in ? xl[c * S + r] : 0.f;
  for (int jb = 0; jb < cols; jb += 4 * P) {  // the same trip count in every warp
    const int j0 = jb + 4 * static_cast<int>(threadIdx.x / BM);
    const bool live = j0 < cols;  // 4 | cols: a group is all in or all out
    float acc[4];
    if (live) {
      const float4 w = staged4(w0s, 0, j0);
      acc[0] = __fmul_rn(x[0], w.x), acc[1] = __fmul_rn(x[0], w.y);
      acc[2] = __fmul_rn(x[0], w.z), acc[3] = __fmul_rn(x[0], w.w);
#pragma unroll
      for (int c = 1; c < kMaxIn; ++c) {
        if (c < n_in) {
          const float4 wc = staged4(w0s, c, j0);
          acc[0] = __fadd_rn(acc[0], __fmul_rn(x[c], wc.x));
          acc[1] = __fadd_rn(acc[1], __fmul_rn(x[c], wc.y));
          acc[2] = __fadd_rn(acc[2], __fmul_rn(x[c], wc.z));
          acc[3] = __fadd_rn(acc[3], __fmul_rn(x[c], wc.w));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u;
      const float v =
          live && j < valid ? __fadd_rn(acc[u], __ldg(net.b0 + kappa * kSlabN + j)) : 0.f;
      if (live) out[j * S + r] = relu(v);
      if (mask != nullptr) {
        const unsigned bits = __ballot_sync(0xffffffffu, v > 0.f);
        if (live) store_mask<BM>(mask, j, bits);
      }
    }
  }
}

// The gram head's epilogue on its columns j0 … j0 + cols − 1, hg in e
// (column j at j − e_col0), by the first kSlices·BM threads: thread (row
// r, slice p) over columns ≡ p (mod kSlices) adds (hg + 2u)_j · h_j to its
// quad partial q by fmaf and sets e ← h > 0 ? hg + u : 0 in place (0 past
// H). h from the tile `h` (column j at j − h_col0), or (null) recomputed
// from the input tile (a trunk of the skinny layer alone). j0 is a
// multiple of kSlices, so a column's slice is the same in every plan.
template <int BM>
__device__ __forceinline__ void gram_epilogue(const float* h, int h_col0, float* e, int e_col0,
                                              int H, int j0, int cols,
                                              const float* __restrict__ u, const float* xl,
                                              const WideNet& net, float& q) {
  constexpr int S = tile_stride(BM);
  constexpr int P = kSlices;
  if (threadIdx.x >= P * BM) return;
  const int r = threadIdx.x % BM;
  for (int jl = static_cast<int>(threadIdx.x) / BM; jl < cols; jl += P) {
    const int j = j0 + jl;
    float hv = 0.f, hg = 0.f, uj = 0.f;
    if (j < H) {
      hv = h != nullptr
               ? h[(j - h_col0) * S + r]
               : relu(skinny_dot(xl + r, S, net.n_in, net.w0 + j, net.n1, __ldg(net.b0 + j)));
      hg = e[(j - e_col0) * S + r];
      uj = __ldg(u + j);
    }
    q = fmaf(hg + 2.f * uj, hv, q);
    e[(j - e_col0) * S + r] = hv > 0.f ? hg + uj : 0.f;
  }
}

// out[row0 + r] = Σ over the kSlices slices, in order, of the partials v
// of row r.
template <int BM>
__device__ __forceinline__ void rows_write(float v, float* red, float* __restrict__ out,
                                           int row0, int n_rows) {
  constexpr int P = kSlices;
  if (threadIdx.x < P * BM) red[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x < BM && row0 + static_cast<int>(threadIdx.x) < n_rows) {
    float s = 0.f;
    for (int k = 0; k < P; ++k) s += red[k * BM + threadIdx.x];
    out[row0 + threadIdx.x] = s;
  }
}

// dx partials from `valid` columns of a chunk of e_0 (w0's columns
// w0_col …, staged in `w0s`, 0 past valid): thread (row r, slice p <
// kSlices) over the groups of four columns 4p … 4p + 3, 4p + 32 …, in
// column order, one fp32 sum per input column by fmaf.
template <int BM>
__device__ __forceinline__ void dx_partials(const float* e, int valid, int w0_col,
                                            const WideNet& net, float (&dxp)[kMaxIn],
                                            float* w0s) {
  constexpr int S = tile_stride(BM);
  constexpr int P = kSlices;
  stage_w0(net, w0_col, valid, w0s);
  __syncthreads();
  if (threadIdx.x >= P * BM) return;
  const int r = threadIdx.x % BM;
  const int n_in = net.n_in;
  for (int j0 = 4 * static_cast<int>(threadIdx.x / BM); j0 < valid; j0 += 4 * P) {
    float ev[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) ev[u] = j0 + u < valid ? e[(j0 + u) * S + r] : 0.f;
#pragma unroll
    for (int c = 0; c < kMaxIn; ++c) {
      if (c < n_in) {
        const float4 w = staged4(w0s, c, j0);
        dxp[c] = fmaf(ev[0], w.x, dxp[c]);
        if (j0 + 1 < valid) dxp[c] = fmaf(ev[1], w.y, dxp[c]);
        if (j0 + 2 < valid) dxp[c] = fmaf(ev[2], w.z, dxp[c]);
        if (j0 + 3 < valid) dxp[c] = fmaf(ev[3], w.w, dxp[c]);
      }
    }
  }
}

// dx = Σ over the kSlices slices, in order, of the partials, times the
// log-clamp's derivative.
template <int BM>
__device__ __forceinline__ void dx_write(const float (&dxp)[kMaxIn], const float* __restrict__ x,
                                         float* __restrict__ dx, float* red, int n_in, int row0,
                                         int n_rows) {
  constexpr int P = kSlices;
#pragma unroll
  for (int c = 0; c < kMaxIn; ++c) {
    if (c >= n_in) break;
    __syncthreads();
    if (threadIdx.x < P * BM) red[threadIdx.x] = dxp[c];
    __syncthreads();
    const int row = row0 + static_cast<int>(threadIdx.x);
    if (threadIdx.x < BM && row < n_rows) {
      float s = 0.f;
      for (int k = 0; k < P; ++k) s += red[k * BM + threadIdx.x];
      const size_t at = static_cast<size_t>(row) * n_in + c;
      dx[at] = log_clamp_grad(x[at], c) * s;
    }
  }
}

// Columns kappa·kSlabN … + kSlabN − 1 of the input rows into the k-major
// chunk buffer `dst` (0 past n_in and past n_rows), log-clamped where
// `log_cols`: a chunk of a dense layer 0's input, read from device memory
// where a product needs it (as load_input reads the skinny layer's).
template <int BM>
__device__ __forceinline__ void input_chunk(const float* __restrict__ x, int n_rows, int row0,
                                            int n_in, int kappa, bool log_cols, float* dst) {
  constexpr int S = tile_stride(BM);
  for (int t = threadIdx.x; t < BM * kSlabN; t += blockDim.x) {
    const int r = t % BM;
    const int k = t / BM;
    const int row = row0 + r;
    const int c = kappa * kSlabN + k;
    float v = 0.f;
    if (row < n_rows && c < n_in) {
      v = x[static_cast<size_t>(row) * n_in + c];
      if (log_cols) v = log_clamp(v, c);
    }
    dst[k * S + r] = v;
  }
}

// `valid` columns of a finished chunk `src` (row r's column j at j·S + r),
// columns col0 + j of a row's output: K1's signal (kOutSignal, rows of
// `cols` floats), dx times the log-clamp's derivative (kOutDx, rows of
// n_in), or (kOutSumsq) y² added by fmaf to the Σy² partial q of thread
// (row r, slice p) over the chunk's columns j ≡ p (mod kSlices), j
// ascending, as gram_epilogue adds the quad's. The writes take a row's
// consecutive columns per warp.
template <int BM>
__device__ __forceinline__ void out_chunk(const float* src, int col0, int valid, int mode,
                                          const float* __restrict__ x, float* __restrict__ out,
                                          int cols, int n_in, int row0, int n_rows, float& q) {
  constexpr int S = tile_stride(BM);
  if (mode == kOutSumsq) {
    if (threadIdx.x >= kSlices * BM) return;
    const int r = threadIdx.x % BM;
    for (int j = static_cast<int>(threadIdx.x) / BM; j < valid; j += kSlices) {
      const float v = src[j * S + r];
      q = fmaf(v, v, q);
    }
    return;
  }
  for (int t = threadIdx.x; t < BM * kSlabN; t += blockDim.x) {
    const int j = t % kSlabN;
    const int r = t / kSlabN;
    const int row = row0 + r;
    if (j >= valid || row >= n_rows) continue;
    const float v = src[j * S + r];
    if (mode == kOutDx) {
      const size_t at = static_cast<size_t>(row) * n_in + col0 + j;
      out[at] = log_clamp_grad(x[at], col0 + j) * v;
    } else {
      out[static_cast<size_t>(row) * cols + col0 + j] = v;
    }
  }
}

// A 128-column chunk of the workspace's tiles (k rows col …) into the
// chunk buffer `dst`, by cp.async, each thread waiting for its own copies
// (the next op's barrier makes the chunk whole); the wait also lands the
// ring's slabs in flight.
template <int BM>
__device__ __forceinline__ void ws_load(const float* ws, int col, float* dst) {
  constexpr int S = tile_stride(BM);
  const float* src = ws + static_cast<size_t>(col) * S;
  for (int t = threadIdx.x; t < kSlabN * S / 4; t += kThreads) cp_async16(dst + 4 * t, src + 4 * t);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  cp_async_wait<0>();
}

// The chunk buffer `src` into the workspace's k rows col … col + 127.
template <int BM>
__device__ __forceinline__ void ws_store(const float* src, float* ws, int col) {
  constexpr int S = tile_stride(BM);
  float4* dst = reinterpret_cast<float4*>(ws + static_cast<size_t>(col) * S);
  for (int t = threadIdx.x; t < kSlabN * S / 4; t += kThreads)
    dst[t] = reinterpret_cast<const float4*>(src)[t];
}

// ---------------------------------------------------------------- kernel

// One OP_MM on the tensor cores at PF parts: the input chunk split or
// rounded into the A-chunk tile, then the products.
template <int BM, int PF>
__device__ __forceinline__ void op_mma(const int (&f)[kOpInts], const float* in,
                                       __nv_bfloat16* at, const uint32_t* __restrict__ frags,
                                       float* out) {
  to_a_chunk<BM, PF>(in, f[3], at);
  __syncthreads();
  const int tiles = ((f[13] + 15) & ~15) / 8;
  mm_mma<BM, PF>(at, f[3], frags + f[10], f[11], f[12], 16 * f[4], min(16 * f[5], tiles), out,
                 f[8], f[6] & kMMFirst);
}

// PA: the A-chunk tile's parts, the most any op of the program runs on
// the tensor cores (0: every product is fp32, on the CUDA cores; 1 bf16;
// 2 bf16x3). dx null: K2 or K1, a program without a backward. out: the
// quad (K2, K3), or K1's Σy² (out_cols 1) or signal (out_cols n_out
// floats a row); log_cols: the input's columns 0–2 are log-clamped.
template <int BM, int PA>
__global__ void __launch_bounds__(kThreads, 2)
fused_loglik_grad_gram_kernel(const float* __restrict__ x, float* __restrict__ quad,
                              float* __restrict__ dx, int n_rows, int out_cols, int log_cols,
                              const WideNet net_in) {
  using R = WideRing<BM>;
  using M = MaskBits<BM>;
  constexpr int S = tile_stride(BM);
  // member blockIdx.y: its operands, moved there once per CTA into a
  // shared copy, its rows of quad and dx; x is shared
  __shared__ WideNet net;
  if (threadIdx.x == 0) {
    net = net_in;
    to_member(net, blockIdx.y);
  }
  __syncthreads();
  const int n_in = net.n_in;
  const bool dense = n_in > kMaxIn;  // layer 0 an ordinary layer: no input tile
  quad += static_cast<size_t>(blockIdx.y) * n_rows * out_cols;
  if (dx != nullptr) dx += static_cast<size_t>(blockIdx.y) * n_rows * n_in;

  // shared memory: the ring, the A-chunk tile, the partials, the staged
  // w0 chunk (over the A-chunk tile where there is one) and the input
  // tile (neither where layer 0 is dense), CA, CB, P, Q, R, the mask bytes
  // (unless they lie in the workspace)
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* const at = reinterpret_cast<__nv_bfloat16*>(ring + R::kSlots * R::kFloats);
  float* const red = reinterpret_cast<float*>(at + PA * BM * kAStride);
  float* const w0s = PA > 0 ? reinterpret_cast<float*>(at) : red + kRedFloats;
  float* const xl = red + kRedFloats + (PA > 0 || dense ? 0 : kW0Floats);
  // buffer id → its tile: CA, CB, P, Q, R back to back after the input tile
  const int cols0 = net.cols[0], cols1 = net.cols[1];
  const int in_rows = dense ? 0 : kInRows;
  const auto buf = [&](int id) {
    return xl + S * (in_rows + (id >= kCB ? kSlabN : 0) + (id >= kP ? kSlabN : 0) +
                     (id >= kQ ? cols0 : 0) + (id >= kR ? cols1 : 0));
  };
  // this CTA's region of the workspace: its tiles, then the mask bits
  // where they lie there
  uint8_t* const wsb =
      net.ws == nullptr
          ? nullptr
          : net.ws + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * net.ws_cta_bytes;
  float* const wsf = reinterpret_cast<float*>(wsb);
  uint8_t* const mask = net.ws_masks ? wsb + 4LL * S * net.ws_cols
                                     : reinterpret_cast<uint8_t*>(buf(kR) + S * net.cols[2]);

  // the row tiles of a persistent grid (gridDim.x CTAs per member), one
  // each otherwise
  for (int tile = blockIdx.x; tile < net.n_tiles; tile += gridDim.x) {
    const int row0 = tile * BM;
    int g = 0;  // the fp32 stream's slab counter
    __syncthreads();  // the last tile's ops are done with every buffer
    if (!dense) load_input<BM>(x, n_rows, row0, n_in, n_in, log_cols != 0, xl);
    float q = 0.f;  // this thread's quad (K1: Σy²) partial
    float dxp[kMaxIn];
#pragma unroll
    for (int c = 0; c < kMaxIn; ++c) dxp[c] = 0.f;

    for (int pc = 0; pc < net.n_ops; ++pc) {
      int f[kOpInts];
#pragma unroll
      for (int k = 0; k < kOpInts / 4; ++k) {
        const int4 v = __ldg(net.prog + pc * (kOpInts / 4) + k);
        f[4 * k] = v.x;
        f[4 * k + 1] = v.y;
        f[4 * k + 2] = v.z;
        f[4 * k + 3] = v.w;
      }
      __syncthreads();  // the last op's outputs are complete, its inputs free
      switch (f[0]) {
        case kOpSkinny:  // κ, cols, valid, mask_col
          skinny_chunk<BM>(xl, net, f[1], f[2], f[3], buf(kCA),
                           f[4] < 0 ? nullptr : mask + f[4] * M::kColBytes, w0s);
          break;
        case kOpMM: {  // src, src_row, k, d0, d1, flags, dst, dst_col0, parts, frag, ksteps,
                       // kstep0, n
          const float* in = buf(f[1]) + f[2] * S;
          if constexpr (PA >= 1) {
            if (f[9] == 1) {
              op_mma<BM, 1>(f, in, at, net.frags, buf(f[7]));
              break;
            }
          }
          if constexpr (PA == 2) {
            if (f[9] == 2) {
              op_mma<BM, 2>(f, in, at, net.frags, buf(f[7]));
              break;
            }
          }
          mm_f32<BM, R>(in, f[3], f[13], f[6] & kMMSplit, buf(f[7]), f[8], f[4], f[5],
                        f[6] & kMMFirst, net.slabs, net.total, ring, g);
          break;
        }
        case kOpFin:  // dst, cols, valid, bias, split, mask_col, kind
          finish<BM>(buf(f[1]), f[2], f[3], f[7] == kFinMasked ? nullptr : net.bias + f[4],
                     f[5], f[6] < 0 ? nullptr : mask + f[6] * M::kColBytes, f[7] == kFinLinear);
          break;
        case kOpGram:  // h, h_col0, e, e_col0, H, j0, cols, u
          gram_epilogue<BM>(f[1] < 0 ? nullptr : buf(f[1]), f[2], buf(f[3]), f[4], f[5], f[6],
                            f[7], net.bias + f[8], xl, net, q);
          break;
        case kOpQuadWrite:
          rows_write<BM>(q, red, quad, row0, n_rows);
          break;
        case kOpDx:  // src, src_row, valid, w0_col
          dx_partials<BM>(buf(f[1]) + f[2] * S, f[3], f[4], net, dxp, w0s);
          break;
        case kOpDxWrite:
          dx_write<BM>(dxp, x, dx, red, n_in, row0, n_rows);
          break;
        case kOpRing:
          start_ring<BM, R>(ring, net.slabs, net.total);
          break;
        case kOpLoad:  // col, dst
          ws_load<BM>(wsf, f[1], buf(f[2]));
          break;
        case kOpStore:  // src, col
          ws_store<BM>(buf(f[1]), wsf, f[2]);
          break;
        case kOpInput:  // κ, dst
          input_chunk<BM>(x, n_rows, row0, n_in, f[1], log_cols != 0, buf(f[2]));
          break;
        case kOpOut:  // src, col0, valid, mode
          out_chunk<BM>(buf(f[1]), f[2], f[3], f[4], x, f[4] == kOutDx ? dx : quad, out_cols,
                        n_in, row0, n_rows, q);
          break;
        default:
          break;
      }
    }
  }
}

// Dynamic shared memory of one block (ops/kernels/wide.py::plan_bytes
// mirrors it, with the static copy of the net).
template <int BM, int PA>
size_t wide_smem_bytes(const int (&cols)[3], int mask_bytes, bool dense) {
  using R = WideRing<BM>;
  const size_t held = static_cast<size_t>(cols[0]) + cols[1] + cols[2];
  const size_t floats = R::kSlots * R::kFloats + kRedFloats +
                        (PA > 0 || dense ? 0 : kW0Floats) +
                        static_cast<size_t>(tile_stride(BM)) *
                            ((dense ? 0 : kInRows) + 2 * kSlabN + held);
  return 4 * floats + static_cast<size_t>(2 * PA * BM * kAStride) + mask_bytes;
}

// max_ctas: where the plan uses the workspace, the CTAs per member it was
// sized for (the persistent grid's width); else 0, one CTA per row tile.
template <int BM, int PA>
cudaError_t launch_wide(const float* x, float* quad, float* dx, int n_rows, int out_cols,
                        int log_cols, int n_members, WideNet net, int mask_cols,
                        int stream_rows, int max_ctas, cudaStream_t s) {
  using R = WideRing<BM>;
  const int mask_bytes = MaskBits<BM>::kColBytes * mask_cols;
  const size_t smem =
      wide_smem_bytes<BM, PA>(net.cols, net.ws_masks ? 0 : mask_bytes, net.n_in > kMaxIn);
  if (smem + sizeof(WideNet) > static_cast<size_t>(kMaxSmem) || stream_rows % R::kDepth != 0) {
    return cudaErrorInvalidValue;
  }
  net.total = stream_rows / R::kDepth;
  net.n_tiles = (n_rows + BM - 1) / BM;
  net.ws_cta_bytes = ws_cta_bytes<BM>(net.ws_cols, net.ws_masks ? mask_bytes : 0);
  int grid_x = net.n_tiles;
  if (net.ws_cols > 0 || net.ws_masks) {
    if (net.ws == nullptr || max_ctas < 1) return cudaErrorInvalidValue;
    grid_x = grid_x < max_ctas ? grid_x : max_ctas;
  }
  auto* kernel = fused_loglik_grad_gram_kernel<BM, PA>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(grid_x, n_members), kThreads, smem, s>>>(x, quad, dx, n_rows, out_cols,
                                                         log_cols, net);
  return cudaGetLastError();
}

int wide_entry(const float* x, float* quad, float* dx, int n_rows, int out_cols, int log_cols,
               int n_layers, const int* widths, const void* const* ptrs,
               const long long* strides, int n_members, int a_parts, int tile_rows, int p_cols,
               int q_cols, int r_cols, int mask_cols, int stream_rows, int n_ops, int ws_cols,
               int ws_masks, int max_ctas, void* workspace, void* stream) {
  if (n_rows <= 0 || !members_ok(n_members) || n_layers < 1 || widths[0] < 1 ||
      out_cols < 1 || a_parts < 0 || a_parts > 2 || n_ops < 1 || p_cols < 0 ||
      q_cols < 0 || r_cols < 0 || mask_cols < 0 || stream_rows < 0 || ws_cols < 0 ||
      max_ctas < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  WideNet net{};
  net.n_in = widths[0];
  net.n1 = widths[1];
  net.n_ops = n_ops;
  net.cols[0] = p_cols;
  net.cols[1] = q_cols;
  net.cols[2] = r_cols;
  net.ws_cols = ws_cols;
  net.ws_masks = ws_masks != 0;
  net.ws = static_cast<uint8_t*>(workspace);
  int k = 0;
  auto next = [&](long long& stride) {
    stride = strides[k];
    return ptrs[k++];
  };
  net.w0 = static_cast<const float*>(next(net.s_w0));
  net.b0 = static_cast<const float*>(next(net.s_b0));
  net.bias = static_cast<const float*>(next(net.s_bias));
  net.slabs = static_cast<const float*>(next(net.s_slabs));
  net.prog = static_cast<const int4*>(next(net.s_prog));
  net.frags = static_cast<const uint32_t*>(next(net.s_frags));
  if (a_parts > 0 && net.frags == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define T21_WIDE(BM, PA)                                                                     \
  err = launch_wide<BM, PA>(x, quad, dx, n_rows, out_cols, log_cols, n_members, net,        \
                            mask_cols, stream_rows, max_ctas, s)
  if (tile_rows == 32) {
    if (a_parts == 0) T21_WIDE(32, 0);
    else if (a_parts == 1) T21_WIDE(32, 1);
    else T21_WIDE(32, 2);
  } else if (tile_rows == 16) {
    if (a_parts == 0) T21_WIDE(16, 0);
    else if (a_parts == 1) T21_WIDE(16, 1);
    else T21_WIDE(16, 2);
  }
#undef T21_WIDE
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The message of a cudaError_t code, for every kernel of the library.
const char* t21_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K3. ptrs, in order: w0, b0 (the skinny layer, exact fp32), the padded
// biases (trunk layers 1 … n_layers−1, then u), the fp32 stream, the op
// program (int32, 16 per op; ops/kernels/wide.py::wide_plan), the
// fragment buffer (null where no op runs on the tensor cores). strides:
// each operand's member stride in bytes, parallel to ptrs; n_members
// (1 … 65,535) networks run on the same x, member m writing
// quad[m·n_rows …] and dx[m·n_rows·n_in …]. a_parts: the A-chunk tile's
// parts (0, 1 bf16, 2 bf16x3: the most any op takes); tile_rows: 32 or
// 16; p_cols, q_cols, r_cols: the held tiles' k rows; mask_cols: the
// activations' padded columns whose masks are kept; stream_rows: the fp32
// stream's k rows; n_ops: the program's length; ws_cols: the k rows of a
// CTA's workspace tiles; ws_masks: the mask bits lie in the workspace;
// max_ctas: where either does, the persistent grid's CTAs per member,
// and `workspace` holds max_ctas · n_members regions of ws_cta_bytes.
// widths: n_in and the trunk's widths (any depth; the program carries
// the layers). Launches on `stream`, allocates nothing and does not
// synchronise; returns the cudaError_t of the launch.
int k3_fused_loglik_grad_gram(const float* x, float* quad, float* dx, int n_rows, int n_layers,
                              const int* widths, const void* const* ptrs,
                              const long long* strides, int n_members, int a_parts,
                              int tile_rows, int p_cols, int q_cols, int r_cols, int mask_cols,
                              int stream_rows, int n_ops, int ws_cols, int ws_masks,
                              int max_ctas, void* workspace, void* stream) {
  if (dx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return wide_entry(x, quad, dx, n_rows, 1, 1, n_layers, widths, ptrs, strides, n_members,
                    a_parts, tile_rows, p_cols, q_cols, r_cols, mask_cols, stream_rows, n_ops,
                    ws_cols, ws_masks, max_ctas, workspace, stream);
}

// K2: the same, from a value-only program (no backward ops, no masks),
// writing quad alone.
int k2_fused_loglik_gram_wide(const float* x, float* quad, int n_rows, int n_layers,
                              const int* widths, const void* const* ptrs,
                              const long long* strides, int n_members, int a_parts,
                              int tile_rows, int p_cols, int q_cols, int r_cols, int mask_cols,
                              int stream_rows, int n_ops, int ws_cols, int ws_masks,
                              int max_ctas, void* workspace, void* stream) {
  return wide_entry(x, quad, nullptr, n_rows, 1, 1, n_layers, widths, ptrs, strides, n_members,
                    a_parts, tile_rows, p_cols, q_cols, r_cols, mask_cols, stream_rows, n_ops,
                    ws_cols, ws_masks, max_ctas, workspace, stream);
}

// K1 on the same program: a value-only program whose head is the network's
// linear output layer (ops/kernels/wide.py::wide_plan with n_out), writing
// per row the signal out[row·n_out …] (reduce 0; n_out = widths[n_layers])
// or its Σy² out[row] (reduce 1, the program's OP_OUT mode and its
// OP_QUAD_WRITE). widths: n_in and every layer's width, the output's
// last; log_clamp: log10/clamp of input columns 0–2. ptrs as K3's, the
// biases layers 1 … (0 … where layer 0 is dense) then the output's; member
// m writes out[m·n_rows·(reduce ? 1 : n_out) …].
int k1_fused_mlp_wide(const float* x, float* out, int n_rows, int n_layers, const int* widths,
                      const void* const* ptrs, const long long* strides, int n_members,
                      int a_parts, int tile_rows, int p_cols, int q_cols, int r_cols,
                      int mask_cols, int stream_rows, int n_ops, int ws_cols, int ws_masks,
                      int max_ctas, void* workspace, int log_clamp, int reduce, void* stream) {
  if (n_layers < 1 || mask_cols != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int out_cols = reduce ? 1 : widths[n_layers];
  return wide_entry(x, out, nullptr, n_rows, out_cols, log_clamp, n_layers, widths, ptrs,
                    strides, n_members, a_parts, tile_rows, p_cols, q_cols, r_cols, mask_cols,
                    stream_rows, n_ops, ws_cols, ws_masks, max_ctas, workspace, stream);
}

}  // extern "C"
