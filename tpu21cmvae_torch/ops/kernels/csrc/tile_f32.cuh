// Register-tiled fp32 device code shared by the port's CUDA-core kernels
// (K1 fused_mlp.cu, K2 fused_loglik_gram.cu, K3 at fp32
// fused_loglik_grad_gram_f32.cu, and the backward of fused_gram_mma.cu's
// reverse mode): the tile geometry, the cp.async
// weight-slab ring, the input tile, the skinny first layer, one dense
// layer with a caller-supplied epilogue, the fixed-order per-row
// reduction, and (K3) ReLU masks kept as bits.
//
// A CTA of kThreads = 256 threads owns a tile of BM rows (BM in {64, 32,
// 16, 8}, a template parameter). Activations live in shared memory
// k-major, element (column k, row r) at k·S + r with S = tile_stride(BM),
// so one thread's TM = BM/8 rows of a column are contiguous.
//
// A dense layer walks its output columns in chunks of kSlabN = 128. For a
// chunk, thread (ty, tx) holds TM × 4 accumulators: rows ty·TM … ty·TM+TM−1
// and columns tx·4 … tx·4+3, ty in 0..7, tx in 0..31. Warp w covers row
// groups 4·(w & 1) … +3 and column groups 8·(w >> 1) … +7: per k it reads
// its rows as TM/4 float4s (four distinct addresses across the warp) and
// its 4 weights as one float4 (eight distinct, 128 contiguous bytes), each
// one shared-memory wavefront, for TM·4 FMAs.
//
// Weights reach shared memory as slabs of R::kDepth × kSlabN fp32 values
// (k-major) through a ring of R::kSlots slabs, R a ring geometry by tile
// height (Ring<BM> for K1 and K2, GradRing<BM> for K3). A warp reads
// only its column quarter of a slab, which it shares with one other warp:
// each such pair copies its quarter with 16-byte cp.asyncs and syncs on a
// named barrier of its own 64 threads, so within a layer no warp waits for
// more than its partner; one CTA barrier per layer orders the activation
// tiles. The wrapper packs every layer the kernel streams once per model
// (ops/kernels/_common.py::pack_slabs): W zero-padded to (padk(K),
// 128·chunks), chunk by chunk, each chunk's (padk(K), 128) block k-major,
// all layers back to back in one buffer. padk pads to kPadK = 32, which
// every slab depth divides, so slab g of the whole network sits at
// g·depth·128 floats for every tile height, and the ring runs across chunk
// and layer boundaries. Each layer's bias is zero-padded to 128·chunks.
//
// Arithmetic: every output element is Σ_k a[r, k]·W[k, j], k ascending, in
// one fp32 accumulator by fmaf, then the epilogue; no split-k, no TF32,
// nothing summed across threads. Padded columns have zero weights and
// bias, so a hidden layer writes 0 there and the next layer's padded k
// rows read 0; a warp whose 32 columns of a chunk all lie past the layer's
// width skips that chunk. A row's result does not depend on the other rows
// of its tile, nor on the tile height or the slab depth.

#pragma once

#include <cstdint>

#include "trunk.cuh"

namespace {

constexpr int kSlabN = 128;           // columns per chunk: 32 groups of 4
constexpr int kPadK = 32;             // fan-ins are padded to a multiple of every slab depth
constexpr int kRedFloats = kThreads;  // per-row partial sums

// The slab ring by tile height. Every slab has a fixed cost (a pair
// barrier, a fresh load latency, the copies' issue), so deeper slabs cost
// less; at 64 rows one CTA fills an SM and 32-deep slabs in three slots
// fit beside the flagship's tiles; at 32 rows two CTAs share an SM and
// 16-deep slabs in two slots keep both within its shared memory (PERF.md).
template <int BM>
struct Ring {
  static constexpr int kDepth = BM == 64 ? 32 : BM == 32 ? 16 : 8;  // k rows per slab
  static constexpr int kSlots = BM == 32 ? 2 : 3;
  static constexpr int kFloats = kDepth * kSlabN;
  static_assert(kDepth % 8 == 0, "a pair's 64 threads copy whole 16-byte pieces");
  static_assert(kPadK % kDepth == 0, "the padded fan-in holds whole slabs");
};

// K3's ring: its ReLU masks share the CTA's shared memory, so at 64 rows
// the flagship keeps two slots of 32-deep slabs (depth costs more than
// slots: PERF.md); the other heights keep Ring's geometry.
template <int BM>
struct GradRing {
  static constexpr int kDepth = Ring<BM>::kDepth;
  static constexpr int kSlots = BM == 64 ? 2 : Ring<BM>::kSlots;
  static constexpr int kFloats = kDepth * kSlabN;
};

__host__ __device__ constexpr int padk(int n) { return (n + kPadK - 1) / kPadK * kPadK; }
__host__ __device__ constexpr int chunks(int n) { return (n + kSlabN - 1) / kSlabN; }

// Row stride of a k-major activation tile. BM = 64, 32: no padding (the
// epilogue's float4 stores meet at most 2-way bank conflicts, the loads
// none); BM = 16 (float2) and 8 (scalar): padded so the stores meet none.
__host__ __device__ constexpr int tile_stride(int bm) {
  return bm == 16 ? 18 : bm == 8 ? 9 : bm;
}

// Dynamic shared memory of one CTA: the input tile (in_rows k rows), two
// ping-pong activation buffers of buf_cols k rows, the slab ring and the
// per-row partials. ops/kernels/_common.py::f32_tile_bytes mirrors it.
template <int BM, class R = Ring<BM>>
size_t tile_smem_bytes(int in_rows, int buf_cols) {
  return sizeof(float) * (static_cast<size_t>(tile_stride(BM)) * (in_rows + 2 * buf_cols) +
                          R::kSlots * R::kFloats + kRedFloats);
}

// Slabs in the stream of layers (k_i → n_i) at tile height BM.
template <int BM, class R = Ring<BM>>
int stream_slabs(const int* k, const int* n, int layers) {
  int total = 0;
  for (int i = 0; i < layers; ++i) total += chunks(n[i]) * (padk(k[i]) / R::kDepth);
  return total;
}

// This thread's place in a chunk: its first row in the tile, its first
// column in the chunk, and its warp's column quarter (32 columns).
template <int BM>
struct TileThread {
  static constexpr int TM = BM / 8;
  int row, col, quarter;
  __device__ TileThread() {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    quarter = warp >> 1;
    row = ((warp & 1) * 4 + (lane & 3)) * TM;
    col = (quarter * 8 + (lane >> 2)) * 4;
  }
};

template <int TM>
__device__ __forceinline__ void load_rows(float (&a)[TM], const float* p) {
  if constexpr (TM % 4 == 0) {
#pragma unroll
    for (int q = 0; q < TM / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      a[4 * q] = v.x;
      a[4 * q + 1] = v.y;
      a[4 * q + 2] = v.z;
      a[4 * q + 3] = v.w;
    }
  } else if constexpr (TM == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x;
    a[1] = v.y;
  } else {
    a[0] = p[0];
  }
}

template <int TM>
__device__ __forceinline__ void store_rows(float* p, const float (&a)[TM]) {
  if constexpr (TM % 4 == 0) {
#pragma unroll
    for (int q = 0; q < TM / 4; ++q)
      reinterpret_cast<float4*>(p)[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  } else if constexpr (TM == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
  } else {
    p[0] = a[0];
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t at = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at), "l"(src) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This warp pair's column quarter of slab g into its ring slot: each k row
// of the quarter is 128 contiguous bytes, eight 16-byte copies spread over
// the pair's 64 threads; one commit group (an empty one past the end keeps
// every thread's group count in step).
template <int BM, class R = Ring<BM>>
__device__ __forceinline__ void issue_slab(float* ring, const float* __restrict__ slabs, int g,
                                           int total) {
  if (g < total) {
    const int quarter = threadIdx.x >> 6;
    float* dst = ring + (g % R::kSlots) * R::kFloats + quarter * 32;
    const float* src = slabs + static_cast<size_t>(g) * R::kFloats + quarter * 32;
#pragma unroll
    for (int t = threadIdx.x & 63; t < R::kDepth * 8; t += 64) {
      const int at = (t >> 3) * kSlabN + (t & 7) * 4;
      cp_async16(dst + at, src + at);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The barrier of this thread's warp pair (the two warps that read one
// column quarter): named barrier 1 + quarter, 64 threads.
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + (threadIdx.x >> 6)) : "memory");
}

// The ring's first kSlots − 1 slabs; call before the input tile so the
// copies overlap it.
template <int BM, class R = Ring<BM>>
__device__ __forceinline__ void start_ring(float* ring, const float* __restrict__ slabs,
                                           int total) {
#pragma unroll
  for (int g = 0; g < R::kSlots - 1; ++g) issue_slab<BM, R>(ring, slabs, g, total);
}

// The tile's input rows x[row0 .. row0 + BM) (row-major, n_in columns)
// into the k-major tile xl of in_rows ≥ n_in k rows, log-clamped if asked;
// rows past the batch and k rows past n_in are zero.
template <int BM>
__device__ __forceinline__ void load_input(const float* __restrict__ x, int n_rows, int row0,
                                           int n_in, int in_rows, bool log_cols, float* xl) {
  constexpr int S = tile_stride(BM);
  for (int t = threadIdx.x; t < BM * in_rows; t += blockDim.x) {
    const int r = t / in_rows;
    const int c = t % in_rows;
    const int row = row0 + r;
    float v = 0.f;
    if (row < n_rows && c < n_in) {
      v = x[static_cast<size_t>(row) * n_in + c];
      if (log_cols) v = log_clamp(v, c);
    }
    xl[c * S + r] = v;
  }
}

// Σ_c xl[c, r] · w0[c, j], then + b0[j]: the skinny first layer (fan-in
// ≤ kMaxIn) in exact fp32, in the Pallas kernels' order (trunk.cuh,
// skinny_dot).
template <int BM>
__device__ __forceinline__ float skinny_value(const float* xl, int n_in,
                                              const float* __restrict__ w0,
                                              const float* __restrict__ b0, int n_out, int r,
                                              int j) {
  constexpr int S = tile_stride(BM);
  return skinny_dot(xl + r, S, n_in, w0 + j, n_out, __ldg(b0 + j));
}

// The skinny layer as a hidden layer: out[j, r] = relu(skinny_value) for
// j < n_out, 0 for n_out ≤ j < padk(n_out).
template <int BM>
__device__ __forceinline__ void skinny_hidden(const float* xl, int n_in,
                                              const float* __restrict__ w0,
                                              const float* __restrict__ b0, int n_out,
                                              float* out) {
  constexpr int S = tile_stride(BM);
  for (int t = threadIdx.x; t < BM * padk(n_out); t += blockDim.x) {
    const int r = t % BM;
    const int j = t / BM;
    out[j * S + r] = j < n_out ? relu(skinny_value<BM>(xl, n_in, w0, b0, n_out, r, j)) : 0.f;
  }
}

// One dense layer of the stream over the tile: for each 128-column chunk,
// acc[i][q] = Σ_k in[k, row + i] · W[k, c0 + q] over k < padk(k_in), k
// ascending, then epi(c0, acc) with c0 this thread's first column in the
// layer. `g` is the stream's slab counter: slab g is in the ring (or in
// flight) when a chunk's loop reaches it, and this layer advances g by its
// slab count. The layer starts with a CTA barrier: `in` is complete, and
// no warp still reads the tile the epilogue will write. Every thread runs
// every barrier; a warp whose columns of a chunk all lie at or past n
// skips the products and the epilogue.
template <int BM, class R = Ring<BM>, class Epi>
__device__ __forceinline__ void tile_layer(const float* in, int k_in, int n,
                                           const float* __restrict__ slabs, int total,
                                           float* ring, int& g, Epi&& epi) {
  constexpr int TM = BM / 8;
  constexpr int S = tile_stride(BM);
  const TileThread<BM> t;
  const int steps = padk(k_in) / R::kDepth;
  const float* a_base = in + t.row;
  __syncthreads();
  for (int c = 0; c < chunks(n); ++c) {
    const bool active = c * kSlabN + t.quarter * 32 < n;  // warp-uniform
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    for (int s = 0; s < steps; ++s, ++g) {
      cp_async_wait<R::kSlots - 2>();  // slab g has landed (this thread's copies)
      pair_sync();                     // … the pair's; its part of slot g − 1 is free
      issue_slab<BM, R>(ring, slabs, g + R::kSlots - 1, total);
      if (active) {
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
    if (active) epi(c * kSlabN + t.col, acc);
  }
}

// The hidden-layer epilogue: out[c0 + q, row + i] = relu(acc + bias) for
// the columns below padk(n) (0 on the padded ones: zero weights and bias).
template <int BM>
__device__ __forceinline__ void relu_store(float* out, const float* __restrict__ bias, int n,
                                           int c0, const float (&acc)[BM / 8][4]) {
  constexpr int TM = BM / 8;
  constexpr int S = tile_stride(BM);
  if (c0 >= padk(n)) return;  // a thread's 4 columns are all below or all past padk(n)
  const TileThread<BM> t;
  const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + c0));
  const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float v[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) v[i] = relu(acc[i][q] + b[q]);
    store_rows<TM>(out + (c0 + q) * S + t.row, v);
  }
}

// ReLU masks as bits (K3): one bit per (row, column) of a hidden
// activation, set where the fp32 pre-activation is > 0 (false for NaN).
// A column's bits are kColBytes bytes; each warp half (warp & 1) owns the
// 4·TM rows its lanes hold, kHalfBytes bytes of them, bit (lane & 3)·TM + i
// for row t.row + i. From 16 rows up that is bit r for row r of the tile;
// at 8 rows a half's 4 rows take the low nibble of its byte.
template <int BM>
struct MaskBits {
  static constexpr int TM = BM / 8;
  static constexpr int kHalfBytes = TM >= 2 ? TM / 2 : 1;
  static constexpr int kColBytes = 2 * kHalfBytes;     // 8, 4, 2, 2 at 64, 32, 16, 8 rows
  static constexpr int kRowsPerByte = BM / kColBytes;  // 8, 8, 8, 4
};

template <int BYTES>
__device__ __forceinline__ void store_bits(uint8_t* at, unsigned bits) {
  if constexpr (BYTES == 4) {
    *reinterpret_cast<uint32_t*>(at) = bits;
  } else if constexpr (BYTES == 2) {
    *reinterpret_cast<uint16_t*>(at) = static_cast<uint16_t>(bits);
  } else {
    *at = static_cast<uint8_t>(bits);
  }
}

template <int BYTES>
__device__ __forceinline__ unsigned load_bits(const uint8_t* at) {
  if constexpr (BYTES == 4) {
    return *reinterpret_cast<const uint32_t*>(at);
  } else if constexpr (BYTES == 2) {
    return *reinterpret_cast<const uint16_t*>(at);
  } else {
    return *at;
  }
}

// skinny_hidden that also writes the activation's mask: one thread per
// (column, mask byte), the byte's rows in order.
template <int BM>
__device__ __forceinline__ void skinny_hidden_masked(const float* xl, int n_in,
                                                     const float* __restrict__ w0,
                                                     const float* __restrict__ b0, int n_out,
                                                     float* out, uint8_t* mask) {
  using M = MaskBits<BM>;
  constexpr int S = tile_stride(BM);
  for (int t = threadIdx.x; t < M::kColBytes * padk(n_out); t += blockDim.x) {
    const int byte = t % M::kColBytes;
    const int j = t / M::kColBytes;
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < M::kRowsPerByte; ++i) {
      const int r = byte * M::kRowsPerByte + i;
      const float v = j < n_out ? skinny_value<BM>(xl, n_in, w0, b0, n_out, r, j) : 0.f;
      bits |= (v > 0.f ? 1u : 0u) << i;
      out[j * S + r] = relu(v);
    }
    mask[t] = static_cast<uint8_t>(bits);
  }
}

// relu_store that also writes the activation's mask where `mask` is not
// null: each thread's TM bits of a column are gathered across the four
// lanes that share the column (lane & 3) by two shuffles, and lane q of
// them stores column c0 + q's bits of this warp half.
template <int BM>
__device__ __forceinline__ void relu_mask_store(float* out, uint8_t* mask,
                                                const float* __restrict__ bias, int n, int c0,
                                                const float (&acc)[BM / 8][4]) {
  using M = MaskBits<BM>;
  constexpr int TM = BM / 8;
  constexpr int S = tile_stride(BM);
  if (c0 >= padk(n)) return;  // the four lanes of a column group leave together
  const TileThread<BM> t;
  const int lane = threadIdx.x & 31;
  const int mine = lane & 3;
  const unsigned group = 0xFu << (lane & ~3);
  const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + c0));
  const float b[4] = {b4.x, b4.y, b4.z, b4.w};
  unsigned word = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float v[TM];
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float s = acc[i][q] + b[q];
      bits |= (s > 0.f ? 1u : 0u) << i;
      v[i] = relu(s);
    }
    store_rows<TM>(out + (c0 + q) * S + t.row, v);
    if (mask != nullptr) {  // uniform over the CTA
      bits <<= mine * TM;
      bits |= __shfl_xor_sync(group, bits, 1);
      bits |= __shfl_xor_sync(group, bits, 2);
      if (q == mine) word = bits;
    }
  }
  if (mask != nullptr)
    store_bits<M::kHalfBytes>(mask + (c0 + mine) * M::kColBytes +
                                  ((threadIdx.x >> 5) & 1) * M::kHalfBytes,
                              word);
}

// The backward's epilogue: out[c0 + q, row + i] = acc where the mask bit of
// that (row, column) is set, else 0, for the columns below padk(n). A
// column's mask bytes start every COL bytes: MaskBits' kColBytes as the
// forward here writes them, or 4 where a column is one 32-bit word with
// bit r for row r (fused_gram_mma.cu's tensor-core forward; from 16 rows
// up MaskBits puts the same bits in its first kColBytes bytes).
template <int BM, int COL = MaskBits<BM>::kColBytes>
__device__ __forceinline__ void masked_store(float* out, const uint8_t* mask, int n, int c0,
                                             const float (&acc)[BM / 8][4]) {
  using M = MaskBits<BM>;
  constexpr int TM = BM / 8;
  constexpr int S = tile_stride(BM);
  static_assert(COL >= M::kColBytes, "a column's bytes do not overlap the next column's");
  if (c0 >= padk(n)) return;
  const TileThread<BM> t;
  const int shift = (threadIdx.x & 3) * TM;
  const uint8_t* at = mask + c0 * COL + ((threadIdx.x >> 5) & 1) * M::kHalfBytes;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned bits = load_bits<M::kHalfBytes>(at + q * COL) >> shift;
    float v[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) v[i] = (bits >> i) & 1u ? acc[i][q] : 0.f;
    store_rows<TM>(out + (c0 + q) * S + t.row, v);
  }
}

// out[row0 + r] = Σ of the per-thread partials part[i] of row r = t.row +
// i: across the 8 lanes that share a row (lane bits 2-4) by shuffles, then
// across the 4 column quarters through `red` in quarter order. Fixed
// order, so the result is deterministic and independent of the batch.
template <int BM>
__device__ __forceinline__ void reduce_rows(const float (&part)[BM / 8], float* red,
                                            float* __restrict__ out, int row0, int n_rows) {
  constexpr int TM = BM / 8;
  const TileThread<BM> t;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float s = part[i];
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if ((lane >> 2) == 0) red[t.quarter * BM + t.row + i] = s;
  }
  __syncthreads();
  if (threadIdx.x < BM && row0 + static_cast<int>(threadIdx.x) < n_rows) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) s += red[q * BM + threadIdx.x];
    out[row0 + threadIdx.x] = s;
  }
}

}  // namespace
