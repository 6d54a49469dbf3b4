// Tensor-core device code shared by the port's bf16-tier kernels (K1
// fused_mlp_mma.cu; K2 and K3 fused_gram_mma.cu; the backward of K3
// fused_gram_mixed.cu): the ldmatrix and mma.sync wrappers, the packed
// B-fragment loads, the split-once stores into a layer's bf16 input tile,
// the skinny first layer, and one dense layer on the tensor cores with a
// caller-supplied epilogue.
//
// Arithmetic (see fused_mlp_mma.cu): bf16x3 is hi(a)·w_hi + hi(a)·w_lo +
// lo(a)·w_hi with hi(x) = bits(x) & 0xFFFF0000 and lo(x) = bf16_rn(x −
// hi(x)); bf16 is bf16_rn(a)·bf16_rn(w). Every product is of bf16 values
// and exact in fp32. Each k-step's products are summed by the mma from
// zero and added to the running fp32 sum by an IEEE add, because the
// tensor cores' own accumulation does not round to nearest (PERF.md).
//
// Tiles: a layer's input is a row-major bf16 tile of MT·16 rows with a
// row stride of `stride` elements (a multiple of 8, ≥ the widest padded
// width + 8, so ldmatrix's eight 16-byte rows fall in eight bank
// groups); at bf16x3 the lo tile sits tile_elems elements after the hi
// tile. Widths are padded to multiples of 16 with zero weights, so padded
// columns come out 0 and no k-step reads unwritten shared memory.

#pragma once

#include <cstdint>

#include "trunk.cuh"

namespace {

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kNTiles = 4;  // n8 tiles a warp carries at once

__device__ __forceinline__ int pad16(int n) { return (n + 15) & ~15; }

// The tile row of this lane's accumulator pair (mt, h): rows g and g + 8
// of m tile mt, g = lane / 4.
__device__ __forceinline__ int mma_row(int mt, int h) {
  return mt * 16 + h * 8 + ((threadIdx.x & 31) >> 2);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t at = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(at));
}

// d += a · b on the tensor cores: a 16×16 (row), b 16×8 (col), fp32 d.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One lane's B fragment words: (b0, b1) of w_hi, then of w_lo at bf16x3.
template <int PARTS>
__device__ __forceinline__ void load_b(uint32_t (&b)[2 * PARTS], const uint32_t* p) {
  if constexpr (PARTS == 2) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    b[0] = v.x;
    b[1] = v.y;
    b[2] = v.z;
    b[3] = v.w;
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    b[0] = v.x;
    b[1] = v.y;
  }
}

// An activation into a layer's input tile(s), split (bf16x3) or rounded
// (bf16) once: hi at tile[at], lo at tile[at + tile_elems].
template <int PARTS>
__device__ __forceinline__ void store_one(__nv_bfloat16* tile, int tile_elems, int at, float v) {
  if constexpr (PARTS == 2) {
    const float h = hi_part(v);
    tile[at] = __float2bfloat16_rn(h);
    tile[at + tile_elems] = __float2bfloat16_rn(v - h);
  } else {
    tile[at] = __float2bfloat16_rn(v);
  }
}

// Two neighbouring columns at once (at even).
template <int PARTS>
__device__ __forceinline__ void store_pair(__nv_bfloat16* tile, int tile_elems, int at, float v0,
                                           float v1) {
  if constexpr (PARTS == 2) {
    const float h0 = hi_part(v0);
    const float h1 = hi_part(v1);
    *reinterpret_cast<__nv_bfloat162*>(tile + at) = __floats2bfloat162_rn(h0, h1);
    *reinterpret_cast<__nv_bfloat162*>(tile + at + tile_elems) =
        __floats2bfloat162_rn(v0 - h0, v1 - h1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(tile + at) = __floats2bfloat162_rn(v0, v1);
  }
}

// The skinny first layer, exact fp32 in the Pallas kernels' order
// (trunk.cuh, skinny_dot), then ReLU, from the fp32 input tile xl (rows ×
// n_in, row-major): store(r, j, v) for every row r and every column j <
// pad16(n_out), v = 0 on the padded columns.
template <class Store>
__device__ __forceinline__ void skinny_layer(const float* xl, int rows, int n_in,
                                             const float* __restrict__ w0,
                                             const float* __restrict__ b0, int n_out,
                                             Store&& store) {
  const int np = pad16(n_out);
  for (int t = threadIdx.x; t < rows * np; t += blockDim.x) {
    const int r = t / np;
    const int j = t % np;
    float v = 0.f;
    if (j < n_out) v = relu(skinny_dot(xl + r * n_in, 1, n_in, w0 + j, n_out, __ldg(b0 + j)));
    store(r, j, v);
  }
}

// One tensor-core layer over this warp's share of the n8 output tiles:
// acc = in @ W over the in tile's kp columns, for MT m16 tiles of rows,
// from the packed B fragments w (ops/kernels/fused_mlp.py::
// pack_mma_operands) of a layer n columns wide. For each n8 tile it calls
// epi(col, acc) once, col = the first of this lane's two columns (col,
// col + 1) and acc[mt] = {(row mma_row(mt, 0): col, col + 1), (row
// mma_row(mt, 1): col, col + 1)}. The warps split the tiles evenly and
// carry up to kNTiles of them at once, so one ldmatrix feeds kNTiles·PARTS
// (+1 at bf16x3) mmas; the next k-step's fragments are loaded before this
// step's mmas.
template <int PARTS, int MT, class Epi>
__device__ __forceinline__ void mma_layer(const __nv_bfloat16* in, int kp,
                                          const uint32_t* __restrict__ w, int n, int stride,
                                          int tile_elems, Epi&& epi) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tig = lane & 3;
  const int tiles = pad16(n) / 8;
  const int ksteps = kp / 16;
  const int t_begin = warp * tiles / kMmaWarps;
  const int mine = (warp + 1) * tiles / kMmaWarps - t_begin;
  const int chunks = (mine + kNTiles - 1) / kNTiles;
  const size_t tile_words = static_cast<size_t>(ksteps) * 32 * 2 * PARTS;  // one n8 tile
  constexpr int kstep_words = 32 * 2 * PARTS;
  // this lane's ldmatrix row: rows 0-15 of an m tile, k columns 0-7 or 8-15
  const __nv_bfloat16* a_row = in + (lane & 15) * stride + (lane >> 4) * 8;

  for (int c = 0; c < chunks; ++c) {
    const int t0 = t_begin + c * mine / chunks;
    const int cnt = t_begin + (c + 1) * mine / chunks - t0;
    const uint32_t* wt = w + static_cast<size_t>(t0) * tile_words + lane * 2 * PARTS;
    float acc[kNTiles][MT][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][mt][q] = 0.f;

    uint32_t bc[kNTiles][2 * PARTS];
    uint32_t bn[kNTiles][2 * PARTS];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
      if (j < cnt) load_b<PARTS>(bc[j], wt + j * tile_words);

    for (int s = 0; s < ksteps; ++s) {
      if (s + 1 < ksteps) {
#pragma unroll
        for (int j = 0; j < kNTiles; ++j)
          if (j < cnt) load_b<PARTS>(bn[j], wt + j * tile_words + (s + 1) * kstep_words);
      }
      uint32_t a[MT][PARTS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int p = 0; p < PARTS; ++p)
          ldmatrix_x4(a[mt][p], a_row + p * tile_elems + mt * 16 * stride + s * 16);
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        if (j < cnt) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float t[4] = {0.f, 0.f, 0.f, 0.f};  // this k-step's products alone
            mma_bf16(t, a[mt][0], bc[j][0], bc[j][1]);  // hi·w_hi (bf16: a·w)
            if constexpr (PARTS == 2) {
              mma_bf16(t, a[mt][0], bc[j][2], bc[j][3]);  // hi·w_lo
              mma_bf16(t, a[mt][1], bc[j][0], bc[j][1]);  // lo·w_hi
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[j][mt][q] += t[q];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int q = 0; q < 2 * PARTS; ++q) bc[j][q] = bn[j][q];
    }

#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
      if (j < cnt) epi((t0 + j) * 8 + 2 * tig, acc[j]);
  }
}

}  // namespace
