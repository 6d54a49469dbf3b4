// Device code shared by the port's fused-network kernels (K1
// fused_mlp.cu, K2 fused_loglik_gram.cu, K3 fused_loglik_grad_gram.cu):
// the launch geometry, the matmul tiers, the input log-clamp, and dense
// layers over a tile of kRows rows held in shared memory.
//
// Tile layout: column-major, element (column c, row r) at c * kRows + r,
// so a thread that owns output column j reads a whole input column as
// kRows / 4 broadcast float4 loads. Rows past the batch are zero in the
// input tile and are never stored.
//
// Tiers (per product a·w, fp32 accumulation):
//   f32:    a · w
//   bf16:   bf16_rn(a) · w, with w pre-rounded to bf16 by the caller
//   bf16x3: hi(a)·w_hi + hi(a)·w_lo + lo(a)·w_hi, hi(x) = bits(x) & 0xFFFF0000,
//           lo(x) = bf16_rn(x − hi(x)); w_hi, w_lo pre-split by the caller
// Every product of bf16-representable values is exact in fp32, so a
// kernel and its plain PyTorch version differ only in summation order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxLayers = 8;   // layers of a network (K2/K3: trunk layers)
constexpr int kMaxIn = 8;       // widest skinny input (exact fp32 FMA)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;       // rows per CTA
constexpr int kLogCols = 3;     // log10 on input columns 0..2
constexpr int kMaxSmem = 232448;

// The member axis of a launch: grid y runs n_members networks of one
// shape (an ensemble's members, JAX's vmap over pallas_call) on the same
// input rows. Member m reads each operand at m times that operand's byte
// stride and writes its outputs m batches on; a single model is
// n_members = 1 with zero strides. Nothing else in a kernel sees m.
constexpr int kMaxMembers = 65535;  // gridDim.y's limit

inline bool members_ok(int n_members) { return n_members >= 1 && n_members <= kMaxMembers; }

template <class T>
__device__ __forceinline__ T* member_at(T* p, long long stride, int m) {
  return reinterpret_cast<T*>(reinterpret_cast<uintptr_t>(p) +
                              static_cast<uintptr_t>(stride) * static_cast<uintptr_t>(m));
}

enum Tier : int { kF32 = 0, kBF16 = 1, kBF16x3 = 2 };
enum Epilogue : int { kBiasRelu = 0, kStore = 1, kMask = 2 };

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float hi_part(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
}

template <int TIER>
__device__ __forceinline__ float tier_fma(float a, float w_hi, float w_lo, float acc) {
  if constexpr (TIER == kF32) {
    return fmaf(a, w_hi, acc);
  } else if constexpr (TIER == kBF16) {
    return fmaf(bf16_rn(a), w_hi, acc);
  } else {
    const float a_hi = hi_part(a);
    const float a_lo = bf16_rn(a - a_hi);
    return fmaf(a_lo, w_hi, fmaf(a_hi, w_lo, fmaf(a_hi, w_hi, acc)));
  }
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }  // keeps NaN

__device__ __forceinline__ float log_clamp(float v, int c) {
  if (c >= kLogCols) return v;
  if (c == kLogCols - 1 && v == 0.f) v = 1e-6f;
  return log10f(v);
}

__device__ __forceinline__ float log_clamp_grad(float v, int c) {
  if (c >= kLogCols) return 1.f;
  if (c == kLogCols - 1 && v == 0.f) return 0.f;  // the fx == 0 clamp is flat
  return 1.f / (v * 2.302585093f);
}

// The tile's input rows x[row0 .. row0 + kRows) (row-major, n_in columns)
// into `xl`, log-clamped if asked; rows past the batch are zero.
__device__ __forceinline__ void load_input_tile(const float* __restrict__ x, int n_rows,
                                                int row0, int n_in, bool log_cols,
                                                float* xl) {
  for (int t = threadIdx.x; t < kRows * n_in; t += blockDim.x) {
    const int r = t / n_in;
    const int c = t % n_in;
    const int row = row0 + r;
    float v = 0.f;
    if (row < n_rows) {
      v = x[static_cast<size_t>(row) * n_in + c];
      if (log_cols) v = log_clamp(v, c);
    }
    xl[c * kRows + r] = v;
  }
}

// acc[r] = Σ_k in[k, r] · W[k, j] at TIER, k ascending, with W (n_in,
// n_out) row-major in device memory.
template <int TIER>
__device__ __forceinline__ void dot_column(const float* in, int n_in,
                                           const float* __restrict__ w_hi,
                                           const float* __restrict__ w_lo, int n_out, int j,
                                           float (&acc)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 2
  for (int k = 0; k < n_in; ++k) {
    const size_t at = static_cast<size_t>(k) * n_out + j;
    const float wh = __ldg(w_hi + at);
    const float wl = TIER == kBF16x3 ? __ldg(w_lo + at) : 0.f;
    const float4* a4 = reinterpret_cast<const float4*>(in + k * kRows);
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      const float4 a = a4[q];
      acc[4 * q + 0] = tier_fma<TIER>(a.x, wh, wl, acc[4 * q + 0]);
      acc[4 * q + 1] = tier_fma<TIER>(a.y, wh, wl, acc[4 * q + 1]);
      acc[4 * q + 2] = tier_fma<TIER>(a.z, wh, wl, acc[4 * q + 2]);
      acc[4 * q + 3] = tier_fma<TIER>(a.w, wh, wl, acc[4 * q + 3]);
    }
  }
}

// acc[r] = Σ_c in[c, r] · w0[c, j] in exact fp32, c ascending: the skinny
// (fan-in ≤ kMaxIn) first layer at every tier.
__device__ __forceinline__ void skinny_column(const float* in, int n_in,
                                              const float* __restrict__ w0, int n_out, int j,
                                              float (&acc)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int c = 0; c < n_in; ++c) {
    const float w = __ldg(w0 + c * n_out + j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = fmaf(in[c * kRows + r], w, acc[r]);
  }
}

// out[j, r] = relu(Σ_c in[c, r] · w0[c, j] + b0[j]): the skinny first
// layer into a shared-memory tile.
__device__ void skinny_relu_layer(const float* in, int n_in, const float* __restrict__ w0,
                                  const float* __restrict__ b0, float* out, int n_out) {
  for (int j = threadIdx.x; j < n_out; j += blockDim.x) {
    float acc[kRows];
    skinny_column(in, n_in, w0, n_out, j, acc);
    const float bj = __ldg(b0 + j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) out[j * kRows + r] = relu(acc[r] + bj);
  }
}

// out[j, r] = epilogue(Σ_k in[k, r] · W[k, j]) for every j < n_out, with
// in/out tiles in shared memory. kBiasRelu: relu(· + bias[j]); kStore: as
// is; kMask: masked by the value already in `out` (a forward activation),
// in place — the backward's ReLU mask.
template <int TIER, int EPI>
__device__ void dense(const float* in, int n_in, const float* __restrict__ w_hi,
                      const float* __restrict__ w_lo, const float* __restrict__ bias,
                      float* out, int n_out) {
  for (int j = threadIdx.x; j < n_out; j += blockDim.x) {
    float acc[kRows];
    dot_column<TIER>(in, n_in, w_hi, w_lo, n_out, j, acc);
    float* o = out + j * kRows;
    if constexpr (EPI == kBiasRelu) {
      const float bj = __ldg(bias + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r) o[r] = relu(acc[r] + bj);
    } else if constexpr (EPI == kStore) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) o[r] = acc[r];
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) o[r] = o[r] > 0.f ? acc[r] : 0.f;
    }
  }
}

template <int EPI>
__device__ void dense_at(int tier, const float* in, int n_in, const float* w_hi,
                         const float* w_lo, const float* bias, float* out, int n_out) {
  switch (tier) {
    case kF32: dense<kF32, EPI>(in, n_in, w_hi, w_lo, bias, out, n_out); break;
    case kBF16: dense<kBF16, EPI>(in, n_in, w_hi, w_lo, bias, out, n_out); break;
    default: dense<kBF16x3, EPI>(in, n_in, w_hi, w_lo, bias, out, n_out); break;
  }
}

// quad[row0 + r] = Σ_j (hg[j, r] + 2·u[j]) · h[j, r] for the tile's rows
// (one warp per row); with `signal`, hg is then replaced in place by the
// backward signal ½·dquad/dh = hg + u masked by the last ReLU (G is
// symmetric, so h@G is reused).
__device__ void gram_quad(const float* h, float* hg, const float* __restrict__ u, int hidden,
                          int row0, int n_rows, float* __restrict__ quad, bool signal) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += blockDim.x / 32) {
    float s = 0.f;
    for (int j = lane; j < hidden; j += 32) {
      const float g = hg[j * kRows + r];
      const float hj = h[j * kRows + r];
      const float uj = __ldg(u + j);
      s = fmaf(g + 2.f * uj, hj, s);
      if (signal) hg[j * kRows + r] = hj > 0.f ? g + uj : 0.f;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0 && row0 + r < n_rows) quad[row0 + r] = s;
  }
}

}  // namespace
