// Device code shared by every kernel of the port: the launch limits, the
// member axis, the matmul tiers' rounding, the input log-clamp and its
// derivative, and the skinny first layer's dot product.
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
constexpr int kMaxIn = 8;       // widest skinny input (exact fp32)
constexpr int kThreads = 256;
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

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float hi_part(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
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

// The skinny first layer (fan-in ≤ kMaxIn) at one (row, column): Σ_c
// x[c·xs] · w[c·ws] + b in the Pallas kernels' order
// (tpu21cmvae/ops/pallas/fused_mlp.py:265-270, bias at :281): the products
// from c = 0 ascending, each product and each sum rounded to fp32 (no
// contraction into an fma), then the bias. The plain versions compute the
// same (ops/mlp.py::fused_skinny_dense), so the layer is bit for bit the
// same on the card and in plain PyTorch.
__device__ __forceinline__ float skinny_dot(const float* x, int xs, int n_in,
                                            const float* __restrict__ w, int ws, float b) {
  float acc = __fmul_rn(x[0], __ldg(w));
  for (int c = 1; c < n_in; ++c) acc = __fadd_rn(acc, __fmul_rn(x[c * xs], __ldg(w + c * ws)));
  return __fadd_rn(acc, b);
}

}  // namespace
