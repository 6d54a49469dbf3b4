// K3 for Hopper: the gram-form Gaussian log-likelihood and its gradient
// with respect to the raw parameters, for a batch of rows, in one kernel.
//
// Replaces: tpu21cmvae/ops/pallas/fused_loglik.py::make_fused_loglik_grad_gram
// (kernel body _loglik_grad_gram_kernel). Same contract: per row it writes
//   quad = ‖r‖² − c = Σ_j (h@G + 2u)_j · h_j
//   dx   = ½ · d‖r‖²/dx_raw
// where h is the last ReLU trunk activation of the folded network and
// (G, u, c) come from ops/fold.py::gram_fold; the caller returns
// (−½·(quad + c) + log_norm, −dx).
//
// What bounds it on an H100: fp32 FMA throughput on the CUDA cores. At the
// flagship widths (7→288→352→288→224, gram head 224×224) a row needs
// ≈1.18 MFLOP at the f32 tier (forward trunk, gram head, backward trunk),
// and the bf16x3 ("high") tier issues three FMAs per product, so about 3×
// that on the matrix products. The weights (≈1.5 MB of fp32 at the
// flagship) are read once per row tile.
//
// What the design does about it: one CTA of 256 threads per tile of kRows
// rows. Every activation of the tile stays in shared memory (column-major,
// element (column c, row r) at c * kRows + r), so nothing row-shaped goes
// back to device memory except the (rows,) value and the (rows, n_in)
// gradient; the backward writes its masked signal over the forward
// activation it has just consumed as a mask. Weights stream from device
// memory through L2, where all of them fit; each thread owns one output
// column at a time, keeps kRows sums in registers, reads W[k, j] coalesced
// across the warp and the activations as broadcast float4 loads. The
// backward reads pre-transposed weights so its reads coalesce too. The
// skinny first layer (fan-in ≤ 8) runs as exact fp32 FMA in both
// directions at every tier. Tensor cores (mma/wgmma), TMA and persistent
// CTAs are left for later work.
//
// Tiers (per product a·w, fp32 accumulation):
//   f32:    a · w
//   bf16:   bf16_rn(a) · w, with w pre-rounded to bf16 by the caller
//   bf16x3: hi(a)·w_hi + hi(a)·w_lo + lo(a)·w_hi, hi(x) = bits(x) & 0xFFFF0000,
//           lo(x) = bf16_rn(x − hi(x)); w_hi, w_lo pre-split by the caller
// Every product of bf16-representable values is exact in fp32, so the
// kernel and its plain PyTorch version differ only in summation order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tpu21cmvae_torch/ops/kernels/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxLayers = 8;   // trunk layers (layer 0 is the skinny input layer)
constexpr int kMaxIn = 8;       // widest skinny input
constexpr int kThreads = 256;
constexpr int kRows = 16;       // rows per CTA
constexpr int kLogCols = 3;     // log10 on input columns 0..2
constexpr int kMaxSmem = 232448;

enum Tier : int { kF32 = 0, kBF16 = 1, kBF16x3 = 2 };
enum Epilogue : int { kBiasRelu = 0, kStore = 1, kMask = 2 };

struct Net {
  int n_layers;
  int width[kMaxLayers + 1];  // width[0] = n_in; trunk layer i maps width[i] → width[i+1]
  int tier_fwd;
  int tier_bwd;
  const float* w0;            // (n_in, width[1]), exact fp32
  const float* b0;            // (width[1],)
  const float* w_hi[kMaxLayers];   // layer i ≥ 1: (width[i], width[i+1]) at tier_fwd
  const float* w_lo[kMaxLayers];   // bf16x3 only
  const float* b[kMaxLayers];      // (width[i+1],)
  const float* wt_hi[kMaxLayers];  // layer i ≥ 1 transposed: (width[i+1], width[i]) at tier_bwd
  const float* wt_lo[kMaxLayers];  // bf16x3 only
  const float* g_hi;               // (H, H) at tier_fwd, H = width[n_layers]
  const float* g_lo;               // bf16x3 only
  const float* u;                  // (H,)
};

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

// out[j, r] = epilogue(Σ_k in[k, r] · W[k, j]) for every j < n_out, with W
// (n_in, n_out) row-major in device memory and in/out tiles in shared memory.
template <int TIER, int EPI>
__device__ void dense(const float* in, int n_in, const float* __restrict__ w_hi,
                      const float* __restrict__ w_lo, const float* __restrict__ bias,
                      float* out, int n_out) {
  for (int j = threadIdx.x; j < n_out; j += blockDim.x) {
    float acc[kRows];
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
    float* o = out + j * kRows;
    if constexpr (EPI == kBiasRelu) {
      const float bj = __ldg(bias + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r) o[r] = relu(acc[r] + bj);
    } else if constexpr (EPI == kStore) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) o[r] = acc[r];
    } else {  // backward: mask by the forward activation held in `out`, in place
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

__global__ void __launch_bounds__(kThreads)
fused_loglik_grad_gram_kernel(const float* __restrict__ x, float* __restrict__ quad,
                              float* __restrict__ dx, int n_rows, Net net) {
  extern __shared__ float4 smem4[];
  const int n_in = net.width[0];
  const int n_layers = net.n_layers;
  const int hidden = net.width[n_layers];
  const int n1 = net.width[1];
  const int row0 = blockIdx.x * kRows;

  // shared-memory tiles: log-clamped input, one per trunk activation, h@G
  float* xl = reinterpret_cast<float*>(smem4);
  float* act[kMaxLayers];
  float* next = xl + n_in * kRows;
  for (int i = 0; i < n_layers; ++i) {
    act[i] = next;
    next += net.width[i + 1] * kRows;
  }
  float* hg = next;

  // 1. input tile, log-clamped; rows past the batch are zero and never stored
  for (int t = threadIdx.x; t < kRows * n_in; t += blockDim.x) {
    const int r = t / n_in;
    const int c = t % n_in;
    const int row = row0 + r;
    xl[c * kRows + r] = row < n_rows ? log_clamp(x[static_cast<size_t>(row) * n_in + c], c) : 0.f;
  }
  __syncthreads();

  // 2. skinny first layer, exact fp32 at every tier
  for (int j = threadIdx.x; j < n1; j += blockDim.x) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int c = 0; c < n_in; ++c) {
      const float w = __ldg(net.w0 + c * n1 + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(xl[c * kRows + r], w, acc[r]);
    }
    const float bj = __ldg(net.b0 + j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) act[0][j * kRows + r] = relu(acc[r] + bj);
  }
  __syncthreads();

  // 3. hidden layers, ReLU
  for (int i = 1; i < n_layers; ++i) {
    dense_at<kBiasRelu>(net.tier_fwd, act[i - 1], net.width[i], net.w_hi[i], net.w_lo[i],
                        net.b[i], act[i], net.width[i + 1]);
    __syncthreads();
  }

  // 4. gram head: hg = h @ G
  dense_at<kStore>(net.tier_fwd, act[n_layers - 1], hidden, net.g_hi, net.g_lo, nullptr, hg,
                   hidden);
  __syncthreads();

  // 5. quad = Σ_j (hg + 2u)_j h_j per row (one warp per row); the backward
  //    signal ½·dquad/dh = hg + u (G is symmetric, so h@G is reused),
  //    masked by the last ReLU, replaces hg in place
  {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const float* h = act[n_layers - 1];
    for (int r = warp; r < kRows; r += blockDim.x / 32) {
      float s = 0.f;
      for (int j = lane; j < hidden; j += 32) {
        const float g = hg[j * kRows + r];
        const float hj = h[j * kRows + r];
        const float uj = __ldg(net.u + j);
        s = fmaf(g + 2.f * uj, hj, s);
        hg[j * kRows + r] = hj > 0.f ? g + uj : 0.f;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0 && row0 + r < n_rows) quad[row0 + r] = s;
    }
  }
  __syncthreads();

  // 6. backward through hidden layers n_layers-1 … 1: e ← (e @ W_iᵀ) masked
  //    by the ReLU of activation i-1, written over that activation
  for (int i = n_layers - 1; i >= 1; --i) {
    const float* e = i == n_layers - 1 ? hg : act[i];
    dense_at<kMask>(net.tier_bwd, e, net.width[i + 1], net.wt_hi[i], net.wt_lo[i], nullptr,
                    act[i - 1], net.width[i]);
    __syncthreads();
  }

  // 7. skinny layer backward, exact fp32, times the log-clamp derivative
  {
    const float* e = n_layers == 1 ? hg : act[0];
    for (int t = threadIdx.x; t < kRows * n_in; t += blockDim.x) {
      const int r = t % kRows;
      const int c = t / kRows;
      const int row = row0 + r;
      float acc = 0.f;
      for (int j = 0; j < n1; ++j) acc = fmaf(e[j * kRows + r], __ldg(net.w0 + c * n1 + j), acc);
      if (row < n_rows) {
        const size_t at = static_cast<size_t>(row) * n_in + c;
        dx[at] = log_clamp_grad(x[at], c) * acc;
      }
    }
  }
}

}  // namespace

extern "C" {

const char* k3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ptrs, in order: w0, b0; then for each trunk layer i = 1 … n_layers-1:
// w_hi, w_lo, b, wt_hi, wt_lo; then g_hi, g_lo, u. A *_lo pointer may be
// null unless its tier is bf16x3. Launches on `stream`, allocates nothing
// and does not synchronise; returns the cudaError_t of the launch.
int k3_fused_loglik_grad_gram(const float* x, float* quad, float* dx, int n_rows,
                              int n_layers, const int* widths, const void* const* ptrs,
                              int tier_fwd, int tier_bwd, void* stream) {
  if (n_rows <= 0 || n_layers < 1 || n_layers > kMaxLayers || widths[0] < 1 ||
      widths[0] > kMaxIn || tier_fwd < kF32 || tier_fwd > kBF16x3 || tier_bwd < kF32 ||
      tier_bwd > kBF16x3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Net net{};
  net.n_layers = n_layers;
  net.tier_fwd = tier_fwd;
  net.tier_bwd = tier_bwd;
  size_t floats = widths[0] + widths[n_layers];
  for (int i = 0; i <= n_layers; ++i) {
    net.width[i] = widths[i];
    if (i > 0) floats += widths[i];
  }
  const size_t smem = floats * kRows * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);

  int k = 0;
  auto next = [&]() { return static_cast<const float*>(ptrs[k++]); };
  net.w0 = next();
  net.b0 = next();
  for (int i = 1; i < n_layers; ++i) {
    net.w_hi[i] = next();
    net.w_lo[i] = next();
    net.b[i] = next();
    net.wt_hi[i] = next();
    net.wt_lo[i] = next();
  }
  net.g_hi = next();
  net.g_lo = next();
  net.u = next();

  cudaError_t err = cudaFuncSetAttribute(fused_loglik_grad_gram_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n_rows + kRows - 1) / kRows;
  fused_loglik_grad_gram_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, quad, dx, n_rows, net);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
