// K3 for Hopper on a network too wide for the redesigned kernels: the
// gram-form Gaussian log-likelihood and its gradient with respect to the
// raw parameters, for a batch of rows, in one kernel. The bf16 pairs run
// on the tensor cores (fused_gram_mma.cu), the reverse pairs (a bf16x3 or
// bf16 value tier with an fp32 backward) on that kernel's reverse mode,
// the fp32 pair on the register-tiled fused_loglik_grad_gram_f32.cu, and
// an fp32 value tier with a bf16 backward on fused_gram_mixed.cu. This
// kernel takes a reverse pair, or the fp32 pair, of a network whose
// widest layer does not fit those kernels' full-width buffers (it keeps
// every activation at its own width; e.g. hidden (3200, 64, 64)). Its C
// entry still computes every tier pair.
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
// directions at every tier.
//
// The tiers, the tile layout and the dense layers are in trunk.cuh.
//
// Members: grid y runs an ensemble's M members in one launch, each CTA on
// one member's stacked operands (trunk.cuh, member_at). Nothing else
// changes with M, so a member's rows come out bit for bit as from a
// launch of that member alone.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tpu21cmvae_torch/ops/kernels/_build.py).

#include "trunk.cuh"

namespace {

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
  // each operand's member stride in bytes (0: one model)
  long long s_w0, s_b0, s_w_hi[kMaxLayers], s_w_lo[kMaxLayers], s_b[kMaxLayers],
      s_wt_hi[kMaxLayers], s_wt_lo[kMaxLayers], s_g_hi, s_g_lo, s_u;
};

// The net of member m: every operand moved by m times its stride.
__device__ __forceinline__ void to_member(Net& net, int m) {
  net.w0 = member_at(net.w0, net.s_w0, m);
  net.b0 = member_at(net.b0, net.s_b0, m);
#pragma unroll
  for (int i = 1; i < kMaxLayers; ++i) {
    net.w_hi[i] = member_at(net.w_hi[i], net.s_w_hi[i], m);
    net.w_lo[i] = member_at(net.w_lo[i], net.s_w_lo[i], m);
    net.b[i] = member_at(net.b[i], net.s_b[i], m);
    net.wt_hi[i] = member_at(net.wt_hi[i], net.s_wt_hi[i], m);
    net.wt_lo[i] = member_at(net.wt_lo[i], net.s_wt_lo[i], m);
  }
  net.g_hi = member_at(net.g_hi, net.s_g_hi, m);
  net.g_lo = member_at(net.g_lo, net.s_g_lo, m);
  net.u = member_at(net.u, net.s_u, m);
}

__global__ void __launch_bounds__(kThreads)
fused_loglik_grad_gram_kernel(const float* __restrict__ x, float* __restrict__ quad,
                              float* __restrict__ dx, int n_rows, const Net net_in) {
  // member blockIdx.y: its operands, moved there once per CTA into a
  // shared copy (a copy per thread, in local memory, ran these kernels
  // 30-50 % slower on an H100), its rows of quad and dx; x is shared
  __shared__ Net net;
  if (threadIdx.x == 0) {
    net = net_in;
    to_member(net, blockIdx.y);
  }
  __syncthreads();
  quad += static_cast<size_t>(blockIdx.y) * n_rows;
  dx += static_cast<size_t>(blockIdx.y) * n_rows * net.width[0];
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
  load_input_tile(x, n_rows, row0, n_in, true, xl);
  __syncthreads();

  // 2. skinny first layer, exact fp32 at every tier
  skinny_relu_layer(xl, n_in, net.w0, net.b0, act[0], n1);
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

  // 5. quad = Σ_j (hg + 2u)_j h_j per row; the backward signal
  //    ½·dquad/dh = hg + u, masked by the last ReLU, replaces hg in place
  gram_quad(act[n_layers - 1], hg, net.u, hidden, row0, n_rows, quad, true);
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

// The message of a cudaError_t code, for every kernel of the library.
const char* t21_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ptrs, in order: w0, b0; then for each trunk layer i = 1 … n_layers-1:
// w_hi, w_lo, b, wt_hi, wt_lo; then g_hi, g_lo, u. A *_lo pointer may be
// null unless its tier is bf16x3. strides: each operand's member stride in
// bytes, parallel to ptrs; n_members (1 … 65,535) networks run on the
// same x, member m writing quad[m·n_rows …] and dx[m·n_rows·n_in …] (a
// single model: 1 member, zero strides). Launches on `stream`, allocates
// nothing and does not synchronise; returns the cudaError_t of the launch.
int k3_fused_loglik_grad_gram(const float* x, float* quad, float* dx, int n_rows,
                              int n_layers, const int* widths, const void* const* ptrs,
                              const long long* strides, int n_members, int tier_fwd,
                              int tier_bwd, void* stream) {
  if (n_rows <= 0 || !members_ok(n_members) || n_layers < 1 || n_layers > kMaxLayers ||
      widths[0] < 1 || widths[0] > kMaxIn || tier_fwd < kF32 || tier_fwd > kBF16x3 ||
      tier_bwd < kF32 || tier_bwd > kBF16x3) {
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
  auto next = [&](long long& stride) {
    stride = strides[k];
    return static_cast<const float*>(ptrs[k++]);
  };
  net.w0 = next(net.s_w0);
  net.b0 = next(net.s_b0);
  for (int i = 1; i < n_layers; ++i) {
    net.w_hi[i] = next(net.s_w_hi[i]);
    net.w_lo[i] = next(net.s_w_lo[i]);
    net.b[i] = next(net.s_b[i]);
    net.wt_hi[i] = next(net.s_wt_hi[i]);
    net.wt_lo[i] = next(net.s_wt_lo[i]);
  }
  net.g_hi = next(net.s_g_hi);
  net.g_lo = next(net.s_g_lo);
  net.u = next(net.s_u);

  cudaError_t err = cudaFuncSetAttribute(fused_loglik_grad_gram_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_rows + kRows - 1) / kRows, n_members);
  fused_loglik_grad_gram_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, quad, dx, n_rows, net);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
