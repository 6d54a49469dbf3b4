// K2 for Hopper at the fp32 tier: the gram-form Gaussian log-likelihood,
// value only, for a batch of rows, in one kernel. The bf16 tiers run on
// the tensor cores (fused_gram_mma.cu).
//
// Replaces: tpu21cmvae/ops/pallas/fused_loglik.py::make_fused_loglik_gram
// (kernel body _loglik_gram_kernel), at its exact tier. Same contract: per
// row it writes
//   quad = ‖r‖² − c = Σ_j (h@G + 2u)_j · h_j
// where h is the last ReLU trunk activation of the folded network and
// (G, u, c) come from ops/fold.py::gram_fold; the caller returns
// −½·(quad + c) + log_norm. The 451-wide output layer never exists.
//
// What bounds it on an H100: fp32 FMA throughput on the CUDA cores. At the
// flagship widths (7→288→352→288→224, gram head 224×224) a row needs
// ≈0.64 MFLOP. Each row reads 28 bytes and writes 4, so device memory is
// not the limit; the weights (≈1.0 MB of fp32 at the flagship) are read
// once per row tile, from L2, where all of them fit.
//
// What the design does about it: it is K3's forward (trunk.cuh) without
// the backward. One CTA of 256 threads per tile of kRows = 16 rows; each
// thread owns one output column at a time, keeps kRows sums in registers,
// reads W[k, j] coalesced across the warp and the activations as
// broadcast float4 loads. With no backward to feed, only two activation
// buffers exist: they take turns as a layer's input and output, and h@G
// lands in the one that h does not hold. Shared memory per CTA is
// 4·kRows·(n_in + 2·max width) bytes, 45,504 at the flagship (K3 keeps
// every activation: 88.5 KB), so shared memory admits five CTAs per SM
// where it admits two of K3's. The register file admits four at up to 64
// registers a thread, and the launch bounds ask for four: ptxas then uses
// 64 registers where it picks 54 unasked, and at 1 M rows on an H100 the
// 54-register build ran slower (PERF.md). The skinny first layer (fan-in ≤ 8) is exact
// fp32 FMA. Register tiling, TMA and persistent CTAs are left for
// later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tpu21cmvae_torch/ops/kernels/_build.py).

#include "trunk.cuh"

namespace {

struct GramNet {
  int n_layers;
  int width[kMaxLayers + 1];  // width[0] = n_in; trunk layer i maps width[i] → width[i+1]
  int max_width;              // widest trunk layer
  const float* w0;            // (n_in, width[1])
  const float* b0;            // (width[1],)
  const float* w[kMaxLayers];  // layer i ≥ 1: (width[i], width[i+1])
  const float* b[kMaxLayers];  // (width[i+1],)
  const float* g;              // (H, H), H = width[n_layers]
  const float* u;              // (H,)
};

__global__ void __launch_bounds__(kThreads, 4)
fused_loglik_gram_kernel(const float* __restrict__ x, float* __restrict__ quad, int n_rows,
                         GramNet net) {
  extern __shared__ float4 smem4[];
  const int n_in = net.width[0];
  const int n_layers = net.n_layers;
  const int hidden = net.width[n_layers];
  const int row0 = blockIdx.x * kRows;

  // shared-memory tiles: log-clamped input, then two activation buffers
  float* xl = reinterpret_cast<float*>(smem4);
  float* buf[2] = {xl + n_in * kRows, xl + (n_in + net.max_width) * kRows};

  load_input_tile(x, n_rows, row0, n_in, true, xl);
  __syncthreads();

  skinny_relu_layer(xl, n_in, net.w0, net.b0, buf[0], net.width[1]);
  __syncthreads();

  int cur = 0;
  for (int i = 1; i < n_layers; ++i) {
    dense<kF32, kBiasRelu>(buf[cur], net.width[i], net.w[i], nullptr, net.b[i], buf[cur ^ 1],
                           net.width[i + 1]);
    __syncthreads();
    cur ^= 1;
  }

  // gram head: hg = h @ G into the free buffer, then the per-row quad
  const float* h = buf[cur];
  float* hg = buf[cur ^ 1];
  dense<kF32, kStore>(h, hidden, net.g, nullptr, nullptr, hg, hidden);
  __syncthreads();
  gram_quad(h, hg, net.u, hidden, row0, n_rows, quad, false);
}

}  // namespace

extern "C" {

// ptrs, in order, all fp32: w0, b0; then for each trunk layer i = 1 …
// n_layers-1: w, b; then G, u. Launches on `stream`, allocates nothing and
// does not synchronise; returns the cudaError_t of the launch.
int k2_fused_loglik_gram(const float* x, float* quad, int n_rows, int n_layers,
                         const int* widths, const void* const* ptrs, void* stream) {
  if (n_rows <= 0 || n_layers < 1 || n_layers > kMaxLayers || widths[0] < 1 ||
      widths[0] > kMaxIn) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GramNet net{};
  net.n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    net.width[i] = widths[i];
    if (i > 0 && widths[i] > net.max_width) net.max_width = widths[i];
  }
  const size_t smem =
      static_cast<size_t>(widths[0] + 2 * net.max_width) * kRows * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);

  int k = 0;
  auto next = [&]() { return static_cast<const float*>(ptrs[k++]); };
  net.w0 = next();
  net.b0 = next();
  for (int i = 1; i < n_layers; ++i) {
    net.w[i] = next();
    net.b[i] = next();
  }
  net.g = next();
  net.u = next();

  cudaError_t err = cudaFuncSetAttribute(fused_loglik_gram_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n_rows + kRows - 1) / kRows;
  fused_loglik_gram_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, quad, n_rows, net);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
