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
// 0.64 MFLOP: 10.0 ms at 1 M rows at the 67 TFLOP/s peak. Each row reads
// 28 bytes and writes 4, so device memory is not the limit. The first
// design (K3's forward, one output column of a 16-row tile per thread)
// spent five loads on every 16 FMAs, streamed the weights (1.0 MB) from L2
// once per 16 rows, and reached 21 % of the peak.
//
// What the design does about it: K1's register-tiled layers
// (tile_f32.cuh; see fused_mlp.cu; the forward itself is in gram_f32.cuh,
// which K3's fp32 kernel shares): BM rows per CTA of 256 threads, BM/8
// × 4 accumulators per thread per 128-column chunk, the weights packed
// once per model into fp32 slabs (ops/kernels/_common.py::pack_slabs:
// trunk layers 1 … n−1, then G, whose bias slot holds u) and streamed
// through a cp.async ring, one barrier per slab. The
// skinny first layer is a (row, column) loop of exact fp32. The gram
// head is one more register-tiled layer with G; its epilogue forms
// (hg + 2u)·h from the registers and the fp32 h still in shared memory at
// the same (row, column), so no hg tile exists, and the per-row quad is
// reduced across the 8 lanes and 4 column quarters that share a row in a
// fixed order. Shared memory per CTA: 4·S·(n_in + 2·widest trunk width,
// padded to 32) bytes of tiles plus the ring and 1 KB of partials: 232,192
// bytes at the flagship with BM = 64.
//
// Members: grid y runs an ensemble's M members in one launch, each CTA on
// one member's stacked operands (trunk.cuh, member_at). Nothing else
// changes with M, so a member's rows come out bit for bit as from a
// launch of that member alone.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tpu21cmvae_torch/ops/kernels/_build.py).

#include "gram_f32.cuh"

namespace {

// Launch bounds: at 64 rows the flagship's shared memory holds one CTA per
// SM, and asking for two caps registers at 128, where K2 ran 2.6 % faster
// than with ptxas's own 164; a cap of 80 spilled and ran slower (PERF.md).
template <int BM>
__global__ void __launch_bounds__(kThreads, BM >= 32 ? 2 : BM == 16 ? 3 : 4)
fused_loglik_gram_kernel(const float* __restrict__ x, float* __restrict__ quad, int n_rows,
                         GramNet net) {
  // member blockIdx.y: its operands and its rows of quad; x is shared
  to_member(net, blockIdx.y);
  quad += static_cast<size_t>(blockIdx.y) * n_rows;
  extern __shared__ float4 smem4[];
  const GramTile tile = gram_tile<BM, Ring<BM>>(reinterpret_cast<float*>(smem4), net);
  int g = 0;
  float *h, *e;
  uint8_t* mask;
  gram_forward<BM, Ring<BM>, false>(x, quad, n_rows, net, tile, g, h, e, mask);
}

template <int BM>
cudaError_t launch_gram(const float* x, float* quad, int n_rows, int n_members, GramNet net,
                        cudaStream_t s) {
  const size_t smem = tile_smem_bytes<BM>(net.width[0], net.buf_cols);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  net.total = gram_stream_slabs<BM, Ring<BM>>(net, false);
  auto* kernel = fused_loglik_gram_kernel<BM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n_rows + BM - 1) / BM, n_members), kThreads, smem, s>>>(x, quad, n_rows, net);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs, in order, all fp32: w0, b0 (the skinny first layer), then the
// packed slabs and padded biases of trunk layers 1 … n_layers-1 and G,
// whose bias slot holds u (ops/kernels/_common.py::pack_slabs). strides:
// each operand's member stride in bytes, parallel to ptrs; n_members
// (1 … 65,535) networks run on the same x, member m writing
// quad[m·n_rows …] (a single model: 1 member, zero strides). tile_rows:
// the CTA's rows, 64, 32, 16 or 8. Launches on `stream`, allocates nothing
// and does not synchronise; returns the cudaError_t of the launch.
int k2_fused_loglik_gram(const float* x, float* quad, int n_rows, int n_layers,
                         const int* widths, const void* const* ptrs, const long long* strides,
                         int n_members, int tile_rows, void* stream) {
  GramNet net;
  if (!read_gram_net(n_rows, n_layers, widths, ptrs, strides, n_members, net)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tile_rows) {
    case 64: err = launch_gram<64>(x, quad, n_rows, n_members, net, s); break;
    case 32: err = launch_gram<32>(x, quad, n_rows, n_members, net, s); break;
    case 16: err = launch_gram<16>(x, quad, n_rows, n_members, net, s); break;
    case 8: err = launch_gram<8>(x, quad, n_rows, n_members, net, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
