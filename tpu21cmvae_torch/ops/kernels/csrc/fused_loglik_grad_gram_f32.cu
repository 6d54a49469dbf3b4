// K3 for Hopper at the fp32 tier (value and backward both fp32): the
// gram-form Gaussian log-likelihood and its gradient with respect to the
// raw parameters, for a batch of rows, in one kernel. The bf16 tier pairs
// run on the tensor cores (fused_gram_mma.cu); an fp32 value tier with a
// bf16 backward on fused_gram_mixed.cu (this kernel's forward, a
// tensor-core backward); a bf16 value tier with an fp32 backward on
// fused_gram_mma.cu's reverse mode (a tensor-core forward, this kernel's
// backward layers).
//
// Replaces: tpu21cmvae/ops/pallas/fused_loglik.py::make_fused_loglik_grad_gram
// (kernel body _loglik_grad_gram_kernel), at its exact tier. Same contract:
// per row it writes
//   quad = ‖r‖² − c = Σ_j (h@G + 2u)_j · h_j
//   dx   = ½ · d‖r‖²/dx_raw
// where h is the last ReLU trunk activation of the folded network and
// (G, u, c) come from ops/fold.py::gram_fold; the caller returns
// (−½·(quad + c) + log_norm, −dx).
//
// What bounds it on an H100: fp32 FMA throughput on the CUDA cores. At the
// flagship widths (7→288→352→288→224, gram head 224×224) a row needs
// 1.18 MFLOP: 0.317 M products forward, 0.267 M backward, and the skinny
// layer twice. Each row reads 28 bytes and writes 32, so device memory is
// not the limit. The first design (fused_loglik_grad_gram.cu's first version: one output
// column of a 16-row tile per thread, every activation kept in shared
// memory) spent five loads on every 16 FMAs, streamed the weights (2.5 MB
// forward and transposed) from L2 once per 16 rows, and ran slower than
// its plain PyTorch version at large batches.
//
// What the design does about it: K2's register-tiled layers
// (tile_f32.cuh; the forward is gram_f32.cuh's, shared with
// fused_loglik_gram.cu, so the value equals K2's bit for bit at one tile
// height), and the backward as more layers of the same stream. The wrapper
// packs one stream per model (ops/kernels/fused_loglik.py::
// pack_grad_gram_slabs): trunk layers 1 … n−1, G with u in its bias slot,
// then W_iᵀ for i = n−1 … 1; the cp.async ring runs across the
// forward/backward boundary without a restart.
// - The backward of a ReLU network with respect to its input needs only
//   the sign of each activation, so the forward keeps K2's two ping-pong
//   buffers and one bit per (row, column) of activations 0 … n−2 (8 bytes
//   per padded column at 64 rows: 7,424 bytes at the flagship), written by
//   the epilogue that stores the activation. h itself is needed once more,
//   in the gram epilogue, where it is still in shared memory: that
//   epilogue also stores the first signal e = h > 0 ? h@G + u : 0.
// - Backward layer i is tile_layer over W_iᵀ's slabs with an epilogue that
//   stores mask_{i−1} ? acc : 0 into the other buffer. One accumulator per
//   output, k ascending, no split-k: a row's gradient does not depend on
//   the other rows of its tile, on the tile height or on the slab depth.
// - The skinny first layer's backward is one thread per (row, input
//   column), j ascending, exact fp32, times the log-clamp's derivative.
// - Shared memory per CTA: the tiles 4·S·(n_in + 2·widest trunk width,
//   padded to 32), the ring (GradRing: two 32-deep slots at 64 rows, so
//   the masks fit beside them), 1 KB of partials and the masks: 223,232
//   bytes at the flagship with BM = 64, 112,128 with BM = 32 (two CTAs per
//   SM). The wrapper picks the tile height by batch as well as by shared
//   memory: a small batch takes shorter tiles to fill the card's SMs.
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

template <int BM>
__global__ void __launch_bounds__(kThreads, BM >= 32 ? 2 : BM == 16 ? 3 : 4)
fused_loglik_grad_gram_f32_kernel(const float* __restrict__ x, float* __restrict__ quad,
                                  float* __restrict__ dx, int n_rows, GramNet net) {
  // member blockIdx.y: its operands, its rows of quad and dx; x is shared
  to_member(net, blockIdx.y);
  quad += static_cast<size_t>(blockIdx.y) * n_rows;
  dx += static_cast<size_t>(blockIdx.y) * n_rows * net.width[0];
  using R = GradRing<BM>;
  using M = MaskBits<BM>;
  constexpr int TM = BM / 8;
  constexpr int S = tile_stride(BM);
  extern __shared__ float4 smem4[];
  const GramTile tile = gram_tile<BM, R>(reinterpret_cast<float*>(smem4), net);
  const int n_in = net.width[0];
  const int n1 = net.width[1];
  const int row0 = blockIdx.x * BM;

  // forward: quad, the masks of activations 0 … n−2, the first signal
  int g = 0;
  float *in, *out;
  uint8_t* mask;
  gram_forward<BM, R, true>(x, quad, n_rows, net, tile, g, out, in, mask);

  // backward through trunk layers n−1 … 1: e ← (e @ W_iᵀ) where activation
  // i−1 was positive, else 0
  for (int i = net.n_layers - 1; i >= 1; --i) {
    const int n = net.width[i];
    mask -= M::kColBytes * padk(n);
    float* const to = out;
    const uint8_t* const m = mask;
    tile_layer<BM, R>(in, net.width[i + 1], n, net.slabs, net.total, tile.ring, g,
                      [&](int c0, const float (&acc)[TM][4]) {
                        masked_store<BM>(to, m, n, c0, acc);
                      });
    out = in;
    in = to;
  }
  __syncthreads();

  // skinny layer backward, exact fp32, times the log-clamp derivative
  for (int t = threadIdx.x; t < BM * n_in; t += blockDim.x) {
    const int r = t % BM;
    const int c = t / BM;
    const int row = row0 + r;
    float acc = 0.f;
    for (int j = 0; j < n1; ++j) acc = fmaf(in[j * S + r], __ldg(net.w0 + c * n1 + j), acc);
    if (row < n_rows) {
      const size_t at = static_cast<size_t>(row) * n_in + c;
      dx[at] = log_clamp_grad(x[at], c) * acc;
    }
  }
}

template <int BM>
cudaError_t launch_grad_gram(const float* x, float* quad, float* dx, int n_rows, int n_members,
                             GramNet net, cudaStream_t s) {
  using R = GradRing<BM>;
  const size_t smem =
      tile_smem_bytes<BM, R>(net.width[0], net.buf_cols) + gram_mask_bytes<BM>(net);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  net.total = gram_stream_slabs<BM, R>(net, true);
  auto* kernel = fused_loglik_grad_gram_f32_kernel<BM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n_rows + BM - 1) / BM, n_members), kThreads, smem, s>>>(x, quad, dx, n_rows,
                                                                       net);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs, in order, all fp32: w0, b0 (the skinny first layer), then the
// packed slabs and padded biases of trunk layers 1 … n_layers-1, of G,
// whose bias slot holds u, and of W_iᵀ for i = n_layers-1 … 1, whose
// biases are zero and unread (ops/kernels/fused_loglik.py::
// pack_grad_gram_slabs). strides: each operand's member stride in bytes,
// parallel to ptrs; n_members (1 … 65,535) networks run on the same x,
// member m writing quad[m·n_rows …] and dx[m·n_rows·n_in …] (a single
// model: 1 member, zero strides). tile_rows: the CTA's rows, 64, 32, 16
// or 8. Launches on `stream`, allocates nothing and does not synchronise;
// returns the cudaError_t of the launch.
int k3_fused_loglik_grad_gram_f32(const float* x, float* quad, float* dx, int n_rows,
                                  int n_layers, const int* widths, const void* const* ptrs,
                                  const long long* strides, int n_members, int tile_rows,
                                  void* stream) {
  GramNet net;
  if (!read_gram_net(n_rows, n_layers, widths, ptrs, strides, n_members, net)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tile_rows) {
    case 64: err = launch_grad_gram<64>(x, quad, dx, n_rows, n_members, net, s); break;
    case 32: err = launch_grad_gram<32>(x, quad, dx, n_rows, n_members, net, s); break;
    case 16: err = launch_grad_gram<16>(x, quad, dx, n_rows, n_members, net, s); break;
    case 8: err = launch_grad_gram<8>(x, quad, dx, n_rows, n_members, net, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
