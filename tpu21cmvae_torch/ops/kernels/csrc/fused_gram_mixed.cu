// K3 for Hopper at an fp32 value tier with a bf16 backward tier ("high"
// bf16x3 or "default" bf16): the gram-form Gaussian log-likelihood, exact,
// and a cheaper gradient with respect to the raw parameters, for a batch
// of rows, in one kernel. The JAX package documents this pair as the
// admissible cheap HMC: leapfrog with any deterministic force stays
// reversible and volume-preserving, and the Metropolis step uses the exact
// value, so gradient error costs only acceptance. The reverse pairs (a
// bf16 value tier with an fp32 backward) run on fused_gram_mma.cu's
// reverse mode, this design's mirror.
//
// Replaces: tpu21cmvae/ops/pallas/fused_loglik.py::make_fused_loglik_grad_gram
// (kernel body _loglik_grad_gram_kernel), at (highest, high) and (highest,
// default). Same contract: per row it writes
//   quad = ‖r‖² − c = Σ_j (h@G + 2u)_j · h_j
//   dx   = ½ · d‖r‖²/dx_raw
// where h is the last ReLU trunk activation of the folded network and
// (G, u, c) come from ops/fold.py::gram_fold; the caller returns
// (−½·(quad + c) + log_norm, −dx).
//
// What bounds it on an H100: the fp32 forward on the CUDA cores. At the
// flagship widths (7→288→352→288→224, gram head 224×224) a row needs
// 0.317 M fp32 products forward (0.63 MFLOP: 0.62 ms per 65,536 rows at
// the 67 TFLOP/s peak) and 0.267 M backward at the bf16 tier, which the
// tensor cores run at 989 TFLOP/s (0.035 ms at bf16, 0.11 ms at bf16x3).
// Each row reads 28 bytes and writes 32. The first design
// (fused_loglik_grad_gram.cu's first version: one output column of a 16-row tile per
// thread, every activation in shared memory, the bf16 products emulated by
// fp32 FMAs) spent five loads on every 16 FMAs and ran 2.4× slower than
// its plain PyTorch version at 65,536 rows.
//
// What the design does about it: each half runs where the repo's fastest
// kernel for it runs.
// - Forward: gram_f32.cuh::gram_forward, unchanged: register tiles, the
//   weight slabs streamed through the cp.async ring (the stream K2 reads,
//   ops/kernels/fused_loglik.py::pack_gram_slabs), one mask bit per (row,
//   column) of activations 0 … n−2, and the gram epilogue that stores the
//   backward's first signal e = h > 0 ? h@G + u : 0 in fp32. The value is
//   the fp32 K2's (fused_loglik_gram.cu) bit for bit at the same tile
//   height.
// - Boundary: one pass writes e from its k-major fp32 tile (element c·S +
//   r) into a row-major bf16 A tile, split once (bf16x3: hi = bits &
//   0xFFFF0000, lo = bf16_rn(x − hi)) or rounded once (bf16), as the
//   plain version's tier_matmul treats the backward's input.
// - Backward: for trunk layers i = n−1 … 1, mma.cuh::mma_layer over W_iᵀ's
//   packed B fragments at the backward tier; the epilogue masks with
//   activation i−1's bits (mask_rows maps MaskBits' layout onto the mma
//   rows) and writes the next A tile, split or rounded once. Layer 1
//   writes e in fp32, and the skinny layer's backward runs as exact fp32
//   (j ascending) times the log-clamp's derivative, as in the parents.
//   The masks come from the fp32 pre-activations, never from a split
//   tile: hi() of a tiny positive subnormal is 0.
// - Tile: BM = 32 rows (two m16 tiles) or 16 (one) per CTA of 256
//   threads, picked per call (ops/kernels/fused_loglik.py::pick_grad_rows).
//   Shared memory, in order: the masks, the per-row partials, then two
//   regions. The first holds the fp32 e (gram_forward is handed its two
//   buffers so that e lands there) and later the second A tile; the
//   second holds the last activation, the slab ring and the input tile,
//   dead once e is stored, and later the first A tile. At the flagship
//   with BM = 32: 3,712 + 1,024 + 46,080 + 62,336 = 113,152 bytes at
//   bf16x3, 112,128 at bf16 (the fp32 K3's), so two CTAs share an SM.
// - Members: grid y runs an ensemble's M members in one launch. The
//   operand struct, moved to member blockIdx.y, is kept once per CTA in
//   shared memory (a copy per thread, in local memory, ran the
//   tensor-core kernels 30-52 % slower on an H100). Nothing else changes
//   with M, so a member's rows come out bit for bit as from a launch of
//   that member alone.
// mma.sync through mma.cuh; wgmma and TMA are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tpu21cmvae_torch/ops/kernels/_build.py).

#include <algorithm>
#include <cstdint>

#include "gram_f32.cuh"
#include "mma.cuh"

namespace {

struct MixedNet {
  GramNet f;                       // the fp32 forward: skinny layer, then the stream through G
  const uint32_t* wt[kMaxLayers];  // layer i ≥ 1: W_iᵀ's B fragments at the backward tier
  long long s_wt[kMaxLayers];      // their member strides in bytes (0: one model)
  int stride;                      // row stride of the bf16 A tiles, in elements
  int mask_bytes;                  // shared-memory layout (launch_mixed): the masks,
  int r1_floats;                   // then the partials, then the first region
};
// Its shared copy is the kernel's static shared memory, which the launch
// and ops/kernels/fused_loglik.py::grad_mixed_bytes count beside the
// dynamic bytes.
static_assert(sizeof(MixedNet) == 256, "fused_loglik.py's MIXED_NET_BYTES");

// The rows of column `col` of a mask that relu_mask_store or
// skinny_hidden_masked wrote (MaskBits<BM>): from 16 rows up a column is
// one little-endian word of kColBytes bytes holding bit r for tile row r,
// which is how the mma epilogue indexes its rows (mma_row).
template <int BM>
__device__ __forceinline__ unsigned mask_rows(const uint8_t* mask, int col) {
  static_assert(BM == 16 || BM == 32, "one 16- or 32-bit word per column");
  return load_bits<MaskBits<BM>::kColBytes>(mask + col * MaskBits<BM>::kColBytes);
}

// PARTS: of the backward tier (2 bf16x3, 1 bf16). Two CTAs per SM cap
// the registers at 128, which mma_layer at two m16 tiles needs (K1's
// fused_mlp_mma.cu: 120); 16-row tiles run where the batch has at most
// one CTA per SM (pick_grad_rows), so they keep the same cap.
template <int BM, int PARTS>
__global__ void __launch_bounds__(kThreads, 2)
fused_gram_mixed_kernel(const float* __restrict__ x, float* __restrict__ quad,
                        float* __restrict__ dx, int n_rows, const MixedNet net_in) {
  // member blockIdx.y: its operands, moved there once per CTA into a
  // shared copy; its rows of quad and dx; x is shared
  __shared__ MixedNet net;
  if (threadIdx.x == 0) {
    net = net_in;
    to_member(net.f, blockIdx.y);
#pragma unroll
    for (int i = 1; i < kMaxLayers; ++i) net.wt[i] = member_at(net.wt[i], net.s_wt[i], blockIdx.y);
  }
  __syncthreads();
  const int n_in = net.f.width[0];
  const int n = net.f.n_layers;
  quad += static_cast<size_t>(blockIdx.y) * n_rows;
  dx += static_cast<size_t>(blockIdx.y) * n_rows * n_in;
  using R = GradRing<BM>;
  using M = MaskBits<BM>;
  constexpr int MT = BM / 16;
  constexpr int S = tile_stride(BM);
  extern __shared__ float4 smem_mixed[];
  uint8_t* const base = reinterpret_cast<uint8_t*>(smem_mixed);
  float* const red = reinterpret_cast<float*>(base + net.mask_bytes);
  float* const r1 = red + kRedFloats;
  float* const r2 = r1 + net.r1_floats;

  // forward: quad, the masks of activations 0 … n−2, e in fp32. It swaps
  // its two buffers once per streamed trunk layer (n − 1 of them) and
  // writes e into the one that does not hold the last activation: buf0
  // for an even layer count, buf1 for an odd one. So e lands in r1, and
  // the last activation in r2, beside the ring and the input tile.
  GramTile tile;
  tile.mask = base;
  tile.red = red;
  tile.buf0 = n % 2 == 0 ? r1 : r2;
  tile.buf1 = n % 2 == 0 ? r2 : r1;
  tile.ring = r2 + S * net.f.buf_cols;
  tile.xl = tile.ring + R::kSlots * R::kFloats;
  int g = 0;
  float *h, *e;
  uint8_t* mask;
  gram_forward<BM, R, true>(x, quad, n_rows, net.f, tile, g, h, e, mask);

  // e as layer 0's backward signal in fp32: e itself for a trunk of the
  // skinny layer alone, else the fp32 output of backward layer 1
  const float* grad0 = e;
  if (n > 1) {
    // boundary: e into the first A tile, over r2 (every thread is past
    // the gram epilogue: reduce_rows ends the forward with a barrier)
    const int stride = net.stride;
    const int tile_elems = BM * stride;
    __nv_bfloat16* in = reinterpret_cast<__nv_bfloat16*>(r2);
    __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(r1);
    const int kp = pad16(net.f.width[n]);
    for (int t = threadIdx.x; t < BM * kp / 2; t += blockDim.x) {
      const int r = t % BM;
      const int c = 2 * (t / BM);
      store_pair<PARTS>(in, tile_elems, r * stride + c, e[c * S + r], e[(c + 1) * S + r]);
    }
    __syncthreads();

    // backward through trunk layers n−1 … 1: e ← (e @ W_iᵀ) where
    // activation i−1 was positive, else 0; layer 1 writes fp32, k-major
    for (int i = n - 1; i >= 1; --i) {
      mask -= M::kColBytes * padk(net.f.width[i]);
      const uint8_t* const m = mask;
      float* const f = reinterpret_cast<float*>(out);
      mma_layer<PARTS, MT>(in, pad16(net.f.width[i + 1]), net.wt[i], net.f.width[i], stride,
                           tile_elems, [&](int col, const float (&a)[MT][4]) {
                             const unsigned m0 = mask_rows<BM>(m, col);
                             const unsigned m1 = mask_rows<BM>(m, col + 1);
#pragma unroll
                             for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                               for (int hh = 0; hh < 2; ++hh) {
                                 const int r = mma_row(mt, hh);
                                 const float e0 = (m0 >> r) & 1u ? a[mt][2 * hh] : 0.f;
                                 const float e1 = (m1 >> r) & 1u ? a[mt][2 * hh + 1] : 0.f;
                                 if (i == 1) {
                                   f[col * S + r] = e0;
                                   f[(col + 1) * S + r] = e1;
                                 } else {
                                   store_pair<PARTS>(out, tile_elems, r * stride + col, e0, e1);
                                 }
                               }
                           });
      __syncthreads();
      grad0 = f;
      __nv_bfloat16* const done = in;
      in = out;
      out = done;
    }
  }

  // skinny layer backward, exact fp32, times the log-clamp derivative
  const int n1 = net.f.width[1];
  const int row0 = blockIdx.x * BM;
  for (int t = threadIdx.x; t < BM * n_in; t += blockDim.x) {
    const int r = t % BM;
    const int c = t / BM;
    const int row = row0 + r;
    float acc = 0.f;
    for (int j = 0; j < n1; ++j) acc = fmaf(grad0[j * S + r], __ldg(net.f.w0 + c * n1 + j), acc);
    if (row < n_rows) {
      const size_t at = static_cast<size_t>(row) * n_in + c;
      dx[at] = log_clamp_grad(x[at], c) * acc;
    }
  }
}

// Fills the layout, checks the shared memory and launches. The CTA's
// dynamic shared memory (ops/kernels/fused_loglik.py::grad_mixed_bytes
// mirrors it, with the static copy of the net): the mask bytes, the
// per-row partials, then the regions r1 = max(fp32 tile, A tile) and r2 =
// max(fp32 tile + ring + input tile, A tile).
template <int BM, int PARTS>
cudaError_t launch_mixed(const float* x, float* quad, float* dx, int n_rows, int n_members,
                         MixedNet net, cudaStream_t s) {
  using R = GradRing<BM>;
  constexpr int S = tile_stride(BM);
  const size_t tile = sizeof(float) * S * net.f.buf_cols;
  const size_t a = sizeof(__nv_bfloat16) * PARTS * BM * net.stride;
  const size_t rest = tile + sizeof(float) * (R::kSlots * R::kFloats + S * net.f.width[0]);
  const size_t r1 = std::max(tile, a);
  net.mask_bytes = gram_mask_bytes<BM>(net.f);
  net.r1_floats = static_cast<int>(r1 / sizeof(float));
  const size_t smem = net.mask_bytes + sizeof(float) * kRedFloats + r1 + std::max(rest, a);
  if (smem + sizeof(MixedNet) > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  net.f.total = gram_stream_slabs<BM, R>(net.f, false);
  auto* kernel = fused_gram_mixed_kernel<BM, PARTS>;
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

template <int BM>
cudaError_t launch_mixed_at(const float* x, float* quad, float* dx, int n_rows, int n_members,
                            const MixedNet& net, int tier_bwd, cudaStream_t s) {
  return tier_bwd == kBF16x3 ? launch_mixed<BM, 2>(x, quad, dx, n_rows, n_members, net, s)
                             : launch_mixed<BM, 1>(x, quad, dx, n_rows, n_members, net, s);
}

}  // namespace

extern "C" {

// ptrs, in order: w0, b0 (the skinny first layer, exact fp32), the packed
// fp32 slabs and padded biases of trunk layers 1 … n_layers-1 and of G,
// whose bias slot holds u (ops/kernels/fused_loglik.py::pack_gram_slabs,
// K2's stream), then for i = 1 … n_layers-1 the B fragments of W_iᵀ at
// tier_bwd (ops/kernels/fused_loglik.py::pack_grad_fragments). strides:
// each operand's member stride in bytes, parallel to ptrs; n_members (1 …
// 65,535) networks run on the same x, member m writing quad[m·n_rows …]
// and dx[m·n_rows·n_in …] (a single model: 1 member, zero strides).
// tier_bwd: 1 bf16, 2 bf16x3. tile_rows: the CTA's rows, 32 or 16.
// Launches on `stream`, allocates nothing and does not synchronise;
// returns the cudaError_t of the launch.
int k3_fused_loglik_grad_gram_mixed(const float* x, float* quad, float* dx, int n_rows,
                                    int n_layers, const int* widths, const void* const* ptrs,
                                    const long long* strides, int n_members, int tier_bwd,
                                    int tile_rows, void* stream) {
  MixedNet net{};
  if (!read_gram_net(n_rows, n_layers, widths, ptrs, strides, n_members, net.f) ||
      (tier_bwd != kBF16 && tier_bwd != kBF16x3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int kp_max = 0;
  for (int i = 1; i <= n_layers; ++i) kp_max = std::max(kp_max, (widths[i] + 15) & ~15);
  net.stride = kp_max + 8;
  for (int i = 1; i < n_layers; ++i) {
    net.wt[i] = static_cast<const uint32_t*>(ptrs[3 + i]);
    net.s_wt[i] = strides[3 + i];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tile_rows) {
    case 32: err = launch_mixed_at<32>(x, quad, dx, n_rows, n_members, net, tier_bwd, s); break;
    case 16: err = launch_mixed_at<16>(x, quad, dx, n_rows, n_members, net, tier_bwd, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
