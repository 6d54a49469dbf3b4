// K1 for Hopper at the bf16 tiers ("high" bf16x3, "default" bf16): the
// whole dense MLP for a batch of rows in one kernel, its products on the
// tensor cores; optionally reduced to each row's sum of squares. The fp32
// tier and a network whose only layer is skinny stay on fused_mlp.cu.
//
// Replaces: tpu21cmvae/ops/pallas/fused_mlp.py::make_fused_mlp (kernel
// body _mlp_kernel, products _dot_refs), at its bf16 tiers. Same
// contract as fused_mlp.cu: optional log10/clamp of input columns 0–2, a
// skinny first layer (fan-in ≤ 8) in exact fp32, else a tier matmul,
// (matmul + bias, ReLU that keeps NaN) for every hidden layer, a linear
// last layer; with sumsq it writes Σ_j y_j² per row instead of y. Rows
// past the batch are zero in the input tile and never stored.
//
// Arithmetic: the products of the plain version (ops/fold.py). bf16x3:
// hi(a)·w_hi + hi(a)·w_lo + lo(a)·w_hi with hi(x) = bits(x) & 0xFFFF0000
// and lo(x) = bf16_rn(x − hi(x)); bf16: bf16_rn(a)·bf16_rn(w). Every
// product is of bf16 values and exact in fp32, so the kernel and the
// plain version differ only in summation order. Each k-step's 16 (bf16)
// or 48 (bf16x3: three mmas) products are summed by mma.sync.m16n8k16
// from zero and then added to the running fp32 sum by an IEEE add: the
// tensor cores' own accumulation does not round to nearest, and with the
// running sum as the mma's addend the kernel's bf16 results sat farther
// from both the plain version and the CUDA-core kernel (K1 sumsq at bf16,
// 65,537 rows: 1.82 of the value tolerance; PERF.md). The add costs
// nothing measurable at bf16 and 2 % at bf16x3.
//
// What bounds it on an H100: at the flagship widths (7→288→352→288→224→
// 451) a row needs 0.74 MFLOP of tier products, 2.2 MFLOP of bf16 tensor
// work at bf16x3, and the CTA streams every layer's weights from L2 once
// per row tile (bf16x3: hi and lo, 1.47 MB; bf16: 0.74 MB). At 1 M rows
// and 32 rows a tile that is ≈ 48 GB of L2 reads at bf16x3, the larger
// bound; the tensor cores' share is a few ms. The bf16 tiers of the
// CUDA-core kernel were bound by fp32 FMA issue instead, with a split and
// three FMAs (bf16x3) or a rounding (bf16) for every product.
//
// What the design does about it:
// - Tensor cores: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
//   A fragments by ldmatrix from shared memory, B fragments straight
//   from device memory (L2), the next k-step's loaded before this step's
//   mmas.
// - Split or round once per element per layer: a layer's epilogue adds
//   the bias to the fp32 accumulator, applies ReLU and writes the
//   activation into the next layer's tile already in bf16 (hi and lo
//   tiles at bf16x3, one rounded tile at bf16). Tiles are row-major with
//   a row stride of (widest padded width + 8) bf16, so ldmatrix's eight
//   16-byte rows fall in eight different bank groups.
// - Work split: one CTA of 8 warps per tile of 32 rows (two m16 tiles);
//   the warps split a layer's n8 output tiles evenly (288 = 36 tiles: 4
//   or 5 each) and carry up to kNTiles of them at once, so one ldmatrix
//   feeds kNTiles·2 (bf16) or kNTiles·6 (bf16x3) mmas. A 64-row tile (two
//   such row groups, 16 warps, one CTA per SM) halves the weight stream
//   if the second group's fragment loads hit L1, but measured no faster
//   on an H100 (PERF.md), so the tile is 32 rows.
// - Weights are packed once by the wrapper (ops/kernels/fused_mlp.py::
//   pack_mma_operands) as bf16 B fragments, transposed and zero-padded to
//   multiples of 16: each lane's fragment for one n8 tile and one k-step
//   is 8 (bf16) or 16 (bf16x3: hi then lo) contiguous bytes, so a warp's
//   load is one coalesced 256- or 512-byte read. Padded columns have zero
//   weights and bias, so they come out 0 and the next layer's padded k
//   rows read zeros, never uninitialised shared memory.
// - The last layer stays in registers: predict stores its (row, column)
//   pairs, masked past the batch and past the width; sumsq squares and
//   sums in registers, reduces over the 4 lanes of a row with shuffles and
//   over the 8 warps through shared memory in a fixed order.
// Shared memory per CTA: 2 buffers · parts · rows · stride · 2 bytes, plus
// the fp32 input tile and the sumsq partials: 94,080 bytes at the
// flagship, bf16x3, 32 rows (two CTAs per SM). wgmma, TMA and warp
// specialisation are left for later work.
//
// The tensor-core layer, the split-once stores and the skinny layer are
// in mma.cuh, which K2 and K3 at their bf16 tiers (fused_gram_mma.cu)
// share; this file holds K1's epilogues.
//
// Members: grid y runs an ensemble's M members in one launch, each CTA on
// one member's stacked operands (trunk.cuh, member_at). Nothing else
// changes with M, so a member's rows come out bit for bit as from a
// launch of that member alone.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tpu21cmvae_torch/ops/kernels/_build.py).

#include <algorithm>
#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int kTileRows = 32;  // rows per CTA
constexpr int kMTiles = kTileRows / 16;

struct MmaNet {
  int n_layers;
  int width[kMaxLayers + 1];  // width[0] = n_in; layer i maps width[i] → width[i+1]
  int first;                  // first tensor-core layer: 1 after a skinny layer 0
  int stride;                 // row stride of the bf16 tiles, in elements
  int log_clamp;
  int sumsq;
  const uint32_t* w[kMaxLayers];  // packed B fragments; fp32 (n_in, width[1]) if skinny
  const float* b[kMaxLayers];     // padded to a multiple of 16; exact if skinny
  long long s_w[kMaxLayers], s_b[kMaxLayers];  // member strides in bytes (0: one model)
};

// The net of member m: every operand moved by m times its stride.
__device__ __forceinline__ void to_member(MmaNet& net, int m) {
#pragma unroll
  for (int i = 0; i < kMaxLayers; ++i) {
    net.w[i] = member_at(net.w[i], net.s_w[i], m);
    net.b[i] = member_at(net.b[i], net.s_b[i], m);
  }
}

template <int PARTS>
__global__ void __launch_bounds__(kMmaThreads, 2)
fused_mlp_mma_kernel(const float* __restrict__ x, float* __restrict__ y, int n_rows,
                     const MmaNet net_in) {
  // member blockIdx.y: its operands, moved there once per CTA into a
  // shared copy (a copy per thread, in local memory, ran these kernels
  // 30-50 % slower on an H100), its rows of y; x is shared
  __shared__ MmaNet net;
  if (threadIdx.x == 0) {
    net = net_in;
    to_member(net, blockIdx.y);
  }
  __syncthreads();
  y += static_cast<size_t>(blockIdx.y) * n_rows * (net.sumsq ? 1 : net.width[net.n_layers]);
  extern __shared__ uint4 smem_mma[];
  const int tile_elems = kTileRows * net.stride;
  const int buf_elems = PARTS * tile_elems;  // buffer b at buf + b * buf_elems
  __nv_bfloat16* const buf = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  float* xl = reinterpret_cast<float*>(buf + 2 * buf_elems);
  const int n_in = net.width[0];
  float* red = xl + kTileRows * n_in;
  const int last = net.n_layers - 1;
  const int row0 = blockIdx.x * kTileRows;
  const int stride = net.stride;

  if (net.first == 1) {  // skinny layer 0 from the fp32 input tile
    for (int t = threadIdx.x; t < kTileRows * n_in; t += blockDim.x) {
      const int row = row0 + t / n_in;
      const int c = t % n_in;
      float v = 0.f;
      if (row < n_rows) {
        v = x[static_cast<size_t>(row) * n_in + c];
        if (net.log_clamp) v = log_clamp(v, c);
      }
      xl[t] = v;
    }
    __syncthreads();
    skinny_layer(xl, kTileRows, n_in, reinterpret_cast<const float*>(net.w[0]), net.b[0],
                 net.width[1], [&](int r, int j, float v) {
                   store_one<PARTS>(buf, tile_elems, r * stride + j, v);
                 });
  } else {  // the input itself is layer 0's A operand, split once
    const int kp = pad16(n_in);
    for (int t = threadIdx.x; t < kTileRows * kp; t += blockDim.x) {
      const int r = t / kp;
      const int c = t % kp;
      const int row = row0 + r;
      float v = 0.f;
      if (c < n_in && row < n_rows) {
        v = x[static_cast<size_t>(row) * n_in + c];
        if (net.log_clamp) v = log_clamp(v, c);
      }
      store_one<PARTS>(buf, tile_elems, r * stride + c, v);
    }
  }
  __syncthreads();

  float ss[kMTiles][2] = {};
  int cur = 0;
  for (int i = net.first; i < last; ++i) {  // hidden layers, ReLU
    const float* bias = net.b[i];
    __nv_bfloat16* out = buf + (cur ^ 1) * buf_elems;
    mma_layer<PARTS, kMTiles>(buf + cur * buf_elems, pad16(net.width[i]), net.w[i],
                              net.width[i + 1], stride, tile_elems,
                              [&](int col, const float (&a)[kMTiles][4]) {
                                const float2 bj = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
                                for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
                                  for (int h = 0; h < 2; ++h)
                                    store_pair<PARTS>(out, tile_elems,
                                                      mma_row(mt, h) * stride + col,
                                                      relu(a[mt][2 * h] + bj.x),
                                                      relu(a[mt][2 * h + 1] + bj.y));
                              });
    __syncthreads();
    cur ^= 1;
  }
  const __nv_bfloat16* in = buf + cur * buf_elems;
  const int kp = pad16(net.width[last]);
  const int n_out = net.width[last + 1];
  const float* bias = net.b[last];
  if (!net.sumsq) {  // predict: store the (row, column) pairs inside the batch and the width
    mma_layer<PARTS, kMTiles>(in, kp, net.w[last], n_out, stride, tile_elems,
                              [&](int col, const float (&a)[kMTiles][4]) {
                                const float2 bj = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
                                for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
                                  for (int h = 0; h < 2; ++h) {
                                    const int row = row0 + mma_row(mt, h);
                                    if (row >= n_rows) continue;
                                    float* yr = y + static_cast<size_t>(row) * n_out + col;
                                    if (col < n_out) yr[0] = a[mt][2 * h] + bj.x;
                                    if (col + 1 < n_out) yr[1] = a[mt][2 * h + 1] + bj.y;
                                  }
                              });
    return;
  }
  mma_layer<PARTS, kMTiles>(in, kp, net.w[last], n_out, stride, tile_elems,
                            [&](int col, const float (&a)[kMTiles][4]) {
                              const float2 bj = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
                              for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
                                for (int h = 0; h < 2; ++h) {  // padded columns add 0
                                  const float v0 = a[mt][2 * h] + bj.x;
                                  const float v1 = a[mt][2 * h + 1] + bj.y;
                                  ss[mt][h] = fmaf(v1, v1, fmaf(v0, v0, ss[mt][h]));
                                }
                            });
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = ss[mt][h];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if ((lane & 3) == 0) red[warp * kTileRows + mma_row(mt, h)] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x < kTileRows && row0 + threadIdx.x < n_rows) {
    float s = 0.f;
    for (int k = 0; k < kMmaWarps; ++k) s += red[k * kTileRows + threadIdx.x];
    y[row0 + threadIdx.x] = s;
  }
}

template <int PARTS>
cudaError_t launch_mma(const float* x, float* y, int n_rows, int n_members, const MmaNet& net,
                       size_t smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(fused_mlp_mma_kernel<PARTS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_rows + kTileRows - 1) / kTileRows, n_members);
  fused_mlp_mma_kernel<PARTS><<<grid, kMmaThreads, smem, stream>>>(x, y, n_rows, net);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs, in order, for each layer i = 0 … n_layers-1: w, b. w is the
// packed bf16 B fragments of ops/kernels/fused_mlp.py::pack_mma_operands
// and b its bias zero-padded to a multiple of 16, except for a skinny
// first layer (n_in ≤ 8), whose w (n_in, width[1]) and b are exact fp32.
// strides: each operand's member stride in bytes, parallel to ptrs;
// n_members (1 … 65,535) networks run on the same x. tier: 1 bf16, 2
// bf16x3. out is (n_members, n_rows, widths[n_layers]), or (n_members,
// n_rows) with sumsq (a single model: 1 member, zero strides). Launches
// on `stream`, allocates nothing and does not synchronise; returns the
// cudaError_t of the launch.
int k1_fused_mlp_mma(const float* x, float* out, int n_rows, int n_layers, const int* widths,
                     const void* const* ptrs, const long long* strides, int n_members,
                     int tier, int log_clamp, int sumsq, void* stream) {
  if (n_rows <= 0 || !members_ok(n_members) || n_layers < 1 || n_layers > kMaxLayers ||
      (tier != kBF16 && tier != kBF16x3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MmaNet net{};
  net.n_layers = n_layers;
  net.first = widths[0] <= kMaxIn ? 1 : 0;
  net.log_clamp = log_clamp;
  net.sumsq = sumsq;
  if (net.first >= n_layers) return static_cast<int>(cudaErrorInvalidValue);  // fused_mlp.cu's
  int kp_max = 0;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    net.width[i] = widths[i];
    if (i >= net.first && i < n_layers) kp_max = std::max(kp_max, (widths[i] + 15) & ~15);
  }
  net.stride = kp_max + 8;
  const int parts = tier == kBF16x3 ? 2 : 1;
  const size_t smem =
      static_cast<size_t>(2) * parts * kTileRows * net.stride * sizeof(__nv_bfloat16) +
      static_cast<size_t>(kTileRows) * (widths[0] + kMmaWarps) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_layers; ++i) {
    net.w[i] = static_cast<const uint32_t*>(ptrs[2 * i]);
    net.b[i] = static_cast<const float*>(ptrs[2 * i + 1]);
    net.s_w[i] = strides[2 * i];
    net.s_b[i] = strides[2 * i + 1];
  }

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(parts == 2 ? launch_mma<2>(x, out, n_rows, n_members, net, smem, s)
                                     : launch_mma<1>(x, out, n_rows, n_members, net, smem, s));
}

}  // extern "C"
