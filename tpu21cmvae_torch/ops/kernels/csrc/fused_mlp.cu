// K1 for Hopper at the fp32 tier: a whole dense MLP (ReLU hidden layers,
// linear last layer) for a batch of rows, in one kernel; optionally
// reduced to each row's sum of squares. The bf16 tiers run on the tensor
// cores (fused_mlp_mma.cu); a network whose only layer is skinny runs
// here at every tier, since that layer is exact fp32 at every tier.
//
// Replaces: tpu21cmvae/ops/pallas/fused_mlp.py::make_fused_mlp (kernel
// body _mlp_kernel, products _dot_refs), at its exact tier. Same
// contract: optional log10/clamp of input columns 0–2, a skinny first
// layer (fan-in ≤ 8) in exact fp32, (matmul + bias, ReLU that keeps
// NaN) for every hidden layer, a linear last layer; with sumsq it writes
// Σ_j y_j² per row instead of y. The callers fold the normalizer
// (predict) or the normalizer, observation and noise (the direct
// likelihood) into the first and last layers.
//
// What bounds it on an H100: fp32 FMA throughput on the CUDA cores (IEEE
// fp32 has no tensor-core form). At the flagship widths (7→288→352→288→
// 224→451) a row needs 0.74 MFLOP, 27 % of it in the 451-wide output
// layer: 11.6 ms at 1 M rows at the 67 TFLOP/s peak. Each row reads 28
// bytes; predict writes 1804 bytes per row (1.8 GB at 1 M rows, about
// half a millisecond of device-memory time), sumsq 4 bytes. The first
// design (one output column of a 16-row tile per thread) spent five loads
// on every 16 FMAs, streamed the weights from L2 once per 16 rows, and
// reached 18 % of the peak.
//
// What the design does about it (device code in tile_f32.cuh):
// - Register tiles: a CTA of 256 threads owns BM rows; each thread holds
//   BM/8 × 4 accumulators of a 128-column chunk and per k reads its rows
//   and its 4 weights as float4s from shared memory: 3 loads per 32 FMAs
//   at BM = 64, 2 per 16 at BM = 32.
// - Weight slabs: the wrapper packs the weights once per model
//   (ops/kernels/_common.py::pack_slabs), zero-padded, all layers back to
//   back; a cp.async ring streams them through shared memory as slabs of
//   32 × 128 fp32 values in three slots at BM = 64 (16 × 128 in two at
//   32), one warp-pair barrier per slab, so one L2 read of a weight
//   serves BM rows. The fixed cost of a slab, not the loads, set the
//   first cut's pace: 8-deep slabs ran 1.34× slower than 32-deep ones at
//   BM = 64 (PERF.md).
// - Tile height: the wrapper passes BM, the tallest height up to its
//   preferred one (64) whose shared memory fits (ops/kernels/fused_mlp.py::
//   f32_rows); wide networks take 32, 16 or 8 rows, the same code.
// - Epilogues from registers: hidden layers add the bias, apply ReLU and
//   write the next layer's k-major tile (two ping-pong buffers as wide as
//   the widest hidden layer, padded to 32); the last layer adds the bias
//   and stores its (row, column) pairs inside the batch and the width, or,
//   under sumsq, squares and sums them per thread, then per row across
//   the 8 lanes and the 4 column quarters that share it in a fixed order,
//   so the (B, 451) signal never reaches device memory.
// - The skinny layer stays a (row, column) loop of exact fp32 in the
//   Pallas kernel's order (trunk.cuh, skinny_dot); a network of that layer alone writes straight from it.
// Shared memory per CTA: 4·S·(in rows + 2·buffer columns) bytes of tiles
// plus the ring (48 KB at BM = 64, 16 KB at 32, 12 KB below) and 1 KB of
// partials, S = BM (64, 32), 18 (16), 9 (8): 232,192 bytes at the
// flagship with BM = 64.
//
// Members: grid y runs an ensemble's M members in one launch, each CTA on
// one member's stacked operands (trunk.cuh, member_at). Nothing else
// changes with M, so a member's rows come out bit for bit as from a
// launch of that member alone.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tpu21cmvae_torch/ops/kernels/_build.py).

#include "tile_f32.cuh"

namespace {

struct MlpNet {
  int n_layers;
  int width[kMaxLayers + 1];  // width[0] = n_in; layer i maps width[i] → width[i+1]
  int skinny;                 // layer 0 is exact fp32 (n_in ≤ kMaxIn)
  int in_rows;                // k rows of the input tile: n_in if skinny, else padk(n_in)
  int buf_cols;               // k rows of each activation buffer: widest hidden, padded to 32
  int log_clamp;              // log10/clamp input columns 0..2
  int total;                  // slabs in the stream (the layers after a skinny one) at BM
  const float* w0;            // skinny layer: (n_in, width[1]), exact fp32
  const float* b0;            // (width[1],)
  const float* slabs;         // the streamed layers' packed slabs
  const float* bias;          // their biases, each padded to 128·chunks
  long long s_w0, s_b0, s_slabs, s_bias;  // member strides in bytes (0: one model)
};

// The net of member m: every operand moved by m times its stride.
__device__ __forceinline__ void to_member(MlpNet& net, int m) {
  net.w0 = member_at(net.w0, net.s_w0, m);
  net.b0 = member_at(net.b0, net.s_b0, m);
  net.slabs = member_at(net.slabs, net.s_slabs, m);
  net.bias = member_at(net.bias, net.s_bias, m);
}

// The lone skinny layer is the output layer: y = skinny_value, stored, or
// squared and summed per row (phase p of P = kThreads/BM takes columns p,
// p + P, …; the phases are summed in order).
template <int BM, bool SUMSQ>
__device__ void skinny_output(const float* xl, const MlpNet& net, int row0, int n_rows,
                              float* __restrict__ y, float* red) {
  const int n_in = net.width[0];
  const int n_out = net.width[1];
  if constexpr (!SUMSQ) {
    for (int t = threadIdx.x; t < BM * n_out; t += blockDim.x) {
      const int r = t / n_out;
      const int j = t % n_out;
      if (row0 + r < n_rows)
        y[static_cast<size_t>(row0 + r) * n_out + j] =
            skinny_value<BM>(xl, n_in, net.w0, net.b0, n_out, r, j);
    }
  } else {
    constexpr int P = kThreads / BM;
    const int r = threadIdx.x % BM;
    const int p = threadIdx.x / BM;
    float s = 0.f;
    for (int j = p; j < n_out; j += P) {
      const float v = skinny_value<BM>(xl, n_in, net.w0, net.b0, n_out, r, j);
      s = fmaf(v, v, s);
    }
    red[p * BM + r] = s;
    __syncthreads();
    if (threadIdx.x < BM && row0 + static_cast<int>(threadIdx.x) < n_rows) {
      float sum = 0.f;
      for (int q = 0; q < P; ++q) sum += red[q * BM + threadIdx.x];
      y[row0 + threadIdx.x] = sum;
    }
  }
}

// Launch bounds: at 64 rows the flagship's shared memory holds one CTA per
// SM, and asking for two caps registers at 128, under which K1 keeps
// ptxas's own 96 (sumsq) and 114 (predict); a cap of 80 ran slower
// (PERF.md).
template <int BM, bool SUMSQ>
__global__ void __launch_bounds__(kThreads, BM >= 32 ? 2 : BM == 16 ? 3 : 4)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ y, int n_rows, MlpNet net) {
  // member blockIdx.y: its operands and its rows of y; x is shared
  to_member(net, blockIdx.y);
  y += static_cast<size_t>(blockIdx.y) * n_rows * (SUMSQ ? 1 : net.width[net.n_layers]);
  constexpr int TM = BM / 8;
  constexpr int S = tile_stride(BM);
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  float* const red = ring + Ring<BM>::kSlots * Ring<BM>::kFloats;
  float* const buf[2] = {red + kRedFloats, red + kRedFloats + S * net.buf_cols};
  float* const xl = buf[1] + S * net.buf_cols;
  const int n_in = net.width[0];
  const int last = net.n_layers - 1;
  const int row0 = blockIdx.x * BM;

  start_ring<BM>(ring, net.slabs, net.total);
  load_input<BM>(x, n_rows, row0, n_in, net.in_rows, net.log_clamp != 0, xl);
  __syncthreads();
  if (net.skinny && last == 0) {
    skinny_output<BM, SUMSQ>(xl, net, row0, n_rows, y, red);
    return;
  }

  const float* in = xl;
  int first = 0;
  if (net.skinny) {
    skinny_hidden<BM>(xl, n_in, net.w0, net.b0, net.width[1], buf[0]);
    in = buf[0];
    first = 1;
  }
  int g = 0;
  const float* bias = net.bias;
  for (int i = first; i < last; ++i) {  // hidden layers, ReLU
    float* out = in == buf[0] ? buf[1] : buf[0];
    const int n = net.width[i + 1];
    tile_layer<BM>(in, net.width[i], n, net.slabs, net.total, ring, g,
                   [&](int c0, const float (&acc)[TM][4]) { relu_store<BM>(out, bias, n, c0, acc); });
    bias += chunks(n) * kSlabN;
    in = out;
  }

  const int n_out = net.width[last + 1];
  const TileThread<BM> t;
  if constexpr (!SUMSQ) {  // predict: the (row, column) pairs inside the batch and the width
    tile_layer<BM>(in, net.width[last], n_out, net.slabs, net.total, ring, g,
                   [&](int c0, const float (&acc)[TM][4]) {
                     const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + c0));
                     const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
                     for (int i = 0; i < TM; ++i) {
                       const int row = row0 + t.row + i;
                       if (row >= n_rows) break;
                       float* yr = y + static_cast<size_t>(row) * n_out;
#pragma unroll
                       for (int q = 0; q < 4; ++q)
                         if (c0 + q < n_out) yr[c0 + q] = acc[i][q] + b[q];
                     }
                   });
  } else {  // sumsq: padded columns are exactly 0 and add nothing
    float ss[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) ss[i] = 0.f;
    tile_layer<BM>(in, net.width[last], n_out, net.slabs, net.total, ring, g,
                   [&](int c0, const float (&acc)[TM][4]) {
                     const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + c0));
                     const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
                     for (int i = 0; i < TM; ++i)
#pragma unroll
                       for (int q = 0; q < 4; ++q) {
                         const float v = acc[i][q] + b[q];
                         ss[i] = fmaf(v, v, ss[i]);
                       }
                   });
    reduce_rows<BM>(ss, red, y, row0, n_rows);
  }
}

template <int BM, bool SUMSQ>
cudaError_t launch_mlp(const float* x, float* y, int n_rows, int n_members, MlpNet net,
                       cudaStream_t s) {
  const size_t smem = tile_smem_bytes<BM>(net.in_rows, net.buf_cols);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const int first = net.skinny ? 1 : 0;
  net.total = stream_slabs<BM>(net.width + first, net.width + first + 1, net.n_layers - first);
  auto* kernel = fused_mlp_kernel<BM, SUMSQ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n_rows + BM - 1) / BM, n_members), kThreads, smem, s>>>(x, y, n_rows, net);
  return cudaGetLastError();
}

template <bool SUMSQ>
cudaError_t launch_height(int rows, const float* x, float* y, int n_rows, int n_members,
                          const MlpNet& net, cudaStream_t s) {
  switch (rows) {
    case 64: return launch_mlp<64, SUMSQ>(x, y, n_rows, n_members, net, s);
    case 32: return launch_mlp<32, SUMSQ>(x, y, n_rows, n_members, net, s);
    case 16: return launch_mlp<16, SUMSQ>(x, y, n_rows, n_members, net, s);
    case 8: return launch_mlp<8, SUMSQ>(x, y, n_rows, n_members, net, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// ptrs, in order: w0, b0 (the skinny first layer's exact fp32 weights and
// bias; null when layer 0 is not skinny), then the packed slabs and the
// padded biases of every other layer (ops/kernels/_common.py::pack_slabs).
// strides: each operand's member stride in bytes, parallel to ptrs;
// n_members (1 … 65,535) networks run on the same x. out is (n_members,
// n_rows, widths[n_layers]), or (n_members, n_rows) with sumsq (a single
// model: 1 member, zero strides). tile_rows: the CTA's rows, 64, 32, 16
// or 8. Launches on `stream`, allocates nothing and does not synchronise;
// returns the cudaError_t of the launch.
int k1_fused_mlp(const float* x, float* out, int n_rows, int n_layers, const int* widths,
                 const void* const* ptrs, const long long* strides, int n_members,
                 int log_clamp, int sumsq, int tile_rows, void* stream) {
  if (n_rows <= 0 || !members_ok(n_members) || n_layers < 1 || n_layers > kMaxLayers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MlpNet net{};
  net.n_layers = n_layers;
  net.skinny = widths[0] <= kMaxIn;
  net.log_clamp = log_clamp;
  net.in_rows = net.skinny ? widths[0] : padk(widths[0]);
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    net.width[i] = widths[i];
    if (i > 0 && i < n_layers && padk(widths[i]) > net.buf_cols) net.buf_cols = padk(widths[i]);
  }
  net.w0 = static_cast<const float*>(ptrs[0]);
  net.b0 = static_cast<const float*>(ptrs[1]);
  net.slabs = static_cast<const float*>(ptrs[2]);
  net.bias = static_cast<const float*>(ptrs[3]);
  net.s_w0 = strides[0];
  net.s_b0 = strides[1];
  net.s_slabs = strides[2];
  net.s_bias = strides[3];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      sumsq ? launch_height<true>(tile_rows, x, out, n_rows, n_members, net, s)
            : launch_height<false>(tile_rows, x, out, n_rows, n_members, net, s));
}

}  // extern "C"
