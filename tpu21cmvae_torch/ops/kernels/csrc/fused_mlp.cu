// K1 for Hopper at the fp32 tier: a whole dense MLP (ReLU hidden layers,
// linear last layer) for a batch of rows, in one kernel; optionally
// reduced to each row's sum of squares. The bf16 tiers run on the tensor
// cores (fused_mlp_mma.cu); a network whose only layer is skinny runs
// here at every tier, since that layer is exact fp32 at every tier.
//
// Replaces: tpu21cmvae/ops/pallas/fused_mlp.py::make_fused_mlp (kernel
// body _mlp_kernel, products _dot_refs), at its exact tier. Same
// contract: optional log10/clamp of input columns 0–2, a skinny first
// layer (fan-in ≤ 8) as exact fp32 FMA, (matmul + bias, ReLU) for every
// hidden layer, a linear last layer; with reduce = sumsq it writes
// Σ_j y_j² per row instead of y. The callers fold the normalizer
// (predict) or the normalizer, observation and noise (the direct
// likelihood) into the first and last layers.
//
// What bounds it on an H100: fp32 FMA throughput on the CUDA cores. At the
// flagship widths (7→288→352→288→224→451) a row needs ≈0.74 MFLOP, 27 %
// of it in the 451-wide output layer. Each row reads 28 bytes; predict
// writes 1804 bytes per row (at 1 M rows, 1.8 GB, about half a
// millisecond of device-memory time), sumsq 4 bytes.
// The weights (≈1.5 MB of fp32 at the flagship) are read once per row
// tile, from L2.
//
// What the design does about it: one CTA of 256 threads per tile of
// kRows = 16 rows, the dense layers of K2 and K3 (trunk.cuh): each thread
// owns one output column at a time, keeps kRows sums in registers, reads
// W[k, j] coalesced across the warp and the activations as broadcast
// float4 loads. Two activation buffers as wide as the widest hidden layer
// take turns as a layer's input and output. The last layer never goes to
// shared memory: each thread adds the bias to its registers and either
// stores its column (a warp writes 32 neighbouring floats of a row) or
// squares and sums it; under sumsq the per-row partial sums are reduced
// across each warp by shuffles and across the 8 warps through shared
// memory, in a fixed order, so the (B, 451) signal never reaches device
// memory. Rows past the batch are zero in the input tile and never
// stored. Shared memory per CTA: 4·kRows·(n_in + 2·max hidden width +
// kWarps) bytes, 46,016 at the flagship. The tensor cores have no IEEE
// fp32 product; register tiling (several rows and columns per thread),
// TMA and persistent CTAs are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tpu21cmvae_torch/ops/kernels/_build.py).

#include "trunk.cuh"

namespace {

struct MlpNet {
  int n_layers;
  int width[kMaxLayers + 1];  // width[0] = n_in; layer i maps width[i] → width[i+1]
  int max_hidden;             // widest hidden layer (0 with a single layer)
  int skinny;                 // layer 0 is exact fp32 FMA (n_in ≤ kMaxIn)
  int log_clamp;              // log10/clamp input columns 0..2
  int sumsq;                  // write Σ y² per row instead of y
  const float* w[kMaxLayers];  // (width[i], width[i+1])
  const float* b[kMaxLayers];  // (width[i+1],)
};

// The linear last layer from registers: y[r, j] = Σ_k in[k, r]·W[k, j] +
// b[j], stored row-major into out (n_rows, n_out), or, under sumsq,
// reduced to out[row] = Σ_j y[r, j]² through `red` (kWarps·kRows floats).
template <bool SKINNY>
__device__ void output_layer(const float* in, int n_in, const float* __restrict__ w,
                             const float* __restrict__ bias, int n_out, int row0, int n_rows,
                             bool sumsq, float* __restrict__ out, float* red) {
  float ss[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) ss[r] = 0.f;
  for (int j = threadIdx.x; j < n_out; j += blockDim.x) {
    float acc[kRows];
    if constexpr (SKINNY) {
      skinny_column(in, n_in, w, n_out, j, acc);
    } else {
      dot_column<kF32>(in, n_in, w, nullptr, n_out, j, acc);
    }
    const float bj = __ldg(bias + j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float y = acc[r] + bj;
      if (sumsq) {
        ss[r] = fmaf(y, y, ss[r]);
      } else if (row0 + r < n_rows) {
        out[static_cast<size_t>(row0 + r) * n_out + j] = y;
      }
    }
  }
  if (!sumsq) return;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float s = ss[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp * kRows + r] = s;
  }
  __syncthreads();
  if (threadIdx.x < kRows && row0 + threadIdx.x < n_rows) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * kRows + threadIdx.x];
    out[row0 + threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out, int n_rows, MlpNet net) {
  extern __shared__ float4 smem4[];
  const int n_in = net.width[0];
  const int last = net.n_layers - 1;
  const int row0 = blockIdx.x * kRows;

  // shared-memory tiles: the input, two activation buffers, the sumsq partials
  float* xl = reinterpret_cast<float*>(smem4);
  float* buf[2] = {xl + n_in * kRows, xl + (n_in + net.max_hidden) * kRows};
  float* red = xl + (n_in + 2 * net.max_hidden) * kRows;

  load_input_tile(x, n_rows, row0, n_in, net.log_clamp != 0, xl);
  __syncthreads();

  const float* in = xl;
  int cur = 0;
  for (int i = 0; i < last; ++i) {  // hidden layers, ReLU
    if (i == 0 && net.skinny) {
      skinny_relu_layer(in, n_in, net.w[0], net.b[0], buf[cur], net.width[1]);
    } else {
      dense<kF32, kBiasRelu>(in, net.width[i], net.w[i], nullptr, net.b[i], buf[cur],
                             net.width[i + 1]);
    }
    __syncthreads();
    in = buf[cur];
    cur ^= 1;
  }
  const int n_out = net.width[last + 1];
  if (last == 0 && net.skinny) {
    output_layer<true>(in, n_in, net.w[0], net.b[0], n_out, row0, n_rows, net.sumsq, out, red);
  } else {
    output_layer<false>(in, net.width[last], net.w[last], net.b[last], n_out, row0, n_rows,
                        net.sumsq, out, red);
  }
}

}  // namespace

extern "C" {

// ptrs, in order, for each layer i = 0 … n_layers-1: w, b, in fp32. out
// is (n_rows, widths[n_layers]), or (n_rows,) with sumsq. Launches on
// `stream`, allocates nothing and does not synchronise; returns the
// cudaError_t of the launch.
int k1_fused_mlp(const float* x, float* out, int n_rows, int n_layers, const int* widths,
                 const void* const* ptrs, int log_clamp, int sumsq, void* stream) {
  if (n_rows <= 0 || n_layers < 1 || n_layers > kMaxLayers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MlpNet net{};
  net.n_layers = n_layers;
  net.skinny = widths[0] <= kMaxIn;
  net.log_clamp = log_clamp;
  net.sumsq = sumsq;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    net.width[i] = widths[i];
    if (i > 0 && i < n_layers && widths[i] > net.max_hidden) net.max_hidden = widths[i];
  }
  const size_t smem =
      static_cast<size_t>(widths[0] + 2 * net.max_hidden + kWarps) * kRows * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);

  for (int i = 0; i < n_layers; ++i) {
    net.w[i] = static_cast<const float*>(ptrs[2 * i]);
    net.b[i] = static_cast<const float*>(ptrs[2 * i + 1]);
  }

  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n_rows + kRows - 1) / kRows;
  fused_mlp_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, out, n_rows,
                                                                               net);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
