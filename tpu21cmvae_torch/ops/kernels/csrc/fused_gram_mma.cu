// K3 and K2 for Hopper at the bf16 tiers ("high" bf16x3, "default"
// bf16): the gram-form Gaussian log-likelihood of a batch of rows, with
// (K3) or without (K2) its gradient with respect to the raw parameters,
// in one kernel whose products run on the tensor cores. K3 at a reverse
// pair (a bf16 value tier with an fp32 backward) runs here too, in a
// mode of its own (PB = kGradF32): this forward, then the backward
// register-tiled on the CUDA cores. The fp32 tier runs on
// fused_loglik_grad_gram_f32.cu (K3) and fused_loglik_gram.cu (K2); K3 at
// an fp32 value tier with a bf16 backward on fused_gram_mixed.cu, whose
// backward is this kernel's; a network too wide for this kernel's shared
// memory at a reverse pair on fused_loglik_grad_gram.cu.
//
// Replaces, at their bf16 tiers:
//   K3 tpu21cmvae/ops/pallas/fused_loglik.py::make_fused_loglik_grad_gram
//      (kernel body _loglik_grad_gram_kernel);
//   K2 tpu21cmvae/ops/pallas/fused_loglik.py::make_fused_loglik_gram
//      (kernel body _loglik_gram_kernel).
// Same contract: per row it writes
//   quad = ‖r‖² − c = Σ_j (h@G + 2u)_j · h_j
//   dx   = ½ · d‖r‖²/dx_raw   (K3 only)
// where h is the last ReLU trunk activation of the folded network and
// (G, u, c) come from ops/fold.py::gram_fold; the caller returns
// −½·(quad + c) + log_norm and −dx.
//
// Arithmetic: the products of the plain version (ops/kernels/
// fused_loglik.py::loglik_grad_gram_reference), split or rounded exactly
// as its tier_matmul does (mma.cuh), so kernel and plain differ only in
// summation order. The skinny first layer (fan-in ≤ 8) is exact fp32 in
// both directions, the forward in the plain version's order (skinny_dot). The ReLU masks of the backward are taken from the
// fp32 activations, as the plain version takes them, never from a split
// tile: hi() and bf16_rn() of a tiny positive subnormal are 0. The quad
// multiplies the fp32 h, not its split.
//
// What bounds it on an H100: at the flagship widths (7→288→352→288→224,
// gram head 224×224) a row needs 0.317 M tier products forward and 0.267 M
// backward: 2.44 MFLOP of bf16 tensor work at (high, default), 3.51 at
// (high, high), 1.90 for K2 at high. A tile's CTA streams every layer's
// packed weights from L2 (K3 high/default: 1.27 MB forward, 0.53 MB
// backward). At HMC's 4096 rows the grid is one wave of CTAs, so one
// CTA's chain of seven tensor-core layers sets the time, not the card's
// throughput (0.11 ms of device time against a 0.011 ms bound; PERF.md).
// The reverse mode's backward is 0.267 M fp32 products per row on the
// CUDA cores (0.52 ms per 65,536 rows at the 67 TFLOP/s peak), which
// bounds it beside the forward's bf16 work.
//
// What the design does about it (the layer loop is K1's, mma.cuh):
// - Forward: the skinny layer writes the first A tile; each hidden layer
//   runs mma_layer with a ReLU epilogue that writes the next A tile at the
//   value tier, and (K3) one mask bit per (row, column) from the fp32
//   value, gathered over the 8 lanes that hold a column by three shuffles
//   and stored as one 32-bit word per column. The last trunk layer also
//   keeps h in fp32.
// - Gram head: one more mma_layer over h's A tile with G's fragments and
//   no bias; its epilogue adds (hg + 2u)·h into per-row quad partials in
//   registers (reduced by shuffles and a fixed-order sum across warps, as
//   K1's sumsq) and (K3) writes the backward signal e = hg + u, masked by
//   h > 0, at the grad tier as the first backward A tile (G is
//   symmetric, so h@G is reused); no fp32 hg tile exists.
// - Backward (K3): for trunk layers i = n−1 … 1, mma_layer over e with
//   W_iᵀ's fragments at the grad tier, masked by activation i−1's bits;
//   layer 1 writes e in fp32 over the h tile, and the skinny layer's
//   backward (Σ_j e_j·w0[c, j], j ascending, times the log-clamp
//   derivative) runs as exact fp32 on the CUDA cores, as in
//   fused_loglik_grad_gram_f32.cu. A trunk of the skinny layer alone has the
//   gram head as its only mma layer and its e goes to fp32 directly.
// - Reverse mode (K3 at a bf16 value tier, an fp32 backward): steps 1-4
//   unchanged, so the value is the tensor-core K2's at the value tier bit
//   for bit; the gram epilogue writes e = h > 0 ? hg + u : 0 in fp32 into
//   a k-major tile (element c·18 + r, tile_f32.cuh's 16-row layout) kept
//   apart from the forward's tiles. Then for i = n−1 … 1,
//   tile_f32.cuh::tile_layer over W_iᵀ's fp32 slabs (the tail of the fp32
//   K3's stream, ops/kernels/fused_loglik.py::pack_backward_slabs), one
//   accumulator per output, k ascending, epilogue masked_store with
//   activation i−1's words read at a 4-byte column stride; the other fp32
//   tile and the slab ring (GradRing<16>) go over the forward's A tiles
//   and h, dead once the quad is reduced. The mask words are laid out at
//   padk(width) columns per activation and zeroed first, as are e's k rows
//   pad16 … padk of h's width: the fp32 layers read k up to padk, the mma
//   epilogues write up to pad16, and a NaN left there times a zero weight
//   would poison a sum. The skinny layer's backward as above.
// - Tile: kGramRows = 16 rows (one m16 tile) per CTA of 8 warps, two
//   CTAs per SM (118–124 registers), so HMC's 4096 rows make 256 CTAs,
//   one wave. 32-row tiles (two m16 tiles: half the weight stream, but
//   one CTA per SM at bf16x3, by shared memory) measured slower at 4096
//   and 65,536 rows at both K3 tier pairs and for K2 at bf16x3; only K2 at
//   single-pass bf16, where two 32-row CTAs fit an SM, ran faster on them
//   (PERF.md).
// - Members: an ensemble's M members run in one launch on grid y (the
//   vmap over pallas_call of JAX's mixture), each CTA on one member's
//   stacked operands (trunk.cuh, member_at); the shared memory and the
//   arithmetic do not change with M, so a member's rows come out bit for
//   bit as from a launch of that member alone.
// Shared memory per CTA (16 rows, flagship, K3 at high/default), in order:
//   two ping-pong A buffers, hi and lo, stride 352 + 8:  2·2·16·360·2 = 46,080
//   fp32 h, then e of layer 0, stride 288 + 8:             16·296·4 = 18,944
//   mask words of activations 0 … n−2:              (288+352+288)·4 =  3,712
//   the input tile:                                          16·7·4 =    448
//   the per-warp quad partials:                              8·16·4 =    512
//   total 69,696 bytes; K2 at high, with no masks and a 224-column fp32
//   tile, 61,888. Parts follow the wider of the two tiers.
// The reverse mode (flagship, bf16x3), in order:
//   mask words, padk(width) per activation:         (288+352+288)·4 =  3,712
//   e, k-major, as wide as the widest trunk layer:         352·18·4 = 25,344
//   then the larger of the forward's tiles (K2's, above)      61,888
//     and the backward's other fp32 tile and slab ring:
//                                     25,344 + 3·8·128·4 = 37,632
//   total 90,944 dynamic bytes (67,904 at bf16) and the 552-byte static
//   copy of the net: two CTAs per SM.
// wgmma, TMA and warp specialisation are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tpu21cmvae_torch/ops/kernels/_build.py).

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "mma.cuh"
#include "tile_f32.cuh"

namespace {

constexpr int kGramRows = 16;  // rows per CTA
constexpr int kGramMTiles = kGramRows / 16;
static_assert(kGramRows <= 32, "one 32-bit mask word holds a column of the tile");
// PB of the reverse pairs' backward: fp32, register-tiled (tile_f32.cuh)
constexpr int kGradF32 = 3;
constexpr int kRevS = tile_stride(kGramRows);  // row stride of its k-major fp32 tiles
using RevRing = GradRing<kGramRows>;           // its slab ring: 3 slots of 8 × 128 floats

struct GramMmaNet {
  int n_layers;                // trunk layers, the skinny one included
  int width[kMaxLayers + 1];   // width[0] = n_in; trunk layer i maps width[i] → width[i+1]
  int stride;                  // row stride of the bf16 tiles, in elements
  int fstride;                 // row stride of the fp32 tile, in elements
  int mask_at[kMaxLayers];     // first mask word of activation i; mask_at[n_layers-1] words in all
  const float* w0;             // (n_in, width[1]), exact fp32
  const float* b0;             // (width[1],)
  const uint32_t* w[kMaxLayers];   // layer i ≥ 1: packed at the value tier
  const float* b[kMaxLayers];      // layer i ≥ 1: padded to a multiple of 16
  const uint32_t* wt[kMaxLayers];  // layer i ≥ 1: W_iᵀ packed at the grad tier (K3)
  const uint32_t* g;               // G packed at the value tier
  const float* u;                  // padded to a multiple of 16
  // each operand's member stride in bytes (0: one model)
  long long s_w0, s_b0, s_w[kMaxLayers], s_b[kMaxLayers], s_wt[kMaxLayers], s_g, s_u;
};

// The reverse pairs' net: the forward's, then the backward's fp32 stream.
struct GramReverseNet : GramMmaNet {
  const float* slabs;  // W_iᵀ for i = n−1 … 1 as tile_f32.cuh streams them
  long long s_slabs;   // its member stride in bytes (0: one model)
  int total;           // slabs in that stream at RevRing's depth
  int buf_cols;        // k rows of each fp32 tile: the widest trunk width padded to 32
};
// Its shared copy is the kernel's static shared memory, which the launch
// and ops/kernels/fused_loglik.py::grad_reverse_bytes count beside the
// dynamic bytes.
static_assert(sizeof(GramReverseNet) == 552, "fused_loglik.py's REVERSE_NET_BYTES");

template <int PB>
using GramNetOf = std::conditional_t<PB == kGradF32, GramReverseNet, GramMmaNet>;

// The net of member m: every operand moved by m times its stride.
__device__ __forceinline__ void to_member(GramMmaNet& net, int m) {
  net.w0 = member_at(net.w0, net.s_w0, m);
  net.b0 = member_at(net.b0, net.s_b0, m);
#pragma unroll
  for (int i = 1; i < kMaxLayers; ++i) {
    net.w[i] = member_at(net.w[i], net.s_w[i], m);
    net.b[i] = member_at(net.b[i], net.s_b[i], m);
    net.wt[i] = member_at(net.wt[i], net.s_wt[i], m);
  }
  net.g = member_at(net.g, net.s_g, m);
  net.u = member_at(net.u, net.s_u, m);
}

// The fp32 tiles' k rows: the reverse net's buf_cols, 0 for the others.
template <class Net>
__device__ __forceinline__ int fp32_cols(const Net& net) {
  if constexpr (std::is_same_v<Net, GramReverseNet>) {
    return net.buf_cols;
  } else {
    return 0;
  }
}

// PF: parts of the value tier (2 bf16x3, 1 bf16); PB: of the grad tier,
// 0 for K2 (no backward), kGradF32 for the reverse pairs' fp32 backward.
template <int PF, int PB>
__global__ void __launch_bounds__(kMmaThreads, 2)
fused_gram_mma_kernel(const float* __restrict__ x, float* __restrict__ quad,
                      float* __restrict__ dx, int n_rows, const GramNetOf<PB> net_in) {
  constexpr bool kRev = PB == kGradF32;
  // member blockIdx.y: its operands, moved there once per CTA into a
  // shared copy (a copy per thread, in local memory, ran these kernels
  // 30-50 % slower on an H100), its rows of quad and dx; x is shared
  __shared__ GramNetOf<PB> net;
  if (threadIdx.x == 0) {
    net = net_in;
    to_member(net, blockIdx.y);
    if constexpr (kRev) net.slabs = member_at(net.slabs, net.s_slabs, blockIdx.y);
  }
  __syncthreads();
  quad += static_cast<size_t>(blockIdx.y) * n_rows;
  if constexpr (PB > 0) dx += static_cast<size_t>(blockIdx.y) * n_rows * net.width[0];
  constexpr int MT = kGramMTiles;
  constexpr int kParts = kRev ? PF : PF > PB ? PF : PB;
  extern __shared__ uint4 smem_gram[];
  const int n_in = net.width[0];
  const int n = net.n_layers;
  const int hidden = net.width[n];
  const int stride = net.stride;
  const int fstride = net.fstride;
  const int tile_elems = kGramRows * stride;
  const int buf_elems = kParts * tile_elems;  // buffer b at buf + b * buf_elems
  // the reverse pairs keep their masks and e (fp32, k-major: element (c,
  // r) at c·kRevS + r) first, apart from the forward's tiles, over which
  // the backward's other fp32 tile and its slab ring go
  const int head = kRev ? net.mask_at[n - 1] + kRevS * fp32_cols(net) : 0;  // 4-byte words
  __nv_bfloat16* const buf =
      reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<uint32_t*>(smem_gram) + head);
  float* const hf = reinterpret_cast<float*>(buf + 2 * buf_elems);
  uint32_t* const mask = kRev ? reinterpret_cast<uint32_t*>(smem_gram)
                              : reinterpret_cast<uint32_t*>(hf + kGramRows * fstride);
  float* const xl = kRev ? hf + kGramRows * fstride
                         : reinterpret_cast<float*>(mask + (PB > 0 ? net.mask_at[n - 1] : 0));
  float* const red = xl + kGramRows * n_in;
  float* const ef = kRev ? reinterpret_cast<float*>(mask + net.mask_at[n - 1]) : nullptr;
  const int row0 = blockIdx.x * kGramRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // 1. the input tile, log-clamped; rows past the batch are zero and
  //    never stored. K3 zeroes activation 0's mask words, which the
  //    skinny layer sets bit by bit; the reverse pairs zero every mask
  //    word (the epilogues write pad16 columns of an activation, the fp32
  //    backward reads padk) and e's k rows pad16(hidden) … padk(hidden).
  for (int t = threadIdx.x; t < kGramRows * n_in; t += blockDim.x) {
    const int row = row0 + t / n_in;
    const int c = t % n_in;
    xl[t] = row < n_rows ? log_clamp(x[static_cast<size_t>(row) * n_in + c], c) : 0.f;
  }
  if constexpr (PB > 0) {
    const int words0 = kRev ? net.mask_at[n - 1] : n > 1 ? net.mask_at[1] : 0;
    for (int t = threadIdx.x; t < words0; t += blockDim.x) mask[t] = 0u;
  }
  if constexpr (kRev) {
    const int c0 = pad16(hidden);
    for (int t = threadIdx.x; t < (padk(hidden) - c0) * kRevS; t += blockDim.x) {
      ef[c0 * kRevS + t] = 0.f;
    }
  }
  __syncthreads();

  // 2. skinny layer 0, exact fp32, into the first A tile; a trunk of the
  //    skinny layer alone keeps it as h in fp32
  skinny_layer(xl, kGramRows, n_in, net.w0, net.b0, net.width[1], [&](int r, int j, float v) {
    store_one<PF>(buf, tile_elems, r * stride + j, v);
    if (n == 1) {
      hf[r * fstride + j] = v;
    } else if (PB > 0 && v > 0.f) {
      atomicOr(mask + j, 1u << r);
    }
  });
  __syncthreads();

  // 3. hidden layers, ReLU; (K3) mask bits; the last keeps h in fp32
  int cur = 0;
  for (int i = 1; i < n; ++i) {
    const bool last = i == n - 1;
    uint32_t* const m = PB > 0 && !last ? mask + net.mask_at[i] : nullptr;
    const float* bias = net.b[i];
    __nv_bfloat16* out = buf + (cur ^ 1) * buf_elems;
    mma_layer<PF, MT>(buf + cur * buf_elems, pad16(net.width[i]), net.w[i], net.width[i + 1],
                      stride, tile_elems, [&](int col, const float (&a)[MT][4]) {
                        const float2 bj = __ldg(reinterpret_cast<const float2*>(bias + col));
                        uint32_t bits0 = 0u, bits1 = 0u;
#pragma unroll
                        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                          for (int h = 0; h < 2; ++h) {
                            const int r = mma_row(mt, h);
                            const float v0 = relu(a[mt][2 * h] + bj.x);
                            const float v1 = relu(a[mt][2 * h + 1] + bj.y);
                            store_pair<PF>(out, tile_elems, r * stride + col, v0, v1);
                            if (last) {
                              *reinterpret_cast<float2*>(hf + r * fstride + col) =
                                  make_float2(v0, v1);
                            }
                            bits0 |= static_cast<uint32_t>(v0 > 0.f) << r;
                            bits1 |= static_cast<uint32_t>(v1 > 0.f) << r;
                          }
                        if (m != nullptr) {  // OR over the 8 lanes that share lane & 3
#pragma unroll
                          for (int o = 4; o < 32; o <<= 1) {
                            bits0 |= __shfl_xor_sync(0xffffffffu, bits0, o);
                            bits1 |= __shfl_xor_sync(0xffffffffu, bits1, o);
                          }
                          if (lane < 4) {
                            m[col] = bits0;
                            m[col + 1] = bits1;
                          }
                        }
                      });
    __syncthreads();
    cur ^= 1;
  }

  // 4. gram head: hg = h @ G in registers; quad partials Σ (hg + 2u)·h;
  //    (K3) e = hg + u masked by h > 0, the first backward input: an A
  //    tile at the grad tier, or (reverse pairs) fp32 into ef
  float q[MT][2] = {};
  {
    const float* u = net.u;
    __nv_bfloat16* out = buf + (cur ^ 1) * buf_elems;
    mma_layer<PF, MT>(buf + cur * buf_elems, pad16(hidden), net.g, hidden, stride, tile_elems,
                      [&](int col, const float (&a)[MT][4]) {
                        const float2 uj = __ldg(reinterpret_cast<const float2*>(u + col));
#pragma unroll
                        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                          for (int h = 0; h < 2; ++h) {
                            const int r = mma_row(mt, h);
                            float2* hp = reinterpret_cast<float2*>(hf + r * fstride + col);
                            const float2 hv = *hp;
                            const float g0 = a[mt][2 * h];
                            const float g1 = a[mt][2 * h + 1];
                            q[mt][h] = fmaf(g1 + 2.f * uj.y, hv.y,
                                            fmaf(g0 + 2.f * uj.x, hv.x, q[mt][h]));
                            if constexpr (PB > 0) {
                              const float e0 = hv.x > 0.f ? g0 + uj.x : 0.f;
                              const float e1 = hv.y > 0.f ? g1 + uj.y : 0.f;
                              if constexpr (kRev) {
                                ef[col * kRevS + r] = e0;
                                ef[(col + 1) * kRevS + r] = e1;
                              } else if (n > 1) {
                                store_pair<PB>(out, tile_elems, r * stride + col, e0, e1);
                              } else {
                                *hp = make_float2(e0, e1);  // in place: this lane read it
                              }
                            }
                          }
                      });
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = q[mt][h];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if ((lane & 3) == 0) red[warp * kGramRows + mma_row(mt, h)] = s;
    }
  __syncthreads();
  if (threadIdx.x < kGramRows && row0 + static_cast<int>(threadIdx.x) < n_rows) {
    float s = 0.f;
    for (int k = 0; k < kMmaWarps; ++k) s += red[k * kGramRows + threadIdx.x];
    quad[row0 + threadIdx.x] = s;
  }
  if constexpr (PB > 0) {
    // layer 0's backward signal in fp32: row-major in hf, or (reverse
    // pairs) k-major
    const float* grad0 = hf;
    if constexpr (kRev) {
      // 5. backward through trunk layers n−1 … 1 on the CUDA cores:
      //    tile_layer over W_iᵀ's fp32 slabs, k ascending in one
      //    accumulator per output, masked by activation i−1's words;
      //    ping-pong between ef and a tile over the dead forward tiles
      __syncthreads();  // the quad partials are read: buf, hf, xl and red are dead
      float* const other = reinterpret_cast<float*>(buf);
      float* const ring = other + kRevS * net.buf_cols;
      int g = 0;
      start_ring<kGramRows, RevRing>(ring, net.slabs, net.total);
      float* in = ef;
      float* out = other;
      for (int i = n - 1; i >= 1; --i) {
        const uint8_t* const m = reinterpret_cast<const uint8_t*>(mask + net.mask_at[i - 1]);
        const int w = net.width[i];
        float* const to = out;
        tile_layer<kGramRows, RevRing>(in, net.width[i + 1], w, net.slabs, net.total, ring, g,
                                       [&](int c0, const float (&acc)[kGramRows / 8][4]) {
                                         masked_store<kGramRows, 4>(to, m, w, c0, acc);
                                       });
        out = in;
        in = to;
      }
      __syncthreads();
      grad0 = in;
    } else {
      // 5. backward through trunk layers n−1 … 1: e ← (e @ W_iᵀ) masked by
      //    activation i−1; layer 1 writes fp32 into the h tile
      cur ^= 1;
      for (int i = n - 1; i >= 1; --i) {
        const uint32_t* m = mask + net.mask_at[i - 1];
        __nv_bfloat16* out = buf + (cur ^ 1) * buf_elems;
        mma_layer<PB, MT>(buf + cur * buf_elems, pad16(net.width[i + 1]), net.wt[i],
                          net.width[i], stride, tile_elems, [&](int col, const float (&a)[MT][4]) {
                            const uint32_t m0 = m[col];
                            const uint32_t m1 = m[col + 1];
#pragma unroll
                            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                              for (int h = 0; h < 2; ++h) {
                                const int r = mma_row(mt, h);
                                const float e0 = (m0 >> r) & 1u ? a[mt][2 * h] : 0.f;
                                const float e1 = (m1 >> r) & 1u ? a[mt][2 * h + 1] : 0.f;
                                if (i == 1) {
                                  *reinterpret_cast<float2*>(hf + r * fstride + col) =
                                      make_float2(e0, e1);
                                } else {
                                  store_pair<PB>(out, tile_elems, r * stride + col, e0, e1);
                                }
                              }
                          });
        __syncthreads();
        cur ^= 1;
      }
    }

    // 6. skinny layer backward, exact fp32, times the log-clamp derivative
    const int n1 = net.width[1];
    for (int t = threadIdx.x; t < kGramRows * n_in; t += blockDim.x) {
      const int r = t % kGramRows;
      const int c = t / kGramRows;
      const int row = row0 + r;
      float acc = 0.f;
      for (int j = 0; j < n1; ++j) {
        const float ej = kRev ? grad0[j * kRevS + r] : grad0[r * fstride + j];
        acc = fmaf(ej, __ldg(net.w0 + c * n1 + j), acc);
      }
      if (row < n_rows) {
        const size_t at = static_cast<size_t>(row) * n_in + c;
        dx[at] = log_clamp_grad(x[at], c) * acc;
      }
    }
  }
}

template <int PF, int PB>
cudaError_t launch_gram(const float* x, float* quad, float* dx, int n_rows, int n_members,
                        const GramNetOf<PB>& net, size_t smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(fused_gram_mma_kernel<PF, PB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_rows + kGramRows - 1) / kGramRows, n_members);
  fused_gram_mma_kernel<PF, PB><<<grid, kMmaThreads, smem, stream>>>(x, quad, dx, n_rows, net);
  return cudaGetLastError();
}

int parts_of(int tier) { return tier == kBF16x3 ? 2 : 1; }

// Checks the shapes and tiers, fills the net from ptrs and launches.
// grad_tier < 0: K2 (no backward operands in ptrs, dx unused); kF32: K3
// at a reverse pair (no wt entries; the backward's slab stream last).
int launch_gram_mma(const float* x, float* quad, float* dx, int n_rows, int n_layers,
                    const int* widths, const void* const* ptrs, const long long* strides,
                    int n_members, int tier, int grad_tier, void* stream) {
  const bool k3 = grad_tier >= 0;
  const bool rev = grad_tier == kF32;
  if (n_rows <= 0 || !members_ok(n_members) || n_layers < 1 || n_layers > kMaxLayers ||
      widths[0] < 1 || widths[0] > kMaxIn || (tier != kBF16 && tier != kBF16x3) ||
      (k3 && !rev && grad_tier != kBF16 && grad_tier != kBF16x3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GramReverseNet net{};  // the other routes launch its GramMmaNet part
  net.n_layers = n_layers;
  int kp_max = 0;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    net.width[i] = widths[i];
    if (i > 0) {
      kp_max = std::max(kp_max, (widths[i] + 15) & ~15);
      net.buf_cols = std::max(net.buf_cols, padk(widths[i]));
    }
  }
  const int hidden = widths[n_layers];
  net.stride = kp_max + 8;
  net.fstride = ((std::max(hidden, k3 && !rev ? widths[1] : 0) + 15) & ~15) + 8;
  for (int i = 0, words = 0; i < n_layers; ++i) {
    net.mask_at[i] = words;
    words += rev ? padk(widths[i + 1]) : (widths[i + 1] + 15) & ~15;
  }
  const int parts = std::max(parts_of(tier), k3 && !rev ? parts_of(grad_tier) : 0);
  const size_t mask_bytes = static_cast<size_t>(k3 ? net.mask_at[n_layers - 1] : 0) * 4;
  const size_t forward =
      static_cast<size_t>(2) * parts * kGramRows * net.stride * sizeof(__nv_bfloat16) +
      static_cast<size_t>(kGramRows) * net.fstride * sizeof(float) +
      static_cast<size_t>(kGramRows) * (widths[0] + kMmaWarps) * sizeof(float);
  // the reverse pairs: the masks and e, then the forward's tiles or the
  // backward's other fp32 tile and its slab ring (ops/kernels/
  // fused_loglik.py::grad_reverse_bytes mirrors it, with the static copy
  // of the net)
  const size_t f32_tile = sizeof(float) * kRevS * net.buf_cols;
  const size_t smem =
      rev ? mask_bytes + f32_tile +
                std::max(forward, f32_tile + sizeof(float) * RevRing::kSlots * RevRing::kFloats)
          : forward + mask_bytes;
  if (smem + (rev ? sizeof(GramReverseNet) : 0) > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  int k = 0;
  net.s_w0 = strides[k];
  net.w0 = static_cast<const float*>(ptrs[k++]);
  net.s_b0 = strides[k];
  net.b0 = static_cast<const float*>(ptrs[k++]);
  for (int i = 1; i < n_layers; ++i) {
    net.s_w[i] = strides[k];
    net.w[i] = static_cast<const uint32_t*>(ptrs[k++]);
    net.s_b[i] = strides[k];
    net.b[i] = static_cast<const float*>(ptrs[k++]);
    if (k3 && !rev) {
      net.s_wt[i] = strides[k];
      net.wt[i] = static_cast<const uint32_t*>(ptrs[k++]);
    }
  }
  net.s_g = strides[k];
  net.g = static_cast<const uint32_t*>(ptrs[k++]);
  net.s_u = strides[k];
  net.u = static_cast<const float*>(ptrs[k++]);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pf = parts_of(tier);
  if (rev) {
    net.s_slabs = strides[k];
    net.slabs = static_cast<const float*>(ptrs[k++]);
    // backward layer i maps width[i+1] → width[i], i = n−1 … 1
    int kin[kMaxLayers], nout[kMaxLayers], layers = 0;
    for (int i = n_layers - 1; i >= 1; --i, ++layers) {
      kin[layers] = widths[i + 1];
      nout[layers] = widths[i];
    }
    net.total = stream_slabs<kGramRows, RevRing>(kin, nout, layers);
    const cudaError_t err =
        pf == 2 ? launch_gram<2, kGradF32>(x, quad, dx, n_rows, n_members, net, smem, s)
                : launch_gram<1, kGradF32>(x, quad, dx, n_rows, n_members, net, smem, s);
    return static_cast<int>(err);
  }
  const int pb = k3 ? parts_of(grad_tier) : 0;
  const GramMmaNet& m = net;
  cudaError_t err;
  if (pf == 2) {
    err = pb == 2   ? launch_gram<2, 2>(x, quad, dx, n_rows, n_members, m, smem, s)
          : pb == 1 ? launch_gram<2, 1>(x, quad, dx, n_rows, n_members, m, smem, s)
                    : launch_gram<2, 0>(x, quad, dx, n_rows, n_members, m, smem, s);
  } else {
    err = pb == 2   ? launch_gram<1, 2>(x, quad, dx, n_rows, n_members, m, smem, s)
          : pb == 1 ? launch_gram<1, 1>(x, quad, dx, n_rows, n_members, m, smem, s)
                    : launch_gram<1, 0>(x, quad, dx, n_rows, n_members, m, smem, s);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// ptrs, in order: w0, b0 (exact fp32); then for each trunk layer i = 1 …
// n_layers-1: w, b and wt, where w is layer i's packed B fragments at
// tier (ops/kernels/fused_mlp.py::pack_mma_operands), b its bias
// zero-padded to a multiple of 16, and wt the fragments of W_iᵀ at
// tier_bwd; then G's fragments at tier and u zero-padded to a multiple of
// 16. strides: each operand's member stride in bytes, parallel to ptrs;
// n_members (1 … 65,535) networks run on the same x, member m writing
// quad[m·n_rows …] and dx[m·n_rows·n_in …] (a single model: 1 member,
// zero strides). tier, tier_bwd: 1 bf16, 2 bf16x3. Launches on `stream`,
// allocates nothing and does not synchronise; returns the cudaError_t of
// the launch.
int k3_fused_loglik_grad_gram_mma(const float* x, float* quad, float* dx, int n_rows,
                                  int n_layers, const int* widths, const void* const* ptrs,
                                  const long long* strides, int n_members, int tier,
                                  int tier_bwd, void* stream) {
  if (tier_bwd != kBF16 && tier_bwd != kBF16x3) return static_cast<int>(cudaErrorInvalidValue);
  return launch_gram_mma(x, quad, dx, n_rows, n_layers, widths, ptrs, strides, n_members, tier,
                         tier_bwd, stream);
}

// K3 at a reverse pair (value tier `tier`, fp32 backward): ptrs and
// strides as K3's above without the wt entries, then the backward's fp32
// slabs of W_iᵀ for i = n_layers-1 … 1 (ops/kernels/fused_loglik.py::
// pack_backward_slabs; their zero biases are not passed). The value is
// K2's at `tier` bit for bit.
int k3_fused_loglik_grad_gram_reverse(const float* x, float* quad, float* dx, int n_rows,
                                      int n_layers, const int* widths, const void* const* ptrs,
                                      const long long* strides, int n_members, int tier,
                                      void* stream) {
  return launch_gram_mma(x, quad, dx, n_rows, n_layers, widths, ptrs, strides, n_members, tier,
                         kF32, stream);
}

// K3's forward alone: ptrs and strides as K3's without the wt entries;
// writes quad.
int k2_fused_loglik_gram_mma(const float* x, float* quad, int n_rows, int n_layers,
                             const int* widths, const void* const* ptrs,
                             const long long* strides, int n_members, int tier, void* stream) {
  return launch_gram_mma(x, quad, nullptr, n_rows, n_layers, widths, ptrs, strides, n_members,
                         tier, -1, stream);
}

}  // extern "C"
