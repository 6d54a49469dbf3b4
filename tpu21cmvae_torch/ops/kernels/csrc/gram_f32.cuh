// What the port's register-tiled fp32 gram kernels share (K2
// fused_loglik_gram.cu, K3 fused_loglik_grad_gram_f32.cu, and the forward
// of K3 fused_gram_mixed.cu): the network a launch carries, the CTA's
// shared-memory layout, and the forward: input tile, skinny first layer,
// the streamed trunk layers and the gram head, whose epilogue forms the
// per-row quad
//   quad = ‖r‖² − c = Σ_j (h@G + 2u)_j · h_j
// from the registers and the fp32 h still in shared memory. K3 runs the
// same forward with kGrad set: it also writes the ReLU masks of the
// activations the backward needs (tile_f32.cuh, MaskBits) and the
// backward's first signal e = h > 0 ? h@G + u : 0 (G is symmetric, so
// ½·dquad/dh reuses h@G). Every sum is the same in both, in the same
// order, so K3's value equals K2's bit for bit at one tile height.

#pragma once

#include "tile_f32.cuh"

namespace {

struct GramNet {
  int n_layers;               // trunk layers, the skinny one included
  int width[kMaxLayers + 1];  // width[0] = n_in; trunk layer i maps width[i] → width[i+1]
  int buf_cols;               // k rows of each activation buffer: widest trunk width, padded to 32
  int total;                  // slabs in the stream at BM: trunk layers 1 … n−1, G, (K3) W_iᵀ
  const float* w0;            // (n_in, width[1]), exact fp32
  const float* b0;            // (width[1],)
  const float* slabs;
  const float* bias;          // each streamed layer's bias padded to 128·chunks; G's slot holds u
  long long s_w0, s_b0, s_slabs, s_bias;  // member strides in bytes (0: one model)
};

// The net of member m: every operand moved by m times its stride.
__device__ __forceinline__ void to_member(GramNet& net, int m) {
  net.w0 = member_at(net.w0, net.s_w0, m);
  net.b0 = member_at(net.b0, net.s_b0, m);
  net.slabs = member_at(net.slabs, net.s_slabs, m);
  net.bias = member_at(net.bias, net.s_bias, m);
}

// A CTA's dynamic shared memory: the slab ring, the per-row partials, two
// ping-pong activation buffers, the input tile and (K3) the mask bytes.
struct GramTile {
  float* ring;
  float* red;
  float* buf0;
  float* buf1;
  float* xl;
  uint8_t* mask;
};

template <int BM, class R>
__device__ __forceinline__ GramTile gram_tile(float* smem, const GramNet& net) {
  constexpr int S = tile_stride(BM);
  GramTile t;
  t.ring = smem;
  t.red = t.ring + R::kSlots * R::kFloats;
  t.buf0 = t.red + kRedFloats;
  t.buf1 = t.buf0 + S * net.buf_cols;
  t.xl = t.buf1 + S * net.buf_cols;
  t.mask = reinterpret_cast<uint8_t*>(t.xl + S * net.width[0]);
  return t;
}

// Mask bytes of a K3 CTA: activations 0 … n−2, padded columns included.
template <int BM>
int gram_mask_bytes(const GramNet& net) {
  int cols = 0;
  for (int i = 1; i < net.n_layers; ++i) cols += padk(net.width[i]);
  return MaskBits<BM>::kColBytes * cols;
}

// Slabs in the stream: trunk layers 1 … n−1 (width[i] → width[i+1]), G
// (H → H) and, with `backward`, W_iᵀ (width[i+1] → width[i]) for i = n−1 … 1.
template <int BM, class R>
int gram_stream_slabs(const GramNet& net, bool backward) {
  int k[2 * kMaxLayers], n[2 * kMaxLayers];
  int layers = 0;
  for (int i = 1; i < net.n_layers; ++i, ++layers) {
    k[layers] = net.width[i];
    n[layers] = net.width[i + 1];
  }
  k[layers] = n[layers] = net.width[net.n_layers];
  ++layers;
  if (backward) {
    for (int i = net.n_layers - 1; i >= 1; --i, ++layers) {
      k[layers] = net.width[i + 1];
      n[layers] = net.width[i];
    }
  }
  return stream_slabs<BM, R>(k, n, layers);
}

// The C entries' argument reading: false if a count or a width is out of
// range. ptrs, in order, all fp32: w0, b0, the packed slabs, the padded
// biases; strides: their member strides in bytes.
inline bool read_gram_net(int n_rows, int n_layers, const int* widths, const void* const* ptrs,
                          const long long* strides, int n_members, GramNet& net) {
  if (n_rows <= 0 || !members_ok(n_members) || n_layers < 1 || n_layers > kMaxLayers ||
      widths[0] < 1 || widths[0] > kMaxIn) {
    return false;
  }
  net = GramNet{};
  net.n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] < 1) return false;
    net.width[i] = widths[i];
    if (i > 0 && padk(widths[i]) > net.buf_cols) net.buf_cols = padk(widths[i]);
  }
  net.w0 = static_cast<const float*>(ptrs[0]);
  net.b0 = static_cast<const float*>(ptrs[1]);
  net.slabs = static_cast<const float*>(ptrs[2]);
  net.bias = static_cast<const float*>(ptrs[3]);
  net.s_w0 = strides[0];
  net.s_b0 = strides[1];
  net.s_slabs = strides[2];
  net.s_bias = strides[3];
  return true;
}

// The gram head's epilogue for this thread's rows of columns c0 … c0+3:
// q[i] += (hg + 2u)·h with hg = acc; with kGrad also e = h > 0 ? hg + u : 0
// (0 on the padded columns, where h, G's columns and u are 0).
template <int BM, bool kGrad>
__device__ __forceinline__ void gram_epilogue(const float* h, float* e,
                                              const float* __restrict__ u_pad, int hidden, int c0,
                                              const float (&acc)[BM / 8][4], float (&q)[BM / 8]) {
  constexpr int TM = BM / 8;
  constexpr int S = tile_stride(BM);
  if (c0 >= padk(hidden)) return;  // h holds no columns past padk(hidden)
  const TileThread<BM> t;
  const float4 u4 = __ldg(reinterpret_cast<const float4*>(u_pad + c0));
  const float u[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float hv[TM];
    load_rows<TM>(hv, h + (c0 + c) * S + t.row);
#pragma unroll
    for (int i = 0; i < TM; ++i) q[i] = fmaf(acc[i][c] + 2.f * u[c], hv[i], q[i]);
    if constexpr (kGrad) {
      float ev[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) ev[i] = hv[i] > 0.f ? acc[i][c] + u[c] : 0.f;
      store_rows<TM>(e + (c0 + c) * S + t.row, ev);
    }
  }
}

// The forward of one tile: writes quad for the tile's rows. `g` is the
// stream's slab counter, advanced past G. With kGrad, on return `h` is
// the buffer of the last activation (dead by then), `e` the buffer that
// holds the backward's first signal, and `mask` points past the last
// mask written (activation n−2's).
template <int BM, class R, bool kGrad>
__device__ __forceinline__ void gram_forward(const float* __restrict__ x,
                                             float* __restrict__ quad, int n_rows,
                                             const GramNet& net, const GramTile& tile, int& g,
                                             float*& h, float*& e, uint8_t*& mask) {
  constexpr int TM = BM / 8;
  const int n_in = net.width[0];
  const int n_layers = net.n_layers;
  const int row0 = blockIdx.x * BM;

  start_ring<BM, R>(tile.ring, net.slabs, net.total);
  load_input<BM>(x, n_rows, row0, n_in, n_in, true, tile.xl);
  __syncthreads();
  h = tile.buf0;
  e = tile.buf1;
  mask = tile.mask;
  if (kGrad && n_layers > 1) {  // a lone skinny layer is h itself: no mask
    skinny_hidden_masked<BM>(tile.xl, n_in, net.w0, net.b0, net.width[1], h, mask);
    mask += MaskBits<BM>::kColBytes * padk(net.width[1]);
  } else {
    skinny_hidden<BM>(tile.xl, n_in, net.w0, net.b0, net.width[1], h);
  }

  const float* bias = net.bias;
  for (int i = 1; i < n_layers; ++i) {
    float* out = e;
    const int n = net.width[i + 1];
    // the last activation needs no mask: the gram epilogue reads h itself
    uint8_t* const m = kGrad && i < n_layers - 1 ? mask : nullptr;
    tile_layer<BM, R>(h, net.width[i], n, net.slabs, net.total, tile.ring, g,
                      [&](int c0, const float (&acc)[TM][4]) {
                        if constexpr (kGrad) {
                          relu_mask_store<BM>(out, m, bias, n, c0, acc);
                        } else {
                          relu_store<BM>(out, bias, n, c0, acc);
                        }
                      });
    if (m != nullptr) mask += MaskBits<BM>::kColBytes * padk(n);
    bias += chunks(n) * kSlabN;
    e = h;
    h = out;
  }

  // gram head: hg = h @ G in registers; quad += (hg + 2u)·h per (row, column)
  const int hidden = net.width[n_layers];
  const float* hc = h;
  float* ec = e;
  float q[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) q[i] = 0.f;
  tile_layer<BM, R>(hc, hidden, hidden, net.slabs, net.total, tile.ring, g,
                    [&](int c0, const float (&acc)[TM][4]) {
                      gram_epilogue<BM, kGrad>(hc, ec, bias, hidden, c0, acc, q);
                    });
  reduce_rows<BM>(q, tile.red, quad, row0, n_rows);
}

}  // namespace
