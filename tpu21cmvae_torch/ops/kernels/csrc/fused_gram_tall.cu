// K3 for Hopper at the bf16 tier pairs on large batches: the gram-form
// Gaussian log-likelihood of a batch of rows and its gradient with respect
// to the raw parameters, in one kernel, on 64-row tiles whose products run
// on wgmma, the weights staged through a ring of shared-memory slots that
// a producer fills by bulk copies (TMA).
//
// Replaces, at the pair (bf16x3, bf16), HMC's default, and at batches that
// fill the card with 64-row tiles:
//   K3 tpu21cmvae/ops/pallas/fused_loglik.py::make_fused_loglik_grad_gram
//      (kernel body _loglik_grad_gram_kernel).
// Smaller batches, member-batched launches, networks whose plan does not
// fit and the other bf16 pairs run fused_gram_mma.cu (ops/kernels/
// fused_loglik.py::k3_batch_route, tall_plan). The template takes every
// bf16 pair, but each pair built costs ~18 s of nvcc in the build's
// critical path, so only the pair a main path runs at such batches is
// built (PERF.md §6).
//
// Contract and arithmetic: fused_gram_mma.cu's K3, unchanged. Per row
//   quad = ‖r‖² − c = Σ_j (h@G + 2u)_j · h_j,  dx = ½ · d‖r‖²/dx_raw;
// the skinny first layer exact fp32 in skinny_dot's order (trunk.cuh),
// each hidden layer at the value tier (bf16x3: hi·w_hi + hi·w_lo +
// lo·w_hi, the input split once), h@G reused for e = hg + u, the backward
// at the grad tier, ReLU masks from the fp32 activations, the skinny
// layer's backward as exact fp32 sums. Each k-step's products are summed
// by the tensor cores from zero and added to the running fp32 sum by an
// IEEE add, as in mma.cuh. Only the order of summation differs from
// fused_gram_mma.cu and from the plain version (ops/kernels/
// fused_loglik.py::loglik_grad_gram_reference).
//
// What bounds it on an H100: fused_gram_mma.cu runs a CTA on 16 rows, and
// each CTA streams every layer's weights from L2: at the flagship widths
// (7→288→352→288→224, gram head 224) and (high, default) 1.27 MB forward
// and 0.53 MB backward, 7.4 GB per 65,536-row launch. A 64-row tile brings
// each weight byte from L2 once for 64 rows, 1.8 GB per launch. The tensor
// work is 2.44 MFLOP a row at (high, default), 0.16 ms per 65,536 rows at
// the 989 TFLOP/s peak. What sets this kernel's time is a warpgroup's
// chain of k-steps: each waits for its block, runs its group of wgmmas,
// waits for them and adds their sum, about 220 k-steps a tile at the
// flagship, and the epilogues, during which the tensor cores idle; the
// ring's depth keeps the stream ahead (PERF.md §6).
//
// Design:
// - One persistent CTA per SM walks the 64-row tiles. Two consumer
//   warpgroups split each layer's output columns; a producer warpgroup,
//   one thread of which issues the copies, streams the layers' packed
//   weights (ops/kernels/fused_loglik.py::pack_tall) in the order the
//   consumers take them, tile after tile, through `ring` slots behind
//   full and empty mbarriers: the next blocks' copies overlap the products
//   on this one, and the next layer's, or the next tile's, first blocks
//   arrive during an epilogue. setmaxnreg moves registers from the
//   producer (40) to the consumers (232).
// - A layer's padded output columns are cut into 16-column units, half to
//   each warpgroup (the first takes the odd one), each half into chunks of
//   at most 11 units (n ≤ 176, one wgmma m64nNk16 per part and k-step: a
//   flagship layer is one chunk per warpgroup). The stream holds, chunk by
//   chunk and k-step by k-step, the first then the second warpgroup's
//   block, each its planes (w_hi, w_lo at bf16x3) in wgmma's K-major
//   core-matrix layout without swizzle (8 rows of 16 bytes per 128-byte
//   core matrix, k8 groups LBO = N·16 bytes apart, n8 groups SBO = 128
//   apart); a slot holds one block, so the two warpgroups' blocks
//   alternate through the ring.
// - A and B both come from shared memory. Activations live as bf16 planes
//   (hi and lo at bf16x3) in the same core-matrix layout (row groups 128
//   bytes apart, k8 groups 1024), written by the epilogues. A k-step's
//   group of wgmmas sums into a register tile from zero; the warpgroup
//   waits for it, frees the slot and adds the tile to the fp32 sum, while
//   the other warpgroup's group runs. (Keeping two groups in flight, one
//   tile read while the next is written, made the compiler serialize
//   every wgmma.)
// - Mask bits: 16 bits per (column, warp), the warp's 16 rows; the
//   backward's epilogue thread reads the word its own warp wrote.
// - Epilogues as fused_gram_mma.cu's: bias and ReLU into the next tile and
//   the mask bits; the last trunk layer writes h in fp32, split into its
//   A tile by one more pass; the gram head adds (hg + 2u)·h into per-row
//   partials (reduced by shuffles, then the two warpgroups' sums in a
//   fixed order) and writes e = h > 0 ? hg + u : 0 at the grad tier; each
//   backward layer masks by activation i−1's bits and layer 1 writes e in
//   fp32 for the skinny layer's backward, a warp a row.
// Shared memory per CTA (flagship, (high, default)), in order:
//   the ring, 5 slots of the largest block (one k-step of 176 columns,
//   hi and lo: 16·176·2·2):                           5·11,264 = 56,320
//   the arena: each layer's input and output tiles at its two ends, so it
//   needs the largest live set (layer 1's: 288 and 352 wide, hi and lo,
//   64 rows: 73,728 + 90,112):                                  163,840
//   mask words of activations 0 … n−2, 8 bytes a column:  928·8 =  7,424
//   the input tile:                                          64·7·4 = 1,792
//   the two warpgroups' quad partials:                      2·64·4 =   512
//   the full and empty barriers:                              2·5·8 =    80
//   total 229,968 bytes, one CTA per SM; the net is a __grid_constant__
//   parameter. ops/kernels/fused_loglik.py::tall_plan places the arena's
//   tiles and sizes the ring (mirrored in launch_tall below).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tpu21cmvae_torch/ops/kernels/_build.py).

#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>

#include "trunk.cuh"

namespace {
namespace tall {

constexpr int kRows = 64;                       // rows per tile: wgmma's m64
constexpr int kConsumers = 2;                   // consumer warpgroups
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 128;  // and one producer warpgroup
constexpr int kMaxUnits = 11;                   // 16-column units per chunk: n ≤ 176
constexpr int kMaxStages = 2 * kMaxLayers - 1;  // forward, gram head, backward
constexpr int kMinRing = 2;
constexpr int kMaxRing = 12;

struct TallNet {
  int n_layers;                // trunk layers, the skinny one included (≥ 2)
  int width[kMaxLayers + 1];   // width[0] = n_in; trunk layer i maps width[i] → width[i+1]
  int ring;                    // ring slots
  int slot_bytes;              // one slot: the largest block
  int arena, masks, xl, red, bars;  // byte offsets in shared memory
  int mask_at[kMaxLayers];     // first column of activation i's mask words
  int in_off[kMaxStages];      // stage s's input tile, bytes into the arena
  int out_off[kMaxStages];     // its output tile
  const float* w0;             // (n_in, width[1]), exact fp32
  const float* b0;             // (width[1],)
  const float* b[kMaxLayers];  // layer i ≥ 1: padded to a multiple of 16
  const float* u;              // padded to a multiple of 16
  const uint8_t* stream;       // every stage's blocks in the order they are taken
};

// A layer's output columns: u0 16-column units for warpgroup 0, u1 for
// warpgroup 1, each cut into nch chunks (fused_loglik.py::tall_split).
struct Split {
  int u0, u1, nch;
};

__host__ __device__ __forceinline__ Split split_of(int n) {
  const int u = (n + 15) / 16;
  const int u0 = (u + 1) / 2;
  return {u0, u - u0, (u0 + kMaxUnits - 1) / kMaxUnits};
}

// Units of chunk c when u units are cut into nch chunks; chunks 0 … c−1
// hold c·u/nch of them.
__host__ __device__ __forceinline__ int part(int u, int nch, int c) {
  return (c + 1) * u / nch - c * u / nch;
}

// Stage s: its fan-in k, its width n and whether it runs at the value
// tier (forward layers 1 … n−1, the gram head) or the grad tier (backward
// layers n−1 … 1).
struct Stage {
  int k, n;
  bool value;
};

__host__ __device__ __forceinline__ Stage stage_of(const int* width, int n_layers, int s) {
  if (s < n_layers - 1) return {width[s + 1], width[s + 2], true};
  if (s == n_layers - 1) return {width[n_layers], width[n_layers], true};
  const int i = 2 * n_layers - 1 - s;
  return {width[i + 1], width[i], false};
}

// Bytes of one block of the stream (one warpgroup's chunk, one k-step):
// parts × 16 k rows × 16·units columns × 2.
__host__ __device__ __forceinline__ int block_bytes(int parts, int units) {
  return parts * units * 512;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A shared-memory matrix descriptor without swizzle: start, LBO (between
// core matrices adjacent in k) and SBO (adjacent in m or n), in bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

// The producer's arrival on a full barrier, with the bytes its copy brings.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// A bulk copy (TMA) of `bytes` contiguous bytes into shared memory,
// completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Generic-proxy stores into shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The consumer warpgroups' own barrier; the producer runs on.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the register tile at this point of the program: its values are
// read after the wait that precedes this, never before.
template <int R>
__device__ __forceinline__ void fence_regs(float (&t)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(t[i])::"memory");
}

// d = (scale_d ? d : 0) + a · b for a 64 × 16 A and a 16 × N B, both in
// shared memory (K-major, no swizzle), fp32 d in wgmma's fragment layout.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(float (&d)[24], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_ss<80>(float (&d)[40], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_ss<96>(float (&d)[48], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_ss<112>(float (&d)[56], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_ss<144>(float (&d)[72], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_ss<160>(float (&d)[80], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_ss<176>(float (&d)[88], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87"
      "}, %88, %89, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

// A warpgroup's place in the ring. The producer fills the slots in
// stream order, and the stream alternates the two warpgroups' blocks, so
// warpgroup w's blocks are the stream's blocks w, w + 2, w + 4, …: each
// waits on its own and steps over the other's. Full barriers sit at bars +
// 8·slot, empty ones at bars + 8·(n + slot).
struct Ring {
  int slot, phase, n;
  uint32_t bars;

  // Waits until this warpgroup's next block has landed; returns its slot.
  __device__ __forceinline__ int take() {
    const int s = slot;
    mbar_wait(bars + 8 * s, phase);
    slot += kConsumers;
    if (slot >= n) {
      slot -= n;
      phase ^= 1;
    }
    return s;
  }

  // This warp is done with slot s (its wgmmas on it have completed).
  __device__ __forceinline__ void release(int s) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(bars + 8 * (n + s));
  }
};

// Byte offset of (row r, column c) in a 64-row core-matrix tile plane:
// row groups 128 bytes apart, k8 groups 1024.
__device__ __forceinline__ int tile_at(int r, int c) {
  return (((c >> 3) * 8 + (r >> 3)) * 64 + (r & 7) * 8 + (c & 7)) * 2;
}

// Two neighbouring columns (c even) of row r into a tile, split (bf16x3:
// hi at the plane, lo one plane on) or rounded (bf16) once, as mma.cuh's
// store_pair.
template <int P>
__device__ __forceinline__ void store_pair(uint8_t* tile, int plane, int r, int c, float v0,
                                           float v1) {
  uint8_t* at = tile + tile_at(r, c);
  if constexpr (P == 2) {
    const float h0 = hi_part(v0);
    const float h1 = hi_part(v1);
    *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(h0, h1);
    *reinterpret_cast<__nv_bfloat162*>(at + plane) = __floats2bfloat162_rn(v0 - h0, v1 - h1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(v0, v1);
  }
}

template <int P>
__device__ __forceinline__ void store_one(uint8_t* tile, int plane, int r, int c, float v) {
  __nv_bfloat16* at = reinterpret_cast<__nv_bfloat16*>(tile + tile_at(r, c));
  if constexpr (P == 2) {
    const float h = hi_part(v);
    at[0] = __float2bfloat16_rn(h);
    *reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<uint8_t*>(at) + plane) =
        __float2bfloat16_rn(v - h);
  } else {
    at[0] = __float2bfloat16_rn(v);
  }
}

// One chunk of NC columns of a layer for this warpgroup: acc = in @ W over
// ksteps k-steps of the P-plane input tile at shared address `in`, one
// ring block a k-step, then epi(col, r, v00, v01, v10, v11) for each of
// this lane's n8 groups: rows r and r + 8, columns col and col + 1, col
// from col0. Each k-step's products are summed into t from zero by one
// group of wgmmas, which the warpgroup waits for before it adds t to acc
// (nothing reads a wgmma's registers while it is in flight, so the
// compiler keeps the group's wgmmas back to back); the other warpgroup's
// group runs on the tensor cores meanwhile.
template <int NC, int P, class Epi>
__device__ __forceinline__ void chunk(uint32_t in, int ksteps, Ring& ring, uint32_t slots,
                                      int slot_bytes, int col0, Epi&& epi) {
  constexpr int R = NC / 2;
  float acc[R], t[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  const uint32_t a_plane = 2048u * ksteps;  // 64 rows × 16·ksteps × 2 bytes
  constexpr uint32_t b_plane = 32u * NC;    // 16 k × NC × 2 bytes
  for (int j = 0; j < ksteps; ++j) {
    const int slot = ring.take();
    const uint32_t b = slots + slot * slot_bytes;
    const uint64_t a0 = desc(in + 2048u * j, 1024, 128);
    const uint64_t b0 = desc(b, 16 * NC, 128);
    wg_fence();
    wgmma_ss<NC>(t, a0, b0, 0);  // hi·w_hi (bf16: a·w)
    if constexpr (P == 2) {
      wgmma_ss<NC>(t, a0, desc(b + b_plane, 16 * NC, 128), 1);              // hi·w_lo
      wgmma_ss<NC>(t, desc(in + a_plane + 2048u * j, 1024, 128), b0, 1);  // lo·w_hi
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(t);
    ring.release(slot);
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] += t[i];
  }

  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    epi(col0 + 8 * j + 2 * (lane & 3), r, acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
        acc[4 * j + 3]);
  }
}

// One layer of fan-in k and width n for this warpgroup (wg) from the
// P-plane input tile at shared address `in`: every chunk of its columns.
// Each chunk is 1 … kMaxUnits units wide (tall_plan takes no trunk width
// of 16 or less, so neither warpgroup has an empty chunk).
template <int P, class Epi>
__device__ __forceinline__ void layer(uint32_t in, int k, int n, Ring& ring, uint32_t slots,
                                      int slot_bytes, int wg, Epi&& epi) {
  const int ksteps = (k + 15) / 16;
  const Split s = split_of(n);
  for (int c = 0; c < s.nch; ++c) {
    const int mine = wg == 0 ? part(s.u0, s.nch, c) : part(s.u1, s.nch, c);
    const int col0 = 16 * (wg == 0 ? c * s.u0 / s.nch : s.u0 + c * s.u1 / s.nch);
    switch (mine) {
#define TALL_CHUNK(U)                                                   \
  case U:                                                               \
    chunk<16 * U, P>(in, ksteps, ring, slots, slot_bytes, col0, epi); \
    break;
      TALL_CHUNK(1)
      TALL_CHUNK(2)
      TALL_CHUNK(3)
      TALL_CHUNK(4)
      TALL_CHUNK(5)
      TALL_CHUNK(6)
      TALL_CHUNK(7)
      TALL_CHUNK(8)
      TALL_CHUNK(9)
      TALL_CHUNK(10)
      TALL_CHUNK(11)
#undef TALL_CHUNK
      default:
        __trap();  // a width the plan does not give
    }
  }
}

// The producer: every stage's blocks, tile after tile, each into the next
// free slot by one bulk copy. The producer warpgroup's first thread alone.
template <int PF, int PB>
__device__ void produce(const TallNet& net, int tiles, uint32_t slots, uint32_t bars) {
  int slot = 0, phase = 0;
  const int n = net.n_layers;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const uint8_t* src = net.stream;
    for (int s = 0; s < 2 * n - 1; ++s) {
      const Stage st = stage_of(net.width, n, s);
      const int parts = st.value ? PF : PB;
      const int ksteps = (st.k + 15) / 16;
      const Split sp = split_of(st.n);
      for (int c = 0; c < sp.nch; ++c) {
        const int units[kConsumers] = {part(sp.u0, sp.nch, c), part(sp.u1, sp.nch, c)};
        for (int j = 0; j < ksteps; ++j) {
          for (int w = 0; w < kConsumers; ++w) {
            const int bytes = block_bytes(parts, units[w]);
            mbar_wait(bars + 8 * (net.ring + slot), phase ^ 1);  // the slot is free
            mbar_expect(bars + 8 * slot, bytes);
            bulk_load(slots + slot * net.slot_bytes, src, bytes, bars + 8 * slot);
            src += bytes;
            if (++slot == net.ring) {
              slot = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  }
}

// PF: parts of the value tier (2 bf16x3, 1 bf16); PB: of the grad tier.
template <int PF, int PB>
__global__ void __launch_bounds__(kThreads, 1)
fused_gram_mma_kernel(const float* __restrict__ x, float* __restrict__ quad,
                      float* __restrict__ dx, int n_rows, const __grid_constant__ TallNet net) {
  extern __shared__ __align__(128) uint8_t smem_tall[];
  const uint32_t slots = smem_addr(smem_tall);
  const uint32_t bars = slots + net.bars;
  const int n = net.n_layers;
  const int tiles = (n_rows + kRows - 1) / kRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < net.ring; ++s) {
      mbar_init(bars + 8 * s, 1);                               // full: the producer's arrival
      mbar_init(bars + 8 * (net.ring + s), 4);  // empty: its warpgroup's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumerThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumerThreads) produce<PF, PB>(net, tiles, slots, bars);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  uint8_t* const arena = smem_tall + net.arena;
  const uint32_t arena_at = slots + net.arena;
  uint16_t* const mask = reinterpret_cast<uint16_t*>(smem_tall + net.masks);
  float* const xl = reinterpret_cast<float*>(smem_tall + net.xl);
  float* const red = reinterpret_cast<float*>(smem_tall + net.red);
  const int ct = threadIdx.x;
  const int wg = ct >> 7;
  const int wi = (ct >> 5) & 3;  // this warp's 16 rows of the tile
  const int lane = ct & 31;
  const int g = lane >> 2;
  const int n_in = net.width[0];
  const int n1 = net.width[1];
  const int hidden = net.width[n];
  Ring ring{wg, 0, net.ring, bars};

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kRows;

    // 1. the input tile, log-clamped; rows past the batch are zero and
    //    never stored
    for (int t = ct; t < kRows * n_in; t += kConsumerThreads) {
      const int row = row0 + t / n_in;
      const int c = t % n_in;
      xl[t] = row < n_rows ? log_clamp(x[static_cast<size_t>(row) * n_in + c], c) : 0.f;
    }
    consumer_sync();

    // 2. skinny layer 0, exact fp32, into the first tile at the value
    //    tier: one item a (column, 16 rows), the column's weights held in
    //    registers, the 16 rows' dots in skinny_dot's order (products from
    //    c = 0, each product and sum rounded, then the bias); the item
    //    writes that column's mask word of the warp that owns the rows
    {
      uint8_t* const out = arena + net.in_off[0];
      const int np = (n1 + 15) & ~15;
      const int plane = 128 * np;
      for (int t = ct; t < 4 * np; t += kConsumerThreads) {
        const int j = t % np;
        const int r0 = 16 * (t / np);
        const bool real = j < n1;
        float w[kMaxIn];
#pragma unroll
        for (int c = 0; c < kMaxIn; ++c) w[c] = real && c < n_in ? __ldg(net.w0 + c * n1 + j) : 0.f;
        const float bj = real ? __ldg(net.b0 + j) : 0.f;
        uint32_t bits = 0u;
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
          const float* xr = xl + (r0 + rr) * n_in;
          float acc = __fmul_rn(xr[0], w[0]);
#pragma unroll
          for (int c = 1; c < kMaxIn; ++c) {
            if (c < n_in) acc = __fadd_rn(acc, __fmul_rn(xr[c], w[c]));
          }
          const float v = real ? relu(__fadd_rn(acc, bj)) : 0.f;
          store_one<PF>(out, plane, r0 + rr, j, v);
          bits |= static_cast<uint32_t>(v > 0.f) << rr;
        }
        mask[(net.mask_at[0] + j) * 4 + t / np] = static_cast<uint16_t>(bits);
      }
    }
    fence_async();
    consumer_sync();

    // 3. hidden layers 1 … n−1, ReLU, mask bits; the last writes h in fp32
    const int hs = ((hidden + 15) & ~15) + 8;  // row stride of the fp32 h tile
    for (int i = 1; i < n; ++i) {
      const int s = i - 1;
      const bool last = i == n - 1;
      const float* const bias = net.b[i];
      uint8_t* const out = arena + net.out_off[s];
      float* const hf = reinterpret_cast<float*>(out);
      const int plane = 128 * ((net.width[i + 1] + 15) & ~15);
      uint16_t* const m = mask + 4 * (last ? 0 : net.mask_at[i]);
      layer<PF>(arena_at + net.in_off[s], net.width[i], net.width[i + 1], ring, slots,
                net.slot_bytes, wg,
                [&](int col, int r, float v00, float v01, float v10, float v11) {
                  const float2 bj = __ldg(reinterpret_cast<const float2*>(bias + col));
                  const float a00 = relu(v00 + bj.x), a01 = relu(v01 + bj.y);
                  const float a10 = relu(v10 + bj.x), a11 = relu(v11 + bj.y);
                  if (last) {
                    *reinterpret_cast<float2*>(hf + r * hs + col) = make_float2(a00, a01);
                    *reinterpret_cast<float2*>(hf + (r + 8) * hs + col) = make_float2(a10, a11);
                    return;
                  }
                  store_pair<PF>(out, plane, r, col, a00, a01);
                  store_pair<PF>(out, plane, r + 8, col, a10, a11);
                  uint32_t bits0 = static_cast<uint32_t>(a00 > 0.f) << g |
                                   static_cast<uint32_t>(a10 > 0.f) << (g + 8);
                  uint32_t bits1 = static_cast<uint32_t>(a01 > 0.f) << g |
                                   static_cast<uint32_t>(a11 > 0.f) << (g + 8);
#pragma unroll
                  for (int o = 4; o < 32; o <<= 1) {  // OR over the 8 lanes of a column
                    bits0 |= __shfl_xor_sync(0xffffffffu, bits0, o);
                    bits1 |= __shfl_xor_sync(0xffffffffu, bits1, o);
                  }
                  if (lane < 4) {
                    m[col * 4 + wi] = static_cast<uint16_t>(bits0);
                    m[(col + 1) * 4 + wi] = static_cast<uint16_t>(bits1);
                  }
                });
      fence_async();
      consumer_sync();
    }

    // 4. h (fp32) split into the gram head's input tile
    const float* const hf = reinterpret_cast<const float*>(arena + net.out_off[n - 2]);
    const int hp = (hidden + 15) & ~15;
    {
      uint8_t* const ha = arena + net.in_off[n - 1];
      for (int t = ct; t < kRows * hp / 2; t += kConsumerThreads) {
        const int r = t / (hp / 2);
        const int c = 2 * (t % (hp / 2));
        const float2 v = *reinterpret_cast<const float2*>(hf + r * hs + c);
        store_pair<PF>(ha, 128 * hp, r, c, v.x, v.y);
      }
    }
    fence_async();
    consumer_sync();

    // 5. gram head: hg = h @ G in registers; quad partials Σ (hg + 2u)·h;
    //    e = hg + u masked by h > 0 at the grad tier, the first backward
    //    input
    float q0 = 0.f, q1 = 0.f;  // rows r and r + 8
    {
      uint8_t* const out = arena + net.out_off[n - 1];
      const float* const u = net.u;
      layer<PF>(arena_at + net.in_off[n - 1], hidden, hidden, ring, slots, net.slot_bytes, wg,
                [&](int col, int r, float g00, float g01, float g10, float g11) {
                  const float2 uj = __ldg(reinterpret_cast<const float2*>(u + col));
                  const float2 h0 = *reinterpret_cast<const float2*>(hf + r * hs + col);
                  const float2 h1 = *reinterpret_cast<const float2*>(hf + (r + 8) * hs + col);
                  q0 = fmaf(g01 + 2.f * uj.y, h0.y, fmaf(g00 + 2.f * uj.x, h0.x, q0));
                  q1 = fmaf(g11 + 2.f * uj.y, h1.y, fmaf(g10 + 2.f * uj.x, h1.x, q1));
                  store_pair<PB>(out, 128 * hp, r, col, h0.x > 0.f ? g00 + uj.x : 0.f,
                                 h0.y > 0.f ? g01 + uj.y : 0.f);
                  store_pair<PB>(out, 128 * hp, r + 8, col, h1.x > 0.f ? g10 + uj.x : 0.f,
                                 h1.y > 0.f ? g11 + uj.y : 0.f);
                });
    }
    q0 += __shfl_xor_sync(0xffffffffu, q0, 1);
    q0 += __shfl_xor_sync(0xffffffffu, q0, 2);
    q1 += __shfl_xor_sync(0xffffffffu, q1, 1);
    q1 += __shfl_xor_sync(0xffffffffu, q1, 2);
    if ((lane & 3) == 0) {
      red[wg * kRows + 16 * wi + g] = q0;
      red[wg * kRows + 16 * wi + g + 8] = q1;
    }
    fence_async();
    consumer_sync();
    if (ct < kRows && row0 + ct < n_rows) quad[row0 + ct] = red[ct] + red[kRows + ct];

    // 6. backward through trunk layers n−1 … 1: e ← (e @ W_iᵀ) masked by
    //    activation i−1; layer 1 writes e in fp32
    const int es = ((n1 + 15) & ~15) + 8;  // row stride of the fp32 e of layer 0
    for (int i = n - 1; i >= 1; --i) {
      const int s = 2 * n - 1 - i;
      const uint16_t* const m = mask + 4 * net.mask_at[i - 1];
      uint8_t* const out = arena + net.out_off[s];
      float* const ef = reinterpret_cast<float*>(out);
      const int plane = 128 * ((net.width[i] + 15) & ~15);
      layer<PB>(arena_at + net.in_off[s], net.width[i + 1], net.width[i], ring, slots,
                net.slot_bytes, wg,
                [&](int col, int r, float v00, float v01, float v10, float v11) {
                  const uint32_t m0 = m[col * 4 + wi];
                  const uint32_t m1 = m[(col + 1) * 4 + wi];
                  const float e00 = (m0 >> g) & 1u ? v00 : 0.f;
                  const float e10 = (m0 >> (g + 8)) & 1u ? v10 : 0.f;
                  const float e01 = (m1 >> g) & 1u ? v01 : 0.f;
                  const float e11 = (m1 >> (g + 8)) & 1u ? v11 : 0.f;
                  if (i == 1) {
                    *reinterpret_cast<float2*>(ef + r * es + col) = make_float2(e00, e01);
                    *reinterpret_cast<float2*>(ef + (r + 8) * es + col) = make_float2(e10, e11);
                  } else {
                    store_pair<PB>(out, plane, r, col, e00, e01);
                    store_pair<PB>(out, plane, r + 8, col, e10, e11);
                  }
                });
      fence_async();
      consumer_sync();
    }

    // 7. skinny layer backward, exact fp32, times the log-clamp derivative:
    //    a warp a row, its lanes over j (e's row read without bank
    //    conflicts, w0's rows coalesced), each input's sum over j reduced
    //    across the lanes
    {
      const float* const e0 = reinterpret_cast<const float*>(arena + net.out_off[2 * n - 2]);
      for (int r = ct >> 5; r < kRows; r += kConsumerThreads / 32) {
        float acc[kMaxIn];
#pragma unroll
        for (int c = 0; c < kMaxIn; ++c) acc[c] = 0.f;
        for (int j = lane; j < n1; j += 32) {
          const float ej = e0[r * es + j];
#pragma unroll
          for (int c = 0; c < kMaxIn; ++c) {
            if (c < n_in) acc[c] = fmaf(ej, __ldg(net.w0 + c * n1 + j), acc[c]);
          }
        }
        float mine = 0.f;  // lane c keeps input c's sum
#pragma unroll
        for (int c = 0; c < kMaxIn; ++c) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
          if (lane == c) mine = acc[c];
        }
        const int row = row0 + r;
        if (lane < n_in && row < n_rows) {
          const size_t at = static_cast<size_t>(row) * n_in + lane;
          dx[at] = log_clamp_grad(x[at], lane) * mine;
        }
      }
    }
    consumer_sync();  // the next tile overwrites the input tile, the masks and the arena
  }
}

template <int PF, int PB>
cudaError_t launch_kernel(const float* x, float* quad, float* dx, int n_rows, const TallNet& net,
                          int smem, int ctas, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(fused_gram_mma_kernel<PF, PB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n_rows + kRows - 1) / kRows;
  fused_gram_mma_kernel<PF, PB><<<std::min(tiles, ctas), kThreads, smem, stream>>>(x, quad, dx,
                                                                                   n_rows, net);
  return cudaGetLastError();
}

int parts_of(int tier) { return tier == kBF16x3 ? 2 : 1; }

int round16(int bytes) { return (bytes + 15) & ~15; }

// Checks the shapes, the tiers and the plan, lays out shared memory as
// fused_loglik.py::tall_plan does and launches.
int launch_tall(const float* x, float* quad, float* dx, int n_rows, int n_layers,
                const int* widths, const void* const* ptrs, int n_members, int tier,
                int tier_bwd, const int* plan, int ctas, cudaStream_t stream) {
  if (n_rows <= 0 || n_members != 1 || n_layers < 2 || n_layers > kMaxLayers || widths[0] < 1 ||
      widths[0] > kMaxIn || tier != kBF16x3 || tier_bwd != kBF16 || ctas < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TallNet net{};
  net.n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    net.width[i] = widths[i];
  }
  const int pf = parts_of(tier);  // the kernel's PF and PB
  const int pb = parts_of(tier_bwd);
  const int stages = 2 * n_layers - 1;
  int slot_bytes = 0;
  for (int s = 0; s < stages; ++s) {
    const Stage st = stage_of(net.width, n_layers, s);
    const Split sp = split_of(st.n);
    if (st.n <= 16) return static_cast<int>(cudaErrorInvalidValue);  // an empty chunk
    const int units = (sp.u0 + sp.nch - 1) / sp.nch;  // the widest chunk
    slot_bytes = std::max(slot_bytes, block_bytes(st.value ? pf : pb, units));
  }
  const int arena = plan[0];
  net.ring = plan[1];
  net.slot_bytes = slot_bytes;
  if (net.ring < kMinRing || net.ring > kMaxRing || arena < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int s = 0; s < stages; ++s) {
    net.in_off[s] = plan[2 + s];
    net.out_off[s] = plan[2 + stages + s];
    if (net.in_off[s] < 0 || net.out_off[s] < 0 || net.in_off[s] % 16 != 0 ||
        net.out_off[s] % 16 != 0 || net.in_off[s] >= arena || net.out_off[s] >= arena) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  int cols = 0;
  for (int i = 0; i < n_layers - 1; ++i) {
    net.mask_at[i] = cols;
    cols += (widths[i + 1] + 15) & ~15;
  }
  net.arena = net.ring * slot_bytes;
  net.masks = net.arena + arena;
  net.xl = net.masks + 8 * cols;
  net.red = net.xl + round16(4 * kRows * widths[0]);
  net.bars = net.red + 4 * kConsumers * kRows;
  const int smem = net.bars + 16 * net.ring;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);

  int k = 0;
  net.w0 = static_cast<const float*>(ptrs[k++]);
  net.b0 = static_cast<const float*>(ptrs[k++]);
  for (int i = 1; i < n_layers; ++i) net.b[i] = static_cast<const float*>(ptrs[k++]);
  net.u = static_cast<const float*>(ptrs[k++]);
  net.stream = static_cast<const uint8_t*>(ptrs[k++]);

  return static_cast<int>(launch_kernel<2, 1>(x, quad, dx, n_rows, net, smem, ctas, stream));
}

}  // namespace tall
}  // namespace

extern "C" {

// K3 on 64-row tiles. ptrs, in order: w0, b0 (exact fp32); each trunk
// layer i = 1 … n_layers-1's bias zero-padded to a multiple of 16; u
// zero-padded to a multiple of 16; then the weight stream of
// ops/kernels/fused_loglik.py::pack_tall (bf16: layers 1 … n_layers-1 and
// G at tier, W_iᵀ for i = n_layers-1 … 1 at tier_bwd). strides are not
// read: one model per launch (n_members 1). tier, tier_bwd: 2 (bf16x3)
// and 1 (bf16), the one pair built. plan: the arena's bytes, the ring's
// slots, then each stage's input and output offsets in the arena
// (fused_loglik.py::tall_plan).
// ctas: the persistent grid's CTAs (the card's SMs). Launches on
// `stream`, allocates nothing and does not synchronise; returns the
// cudaError_t of the launch.
int k3_fused_loglik_grad_gram_tall(const float* x, float* quad, float* dx, int n_rows,
                                   int n_layers, const int* widths, const void* const* ptrs,
                                   const long long* strides, int n_members, int tier,
                                   int tier_bwd, const int* plan, int ctas, void* stream) {
  (void)strides;
  return tall::launch_tall(x, quad, dx, n_rows, n_layers, widths, ptrs, n_members, tier,
                           tier_bwd, plan, ctas, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
