// Shared device code of the fused ConvNeXt block tail for Hopper (sm_90a):
//   y = r + keep * gamma * (gelu_tanh(LN(s) @ W1 + b1) @ W2 + b2)
// block_mlp.cu instantiates the forward and the input-only backward,
// block_mlp_bwd.cu the full backward's row pass; each is built into its own
// library.
//
// Replaces the TPU kernels of revisiting_at_tpu/ops/block_mlp.py:
//   fwd_kernel (block_mlp.cu)  <- _fwd_kernel        (forward)
//   bwd_kernel<C, T, false>    <- _bwd_input_kernel  (ds only)
//   bwd_kernel<C, T, true>     <- the row work of _bwd_kernel (ds, the bf16
//                                 side outputs, per-tile column sums)
//
// Numerics follow the TPU kernels: bf16 operands with f32 accumulation,
// u16 = bf16(LN(s)), g16 = bf16(gelu(h)), kdy16 = bf16(keep * dy), dh16 =
// bf16(dg * gelu'(h)), w2g16 = bf16(W2 * gamma); GELU is the tanh form; LN
// statistics are f32 and two-pass, eps 1e-6. Every sum is taken in an order
// fixed by the code (no atomics), so two launches give the same bits, and
// the row pass's ds is the input backward's, bit for bit (one code path).
//
// What bounds them on the H100: per row the forward does 16 C^2 flops and
// the backward 24 C^2 against about 6 C bytes of activations, so at every
// width they are bound by the tensor cores (989 TFLOP/s bf16), not by HBM.
// A block cannot hold the weights (16 C^2 bytes in bf16, 2.4 MB at C =
// 384), so it streams them over the 4C axis and reads them from L2 once per
// block: as many flops per L2 byte as the block has rows (64 for a 64-row
// block, more than the L2 can feed at the tensor-core rate). The WMMA design
// ran each product as synchronous 16x16 WMMA with weight fragments loaded
// straight from L2, serialised every chunk through f32 shared memory and
// two __syncthreads, and ran at 5-7% of the bf16 peak.
//
// The design at C = 96, 128, 192, 256 and 384 (`kWgmma`, a block alone):
//   * One producer thread keeps TMA loads of the weights in flight through a
//     ring of S stages guarded by mbarriers. Each stage is one 64-row chunk
//     of the 4C axis of a [4C, C] weight: W1^T (the wrapper transposes W1),
//     W2 in the forward, w2g in the backward, as 64 x 64 boxes with 128-byte
//     swizzle (columns past C zero-filled). So every product's B operand is
//     a slice of a stage: h = u W1c and dg = kdy w2g_c^T take it K-major
//     (rows of the chunk), o += g W2c and du += dh16 W1c take it MN-major
//     (columns of C). One W1^T stage feeds both h and du in the backward.
//   * R x G consumer warpgroups: R row tiles of 64 rows (two up to C = 192,
//     and at C = 96 four in the forward and three in the input backward:
//     each stage is read by every row tile, so L2 reads per row fall with
//     R, and the warpgroups hide each other's latencies), each row tile's C
//     output columns split over G warpgroups (G = 2 from C = 256, so that a
//     thread's f32 accumulator of o or du is at most 96 registers). The row
//     tile's warpgroups also split its chunk columns for h and dg. On the
//     H100 the extra row tiles at C = 96 cut the forward's and the input
//     backward's time by 20% and 18% (tools/tree_compare.py); issuing the
//     next chunk's h before this chunk's GELU measured 6-12% slower.
//   * The consumers normalise their rows (and form kdy) into bf16 tiles in
//     shared memory laid out and swizzled as wgmma's K-major A operand
//     reads them, while the first stages land; fence.proxy.async makes the
//     writes visible to wgmma.
//   * Per chunk: h (and dg) by wgmma from shared memory into registers;
//     b1, GELU (gelu') in registers; the bf16 g (dh16) tile stored swizzled
//     into a double-buffered shared tile, one named barrier for the row
//     tile; o (du) += tile @ stage by wgmma, left in flight while the next
//     chunk's h is issued. Nothing goes through f32 shared memory.
//   * Epilogues from the accumulator registers: the forward adds b2,
//     keep * gamma and the residual; the backward sums the LayerNorm
//     backward's row sums over a quad of lanes, then over the row tile's
//     warpgroups in order. The row pass also writes u16, kdy16, g16, dh16
//     and per-64-row-tile column sums of the f32 dh (db1), du * xhat and du.
//   * A producer warpgroup (one thread issues the loads) hands registers to
//     the consumers by setmaxnreg.
//   Rows past M are zero in the u and kdy tiles and are never stored.
//
// The design at C = 432, 512 and 768 (kCluster = 2): a 64-row tile's u and
// kdy tiles (192 KB at C = 768), a 64-row weight chunk (96 KB) and a [64, C]
// f32 accumulator (384 registers a thread of a warpgroup) do not fit one
// block, and at 432 and 512 one block has room for the forward's ring but not
// for the backward's. So a thread-block cluster of two blocks takes each
// tile, block rank r holding columns [CB r, CB r + CB) of C, CB = CP / 2: its
// halves of u and kdy, of every ring stage (the K half of a W1^T or w2g
// chunk, the column half of a W2 chunk), of o or du; each block is tiled as
// C = CB (two consumer warpgroups of CB / 2 accumulator columns, a producer
// warpgroup).
//   * C = 432 (convnext_iso) is 13.5 x 32: it runs the tiling of its padded
//     width CP = 512 (`kPadded`), rank 1 holding columns 256-431 and 80 pad
//     columns. The pad is zero wherever a product contracts over it: u and
//     kdy are written 0 there, the weight boxes are zero-filled by TMA past
//     column 432 (the box at 448 lies wholly past it), so h and dg are
//     those of 432 columns and the pad columns of o and du are 0. The
//     LayerNorm statistics divide by 432, no load or store reaches past
//     column 432 of a row (a pad column's load is clamped to the last
//     channel and dropped), and no row sum or column sum takes a pad column.
//     Padding costs 18.5% more tensor work than 432 needs.
//   * h = u W1c and dg = kdy w2g_c^T contract over C, so a block forms a
//     partial over its half. The thread of the same index in the other
//     block holds the same rows and columns: each thread sends the peer the
//     half of its registers that the peer finalises (8 f32 of h, and of dg)
//     into the peer's shared memory by st.async, whose bytes complete on the
//     peer's mbarrier (no thread waits for a remote store to be
//     acknowledged, as a release arrive on the peer's barrier would); the
//     peer adds them to its own, a + b, the same bits in every launch.
//   * Each block applies b1 and GELU (gelu') to its half of the chunk's
//     columns and writes the bf16 g (dh16) into its own g tile and, by
//     st.async, the peer's; a tile's mbarrier counts this block's warps and
//     the peer's bytes before o (du) reads it. o and du have the block's own
//     columns as N: no exchange.
//   * LayerNorm: each block reads whole rows of s, so both hold the same
//     statistics; the backward's row sums m1, m2 cross the cluster once,
//     added in the same order in both blocks. Each block writes y or ds,
//     and the row pass's side outputs, for the columns it owns: the row
//     pass's ds stays bit for bit the input backward's.
//   * The forward is software-pipelined by one chunk (the next chunk's h
//     runs while this chunk's partial crosses the cluster and its GELU
//     runs; the producer keeps W1^T a chunk ahead of W2). The backward is
//     not: at C = 768 its two ring stages hold one chunk of w2g and of
//     W1^T, and no more (four stages at 432 and 512).
//   * Launched with cudaLaunchKernelEx and a cluster dimension of 2; the
//     mbarriers of both blocks are initialised before either block arrives
//     on the other's (a cluster barrier), and every thread of both blocks
//     meets at a cluster barrier at the end, so that no block exits while
//     its peer may still reach its shared memory.
//
// The other widths built keep the WMMA kernels (fwd_kernel_wmma,
// bwd_kernel_wmma): 16, 32 and 64 (the micro models), and 1024 (ConvNeXt-B's
// last stage; ROADMAP G4), whose half of C leaves the backward one ring
// stage: it needs a cluster of four, not built yet.
//
// The WMMA design: each block owns BM rows, normalises them into a bf16
// tile, and streams the 4C axis in chunks of BH columns; per chunk every
// warp computes one 16-wide column tile of h for all BM rows, the block
// applies b1 and GELU in shared memory, and every warp accumulates its C
// columns of the next product into WMMA accumulators, with weight fragments
// read from L2. Widths that are not a multiple of 32 (C = 16) leave the
// last lanes of a row without a channel; the row code masks them behind
// `if constexpr`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float kK0 = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float kK1 = 0.044715f;
constexpr float kEps = 1e-6f;

template <int C>
struct Cfg {
  static constexpr int H = 4 * C;
  static constexpr int NT = C / 16;                   // 16-wide column tiles of C
  // warps per block: one per column tile below 6 tiles (C = 16, 32, 64)
  static constexpr int NW = NT < 6 ? NT : (NT % 8 == 0 ? 8 : (NT % 6 == 0 ? 6 : 9));
  static constexpr int NTHREADS = NW * 32;
  static constexpr int BM = C <= 384 ? 64 : (C <= 768 ? 32 : 16);  // rows per block
  static constexpr int MT = BM / 16;                  // 16-row tiles per block
  static constexpr int BH = 16 * NW;                  // 4C chunk: one tile per warp
  static constexpr int CPW = NT / NW;                 // C column tiles per warp
  static constexpr int VPL = (C + 31) / 32;           // values per lane in a row
  static constexpr int LDU = C + 8;                   // bf16 [BM][C] row stride
  static constexpr int LDH = BH + 4;                  // f32 [BM][BH] row stride
  static constexpr int LDG = BH + 8;                  // bf16 [BM][BH] row stride
  static_assert(C % 16 == 0, "C must be a multiple of 16");
  static_assert(NT % NW == 0, "column tiles must split evenly over warps");
  static_assert(H % BH == 0, "4C must split into whole chunks");
  static_assert(NTHREADS == 2 * BH, "each thread owns one column of a chunk");
};

// Rows of the full backward's side buffers are padded to a multiple of this
// (a multiple of every block's rows and of the weight kernel's depth step).
constexpr int kRowPad = 128;

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// Whether value i of a lane's row values (channel lane + 32 * i) is a
// channel: always where C is a multiple of 32, else only below C.
template <int C>
__device__ __forceinline__ bool lane_in_row(int c) {
  if constexpr (C % 32 == 0) {
    return true;
  } else {
    return c < C;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_tanh(float h) {
  float t = tanhf(kK0 * (h + kK1 * h * h * h));
  return 0.5f * h * (1.0f + t);
}

__device__ __forceinline__ float dgelu_tanh(float h) {
  float t = tanhf(kK0 * (h + kK1 * h * h * h));
  float dinner = kK0 * (1.0f + 3.0f * kK1 * h * h);
  return 0.5f * (1.0f + t) + 0.5f * h * (1.0f - t * t) * dinner;
}

// gelu(h) and gelu'(h) from one tanh, the same formulas as above.
__device__ __forceinline__ void gelu_and_dgelu_tanh(float h, float& g, float& dg) {
  float t = tanhf(kK0 * (h + kK1 * h * h * h));
  float dinner = kK0 * (1.0f + 3.0f * kK1 * h * h);
  g = 0.5f * h * (1.0f + t);
  dg = 0.5f * (1.0f + t) + 0.5f * h * (1.0f - t * t) * dinner;
}

__device__ __forceinline__ float keep_of(const float* keep, int rows_per_keep, int64_t row) {
  return keep ? keep[row / rows_per_keep] : 1.0f;
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> AFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> AColFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRowFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BColFrag;

// LayerNorm of the block's BM rows into u16 (bf16). Rows past M become 0.
// Each warp normalises whole rows; statistics are f32 and two-pass, as in
// the TPU kernel's _ln_f32. mean/inv are stored when the backward needs them.
template <int C, typename T>
__device__ void layer_norm_rows(const T* __restrict__ s, const float* __restrict__ ln_g,
                                const float* __restrict__ ln_b, int64_t row0, int64_t M,
                                bf16* u16, float* mean_out, float* inv_out) {
  using K = Cfg<C>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rr = warp; rr < K::BM; rr += K::NW) {
    const int64_t row = row0 + rr;
    bf16* urow = u16 + rr * K::LDU;
    if (row >= M) {
#pragma unroll
      for (int i = 0; i < K::VPL; ++i)
        if (lane_in_row<C>(lane + 32 * i)) urow[lane + 32 * i] = __float2bfloat16(0.0f);
      if (lane == 0 && mean_out) { mean_out[rr] = 0.0f; inv_out[rr] = 0.0f; }
      continue;
    }
    const T* srow = s + row * C;
    float v[K::VPL];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < K::VPL; ++i) {
      v[i] = lane_in_row<C>(lane + 32 * i) ? to_f32(srow[lane + 32 * i]) : 0.0f;
      sum += v[i];
    }
    const float mu = warp_sum(sum) / C;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < K::VPL; ++i) {
      float d = lane_in_row<C>(lane + 32 * i) ? v[i] - mu : 0.0f;
      sq += d * d;
    }
    const float inv = rsqrtf(warp_sum(sq) / C + kEps);
#pragma unroll
    for (int i = 0; i < K::VPL; ++i) {
      const int c = lane + 32 * i;
      if (lane_in_row<C>(c)) urow[c] = __float2bfloat16((v[i] - mu) * inv * ln_g[c] + ln_b[c]);
    }
    if (lane == 0 && mean_out) { mean_out[rr] = mu; inv_out[rr] = inv; }
  }
}

template <int C>
constexpr size_t fwd_smem_bytes() {
  using K = Cfg<C>;
  return align128(K::BM * K::LDU * 2) + align128(K::BM * K::LDH * 4) +
         align128(K::BM * K::LDG * 2) + align128(K::NW * 256 * 4);
}

template <int C>
constexpr size_t bwd_smem_bytes() {
  using K = Cfg<C>;
  return 2 * align128(K::BM * K::LDU * 2) + 2 * align128(K::BM * K::LDH * 4) +
         align128(K::BM * K::LDG * 2) + align128(K::NW * 256 * 4) + align128(4 * K::BM * 4);
}

// Side outputs of the full backward's row pass (FULL = true); unused otherwise.
struct FullOut {
  bf16* u16;        // [Mpad, C]  bf16(LN(s)), 0 past M
  bf16* kdy16;      // [Mpad, C]  bf16(keep * dy), 0 past M
  bf16* g16;        // [Mpad, 4C] bf16(gelu(h)), 0 past M
  bf16* dh16;       // [Mpad, 4C] bf16(dh), 0 past M
  // column sums over each group of `part_rows` rows (the plan's: 64 for
  // the wgmma design, BM for the WMMA kernels), in row order
  float* db1_part;  // [Mpad / part_rows, 4C] of the f32 dh
  float* dlng_part; // [Mpad / part_rows, C]  of du * xhat
  float* dlnb_part; // [Mpad / part_rows, C]  of du
};

// The WMMA backward of the tail for BM rows (the widths without
// kWgmma): ds from dy, with w2g = bf16(W2 * gamma). FULL = false is the
// input-only backward (_bwd_input_kernel). FULL = true is the row pass of
// the full backward (_bwd_kernel): the same ds, bit for bit, plus the side
// outputs above, its column sums per block of BM rows.
template <int C, typename T, bool FULL>
__global__ void __launch_bounds__(Cfg<C>::NTHREADS)
bwd_kernel_wmma(const T* __restrict__ s, const float* __restrict__ keep, int rows_per_keep,
           const float* __restrict__ ln_g, const float* __restrict__ ln_b,
           const bf16* __restrict__ w1, const float* __restrict__ b1,
           const bf16* __restrict__ w2g, const T* __restrict__ dy,
           T* __restrict__ ds, int64_t M, FullOut out) {
  using K = Cfg<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  bf16* u16 = reinterpret_cast<bf16*>(p);     p += align128(K::BM * K::LDU * 2);
  bf16* kdy16 = reinterpret_cast<bf16*>(p);   p += align128(K::BM * K::LDU * 2);
  float* hbuf = reinterpret_cast<float*>(p);  p += align128(K::BM * K::LDH * 4);
  float* dgbuf = reinterpret_cast<float*>(p); p += align128(K::BM * K::LDH * 4);
  bf16* dh16 = reinterpret_cast<bf16*>(p);    p += align128(K::BM * K::LDG * 2);
  float* scratch = reinterpret_cast<float*>(p); p += align128(K::NW * 256 * 4);
  float* mean = reinterpret_cast<float*>(p);
  float* inv = mean + K::BM;
  float* sum1 = inv + K::BM;   // row sums of du * g
  float* sum2 = sum1 + K::BM;  // row sums of du * g * xhat
  // Parts of sum1 and sum2 per 16-wide column tile, [NT][BM] each, added in
  // tile order (no atomics). They reuse hbuf, which no thread reads after
  // the last chunk's GELU step and its __syncthreads.
  float* part1 = hbuf;
  float* part2 = hbuf + K::NT * K::BM;
  static_assert(2 * K::NT <= K::LDH, "row-sum parts must fit in hbuf");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * K::BM;

  layer_norm_rows<C, T>(s, ln_g, ln_b, row0, M, u16, mean, inv);
  for (int i = threadIdx.x; i < K::BM * C; i += K::NTHREADS) {
    const int rr = i / C, c = i % C;
    const int64_t row = row0 + rr;
    const float v = row < M ? keep_of(keep, rows_per_keep, row) * to_f32(dy[row * C + c]) : 0.0f;
    kdy16[rr * K::LDU + c] = __float2bfloat16(v);
  }
  __syncthreads();
  if constexpr (FULL) {
    // u16 and kdy16 are the left operands of the weight pass: 16-byte copies
    for (int i = threadIdx.x; i < K::BM * (C / 8); i += K::NTHREADS) {
      const int rr = i / (C / 8), c8 = (i % (C / 8)) * 8;
      const size_t gi = static_cast<size_t>(row0 + rr) * C + c8;
      *reinterpret_cast<uint4*>(out.u16 + gi) =
          *reinterpret_cast<const uint4*>(u16 + rr * K::LDU + c8);
      *reinterpret_cast<uint4*>(out.kdy16 + gi) =
          *reinterpret_cast<const uint4*>(kdy16 + rr * K::LDU + c8);
    }
  }

  AccFrag du[K::MT][K::CPW];
#pragma unroll
  for (int mi = 0; mi < K::MT; ++mi)
#pragma unroll
    for (int ci = 0; ci < K::CPW; ++ci) wmma::fill_fragment(du[mi][ci], 0.0f);

  for (int h0 = 0; h0 < K::H; h0 += K::BH) {
    const int j0 = h0 + 16 * warp;  // this warp's 16 columns of the chunk
    {
      AccFrag hf[K::MT];
#pragma unroll
      for (int mi = 0; mi < K::MT; ++mi) wmma::fill_fragment(hf[mi], 0.0f);
      for (int k = 0; k < C; k += 16) {
        BRowFrag b;  // W1[k.., j0..]
        wmma::load_matrix_sync(b, w1 + static_cast<size_t>(k) * K::H + j0, K::H);
#pragma unroll
        for (int mi = 0; mi < K::MT; ++mi) {
          AFrag a;
          wmma::load_matrix_sync(a, u16 + mi * 16 * K::LDU + k, K::LDU);
          wmma::mma_sync(hf[mi], a, b, hf[mi]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < K::MT; ++mi)
        wmma::store_matrix_sync(hbuf + mi * 16 * K::LDH + 16 * warp, hf[mi], K::LDH,
                                wmma::mem_row_major);
    }
    {
      AccFrag gf[K::MT];  // dg = kdy16 @ w2g^T: B[c, j] = w2g[j, c]
#pragma unroll
      for (int mi = 0; mi < K::MT; ++mi) wmma::fill_fragment(gf[mi], 0.0f);
      for (int k = 0; k < C; k += 16) {
        BColFrag b;
        wmma::load_matrix_sync(b, w2g + static_cast<size_t>(j0) * C + k, C);
#pragma unroll
        for (int mi = 0; mi < K::MT; ++mi) {
          AFrag a;
          wmma::load_matrix_sync(a, kdy16 + mi * 16 * K::LDU + k, K::LDU);
          wmma::mma_sync(gf[mi], a, b, gf[mi]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < K::MT; ++mi)
        wmma::store_matrix_sync(dgbuf + mi * 16 * K::LDH + 16 * warp, gf[mi], K::LDH,
                                wmma::mem_row_major);
    }
    __syncthreads();
    if constexpr (FULL) {
      // NTHREADS = 2 * BH: this thread owns column cc of the chunk and every
      // other row; its f32 dh sum and its partner's are added in a fixed order
      float db1_acc = 0.0f;
      for (int i = threadIdx.x; i < K::BM * K::BH; i += K::NTHREADS) {
        const int rr = i / K::BH, cc = i % K::BH;
        const bool live = row0 + rr < M;
        const float h = hbuf[rr * K::LDH + cc] + b1[h0 + cc];
        float g, dgl;
        gelu_and_dgelu_tanh(h, g, dgl);
        const float dh = live ? dgbuf[rr * K::LDH + cc] * dgl : 0.0f;
        const bf16 dhb = __float2bfloat16(dh);
        dh16[rr * K::LDG + cc] = dhb;
        const size_t gi = static_cast<size_t>(row0 + rr) * K::H + h0 + cc;
        out.g16[gi] = __float2bfloat16(live ? g : 0.0f);
        out.dh16[gi] = dhb;
        db1_acc += dh;
      }
      scratch[threadIdx.x] = db1_acc;
    } else {
      for (int i = threadIdx.x; i < K::BM * K::BH; i += K::NTHREADS) {
        const int rr = i / K::BH, cc = i % K::BH;
        const float h = hbuf[rr * K::LDH + cc] + b1[h0 + cc];
        dh16[rr * K::LDG + cc] = __float2bfloat16(dgbuf[rr * K::LDH + cc] * dgelu_tanh(h));
      }
    }
    __syncthreads();
    if constexpr (FULL) {
      if (threadIdx.x < K::BH)
        out.db1_part[static_cast<size_t>(blockIdx.x) * K::H + h0 + threadIdx.x] =
            scratch[threadIdx.x] + scratch[threadIdx.x + K::BH];
    }
    // du[:, this warp's columns] += dh16 @ W1^T: B[j, c] = W1[c, j]
#pragma unroll
    for (int k = 0; k < K::BH; k += 16) {
      AFrag a[K::MT];
#pragma unroll
      for (int mi = 0; mi < K::MT; ++mi)
        wmma::load_matrix_sync(a[mi], dh16 + mi * 16 * K::LDG + k, K::LDG);
#pragma unroll
      for (int ci = 0; ci < K::CPW; ++ci) {
        BColFrag b;
        wmma::load_matrix_sync(
            b, w1 + static_cast<size_t>((warp * K::CPW + ci) * 16) * K::H + h0 + k, K::H);
#pragma unroll
        for (int mi = 0; mi < K::MT; ++mi) wmma::mma_sync(du[mi][ci], a[mi], b, du[mi][ci]);
      }
    }
  }
  // the epilogue reuses scratch, which the last chunk's db1 partial still reads
  if constexpr (FULL) __syncthreads();

  // LayerNorm backward: ds = inv * (dxh - mean(dxh) - xhat * mean(dxh * xhat)),
  // dxh = du * ln_g. Pass 1 reduces the row sums, pass 2 writes ds. The full
  // backward also sums du * xhat and du over the block's rows per column.
  float* scr = scratch + warp * 256;
  float col_g[FULL ? K::CPW : 1], col_b[FULL ? K::CPW : 1];
  if constexpr (FULL) {
#pragma unroll
    for (int ci = 0; ci < K::CPW; ++ci) { col_g[ci] = 0.0f; col_b[ci] = 0.0f; }
  }
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < K::BM; i += K::NTHREADS) {
        float a = 0.0f, b = 0.0f;
        for (int t = 0; t < K::NT; ++t) { a += part1[t * K::BM + i]; b += part2[t * K::BM + i]; }
        sum1[i] = a;
        sum2[i] = b;
      }
      __syncthreads();
    }
#pragma unroll
    for (int mi = 0; mi < K::MT; ++mi) {
#pragma unroll
      for (int ci = 0; ci < K::CPW; ++ci) {
        wmma::store_matrix_sync(scr, du[mi][ci], 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int idx = lane + 32 * e, rr = mi * 16 + idx / 16, cc = idx % 16;
          const int64_t row = row0 + rr;
          const int col = (warp * K::CPW + ci) * 16 + cc;
          const bool live = row < M;
          const float xhat = live ? (to_f32(s[row * C + col]) - mean[rr]) * inv[rr] : 0.0f;
          const float dxh = scr[idx] * ln_g[col];
          if (pass == 0) {
            if constexpr (FULL) {
              // lane holds column lane % 16 and rows lane / 16 + 2e
              col_g[ci] += live ? scr[idx] * xhat : 0.0f;
              col_b[ci] += live ? scr[idx] : 0.0f;
            }
            // lanes 0-15 hold one row, lanes 16-31 the next: reduce over 16 lanes
            float p1 = dxh, p2 = dxh * xhat;
#pragma unroll
            for (int o = 8; o > 0; o >>= 1) {
              p1 += __shfl_xor_sync(0xffffffffu, p1, o);
              p2 += __shfl_xor_sync(0xffffffffu, p2, o);
            }
            if (cc == 0) {
              const int t = warp * K::CPW + ci;  // this column tile
              part1[t * K::BM + rr] = p1;
              part2[t * K::BM + rr] = p2;
            }
          } else if (live) {
            const float m1 = sum1[rr] / C, m2 = sum2[rr] / C;
            ds[row * C + col] = from_f32<T>(inv[rr] * (dxh - m1 - xhat * m2));
          }
        }
        __syncwarp();
      }
    }
  }
  if constexpr (FULL) {
#pragma unroll
    for (int ci = 0; ci < K::CPW; ++ci) {
      const float g = col_g[ci] + __shfl_xor_sync(0xffffffffu, col_g[ci], 16);
      const float b = col_b[ci] + __shfl_xor_sync(0xffffffffu, col_b[ci], 16);
      if (lane < 16) {
        const size_t gi = static_cast<size_t>(blockIdx.x) * C + (warp * K::CPW + ci) * 16 + lane;
        out.dlng_part[gi] = g;
        out.dlnb_part[gi] = b;
      }
    }
  }
}

template <int C, typename T, bool FULL>
int launch_bwd_wmma(const void* s, const float* keep, int rows_per_keep, const float* ln_g,
               const float* ln_b, const bf16* w1, const float* b1, const bf16* w2g,
               const void* dy, void* ds, int64_t M, int64_t rows, FullOut out,
               cudaStream_t stream) {
  using K = Cfg<C>;
  constexpr size_t smem = bwd_smem_bytes<C>();
  auto kern = bwd_kernel_wmma<C, T, FULL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((rows + K::BM - 1) / K::BM);
  kern<<<grid, K::NTHREADS, smem, stream>>>(
      static_cast<const T*>(s), keep, rows_per_keep, ln_g, ln_b, w1, b1, w2g,
      static_cast<const T*>(dy), static_cast<T*>(ds), M, out);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------------- wgmma design

// The widths that take the TMA + wgmma kernels; the others take the WMMA
// kernels, chosen here at compile time.
template <int C>
constexpr bool kWgmma = C == 96 || C == 128 || C == 192 || C == 256 || C == 384 || C == 432 || C == 512 || C == 768;

// Blocks of a thread-block cluster that share each 64-row tile, block rank
// r holding columns [CP / kCluster r, + CP / kCluster) of the padded width
// CP (1: a block alone).
template <int C>
constexpr int kCluster = C == 432 || C == 512 || C == 768 ? 2 : 1;

// The width the wgmma kernels tile: C, or where C is not a multiple of 32
// (432), C rounded up to whole 64-column boxes in every block of a cluster.
// Columns past C are pad: zero in every operand a product contracts over,
// never loaded from or stored to memory.
template <int C>
constexpr int kPadded = C % 32 == 0 ? C : (C + 64 * kCluster<C> - 1) / (64 * kCluster<C>) * (64 * kCluster<C>);

// Whether column c of the padded width is a channel: always where C is not
// padded, else only below C (a compile-time true at the other widths).
template <int C>
__device__ __forceinline__ bool in_c(int c) {
  if constexpr (kPadded<C> == C) {
    return true;
  } else {
    return c < C;
  }
}

// Column c (of W consecutive columns) clamped into the row: a pad column
// reads the row's last channel(s), and the caller drops what it read (a
// select on in_c). The loads are then issued unconditionally, as at the
// other widths: with the loads of s and dy under a column mask, the C = 432
// input backward ran slower on the H100 than 512's, which has 32 chunks of
// 4C to its 27 (tools/tree_compare.py --wide).
template <int C, int W = 1>
__device__ __forceinline__ int clamp_c(int c) {
  if constexpr (kPadded<C> == C) {
    return c;
  } else {
    return c < C ? c : C - W;
  }
}

constexpr int kBox = 8192;            // a 64 x 64 bf16 box, 128-byte rows
constexpr int kProducerRegs = 24;     // registers the producer warpgroup keeps
constexpr int kSmemMax = 232448;      // dynamic shared memory a block can use
enum { kFwd = 0, kBwdInput = 1, kBwdRows = 2 };

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The tiling of one width and mode (ops/block_mlp.py tail_plan mirrors it;
// the entry points refuse a plan that differs).
template <int C, int MODE>
struct Plan {
  static constexpr int CL = kCluster<C>;         // blocks of a cluster
  static constexpr int CP = kPadded<C>;          // the width tiled
  static constexpr int CB = CP / CL;             // columns of CP a block holds
  // row tiles of 64 rows: two up to C = 192, and at C = 96, whose
  // accumulators leave registers for more warpgroups, four in the forward
  // and three in the input backward (the row pass keeps two: its rows per
  // block divide the side buffers' padding)
  static constexpr int R = CB > 192 ? 1 : (C != 96 ? 2 : (MODE == kFwd ? 4 : (MODE == kBwdInput ? 3 : 2)));
  static constexpr int G = CB <= 192 ? 1 : 2;    // warpgroups over a row tile's columns
  static constexpr int NWG = R * G;
  static constexpr int THREADS = 128 * (NWG + 1);  // and the producer warpgroup
  // registers of a consumer thread (setmaxnreg): the block is launched
  // with the registers of an even split (65536 / THREADS, down to a multiple
  // of 8), and setmaxnreg only moves them between its warpgroups: a raise
  // past what the producer gave up would wait forever
  static constexpr int POOL = THREADS * (65536 / THREADS / 8 * 8);
  static constexpr int CREGS = cmin(240, (POOL - 128 * kProducerRegs) / (128 * NWG) / 8 * 8);
  static constexpr int BM = 64 * R;              // rows per block
  static constexpr int BH = 64;                  // 4C chunk: one ring stage
  static constexpr int NCH = 4 * C / BH;
  static constexpr int CW = CB / G;              // accumulator columns per warpgroup
  static constexpr int N1 = BH / G;              // h and dg columns per warpgroup
  static constexpr int NK = N1 / 2 / CL;         // h (dg) registers a thread finalises
  static constexpr int BOXES = (CB + 63) / 64;
  static constexpr int TILE = kBox * BOXES;      // 64 rows of CB, and a ring stage
  // shared memory: alignment slack, u (and kdy) tiles, two g/dh tiles per
  // row tile, the ring, row statistics and row-sum parts (backward),
  // column-sum scratch (row pass), the cluster's exchange of partial h
  // (and dg), barriers. In a cluster the epilogue's row-sum parts and
  // column-sum scratch reuse the u tile, which no wgmma reads by then.
  static constexpr int KDY_BYTES = MODE == kFwd ? 0 : R * TILE;
  static constexpr int STATS_BYTES = MODE == kFwd ? 0 : 2 * BM * 4;
  static constexpr int PART_BYTES = MODE != kFwd && G > 1 && CL == 1 ? 2 * G * BM * 4 : 0;
  static constexpr int SCR_BYTES =
      MODE == kBwdRows ? (CL == 1 ? NWG * 32 * (N1 + CW) : NWG * 32 * N1 / CL) : 0;
  // a chunk's partials from the peer (h, and dg), and the peer's half of a g/dh tile
  static constexpr int XCH_BYTES = CL == 1 ? 0 : (MODE == kFwd ? 1 : 2) * 128 * NWG * NK * 4;
  static constexpr int GPEER_BYTES = 128 * NWG * NK / 2 * 4;
  static constexpr int FIXED = 1024 + R * TILE + KDY_BYTES + R * 2 * kBox + STATS_BYTES +
                               PART_BYTES + SCR_BYTES + XCH_BYTES + 256;
  static constexpr int S_FIT = (kSmemMax - FIXED) / TILE;
  static constexpr int S = cmin(cmin(8, 2 * NCH), S_FIT);  // ring stages
  static constexpr int SMEM = FIXED + S * TILE;
  static_assert(CP % 32 == 0 && CW % 32 == 0 && N1 % 32 == 0 && (4 * C) % BH == 0,
                "plan: widths");
  static_assert(CP == C || (CL > 1 && CP - C < CB && C % 8 == 0), "plan: padding");
  static_assert(S >= 2 && SMEM <= kSmemMax, "plan: shared memory");
  static_assert(128 * NWG * CREGS + 128 * kProducerRegs <= POOL, "plan: registers");
  static_assert(CL == 1 || (CL == 2 && R == 1 && NK % 4 == 0 && (CP / 32) % CL == 0 &&
                            (2 * G * 64 + 2 * 64 + NWG * 8 * CW) * 4 <= TILE),
                "plan: cluster");
};

// The block's shared memory under Plan P.
template <class P>
struct TailSmem {
  unsigned char* u;     // [R] K-major bf16 tiles of 64 rows x CB
  unsigned char* kdy;   // [R] the same for kdy (backward)
  unsigned char* g;     // [R][2] the g or dh16 chunk, 64 x 64
  unsigned char* ring;  // [S] weight chunks, 64 rows of CB
  float* mean;          // [BM] (backward)
  float* inv;           // [BM]
  float* part;          // [2][R][G][64] row-sum parts (backward, G > 1, no cluster)
  float* scr;           // [NWG][8 * N1 + 8 * CW] column-sum scratch (row pass; a
                        // cluster: [NWG][8 * N1 / CL], the rest in the u tile)
  float* xch;           // [1 or 2][NK / 4][128 NWG] float4: the peer's partial h (dg)
  uint64_t* full;       // [S]
  uint64_t* empty;      // [S]
  uint64_t* xfull;      // [1] the peer's partials have landed (cluster)
  uint64_t* gfull;      // [2] both blocks' halves of a g/dh tile are written (cluster)
  uint64_t* rsfull;     // [1] the peer's row sums have landed (cluster, backward)

  __device__ explicit TailSmem(unsigned char* raw) {
    unsigned char* p = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    u = p;     p += P::R * P::TILE;
    kdy = p;   p += P::KDY_BYTES;
    g = p;     p += P::R * 2 * kBox;
    ring = p;  p += P::S * P::TILE;
    mean = reinterpret_cast<float*>(p);
    inv = mean + P::BM;  p += P::STATS_BYTES;
    part = reinterpret_cast<float*>(p);  p += P::PART_BYTES;
    scr = reinterpret_cast<float*>(p);   p += P::SCR_BYTES;
    xch = reinterpret_cast<float*>(p);   p += P::XCH_BYTES;
    full = reinterpret_cast<uint64_t*>(p);
    empty = full + P::S;
    xfull = empty + P::S;
    gfull = xfull + 1;
    rsfull = gfull + 2;
  }
};

// byte offset of bf16 element (r, c) in a K-major tile of 64 rows as TMA
// lays it down with 128-byte swizzle: 64-column boxes, 128-byte rows, the
// 16-byte chunks of row r XOR-ed with r % 8
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 6) * kBox + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// k16 step kk of a K-major tile (A, or a B whose N rows start at `tile`)
__device__ __forceinline__ uint64_t kdesc(const unsigned char* tile, int kk) {
  return desc_kmajor(tile + (kk >> 2) * kBox + (kk & 3) * 32, 128);
}
// k16 step kk of a stage as an MN-major B: its rows 16 kk.., the columns
// from the box at `tile`
__device__ __forceinline__ uint64_t mndesc(const unsigned char* tile, int kk) {
  return desc_mnmajor(tile + kk * 2048, 128, kBox);
}

// the row and column (of a 64 x N product) of accumulator register d[i]
__device__ __forceinline__ int acc_row(int i) {
  const int t = threadIdx.x % 128;
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i / 4) + 2 * (threadIdx.x % 4) + i % 2;
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.0f;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

template <class P>
__device__ __forceinline__ void ring_wait(const TailSmem<P>& sm, int item) {
  mbar_wait(&sm.full[item % P::S], (item / P::S) & 1);
}
// this warp is done with the stage of `item` (its wgmma have completed)
template <class P>
__device__ __forceinline__ void ring_release(const TailSmem<P>& sm, int item) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(&sm.empty[item % P::S]);
}

// The ring's barriers and, in a cluster, the exchange's; a cluster's
// blocks start only when both have initialised theirs, since the peer
// arrives on them
template <class P>
__device__ void ring_init(const TailSmem<P>& sm) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < P::S; ++st) {
      mbar_init(&sm.full[st], 1);              // the producer's arrive with its bytes
      mbar_init(&sm.empty[st], 4 * P::NWG);    // one arrive per consumer warp
    }
    if constexpr (P::CL > 1) {
      mbar_init(sm.xfull, 1);                  // expect_peer, and the peer's bytes
      mbar_init(&sm.gfull[0], 4 * P::NWG);     // each consumer warp, and the peer's bytes
      mbar_init(&sm.gfull[1], 4 * P::NWG);
      mbar_init(sm.rsfull, 1);
    }
    mbar_fence_init();
  }
  if constexpr (P::CL > 1)
    cluster_sync();
  else
    __syncthreads();
}

// Registers per thread: the producer warpgroup keeps kProducerRegs and
// gives the rest to the consumer warpgroups (Plan::CREGS: 240 for two, 160
// for three, 112 for four); an even split of 384 threads leaves 168, and
// the backward's accumulators (du, h and dg: 160 registers at C = 192)
// spilled there.
// The producer warpgroup: its first thread loads item i into ring stage i %
// S, columns col0.. (the block's CB) of a chunk of map `first` or `second`:
// with LEAD = 0 chunk i / 2 of `first` (i even) or `second` (i odd); with
// LEAD = 1 `first` runs one chunk ahead: chunk 0 of `first`, then chunk c +
// 1 of `first` and chunk c of `second` in turn, then the last of `second`.
template <class P, int LEAD = 0>
__device__ void produce(const TailSmem<P>& sm, const CUtensorMap* first,
                        const CUtensorMap* second, int col0) {
  setmaxnreg_dec<kProducerRegs>();
  if (threadIdx.x != 128 * P::NWG) return;
  for (int i = 0; i < 2 * P::NCH; ++i) {
    const int st = i % P::S;
    if (i >= P::S) mbar_wait(&sm.empty[st], (i / P::S - 1) & 1);
    unsigned char* dst = sm.ring + st * P::TILE;
    bool of_first = i % 2 == 0;
    int chunk = i / 2;
    if constexpr (LEAD == 1) {
      of_first = i == 0 || (i % 2 == 1 && i < 2 * P::NCH - 1);
      chunk = i == 0 ? 0 : (i == 2 * P::NCH - 1 ? P::NCH - 1 : (of_first ? (i + 1) / 2 : i / 2 - 1));
    }
    const CUtensorMap* map = of_first ? first : second;
    mbar_arrive_expect_tx(&sm.full[st], P::TILE);
#pragma unroll
    for (int b = 0; b < P::BOXES; ++b)
      tma_load_2d(dst + b * kBox, map, &sm.full[st], col0 + 64 * b, 64 * chunk);
  }
}

// the block's rank in its cluster (0 for a block alone)
template <class P>
__device__ __forceinline__ uint32_t block_rank() {
  if constexpr (P::CL > 1)
    return cluster_rank();
  else
    return 0;
}

// The end of a block: in a cluster, every thread of both blocks, so that
// no block exits while its peer may still reach its shared memory.
template <class P>
__device__ __forceinline__ void block_end() {
  if constexpr (P::CL > 1) cluster_sync();
}

// The cluster's exchange of a product that contracts over C (h = u W1c,
// dg = kdy w2g_c^T): a block holds its partial over its CB columns of C for
// the whole chunk, a thread N1 / 2 registers (d), and finalises NK of them:
// rank r the registers [NK r, NK (r + 1)), chunk columns cg N1 + N1 / 2 r
// .. + N1 / 2. The thread of the same index in the peer holds the same
// rows and columns, so each thread sends the peer the half it finalises
// into the peer's exchange slot `part` (0: h, 1: dg), its bytes completing
// on the peer's xfull, and adds the half it receives to its own: a + b,
// two terms, in every launch the same bits.
template <class P>
__device__ __forceinline__ void xch_send(const TailSmem<P>& sm, const float (&d)[P::N1 / 2],
                                         int part, uint32_t rank) {
  const uint32_t base = map_rank(sm.xch + part * (P::NK * 128 * P::NWG), rank ^ 1);
  const uint32_t bar = map_rank(sm.xfull, rank ^ 1);
#pragma unroll
  for (int q = 0; q < P::NK / 4; ++q) {
    // what the peer finalises (selects: a register array takes no run-time index)
    const int lo = 4 * q, hi = P::NK + 4 * q;
    st_async(base + (q * 128 * P::NWG + threadIdx.x) * 16,
             rank ? make_float4(d[lo], d[lo + 1], d[lo + 2], d[lo + 3])
                  : make_float4(d[hi], d[hi + 1], d[hi + 2], d[hi + 3]),
             bar);
  }
}
template <class P>
__device__ __forceinline__ void xch_add(const TailSmem<P>& sm, const float (&d)[P::N1 / 2],
                                        int part, uint32_t rank, float (&out)[P::NK]) {
  const float4* src = reinterpret_cast<const float4*>(sm.xch + part * (P::NK * 128 * P::NWG));
#pragma unroll
  for (int q = 0; q < P::NK / 4; ++q) {
    const float4 v = src[q * 128 * P::NWG + threadIdx.x];
    const int lo = 4 * q, hi = P::NK + 4 * q;  // what this block finalises: hi in rank 1
    out[4 * q] = (rank ? d[hi] : d[lo]) + v.x;
    out[4 * q + 1] = (rank ? d[hi + 1] : d[lo + 1]) + v.y;
    out[4 * q + 2] = (rank ? d[hi + 2] : d[lo + 2]) + v.z;
    out[4 * q + 3] = (rank ? d[hi + 3] : d[lo + 3]) + v.w;
  }
}
// This block's barrier `bar` (count 1) is to take `bytes` from the peer:
// one consumer thread arrives, expecting them, and the phase completes
// once they have landed, whichever comes first. (An arrive on the peer's
// barrier with release at cluster scope instead waits for the thread's
// remote stores to be acknowledged, twice a chunk.)
__device__ __forceinline__ void expect_peer(uint64_t* bar, uint32_t bytes) {
  if (threadIdx.x == 0) mbar_arrive_expect_tx(bar, bytes);
}
// this warp's part of this block's half of a g/dh tile is written: one
// arrive on this block's `bar`, warp 0's also expecting the peer's half
// (its st.async bytes)
template <class P>
__device__ __forceinline__ void arrive_tile(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x == 0)
    mbar_arrive_expect_tx(bar, P::GPEER_BYTES);
  else if (threadIdx.x % 32 == 0)
    mbar_arrive(bar);
}

// LayerNorm of the row tile's 64 rows (row0..) into the swizzled bf16 tile
// u, split over the tile's 4 G warps, whole rows a warp; rows past M become
// 0. The backward also forms kdy = bf16(keep * dy) and keeps mean and inv.
// A warp loads a batch of its rows before it reduces any: one row at a time
// would wait out a round trip to HBM per row. In a cluster each block
// reads whole rows of s, so both hold the same statistics, bit for bit, and
// keeps its CB columns (rank r: c - CB r) of u, and of kdy. At a padded
// width a pad column's load reads the row's last channel and is dropped,
// the pad is written 0 into u and kdy, and the statistics are those of the
// C channels.
template <int C, class P, typename T, bool BWD>
__device__ void ln_rows(const T* __restrict__ s, const float* __restrict__ ln_g,
                        const float* __restrict__ ln_b, const T* __restrict__ dy,
                        const float* __restrict__ keep, int rows_per_keep, int64_t row0, int64_t M,
                        int cg, uint32_t rank, unsigned char* u, unsigned char* kdy, float* mean,
                        float* inv) {
  constexpr int VPL = P::CP / 32;     // values per lane in a row (padded)
  constexpr int VPB = VPL / P::CL;    // of them in the block's columns
  constexpr int NR = 16 / P::G;       // rows per warp
  constexpr int BATCH = 48 / VPL >= NR ? NR : (48 / VPL >= 8 ? 8 : 4);  // rows loaded at once
  static_assert(NR % BATCH == 0, "ln_rows: batches");
  const int lane = threadIdx.x % 32, wt = cg * 4 + (threadIdx.x / 32) % 4;
  const int c0 = P::CB * rank;
  for (int k0 = 0; k0 < NR; k0 += BATCH) {
    float v[BATCH][VPL], dv[BWD ? BATCH : 1][VPB];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int64_t row = row0 + wt + 4 * P::G * (k0 + k);
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = lane + 32 * i;
        const float x = row < M ? to_f32(s[row * C + clamp_c<C>(c)]) : 0.0f;
        v[k][i] = in_c<C>(c) ? x : 0.0f;
      }
      if constexpr (BWD) {
#pragma unroll
        for (int i = 0; i < VPB; ++i) {
          const int c = c0 + lane + 32 * i;
          const float x = row < M ? to_f32(dy[row * C + clamp_c<C>(c)]) : 0.0f;
          dv[k][i] = in_c<C>(c) ? x : 0.0f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int rr = wt + 4 * P::G * (k0 + k);
      const int64_t row = row0 + rr;
      const bool live = row < M;
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) sum += v[k][i];
      const float mu = warp_sum(sum) / C;
      float sq = 0.0f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const float d = in_c<C>(lane + 32 * i) ? v[k][i] - mu : 0.0f;
        sq += d * d;
      }
      const float iv = rsqrtf(warp_sum(sq) / C + kEps);
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = lane + 32 * i;
        if (P::CL == 1 || i / VPB == static_cast<int>(rank)) {
          const float un = (v[k][i] - mu) * iv * ln_g[clamp_c<C>(c)] + ln_b[clamp_c<C>(c)];
          *reinterpret_cast<bf16*>(u + swz(rr, c - c0)) =
              __float2bfloat16(live && in_c<C>(c) ? un : 0.0f);
        }
      }
      if constexpr (BWD) {
        const float kp = live ? keep_of(keep, rows_per_keep, row) : 0.0f;
#pragma unroll
        for (int i = 0; i < VPB; ++i)
          *reinterpret_cast<bf16*>(kdy + swz(rr, lane + 32 * i)) = __float2bfloat16(kp * dv[k][i]);
        if (lane == 0) {
          mean[rr] = live ? mu : 0.0f;
          inv[rr] = live ? iv : 0.0f;
        }
      }
    }
  }
}

// Backward of the tail (kWgmma widths): ds from dy, with w2g = bf16(W2 *
// gamma), over BM rows a block (a cluster: 64 rows, CB columns a block).
// FULL = false is the input-only backward (_bwd_input_kernel); FULL = true
// is the full backward's row pass (_bwd_kernel): the same ds, bit for bit,
// plus the side outputs of FullOut, column sums per 64-row tile, each
// written by the block that finalises its columns. Ring items: chunk j of
// w2g (2 j) and of W1^T (2 j + 1).
template <int C, typename T, bool FULL>
__global__ void __launch_bounds__(Plan<C, FULL ? kBwdRows : kBwdInput>::THREADS, 1)
bwd_kernel(const __grid_constant__ CUtensorMap w1t_map, const __grid_constant__ CUtensorMap w2g_map,
           const T* __restrict__ s, const float* __restrict__ keep, int rows_per_keep,
           const float* __restrict__ ln_g, const float* __restrict__ ln_b,
           const float* __restrict__ b1, const T* __restrict__ dy, T* __restrict__ ds, int64_t M,
           FullOut out) {
  using P = Plan<C, FULL ? kBwdRows : kBwdInput>;
  extern __shared__ unsigned char smem_raw[];
  const TailSmem<P> sm(smem_raw);
  const uint32_t rank = block_rank<P>();
  const int c0 = P::CB * rank;  // the block's first column of C
  ring_init(sm);
  if (threadIdx.x >= 128 * P::NWG) {
    produce<P>(sm, &w2g_map, &w1t_map, c0);
    block_end<P>();
    return;
  }
  setmaxnreg_inc<P::CREGS>();
  // the warpgroup, uniform to the compiler (a shuffle from lane 0), so that
  // ptxas keeps the wgmma pipeline
  const int w = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  const int rt = w / P::G, cg = w % P::G;
  const int wq = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int tile_idx = blockIdx.x / P::CL * P::R + rt;  // this row tile's partial-sum row
  const int64_t row0 = static_cast<int64_t>(tile_idx) * 64;
  const int bar = 1 + rt, bar_n = 128 * P::G;
  unsigned char* u = sm.u + rt * P::TILE;
  unsigned char* kdy = sm.kdy + rt * P::TILE;
  unsigned char* dht = sm.g + rt * 2 * kBox;
  float* mean = sm.mean + 64 * rt;
  float* inv = sm.inv + 64 * rt;
  float* scr = P::CL == 1 ? sm.scr + w * (8 * P::N1 + 8 * P::CW) : sm.scr + w * (8 * P::N1 / P::CL);

  ln_rows<C, P, T, true>(s, ln_g, ln_b, dy, keep, rows_per_keep, row0, M, cg, rank, u, kdy, mean,
                         inv);
  fence_proxy_async();
  named_bar_sync(bar, bar_n);
  if constexpr (FULL) {
    // u16 and kdy16 are the weight pass's operands: 16-byte chunks of the
    // tiles' rows
    for (int i = threadIdx.x % bar_n; i < 64 * (P::CB / 8); i += bar_n) {
      const int r = i / (P::CB / 8), c = (i % (P::CB / 8)) * 8;
      if (!in_c<C>(c0 + c)) continue;  // the pad (C is a multiple of 8)
      const size_t gi = static_cast<size_t>(row0 + r) * C + c0 + c;
      *reinterpret_cast<uint4*>(out.u16 + gi) = *reinterpret_cast<const uint4*>(u + swz(r, c));
      *reinterpret_cast<uint4*>(out.kdy16 + gi) = *reinterpret_cast<const uint4*>(kdy + swz(r, c));
    }
  }

  float acc[P::CW / 2];
  zero(acc);
  for (int j = 0; j < P::NCH; ++j) {
    const int ib = 2 * j, ia = 2 * j + 1;
    float h[P::N1 / 2], dg[P::N1 / 2];
    zero(h);
    zero(dg);
    fence_acc(h);
    fence_acc(dg);
    wgmma_fence();
    ring_wait(sm, ib);
    const unsigned char* wb = sm.ring + (ib % P::S) * P::TILE + cg * P::N1 * 128;
#pragma unroll
    for (int kk = 0; kk < P::CB / 16; ++kk) wgmma_ss<P::N1, 0>(dg, kdesc(kdy, kk), kdesc(wb, kk));
    wgmma_commit();
    ring_wait(sm, ia);
    const unsigned char* wa = sm.ring + (ia % P::S) * P::TILE;
#pragma unroll
    for (int kk = 0; kk < P::CB / 16; ++kk)
      wgmma_ss<P::N1, 0>(h, kdesc(u, kk), kdesc(wa + cg * P::N1 * 128, kk));
    wgmma_commit();
    wgmma_wait<0>();  // dg, h and the previous chunk's du
    fence_acc(h);
    fence_acc(dg);
    fence_acc(acc);
    ring_release(sm, ib);
    if (P::S > 2 && j > 0) ring_release(sm, ia - 2);

    unsigned char* dh_s = dht + (j & 1) * kBox;
    if constexpr (P::CL == 1) {
      // dh = dg * gelu'(h + b1) in place of dg; its bf16 tile for du
#pragma unroll
      for (int i = 0; i < P::N1 / 2; i += 2) {
        const int c = cg * P::N1 + acc_col(i);
        const float2 bb = load2(b1 + 64 * j + c);
        float g0, g1, d0, d1;
        gelu_and_dgelu_tanh(h[i] + bb.x, g0, d0);
        gelu_and_dgelu_tanh(h[i + 1] + bb.y, g1, d1);
        dg[i] *= d0;
        dg[i + 1] *= d1;
        const uint32_t dhp = pack_bf16(dg[i], dg[i + 1]);
        *reinterpret_cast<uint32_t*>(dh_s + swz(acc_row(i), c)) = dhp;
        if constexpr (FULL) {
          const int64_t row = row0 + acc_row(i);
          const bool live = row < M;
          const size_t gi = static_cast<size_t>(row) * (4 * C) + 64 * j + c;
          *reinterpret_cast<uint32_t*>(out.g16 + gi) = live ? pack_bf16(g0, g1) : 0u;
          *reinterpret_cast<uint32_t*>(out.dh16 + gi) = live ? dhp : 0u;
        }
      }
      if constexpr (FULL) {
        // db1: the f32 dh summed over this warp's two rows a lane, its 8 row
        // lanes, then (after the barrier) its warpgroup's 4 warps, in order
        float* s1 = scr + (j & 1) * 4 * P::N1;
#pragma unroll
        for (int q = 0; q < P::N1 / 8; ++q) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = dg[4 * q + e] + dg[4 * q + 2 + e];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (lane < 4) s1[wq * P::N1 + 8 * q + 2 * lane + e] = v;
          }
        }
      }
      fence_proxy_async();
      named_bar_sync(bar, bar_n);
      if constexpr (FULL) {
        const float* s1 = scr + (j & 1) * 4 * P::N1;
        const int t = threadIdx.x % 128;
        if (t < P::N1)
          out.db1_part[static_cast<size_t>(tile_idx) * (4 * C) + 64 * j + cg * P::N1 + t] =
              s1[t] + s1[P::N1 + t] + s1[2 * P::N1 + t] + s1[3 * P::N1 + t];
      }
    } else {
      // the cluster: h and dg summed over both blocks' halves of C for the
      // chunk columns this block finalises (NK registers a thread, columns
      // cg N1 + N1 / 2 rank ..); dh = dg * gelu'(h + b1) into both blocks'
      // dh tiles
      xch_send(sm, h, 0, rank);
      xch_send(sm, dg, 1, rank);
      float hs[P::NK], dgs[P::NK];
      expect_peer(sm.xfull, P::XCH_BYTES);
      mbar_wait_cluster(sm.xfull, j & 1);
      xch_add(sm, h, 0, rank, hs);
      xch_add(sm, dg, 1, rank, dgs);
      const uint32_t dh_peer = map_rank(dh_s, rank ^ 1);
      const uint32_t dh_bar = map_rank(&sm.gfull[j & 1], rank ^ 1);
#pragma unroll
      for (int i = 0; i < P::NK; i += 2) {
        const int c = cg * P::N1 + P::N1 / 2 * rank + acc_col(i);
        const float2 bb = load2(b1 + 64 * j + c);
        float g0, g1, d0, d1;
        gelu_and_dgelu_tanh(hs[i] + bb.x, g0, d0);
        gelu_and_dgelu_tanh(hs[i + 1] + bb.y, g1, d1);
        dgs[i] *= d0;
        dgs[i + 1] *= d1;
        const uint32_t dhp = pack_bf16(dgs[i], dgs[i + 1]);
        const uint32_t off = swz(acc_row(i), c);
        *reinterpret_cast<uint32_t*>(dh_s + off) = dhp;
        st_async(dh_peer + off, dhp, dh_bar);
        if constexpr (FULL) {
          const int64_t row = row0 + acc_row(i);
          const bool live = row < M;
          const size_t gi = static_cast<size_t>(row) * (4 * C) + 64 * j + c;
          *reinterpret_cast<uint32_t*>(out.g16 + gi) = live ? pack_bf16(g0, g1) : 0u;
          *reinterpret_cast<uint32_t*>(out.dh16 + gi) = live ? dhp : 0u;
        }
      }
      constexpr int NF = P::N1 / P::CL;  // chunk columns a warpgroup finalises
      if constexpr (FULL) {
        // db1 of this block's columns, summed as above
        float* s1 = scr + (j & 1) * 4 * NF;
#pragma unroll
        for (int q = 0; q < P::NK / 4; ++q) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = dgs[4 * q + e] + dgs[4 * q + 2 + e];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (lane < 4) s1[wq * NF + 8 * q + 2 * lane + e] = v;
          }
        }
      }
      // a proxy fence after this thread's writes to its own tile, and one
      // after the wait for the peer's writes, before the wgmma reads them
      fence_proxy_async();
      arrive_tile<P>(&sm.gfull[j & 1]);
      mbar_wait_cluster(&sm.gfull[j & 1], (j >> 1) & 1);
      fence_proxy_async();
      if constexpr (FULL) {
        const float* s1 = scr + (j & 1) * 4 * NF;
        const int t = threadIdx.x % 128;
        if (t < NF)
          out.db1_part[static_cast<size_t>(tile_idx) * (4 * C) + 64 * j + cg * P::N1 + NF * rank +
                       t] = s1[t] + s1[NF + t] + s1[2 * NF + t] + s1[3 * NF + t];
      }
    }
    // du += dh16 @ W1c: the W1^T stage as an MN-major B, this warpgroup's columns
    const unsigned char* wc = wa + (cg * P::CW / 64) * kBox;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<P::CW, 1>(acc, kdesc(dh_s, kk), mndesc(wc, kk));
    wgmma_commit();
    if constexpr (P::S == 2) {  // the next W1^T chunk needs this stage
      wgmma_wait<0>();
      fence_acc(acc);
      ring_release(sm, ia);
    }
  }
  if constexpr (P::S > 2) {
    wgmma_wait<0>();
    fence_acc(acc);
    ring_release(sm, 2 * P::NCH - 1);
  }

  // LayerNorm backward: ds = inv * (dxh - mean(dxh) - xhat * mean(dxh * xhat)),
  // dxh = du * ln_g. A thread holds rows lo = acc_row(0) and lo + 8 of the
  // tile; the row sums go over its values, its quad, then the row tile's
  // warpgroups in order, then (a cluster) the two blocks' sums.
  const int rlo = acc_row(0);
  float p1[2] = {0.0f, 0.0f}, p2[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < P::CW / 2; i += 2) {
    const int hi = (i / 2) % 2, rr = rlo + 8 * hi;
    const int64_t row = row0 + rr;
    const int col = c0 + cg * P::CW + acc_col(i);
    const int cc = clamp_c<C, 2>(col);  // a pad pair (C is even) adds no term
    const bool in = in_c<C>(col);
    const float2 x = row < M ? load2(s + row * C + cc) : make_float2(0.0f, 0.0f);
    const float2 lg = load2(ln_g + cc);
    const float x0 = row < M ? (x.x - mean[rr]) * inv[rr] : 0.0f;
    const float x1 = row < M ? (x.y - mean[rr]) * inv[rr] : 0.0f;
    const float dxh0 = in ? acc[i] * lg.x : 0.0f, dxh1 = in ? acc[i + 1] * lg.y : 0.0f;
    p1[hi] += dxh0;
    p1[hi] += dxh1;
    p2[hi] += dxh0 * x0;
    p2[hi] += dxh1 * x1;
  }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      p1[hi] += __shfl_xor_sync(0xffffffffu, p1[hi], o);
      p2[hi] += __shfl_xor_sync(0xffffffffu, p2[hi], o);
    }
  }
  // a cluster's epilogue scratch in the u tile: the row-sum parts [2][G][64],
  // the peer's row sums [2][64], the column-sum scratch [NWG][8 CW]
  float* epi = reinterpret_cast<float*>(sm.u);
  if constexpr (P::G > 1) {
    float* part1 = (P::CL == 1 ? sm.part : epi) + 64 * rt * P::G;  // [R][G][64], then part2 alike
    float* part2 = part1 + P::G * P::BM;
    if (lane % 4 == 0) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        part1[cg * 64 + rlo + 8 * hi] = p1[hi];
        part2[cg * 64 + rlo + 8 * hi] = p2[hi];
      }
    }
    named_bar_sync(bar, bar_n);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float a = part1[rlo + 8 * hi], b = part2[rlo + 8 * hi];
#pragma unroll
      for (int k = 1; k < P::G; ++k) {
        a += part1[k * 64 + rlo + 8 * hi];
        b += part2[k * 64 + rlo + 8 * hi];
      }
      p1[hi] = a;
      p2[hi] = b;
    }
  }
  if constexpr (P::CL > 1) {
    // the two blocks' row sums: a + b, the same bits in both blocks
    float* peer_rs = epi + 2 * P::G * 64;  // [2][64], written by the peer
    if (cg == 0 && lane % 4 == 0) {
      const uint32_t dst = map_rank(peer_rs, rank ^ 1), bar = map_rank(sm.rsfull, rank ^ 1);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        st_async(dst + (rlo + 8 * hi) * 4, p1[hi], bar);
        st_async(dst + (64 + rlo + 8 * hi) * 4, p2[hi], bar);
      }
    }
    expect_peer(sm.rsfull, 2 * 64 * 4);
    mbar_wait_cluster(sm.rsfull, 0);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      p1[hi] += peer_rs[rlo + 8 * hi];
      p2[hi] += peer_rs[64 + rlo + 8 * hi];
    }
  }
  float* s2 = P::CL == 1 ? scr + 8 * P::N1  // [2][4 warps][CW]: du * xhat, du (row pass)
                         : epi + 2 * P::G * 64 + 2 * 64 + w * 8 * P::CW;
#pragma unroll
  for (int q = 0; q < P::CW / 8; ++q) {
    float cgx[2] = {0.0f, 0.0f}, cgb[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int i = 4 * q + 2 * hi, rr = rlo + 8 * hi;
      const int64_t row = row0 + rr;
      const int col = c0 + cg * P::CW + acc_col(i);
      if (row < M && in_c<C>(col)) {
        const float2 x = load2(s + row * C + col);
        const float2 lg = load2(ln_g + col);
        const float x0 = (x.x - mean[rr]) * inv[rr], x1 = (x.y - mean[rr]) * inv[rr];
        const float m1 = p1[hi] / C, m2 = p2[hi] / C;
        const float dxh0 = acc[i] * lg.x, dxh1 = acc[i + 1] * lg.y;
        store2(ds + row * C + col, inv[rr] * (dxh0 - m1 - x0 * m2),
               inv[rr] * (dxh1 - m1 - x1 * m2));
        if constexpr (FULL) {
          cgx[0] += acc[i] * x0;
          cgx[1] += acc[i + 1] * x1;
          cgb[0] += acc[i];
          cgb[1] += acc[i + 1];
        }
      }
    }
    if constexpr (FULL) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          cgx[e] += __shfl_xor_sync(0xffffffffu, cgx[e], o);
          cgb[e] += __shfl_xor_sync(0xffffffffu, cgb[e], o);
        }
        if (lane < 4) {
          s2[wq * P::CW + 8 * q + 2 * lane + e] = cgx[e];
          s2[(4 + wq) * P::CW + 8 * q + 2 * lane + e] = cgb[e];
        }
      }
    }
  }
  if constexpr (FULL) {
    named_bar_sync(1 + P::R + w, 128);
    for (int t = threadIdx.x % 128; t < P::CW; t += 128) {
      if (!in_c<C>(c0 + cg * P::CW + t)) break;  // the pad
      const size_t gi = static_cast<size_t>(tile_idx) * C + c0 + cg * P::CW + t;
      out.dlng_part[gi] = s2[t] + s2[P::CW + t] + s2[2 * P::CW + t] + s2[3 * P::CW + t];
      out.dlnb_part[gi] =
          s2[4 * P::CW + t] + s2[5 * P::CW + t] + s2[6 * P::CW + t] + s2[7 * P::CW + t];
    }
  }
  block_end<P>();
}

// a row-major bf16 [rows, cols] matrix in 64 x 64 boxes, 128-byte swizzle;
// boxes reaching past cols are zero-filled
inline bool make_map(CUtensorMap* map, const void* base, int64_t rows, int cols) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The plan the wrapper passes (ops/block_mlp.py tail_plan): rows per
// block, chunk width, threads, output column split, shared-memory bytes,
// blocks per cluster, the padded width tiled.
struct PlanArgs {
  int rows, chunk, threads, split, smem, cluster, padded;
};

template <int C, int MODE>
bool plan_ok(const PlanArgs& a) {
  if constexpr (kWgmma<C>) {
    using P = Plan<C, MODE>;
    return a.rows == P::BM && a.chunk == P::BH && a.threads == P::THREADS && a.split == P::G &&
           a.smem == P::SMEM && a.cluster == P::CL && a.padded == P::CP;
  } else {
    using K = Cfg<C>;
    const size_t smem = MODE == kFwd ? fwd_smem_bytes<C>() : bwd_smem_bytes<C>();
    return a.rows == K::BM && a.chunk == K::BH && a.threads == K::NTHREADS && a.split == K::NW &&
           static_cast<size_t>(a.smem) == smem && a.cluster == 1 && a.padded == C;
  }
}

// Launch a wgmma kernel of plan P over `rows` rows: a block per BM rows, or
// at kCluster > 1 a cluster of CL blocks per 64-row tile (cudaLaunchKernelEx
// with the cluster dimension). Returns cudaGetLastError(), or -3 when the
// card cannot hold one such cluster at a time (asked once per kernel).
template <class P, typename... Params, typename... Args>
int launch_plan(void (*kern)(Params...), int64_t rows, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = static_cast<unsigned>((rows + P::BM - 1) / P::BM);
  if constexpr (P::CL == 1) {
    kern<<<tiles, P::THREADS, P::SMEM, stream>>>(args...);
    return static_cast<int>(cudaGetLastError());
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(tiles * P::CL);
    cfg.blockDim = dim3(P::THREADS);
    cfg.dynamicSmemBytes = P::SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = P::CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    static int clusters = -1;  // that the card holds at a time
    if (clusters < 0) {
      int n = 0;
      err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
      if (err != cudaSuccess) return static_cast<int>(err);
      clusters = n;
    }
    if (clusters == 0) return -3;
    err = cudaLaunchKernelEx(&cfg, kern, args...);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
}

template <int C, typename T, bool FULL>
int launch_bwd_wgmma(const void* s, const float* keep, int rows_per_keep, const float* ln_g,
                     const float* ln_b, const bf16* w1t, const float* b1, const bf16* w2g,
                     const void* dy, void* ds, int64_t M, int64_t rows, FullOut out,
                     cudaStream_t stream) {
  using P = Plan<C, FULL ? kBwdRows : kBwdInput>;
  CUtensorMap a, b;
  if (!make_map(&a, w1t, 4 * C, C) || !make_map(&b, w2g, 4 * C, C)) return -2;
  return launch_plan<P>(bwd_kernel<C, T, FULL>, rows, stream, a, b, static_cast<const T*>(s), keep,
                        rows_per_keep, ln_g, ln_b, b1, static_cast<const T*>(dy),
                        static_cast<T*>(ds), M, out);
}

// The backward at width C in the design built for it: w1 is W1^T [4C, C]
// for the kWgmma widths, W1 [C, 4C] for the others.
template <int C, typename T, bool FULL>
int launch_bwd(const PlanArgs& plan, const void* s, const float* keep, int rows_per_keep,
               const float* ln_g, const float* ln_b, const bf16* w1, const float* b1,
               const bf16* w2g, const void* dy, void* ds, int64_t M, int64_t rows, FullOut out,
               cudaStream_t stream) {
  if (!plan_ok<C, FULL ? kBwdRows : kBwdInput>(plan)) return -1;
  if constexpr (kWgmma<C>)
    return launch_bwd_wgmma<C, T, FULL>(s, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2g, dy, ds,
                                        M, rows, out, stream);
  else
    return launch_bwd_wmma<C, T, FULL>(s, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2g, dy, ds,
                                       M, rows, out, stream);
}

}  // namespace

// Channel widths built: every ConvNeXt stage width the gates admit
// (T/S: 96-768, B: 128-1024, L: 192-768), convnext_iso's 432, and the micro
// models' 16, 32, 64 (convnext_micro's stages 0-2, vit_micro's width 32).
#define BLOCK_MLP_WIDTHS(X) X(16) X(32) X(64) X(96) X(128) X(192) X(256) X(384) X(432) X(512) X(768) X(1024)
