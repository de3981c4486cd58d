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
// block, more than the L2 can feed at the tensor-core rate). The port's
// first design (synchronous 16x16 WMMA with weight fragments loaded
// straight from L2, every chunk serialised through f32 shared memory and
// two __syncthreads) ran at 5-7% of the bf16 peak. Every width built now
// takes the one design below; only its tiling (`Plan`) differs by width.
//
// The design:
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
// Padded widths (`kPadded`): the tiling takes whole 64-column boxes and
// 32-column accumulator slices in every block. The micro models' C = 16 and
// 32 are tiled as 64, convnext_iso's C = 432 (13.5 x 32) as 512; the other
// widths as themselves. The pad is zero wherever a product contracts over
// it: u and kdy are written 0 there, the weight boxes are zero-filled by
// TMA past column C (a box that lies wholly past it is all zero), so h and
// dg are those of C columns and the pad columns of o and du are 0. The
// LayerNorm statistics divide by C, no load or store reaches past column C
// of a row (a pad column's load is clamped to the last channel and
// dropped), and no row sum or column sum takes a pad column. Padding costs
// 18.5% more tensor work than 432 needs; at C = 16 and 32 the products are
// tiny, and 4C is one or two chunks (a ring of two or four stages).
//
// Thread-block clusters (`kCluster`): at C = 432, 512 and 768 a 64-row
// tile's u and kdy tiles (192 KB at C = 768), a 64-row weight chunk (96 KB)
// and a [64, C] f32 accumulator (384 registers a thread of a warpgroup) do
// not fit one block, and at 432 and 512 one block has room for the
// forward's ring but not for the backward's; at C = 1024 half of C still
// leaves the backward one ring stage. So a cluster of CL blocks takes each
// tile (two at 432, 512 and 768, four at 1024), block rank r holding columns
// [CB r, CB r + CB) of the padded width, CB = CP / CL = 256 (384 at 768): its
// part of u and kdy, of every ring stage (the K part of a W1^T or w2g chunk,
// the column part of a W2 chunk), of o or du; each block is tiled as C = CB
// (two consumer warpgroups of CB / 2 accumulator columns, a producer
// warpgroup).
//   * h = u W1c and dg = kdy w2g_c^T contract over C, so a block forms a
//     partial over its CB columns. The thread of the same index in every
//     other block holds the same rows and columns: each thread sends each
//     peer the NK = N1 / 2 / CL registers that the peer finalises (of h, and
//     of dg) into a slot of the peer's shared memory kept for this sender,
//     by st.async, whose bytes complete on the peer's mbarrier (no thread
//     waits for a remote store to be acknowledged, as a release arrive on
//     the peer's barrier would). Every block adds the CL partials of its
//     columns in rank order, ((p0 + p1) + p2) + p3, its own in its rank's
//     place: the same bits in every launch, and in the row pass as in the
//     input backward.
//   * Each block applies b1 and GELU (gelu') to its N1 / CL of a warpgroup's
//     chunk columns and writes the bf16 g (dh16) into its own g tile and, by
//     st.async, every peer's; a tile's mbarrier counts this block's warps and
//     the peers' bytes before o (du) reads it. o and du have the block's own
//     columns as N: no exchange.
//   * LayerNorm: each block reads whole rows of s, so all hold the same
//     statistics; the backward's row sums m1, m2 cross the cluster once,
//     added in rank order in every block. Each block writes y or ds, and
//     the row pass's side outputs, for the columns it owns: the row pass's
//     ds stays bit for bit the input backward's.
//   * The forward is software-pipelined by one chunk (the next chunk's h
//     runs while this chunk's partial crosses the cluster and its GELU
//     runs; the producer keeps W1^T a chunk ahead of W2). The backward is
//     not: at C = 768 its two ring stages hold one chunk of w2g and of
//     W1^T, and no more (three stages at 1024, four at 432 and 512).
//   * Launched with cudaLaunchKernelEx and a cluster dimension of CL; the
//     mbarriers of every block are initialised before any block arrives on
//     another's (a cluster barrier), and every thread of every block meets
//     at a cluster barrier at the end, so that no block exits while a peer
//     may still reach its shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr float kK0 = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float kK1 = 0.044715f;
constexpr float kEps = 1e-6f;

// Rows of the full backward's side buffers are padded to a multiple of this
// (a multiple of every block's rows and of the weight kernel's depth step).
constexpr int kRowPad = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_tanh(float h) {
  float t = tanhf(kK0 * (h + kK1 * h * h * h));
  return 0.5f * h * (1.0f + t);
}

// gelu(h) and gelu'(h) from one tanh, gelu by the formula above.
__device__ __forceinline__ void gelu_and_dgelu_tanh(float h, float& g, float& dg) {
  float t = tanhf(kK0 * (h + kK1 * h * h * h));
  float dinner = kK0 * (1.0f + 3.0f * kK1 * h * h);
  g = 0.5f * h * (1.0f + t);
  dg = 0.5f * (1.0f + t) + 0.5f * h * (1.0f - t * t) * dinner;
}

__device__ __forceinline__ float keep_of(const float* keep, int rows_per_keep, int64_t row) {
  return keep ? keep[row / rows_per_keep] : 1.0f;
}

// Side outputs of the full backward's row pass (FULL = true); unused otherwise.
struct FullOut {
  bf16* u16;        // [Mpad, C]  bf16(LN(s)), 0 past M
  bf16* kdy16;      // [Mpad, C]  bf16(keep * dy), 0 past M
  bf16* g16;        // [Mpad, 4C] bf16(gelu(h)), 0 past M
  bf16* dh16;       // [Mpad, 4C] bf16(dh), 0 past M
  // column sums over each 64-row tile (the plan's `part_rows`), in row order
  float* db1_part;  // [Mpad / part_rows, 4C] of the f32 dh
  float* dlng_part; // [Mpad / part_rows, C]  of du * xhat
  float* dlnb_part; // [Mpad / part_rows, C]  of du
};

// ------------------------------------------------------------- the plans

// The widths the TMA + wgmma kernels are built for: every width built
// (BLOCK_MLP_WIDTHS); a Plan of any other width does not compile.
template <int C>
constexpr bool kWgmma = C == 16 || C == 32 || C == 64 || C == 96 || C == 128 || C == 192 || C == 256 || C == 384 || C == 432 || C == 512 || C == 768 || C == 1024;

// Blocks of a thread-block cluster that share each 64-row tile, block rank
// r holding columns [CP / kCluster r, + CP / kCluster) of the padded width
// CP (1: a block alone).
template <int C>
constexpr int kCluster = C == 1024 ? 4 : (C == 432 || C == 512 || C == 768 ? 2 : 1);

// The width the kernels tile: C, or C rounded up to whole 64-column boxes
// in every block of a cluster where C is below 64 (16, 32) or not a
// multiple of 32 (432). Columns past C are pad: zero in every operand a
// product contracts over, never loaded from or stored to memory.
template <int C>
constexpr int kPadded = C < 64 || C % 32 != 0 ? (C + 64 * kCluster<C> - 1) / (64 * kCluster<C>) * (64 * kCluster<C>) : C;

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
  // a chunk's partials from the CL - 1 peers (h, and dg), and the peers'
  // parts of a g/dh tile
  static constexpr int XCH_BYTES = (MODE == kFwd ? 1 : 2) * (CL - 1) * 128 * NWG * NK * 4;
  static constexpr int GPEER_BYTES = (CL - 1) * 128 * NWG * NK * 2;
  static constexpr int FIXED = 1024 + R * TILE + KDY_BYTES + R * 2 * kBox + STATS_BYTES +
                               PART_BYTES + SCR_BYTES + XCH_BYTES + 256;
  static constexpr int S_FIT = (kSmemMax - FIXED) / TILE;
  static constexpr int S = cmin(cmin(8, 2 * NCH), S_FIT);  // ring stages
  static constexpr int SMEM = FIXED + S * TILE;
  static_assert(CP % 32 == 0 && CW % 32 == 0 && N1 % 32 == 0 && (4 * C) % BH == 0,
                "plan: widths");
  static_assert(kWgmma<C>, "plan: a width built");
  static_assert(CP == C || (CP - C < CB && C % 8 == 0), "plan: padding");
  static_assert(S >= 2 && SMEM <= kSmemMax, "plan: shared memory");
  static_assert(128 * NWG * CREGS + 128 * kProducerRegs <= POOL, "plan: registers");
  static_assert(CL == 1 || ((CL == 2 || CL == 4) && R == 1 && NK % 4 == 0 && (CP / 32) % CL == 0 &&
                            (2 * G * 64 + CL * 2 * 64 + NWG * 8 * CW) * 4 <= TILE),
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
  float* xch;           // [1 or 2][CL - 1][NK / 4][128 NWG] float4: the peers' partial
                        // h (dg), a slot per peer (xch_slot)
  uint64_t* full;       // [S]
  uint64_t* empty;      // [S]
  uint64_t* xfull;      // [1] the peers' partials have landed (cluster)
  uint64_t* gfull;      // [2] every block's part of a g/dh tile is written (cluster)
  uint64_t* rsfull;     // [1] the peers' row sums have landed (cluster, backward)

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
// blocks start only when all have initialised theirs, since the peers
// arrive on them
template <class P>
__device__ void ring_init(const TailSmem<P>& sm) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < P::S; ++st) {
      mbar_init(&sm.full[st], 1);              // the producer's arrive with its bytes
      mbar_init(&sm.empty[st], 4 * P::NWG);    // one arrive per consumer warp
    }
    if constexpr (P::CL > 1) {
      mbar_init(sm.xfull, 1);                  // expect_peer, and the peers' bytes
      mbar_init(&sm.gfull[0], 4 * P::NWG);     // each consumer warp, and the peers' bytes
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

// The end of a block: in a cluster, every thread of every block, so that
// no block exits while a peer may still reach its shared memory.
template <class P>
__device__ __forceinline__ void block_end() {
  if constexpr (P::CL > 1) cluster_sync();
}

// The cluster's exchange of a product that contracts over C (h = u W1c,
// dg = kdy w2g_c^T): a block holds its partial over its CB columns of C for
// the whole chunk, a thread N1 / 2 registers (d), and finalises NK of them:
// rank r the registers [NK r, NK (r + 1)), chunk columns cg N1 + N1 / CL r
// .. + N1 / CL. The thread of the same index in every other block holds the
// same rows and columns, so each thread sends each peer the registers that
// peer finalises into its exchange slot for this sender (`part` 0: h, 1:
// dg), the bytes completing on the peer's xfull, and sums the CL partials
// of its own registers in rank order, its own in its rank's place: ((p0 +
// p1) + p2) + p3, in every launch the same bits. A register array takes no
// run-time index: the loops over ranks are unrolled, so each register's
// index is a constant and `rank` only picks between them.

// the slot of block `to`'s exchange buffer that block `from` writes
__device__ __forceinline__ int xch_slot(int from, int to) { return from < to ? from : from - 1; }
template <class P>
__device__ __forceinline__ float* xch_buf(const TailSmem<P>& sm, int part, int slot) {
  return sm.xch + (part * (P::CL - 1) + slot) * (P::NK * 128 * P::NWG);
}
template <class P>
__device__ __forceinline__ void xch_send(const TailSmem<P>& sm, const float (&d)[P::N1 / 2],
                                         int part, uint32_t rank) {
#pragma unroll
  for (int to = 0; to < P::CL; ++to) {
    if (to == static_cast<int>(rank)) continue;
    const uint32_t base = map_rank(xch_buf(sm, part, xch_slot(rank, to)), to);
    const uint32_t peer_bar = map_rank(sm.xfull, to);
#pragma unroll
    for (int q = 0; q < P::NK / 4; ++q) {
      const int k = P::NK * to + 4 * q;  // what block `to` finalises
      st_async(base + (q * 128 * P::NWG + threadIdx.x) * 16,
               make_float4(d[k], d[k + 1], d[k + 2], d[k + 3]), peer_bar);
    }
  }
}
template <class P>
__device__ __forceinline__ void xch_add(const TailSmem<P>& sm, const float (&d)[P::N1 / 2],
                                        int part, uint32_t rank, float (&out)[P::NK]) {
#pragma unroll
  for (int q = 0; q < P::NK / 4; ++q) {
#pragma unroll
    for (int from = 0; from < P::CL; ++from) {
      const int k = P::NK * from + 4 * q;  // this block's registers when from == rank
      float4 v;
      if (from == static_cast<int>(rank)) {
        v = make_float4(d[k], d[k + 1], d[k + 2], d[k + 3]);
      } else {
        v = reinterpret_cast<const float4*>(
            xch_buf(sm, part, xch_slot(from, rank)))[q * 128 * P::NWG + threadIdx.x];
      }
      if (from == 0) {
        out[4 * q] = v.x;
        out[4 * q + 1] = v.y;
        out[4 * q + 2] = v.z;
        out[4 * q + 3] = v.w;
      } else {
        out[4 * q] += v.x;
        out[4 * q + 1] += v.y;
        out[4 * q + 2] += v.z;
        out[4 * q + 3] += v.w;
      }
    }
  }
}
// This block's barrier `bar` (count 1) is to take `bytes` from the peers:
// one consumer thread arrives, expecting them, and the phase completes
// once they have landed, whichever comes first. (An arrive on a peer's
// barrier with release at cluster scope instead waits for the thread's
// remote stores to be acknowledged, twice a chunk.)
__device__ __forceinline__ void expect_peer(uint64_t* bar, uint32_t bytes) {
  if (threadIdx.x == 0) mbar_arrive_expect_tx(bar, bytes);
}
// this warp's part of this block's columns of a g/dh tile is written: one
// arrive on this block's `bar`, warp 0's also expecting the peers' parts
// (their st.async bytes)
template <class P>
__device__ __forceinline__ void arrive_tile(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x == 0)
    mbar_arrive_expect_tx(bar, P::GPEER_BYTES);
  else if (threadIdx.x % 32 == 0)
    mbar_arrive(bar);
}
// The .shared::cluster addresses of a g/dh tile and of its barrier in every
// other block of the cluster (peer p: rank + 1 + p, modulo CL), for the
// pairs of bf16 values this block finalises.
template <class P>
struct TilePeers {
  uint32_t tile[P::CL - 1], bar[P::CL - 1];
  __device__ TilePeers(const unsigned char* t, const uint64_t* b, uint32_t rank) {
#pragma unroll
    for (int p = 0; p < P::CL - 1; ++p) {
      const uint32_t to = (rank + 1 + p) % P::CL;
      tile[p] = map_rank(t, to);
      bar[p] = map_rank(b, to);
    }
  }
  // v at byte `off` of every peer's tile
  __device__ __forceinline__ void send(uint32_t off, uint32_t v) const {
#pragma unroll
    for (int p = 0; p < P::CL - 1; ++p) st_async(tile[p] + off, v, bar[p]);
  }
};

// LayerNorm of the row tile's 64 rows (row0..) into the swizzled bf16 tile
// u, split over the tile's 4 G warps, whole rows a warp; rows past M become
// 0. The backward also forms kdy = bf16(keep * dy) and keeps mean and inv.
// A warp loads a batch of its rows before it reduces any: one row at a time
// would wait out a round trip to HBM per row. In a cluster each block
// reads whole rows of s, so all hold the same statistics, bit for bit, and
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

// Backward of the tail: ds from dy, with w2g = bf16(W2 * gamma), over BM
// rows a block (a cluster: 64 rows, CB columns a block).
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
      // the cluster: h and dg summed over every block's part of C for the
      // chunk columns this block finalises (NK registers a thread, columns
      // cg N1 + N1 / CL rank ..); dh = dg * gelu'(h + b1) into every block's
      // dh tile
      xch_send(sm, h, 0, rank);
      xch_send(sm, dg, 1, rank);
      float hs[P::NK], dgs[P::NK];
      expect_peer(sm.xfull, P::XCH_BYTES);
      mbar_wait_cluster(sm.xfull, j & 1);
      xch_add(sm, h, 0, rank, hs);
      xch_add(sm, dg, 1, rank, dgs);
      const TilePeers<P> dh_peers(dh_s, &sm.gfull[j & 1], rank);
#pragma unroll
      for (int i = 0; i < P::NK; i += 2) {
        const int c = cg * P::N1 + P::N1 / P::CL * rank + acc_col(i);
        const float2 bb = load2(b1 + 64 * j + c);
        float g0, g1, d0, d1;
        gelu_and_dgelu_tanh(hs[i] + bb.x, g0, d0);
        gelu_and_dgelu_tanh(hs[i + 1] + bb.y, g1, d1);
        dgs[i] *= d0;
        dgs[i + 1] *= d1;
        const uint32_t dhp = pack_bf16(dgs[i], dgs[i + 1]);
        const uint32_t off = swz(acc_row(i), c);
        *reinterpret_cast<uint32_t*>(dh_s + off) = dhp;
        dh_peers.send(off, dhp);
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
      // after the wait for the peers' writes, before the wgmma reads them
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
  // warpgroups in order, then (a cluster) the blocks' sums in rank order.
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
  // the blocks' row sums [CL][2][64] (slot r from block r), the column-sum
  // scratch [NWG][8 CW]
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
    // the blocks' row sums, added in rank order: the same bits in every block
    float* rs = epi + 2 * P::G * 64;  // [CL][2][64]: slot r written by block r
    if (cg == 0 && lane % 4 == 0) {
#pragma unroll
      for (int to = 0; to < P::CL; ++to) {
        if (to == static_cast<int>(rank)) continue;
        const uint32_t dst = map_rank(rs + 2 * 64 * rank, to), bar = map_rank(sm.rsfull, to);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          st_async(dst + (rlo + 8 * hi) * 4, p1[hi], bar);
          st_async(dst + (64 + rlo + 8 * hi) * 4, p2[hi], bar);
        }
      }
    }
    expect_peer(sm.rsfull, (P::CL - 1) * 2 * 64 * 4);
    mbar_wait_cluster(sm.rsfull, 0);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float a = 0.0f, b = 0.0f;
#pragma unroll
      for (int from = 0; from < P::CL; ++from) {
        const bool own = from == static_cast<int>(rank);
        const float t1 = own ? p1[hi] : rs[2 * 64 * from + rlo + 8 * hi];
        const float t2 = own ? p2[hi] : rs[2 * 64 * from + 64 + rlo + 8 * hi];
        a = from == 0 ? t1 : a + t1;
        b = from == 0 ? t2 : b + t2;
      }
      p1[hi] = a;
      p2[hi] = b;
    }
  }
  float* s2 = P::CL == 1 ? scr + 8 * P::N1  // [2][4 warps][CW]: du * xhat, du (row pass)
                         : epi + 2 * P::G * 64 + P::CL * 2 * 64 + w * 8 * P::CW;
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
  using P = Plan<C, MODE>;
  return a.rows == P::BM && a.chunk == P::BH && a.threads == P::THREADS && a.split == P::G &&
         a.smem == P::SMEM && a.cluster == P::CL && a.padded == P::CP;
}

// The launch configuration of plan P at kCluster > 1: `blocks` blocks in
// clusters of CL (cudaLaunchKernelEx with the cluster dimension).
template <class P>
void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1], unsigned blocks,
                    cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(P::THREADS);
  cfg.dynamicSmemBytes = P::SMEM;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P::CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

// The clusters of plan P running `kern` that the card holds at a time
// (cudaOccupancyMaxActiveClusters, asked once per kernel; 0: not one), or
// minus a CUDA error.
template <class P, typename... Params>
int max_clusters(void (*kern)(Params...)) {
  static int clusters = -1;
  if (clusters < 0) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (err != cudaSuccess) return -static_cast<int>(err);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cluster_config<P>(cfg, attr, P::CL, nullptr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (err != cudaSuccess) return -static_cast<int>(err);
    clusters = n;
  }
  return clusters;
}

// Launch a kernel of plan P over `rows` rows: a block per BM rows, or at
// kCluster > 1 a cluster of CL blocks per 64-row tile. Returns
// cudaGetLastError(), or -3 when the card cannot hold one such cluster at a
// time.
template <class P, typename... Params, typename... Args>
int launch_plan(void (*kern)(Params...), int64_t rows, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = static_cast<unsigned>((rows + P::BM - 1) / P::BM);
  if constexpr (P::CL == 1) {
    kern<<<tiles, P::THREADS, P::SMEM, stream>>>(args...);
    return static_cast<int>(cudaGetLastError());
  } else {
    const int clusters = max_clusters<P>(kern);
    if (clusters < 0) return -clusters;
    if (clusters == 0) return -3;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cluster_config<P>(cfg, attr, tiles * P::CL, stream);
    err = cudaLaunchKernelEx(&cfg, kern, args...);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
}

// The backward at width C: w1 is W1^T [4C, C].
template <int C, typename T, bool FULL>
int launch_bwd(const PlanArgs& plan, const void* s, const float* keep, int rows_per_keep,
               const float* ln_g, const float* ln_b, const bf16* w1t, const float* b1,
               const bf16* w2g, const void* dy, void* ds, int64_t M, int64_t rows, FullOut out,
               cudaStream_t stream) {
  using P = Plan<C, FULL ? kBwdRows : kBwdInput>;
  if (!plan_ok<C, FULL ? kBwdRows : kBwdInput>(plan)) return -1;
  CUtensorMap a, b;
  if (!make_map(&a, w1t, 4 * C, C) || !make_map(&b, w2g, 4 * C, C)) return -2;
  return launch_plan<P>(bwd_kernel<C, T, FULL>, rows, stream, a, b, static_cast<const T*>(s), keep,
                        rows_per_keep, ln_g, ln_b, b1, static_cast<const T*>(dy),
                        static_cast<T*>(ds), M, out);
}

// The clusters of the bf16 kernel of width C and mode MODE (a kernel of
// `kern`'s library) that the card holds at a time; -1 where the plan has
// no clusters.
template <int C, int MODE, typename... Params>
int clusters_of(void (*kern)(Params...)) {
  if constexpr (Plan<C, MODE>::CL == 1)
    return -1;
  else
    return max_clusters<Plan<C, MODE>>(kern);
}

}  // namespace

// Channel widths built: every ConvNeXt stage width the gates admit
// (T/S: 96-768, B: 128-1024, L: 192-768), convnext_iso's 432, and the micro
// models' 16, 32, 64 (convnext_micro's stages 0-2, vit_micro's width 32).
#define BLOCK_MLP_WIDTHS(X) X(16) X(32) X(64) X(96) X(128) X(192) X(256) X(384) X(432) X(512) X(768) X(1024)
