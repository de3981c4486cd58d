// Fused multi-head self-attention for Hopper (sm_90a), straight from the
// qkv Dense output of a ViT block:
//   o[b, n, g*hd + c] = sum_m p[b, g, n, m] * v[b, m, g, c],
//   p = softmax_m(q[b, n, g, :] . k[b, m, g, :] * scale),  scale = f32(hd^-0.5)
// with head g's q, k and v read in place as the column slices [g*hd, g*hd +
// hd) of qkv [B, N, 3D], offset by 0, D and 2D (no transposes), and the
// backward writing one dqkv [B, N, 3D] at the same offsets. Any N >= 1; any
// head width hd that is a multiple of 16 up to 128.
//
// Replaces the TPU kernels of revisiting_at_tpu/ops/attention.py:
//   attn_fwd_kernel                            <- _fwd_qkv_kernel (forward)
//   attn_bwd_rows_kernel, attn_bwd_cols_kernel <- _bwd_qkv_kernel (dqkv)
// They also serve `_fwd_kernel`/`_bwd_kernel` of the [B*H, N, hd] layout,
// whose wrapper in ops/attention.py packs q, k, v into [B, N, 3D].
//
// Numerics follow the TPU kernels: bf16 operands, f32 accumulation; s is
// the f32 product times the scale; keys past N get -1e30 and rows past N
// read as zero; p = e / sum(e), e = exp(s - max), in f32, rounded to bf16
// before PV. Backward: dv = p16^T dO, dp = dO v^T, dS = p * (dp -
// rowsum(dp * p)) with the f32 p, ds16 = bf16(dS * scale), dq = ds16 k,
// dk = ds16^T q. The f32 softmax takes two cheaper forms, each within a few
// f32 ulp: e is 2^(x c - max c), c = scale log2(e), from one fused
// multiply-add and the SFU's ex2 (`exp_scaled`; in the forward, one e in 16
// from a polynomial on the FMA pipe instead, `exp2_fma`), and p = e * (1 /
// sum), with the reciprocal correctly rounded once per row. p is rounded to bf16 where
// JAX rounds it; the few f32 ulp flip that rounding only where p lies within
// them of a bf16 rounding boundary.
//
// What bounds it on the H100: at ViT-S (N = 197, hd = 64, batch 80) the
// forward does 4*B*H*N^2*hd = 4.8 GFLOP against 48 MB of qkv and o, the
// backward 12 GFLOP against 85 MB: the bytes bound both (14.5 and 25 us at
// 3.35 TB/s, against 4.8 and 12 us of tensor-core time). The design:
//   * Persistent blocks, one per SM, each walking (head, image) items, with
//     a producer warpgroup and two consumer warpgroups. The consumers take
//     the head's 64-row tiles, each its own (query tiles in the forward and
//     the dq pass, key tiles in the dk/dv pass), so that one's products
//     overlap the other's softmax (in the forward they issue them in turns,
//     FlashAttention-3's ping-pong), and share every tile the producer
//     loads. The producer gives most of its registers to the
//     consumers (setmaxnreg: 240 each, against 168 for an even split).
//   * An item's streamed tiles (K and V, or Q, dO and the statistics in the
//     dk/dv pass) are loaded once for all of its rounds while they fit the
//     ring (up to 256 keys in the forward, 512 in the backward at hd <= 64),
//     and the ring holds two items' worth, so the next item loads during
//     this one. So a head's q, k, v and dO leave HBM about once.
//   * TMA loads 64-row boxes of a 3-D tensor map over [B, N, 3D] (or dO's
//     [B, N, D]); rows past N come in as zeros. Boxes are hd columns wide up
//     to 32 (32- and 64-byte swizzle), else 64 (128-byte swizzle, two boxes
//     above hd = 64; columns past hd are loaded and not used). Stages and
//     each warpgroup's own tiles are guarded by mbarriers.
//   * wgmma: S = Q K^T with both operands K-major, as the rows lie; the
//     softmax's p (or dS) is rounded to bf16 in registers and fed to the
//     next product as its register A operand, with V, K, dO or Q the
//     MN-major shared-memory B operand. Nothing of the score matrix goes
//     through shared memory.
//   * Forward: up to 256 keys (4 tiles) a query tile's whole score row stays
//     in its warpgroup's registers (128 of them), so max and sum come from
//     quad shuffles and p is rounded after normalising, where JAX rounds it;
//     PV of one key tile runs while the next tile's p is formed. Past 256
//     keys the same kernel sweeps the key tiles twice: the row max and sum
//     first (the sum rescaled as the max grows), then S again, p, and PV.
//     The output is never rescaled, so p is rounded where JAX rounds it.
//   * Backward, in two passes, no float atomics (the same bits every run):
//     attn_bwd_rows_kernel, per query tile: one sweep over the key tiles for
//     the row max, the sum and delta = rowsum(dp * p) (both rescaled as the
//     max grows), a second for dS and dq = ds16 k; it writes dq and, per
//     row, max * c, 1 / sum and delta into a small f32 side buffer [B, H,
//     tiles, 3, 64]. attn_bwd_cols_kernel, per key tile: over the
//     query tiles, S^T = K Q^T and dP^T = V dO^T, p^T from the stored
//     statistics, dv += p16^T dO and dk += ds16^T Q in registers.
//   * o, dq, dk and dv go from the accumulator registers straight to global
//     memory as bf16 pairs, rows past N left alone; a warpgroup gives its
//     own tiles back to the producer as soon as its products have read them.
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after its launch, -1 for a shape it does not take, -2 when
// cuTensorMapEncodeTiled fails.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kRows = 64;         // rows of a tile: queries or keys
constexpr int kMaxConsumers = 2;  // consumer warpgroups per block
// and a producer warpgroup: 2 * 128 * 240 + 128 * 24 registers <= 64K
constexpr int kThreads = 128 * (kMaxConsumers + 1);
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
constexpr int kResident = 4;      // key tiles whose scores the forward holds at once
// Ring stages: the forward's hold a tile of K or V, the backward's two tiles
// (and the statistics). Up to hd = 64 they hold two items' resident tiles.
template <int HD>
__host__ __device__ constexpr int fwd_stages() { return HD > 64 ? 8 : 16; }
template <int HD>
__host__ __device__ constexpr int bwd_stages() { return HD > 64 ? 2 : 8; }
// per query row: max * c (see exp_scaled), 1 / sum, delta
constexpr int kStats = 3;
constexpr uint32_t kStatsBytes = kStats * kRows * 4;
constexpr float kNegInf = -1e30f;

// A 64-row bf16 tile of one head as TMA lays it down: BOXES boxes of BOXW
// columns, each [64][BOXW] with rows of ROW bytes swizzled over ROW bytes.
template <int HD>
struct Tile {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 128, "head width: a multiple of 16, 16-128");
  static constexpr int BOXW = HD <= 32 ? HD : 64;
  static constexpr int BOXES = (HD + BOXW - 1) / BOXW;
  static constexpr int ROW = 2 * BOXW;
  static constexpr uint32_t BOX_BYTES = kRows * ROW;
  static constexpr uint32_t BYTES = BOX_BYTES * BOXES;  // a multiple of 1024

  // the tile as the K-major operand of a product over the head width: k16 step kk
  __device__ static uint64_t kmajor(const unsigned char* t, int kk) {
    return desc_kmajor(t + (kk * 16 / BOXW) * BOX_BYTES + (kk * 16 % BOXW) * 2, ROW);
  }
  // the tile as the MN-major B operand of a product over its 64 rows: k16 step kk
  __device__ static uint64_t mnmajor(const unsigned char* t, int kk) {
    return desc_mnmajor(t + kk * 16 * ROW, ROW, BOX_BYTES);
  }
  // rows [row, row + 64) of columns [col, col + BOXES * BOXW) of image b
  __device__ static void load(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int col,
                              int row, int b) {
#pragma unroll
    for (int j = 0; j < BOXES; ++j)
      tma_load_3d(dst + j * BOX_BYTES, map, bar, col + j * BOXW, row, b);
  }
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// The block's shared memory: the ring; two buffers of each consumer
// warpgroup's own tiles (its query tile in the forward and the dq pass, its
// key tile in the dk/dv pass: one being worked on, one loading); the
// barriers.
struct Smem {
  unsigned char* ring;
  unsigned char* own;
  uint32_t own_bytes;
  uint64_t* full;       // [stages] a stage holds its next item
  uint64_t* empty;      // [stages] every consumer warp is done with a stage
  uint64_t* own_full;   // [kMaxConsumers][2]
  uint64_t* own_empty;  // [kMaxConsumers][2] every warp of the warpgroup is done with them
  __device__ Smem(unsigned char* raw, int stages, uint32_t stage_bytes, uint32_t own_tile_bytes) {
    ring = align1024(raw);
    own = ring + stages * stage_bytes;
    own_bytes = own_tile_bytes;
    full = reinterpret_cast<uint64_t*>(own + 2 * kMaxConsumers * own_bytes);
    empty = full + stages;
    own_full = empty + stages;
    own_empty = own_full + 2 * kMaxConsumers;
  }
  // the buffer of warpgroup w's c-th own tiles, and its barriers' index
  __device__ int slot(int w, int c) const { return 2 * w + c % 2; }
  __device__ unsigned char* own_tiles(int w, int c) const { return own + slot(w, c) * own_bytes; }
  // consumer_warps: the warps of the warpgroups that have tiles
  __device__ void init(int stages, int consumer_warps) const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) {
        mbar_init(&full[s], 1);                // the producer's arrive with its bytes
        mbar_init(&empty[s], consumer_warps);  // one arrive per consumer warp
      }
      for (int i = 0; i < 2 * kMaxConsumers; ++i) {
        mbar_init(&own_full[i], 1);
        mbar_init(&own_empty[i], 4);
      }
      mbar_fence_init();
    }
    __syncthreads();
  }
};

constexpr size_t smem_bytes(int stages, uint32_t stage_bytes, uint32_t own_bytes) {
  return 1024 + stages * stage_bytes + 2 * kMaxConsumers * own_bytes +
         (2 * stages + 4 * kMaxConsumers) * 8;
}

// consumer: wait for ring item g, return its stage
__device__ __forceinline__ int ring_wait(const Smem& sm, int g, int stages) {
  const int st = g % stages;
  mbar_wait(&sm.full[st], (g / stages) & 1);
  return st;
}

// consumer: this warp is done with the stage
__device__ __forceinline__ void ring_release(const Smem& sm, int st) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(&sm.empty[st]);
}

// producer: wait until ring item g may overwrite its stage, return the stage
__device__ __forceinline__ int ring_claim(const Smem& sm, int g, int stages) {
  const int st = g % stages;
  if (g >= stages) mbar_wait(&sm.empty[st], (g / stages - 1) & 1);
  return st;
}

// producer: wait until the buffer of warpgroup w's c-th own tiles is free
// (the tiles it held before are used), return the barrier their bytes
// complete
__device__ __forceinline__ uint64_t* own_claim(const Smem& sm, int w, int c, uint32_t bytes) {
  if (c >= 2) mbar_wait(&sm.own_empty[sm.slot(w, c)], (c / 2 - 1) & 1);
  mbar_arrive_expect_tx(&sm.own_full[sm.slot(w, c)], bytes);
  return &sm.own_full[sm.slot(w, c)];
}

// consumer: wait for warpgroup w's c-th own tiles
__device__ __forceinline__ unsigned char* own_wait(const Smem& sm, int w, int c) {
  mbar_wait(&sm.own_full[sm.slot(w, c)], (c / 2) & 1);
  return sm.own_tiles(w, c);
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.0f;
}

// accumulator register i of a 64 x N product: its row (0..63) within the
// tile and column offset within its 8-column group
__device__ __forceinline__ int acc_row(int i) {
  const int t = threadIdx.x % 128;
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i / 4) + 2 * (threadIdx.x % 4) + i % 2;
}

// s = Q K^T (64 x 64) over the head width, both tiles K-major
template <int HD>
__device__ __forceinline__ void scores(float (&s)[32], const unsigned char* a,
                                       const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_m64n64k16_ss_kmajor(s, Tile<HD>::kmajor(a, kk), Tile<HD>::kmajor(b, kk));
}

// acc += A B over 64 rows of B: A (64 x 64) as bf16 register fragments
// a[kk], B an MN-major tile
template <int HD>
__device__ __forceinline__ void times_tile(float (&acc)[HD / 2], const uint32_t (&a)[4][4],
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<HD>(acc, a[kk], Tile<HD>::mnmajor(b, kk));
}

// the register A fragments of bf16(x) for a 64 x 64 block held as an accumulator
__device__ __forceinline__ void to_frags(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// -1e30 on keys past N (keys key0 + column); only the last key tile reaches
// past N. Scores stay unscaled: the scale goes into the exponent.
__device__ __forceinline__ void mask_keys(float (&s)[32], int key0, int N) {
  if (key0 + kRows > N) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = key0 + acc_col(i) < N ? s[i] : kNegInf;
  }
}

// -1e30 on the keys past N among a key tile's first 8 (d[0 .. 4)), for a
// tile whose keys all lie there (the forward's short last tile)
__device__ __forceinline__ void mask_first8(float (&s)[32], int key0, int N) {
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = key0 + acc_col(i) < N ? s[i] : kNegInf;
}

constexpr float kLog2e = 1.4426950408889634f;

// e^(x * scale - m) for an unscaled score x, as 2^(x * c - mc) with c =
// scale * log2(e) and mc = m * c: one fused multiply-add and the SFU's
// ex2 (ex2.approx, flushing results below 2^-126 to 0), within a few f32
// ulp of expf over a softmax's arguments, at a third of its instructions
__device__ __forceinline__ float exp_scaled(float x, float c, float mc) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(fmaf(x, c, -mc)));
  return y;
}

// each of the thread's two rows (r and r + 8) reduced over the quad of lanes that holds it
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the row max of the tile's first `groups` groups of 8 columns folded into
// m (both of the thread's rows), in four independent chains per row
__device__ __forceinline__ void fold_max(const float (&s)[32], float (&m)[2], int groups = 8) {
  float t[2][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) t[0][k] = t[1][k] = kNegInf;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float& acc = t[(i / 2) % 2][(i / 4) % 4];
    if (i / 4 < groups) acc = fmaxf(acc, s[i]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    m[j] = quad_max(fmaxf(fmaxf(m[j], fmaxf(t[j][0], t[j][1])), fmaxf(t[j][2], t[j][3])));
}

// the thread's part of the row sums of the tile's first `groups` groups of 8
// columns (both rows), in four independent chains per row
__device__ __forceinline__ void add_rows(const float (&s)[32], float (&l)[2], int groups = 8) {
  float t[2][4] = {};
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if (i / 4 < groups) t[(i / 2) % 2][(i / 4) % 4] += s[i];
#pragma unroll
  for (int j = 0; j < 2; ++j) l[j] += (t[j][0] + t[j][1]) + (t[j][2] + t[j][3]);
}

// consumer: this warp is done with warpgroup w's c-th own tiles
__device__ __forceinline__ void own_release(const Smem& sm, int w, int c) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(&sm.own_empty[sm.slot(w, c)]);
}

// acc (64 x HD f32) as bf16 to the rows of a row-major array at dst (row
// stride ld elements), rows at and past `rows` left alone: each lane stores
// its 4-byte pairs, a quad 16 contiguous bytes of a row (on the H100 this
// was faster than staging the tile for a TMA store, and than a quad
// transpose that gives every lane 16 bytes)
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2], bf16* dst, int64_t ld,
                                           int rows) {
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2)
    if (acc_row(i) < rows)
      *reinterpret_cast<uint32_t*>(dst + acc_row(i) * ld + acc_col(i)) =
          pack_bf16(acc[i], acc[i + 1]);
}

// consumer warpgroup with no tile this round: wait for and release n items
__device__ __forceinline__ void drain(const Smem& sm, int& g, int n, int stages) {
  for (int i = 0; i < n; ++i, ++g) ring_release(sm, ring_wait(sm, g, stages));
}

// ----------------------------------------------------------------- forward

// Up to kResident key tiles (N <= 256) the forward loads an item's K and V
// tiles once, K_0.. then V_0.., and every query tile uses them. Past that
// each query tile streams two sweeps: K_0.. for the row max and sum, then
// K_t, V_t per tile for PV. Item i of a stream is tile *t of K or V.
__device__ __forceinline__ int fwd_items(int nt) { return nt <= kResident ? 2 * nt : 3 * nt; }
__device__ __forceinline__ void fwd_item(int nt, int i, int& t, bool& is_v) {
  if (nt <= kResident || i < nt) {
    t = i % nt;
    is_v = i >= nt;
  } else {
    t = (i - nt) / 2;
    is_v = (i - nt) % 2;
  }
}

// Resident items: the block's k-th item hands its query tiles out in the
// order fwd_query_tile(k, 0), (k, 1), ..., the p-th to warpgroup p % 2.
// The order runs backwards on odd items, so that the short last tile (5 of
// 64 rows at N = 197) falls to each warpgroup in turn.
__device__ __forceinline__ int fwd_query_tile(int k, int p, int nt) {
  return k % 2 ? nt - 1 - p : p;
}

// The two consumer warpgroups issue their products in turns (named
// barriers kTurnBar + w), FlashAttention-3's ping-pong: a turn is one
// warpgroup's S, or its PV, so that one's softmax runs while the other's
// products do.
constexpr int kTurnBar = 1;  // barrier 0 is __syncthreads'
__device__ __forceinline__ void turn_wait(int w) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(kTurnBar + w), "n"(2 * 128) : "memory");
}
__device__ __forceinline__ void turn_pass(int w) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(kTurnBar + 1 - w), "n"(2 * 128) : "memory");
}

// 2^x for x <= 0 on the FMA pipe, beside the SFU's ex2: x = j + f with j =
// round(x), 2^f by a degree-7 Taylor polynomial in Horner form (within one
// f32 ulp on [-0.5, 0.5]), j added to the exponent field. Below 2^-126 the
// result is 0, as ex2.approx.ftz flushes it.
__device__ __forceinline__ float exp2_fma(float x) {
  x = fmaxf(x, -127.0f);
  const float t = x + 12582912.0f;  // 1.5 * 2^23: round(x) in the low bits
  const float f = x - (t - 12582912.0f);
  float q = 1.5252733804059840e-5f;  // ln(2)^k / k!, k = 7 .. 0
  q = fmaf(q, f, 1.5403530393381606e-4f);
  q = fmaf(q, f, 1.3333558146428443e-3f);
  q = fmaf(q, f, 9.6181291076284772e-3f);
  q = fmaf(q, f, 5.5504108664821580e-2f);
  q = fmaf(q, f, 2.4022650695910071e-1f);
  q = fmaf(q, f, 6.9314718055994531e-1f);
  q = fmaf(q, f, 1.0f);
  const float r = __int_as_float(__float_as_int(q) + (__float_as_int(t) << 23));
  return x <= -126.0f ? 0.0f : r;
}

// e^(x * scale - m) as exp_scaled computes it, for register i of a score
// tile: every 16th register (i % 16 == 0) on the FMA pipe, the rest on the
// SFU. A larger share on the FMA pipe measured slower (issue slots).
__device__ __forceinline__ float exp_split(float x, float c, float mc, int i) {
  return i % 16 == 0 ? exp2_fma(fmaf(x, c, -mc)) : exp_scaled(x, c, mc);
}

// The two consumer warpgroups take an item's query tiles, each its own. A
// query tile's whole score row (up to 256 keys, 128 registers) stays in its
// warpgroup's registers: the producer is a warpgroup of its own that gives
// most of its registers to the consumers (setmaxnreg). What the H100
// measured (tools/tree_compare.py; PERF.md) shaped the resident path:
//   * the warpgroups' S and PV products go in turns (turn_wait/turn_pass)
//     when both have the same number of query tiles (nt even);
//   * with 4 key tiles, S is one m64n256k16 product per k16 step over the
//     four contiguous ring stages (m64n200k16 when the last tile holds at
//     most 8 keys), not four m64n64k16;
//   * kShortLast: the last key tile holds at most 8 keys (N = 197 = 3 * 64
//     + 5 for a ViT at 224 px) and its softmax is formed on those 8 columns
//     only, no exponential for a dead key; its PV runs on zeros. Bounds
//     known only at run time (a last tile of any width, a PV cut short)
//     measured slower than the dead work they leave out: the softmax stays
//     straight-line code;
//   * each item's query tiles load before its K and V, and a block's first
//     item lands before the next is asked for (all SMs load at once there).
template <int HD, bool kShortLast>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_kernel(const __grid_constant__ CUtensorMap qkv_map, bf16* __restrict__ out, int N,
                int H, float scale, int BH) {
  using T = Tile<HD>;
  constexpr int S = fwd_stages<HD>();
  extern __shared__ unsigned char smem_raw[];
  Smem sm(smem_raw, S, T::BYTES, T::BYTES);
  const int nt = (N + kRows - 1) / kRows;
  const int nc = nt < kMaxConsumers ? nt : kMaxConsumers;  // warpgroups with query tiles
  const int rounds = (nt + nc - 1) / nc;
  const bool resident = nt <= kResident;
  const int items = fwd_items(nt);
  const int D = H * HD;
  const float c = scale * kLog2e;  // exp_scaled's exponent scale
  // turns need as many of them in one warpgroup as in the other
  const bool pingpong = resident && nc == 2 && nt % 2 == 0;
  sm.init(S, 4 * nc);

  if (threadIdx.x >= 128 * kMaxConsumers) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kMaxConsumers) {
      int g = 0, cnt[kMaxConsumers] = {0, 0}, k = 0;
      for (int item = blockIdx.x; item < BH; item += gridDim.x, ++k) {
        const int h = item % H, b = item / H;
        // the item's streamed tiles
        auto stream = [&]() {
          for (int i = 0; i < items; ++i, ++g) {
            const int st = ring_claim(sm, g, S);
            int t;
            bool is_v;
            fwd_item(nt, i, t, is_v);
            mbar_arrive_expect_tx(&sm.full[st], T::BYTES);
            T::load(sm.ring + st * T::BYTES, &qkv_map, &sm.full[st], (is_v ? 2 : 1) * D + h * HD,
                    t * kRows, b);
          }
        };
        if (resident) {
          // each warpgroup's first query tile, the K and V tiles (during the
          // previous item), then the other query tiles; written out rather
          // than as a second lambda, which measured slower on the producer's
          // 24 registers
          for (int p = 0; p < nc; ++p) {
            uint64_t* bar = own_claim(sm, p, cnt[p], T::BYTES);
            T::load(sm.own_tiles(p, cnt[p]++), &qkv_map, bar, h * HD,
                    fwd_query_tile(k, p, nt) * kRows, b);
          }
          stream();
          for (int p = nc; p < nt; ++p) {
            const int w = p % nc;
            uint64_t* bar = own_claim(sm, w, cnt[w], T::BYTES);
            T::load(sm.own_tiles(w, cnt[w]++), &qkv_map, bar, h * HD,
                    fwd_query_tile(k, p, nt) * kRows, b);
          }
          if (k == 0)  // the first item lands before the next is asked for
            for (int i = 0; i < items; ++i) mbar_wait(&sm.full[i], 0);
          continue;
        }
        for (int r = 0; r < rounds; ++r) {
          for (int w = 0; w < nc && r * nc + w < nt; ++w) {
            uint64_t* bar = own_claim(sm, w, cnt[w], T::BYTES);
            T::load(sm.own_tiles(w, cnt[w]++), &qkv_map, bar, h * HD, (r * nc + w) * kRows, b);
          }
          stream();
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // the warpgroup, uniform to the compiler (a shuffle from lane 0): a branch
  // on it is not divergent, so ptxas keeps the products' pipeline
  const int w = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (w >= nc) return;  // one query tile: one warpgroup
  if (pingpong && w == 1) turn_pass(w);  // warpgroup 0 takes the first turn
  int g = 0, cnt = 0, k = 0;  // ring items, query tiles this warpgroup did, items
  for (int item = blockIdx.x; item < BH; item += gridDim.x, ++k) {
    const int h = item % H, b = item / H;
    if (resident) {
      // the whole score row in registers: S over every key tile at once,
      // softmax, p as bf16 fragments, then PV over every V tile at once;
      // the K and V stages go back to the producer after the item
      for (int p = w; p < nt; p += nc) {
        const int qt = fwd_query_tile(k, p, nt);
        unsigned char* q_s = own_wait(sm, w, cnt);
        float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
        float o[HD / 2];  // zeroed just before PV: not live beside the scores
        float s[kResident][32];
#pragma unroll
        for (int t = 0; t < kResident; ++t) {
          if (t < nt) {
            ring_wait(sm, g + t, S);
            zero(s[t]);
            fence_acc(s[t]);
          }
        }
        if (pingpong) turn_wait(w);
        wgmma_fence();
        if (T::BOXES == 1 && nt == kResident && g % S + kResident <= S) {
          // the four key tiles lie in consecutive stages: one product per
          // k16 step, its 256-column accumulator the four tiles' in turn
          float (&s4)[kResident * 32] = reinterpret_cast<float (&)[kResident * 32]>(s);
          const unsigned char* k_s = sm.ring + (g % S) * T::BYTES;
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            if constexpr (kShortLast)
              wgmma_m64n200k16_ss_kmajor(s4, T::kmajor(q_s, kk), T::kmajor(k_s, kk));
            else
              wgmma_m64n256k16_ss_kmajor(s4, T::kmajor(q_s, kk), T::kmajor(k_s, kk));
          }
        } else {
#pragma unroll
          for (int t = 0; t < kResident; ++t)
            if (t < nt) scores<HD>(s[t], q_s, sm.ring + ((g + t) % S) * T::BYTES);
        }
        wgmma_commit();
        if (pingpong) turn_pass(w);
        wgmma_wait_all();
        own_release(sm, w, cnt);
        // every tile's fence first: inside the tiles' branches below they
        // measured slower (the folds of the tiles no longer interleave)
#pragma unroll
        for (int t = 0; t < kResident; ++t)
          if (t < nt) fence_acc(s[t]);
#pragma unroll
        for (int t = 0; t < kResident; ++t) {
          if (kShortLast && t == nt - 1) {
            mask_first8(s[t], t * kRows, N);
            fold_max(s[t], m, 1);
          } else if (t < nt) {
            mask_keys(s[t], t * kRows, N);
            fold_max(s[t], m);
          }
        }
        const float mc[2] = {m[0] * c, m[1] * c};
#pragma unroll
        for (int t = 0; t < kResident; ++t) {
          if (kShortLast && t == nt - 1) {
#pragma unroll
            for (int i = 0; i < 4; ++i) s[t][i] = exp_scaled(s[t][i], c, mc[(i / 2) % 2]);
            add_rows(s[t], l, 1);
          } else if (t < nt) {
#pragma unroll
            for (int i = 0; i < 32; ++i) s[t][i] = exp_split(s[t][i], c, mc[(i / 2) % 2], i);
            add_rows(s[t], l);
          }
        }
        l[0] = quad_sum(l[0]);
        l[1] = quad_sum(l[1]);
        const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
        for (int t = 0; t < kResident; ++t) {
          if (kShortLast && t == nt - 1) {
#pragma unroll
            for (int i = 0; i < 4; ++i) s[t][i] *= rl[(i / 2) % 2];
          } else if (t < nt) {
#pragma unroll
            for (int i = 0; i < 32; ++i) s[t][i] *= rl[(i / 2) % 2];
          }
        }
        // p of tile t as bf16 fragments, PV of tile t in flight while the
        // next tile's fragments are formed: two fragment buffers. Past the
        // last tile's 8 keys p is zero (those scores were never written).
        uint32_t a[2][4][4];
        zero(o);
        if (pingpong) turn_wait(w);
#pragma unroll
        for (int t = 0; t < kResident; ++t) {
          if (t < nt) {
            to_frags(s[t], a[t % 2]);
            ring_wait(sm, g + nt + t, S);
            fence_acc(o);
            wgmma_fence();
            times_tile<HD>(o, a[t % 2], sm.ring + ((g + nt + t) % S) * T::BYTES);
            wgmma_commit();
            wgmma_wait<1>();  // tile t - 1's PV is done: its fragments are free
          }
        }
        if (pingpong) turn_pass(w);
        wgmma_wait_all();
        fence_acc(o);
        if (p + nc >= nt) {  // this warpgroup's last tile of the item
          for (int i = 0; i < items; ++i) ring_release(sm, (g + i) % S);
          g += items;
        }
        store_rows<HD>(o, out + (static_cast<int64_t>(b) * N + qt * kRows) * D + h * HD, D,
                       N - qt * kRows);
        ++cnt;
      }
      continue;
    }
    for (int r = 0; r < rounds; ++r) {
      const int qt = r * nc + w;
      if (qt >= nt) {  // no query tile this round
        drain(sm, g, items, S);
        continue;
      }
      unsigned char* q_s = own_wait(sm, w, cnt);
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
      float o[HD / 2];
      // sweep 1: the row max, and the sum rescaled as the max grows
      float s[32];
      for (int t = 0; t < nt; ++t) {
        const int st = ring_wait(sm, g++, S);
        zero(s);
        fence_acc(s);
        wgmma_fence();
        scores<HD>(s, q_s, sm.ring + st * T::BYTES);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(s);
        ring_release(sm, st);
        mask_keys(s, t * kRows, N);
        float mn[2] = {m[0], m[1]};
        fold_max(s, mn);
        const float mc[2] = {mn[0] * c, mn[1] * c};
        l[0] *= exp_scaled(m[0], c, mc[0]);
        l[1] *= exp_scaled(m[1], c, mc[1]);
#pragma unroll
        for (int i = 0; i < 32; ++i) l[(i / 2) % 2] += exp_scaled(s[i], c, mc[(i / 2) % 2]);
        m[0] = mn[0];
        m[1] = mn[1];
      }
      l[0] = quad_sum(l[0]);
      l[1] = quad_sum(l[1]);
      const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
      const float mc[2] = {m[0] * c, m[1] * c};
      // sweep 2: S again, p rounded after normalising, PV
      zero(o);
      for (int t = 0; t < nt; ++t) {
        int st = ring_wait(sm, g++, S);
        zero(s);
        fence_acc(s);
        wgmma_fence();
        scores<HD>(s, q_s, sm.ring + st * T::BYTES);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(s);
        ring_release(sm, st);
        if (t == nt - 1) own_release(sm, w, cnt);
        mask_keys(s, t * kRows, N);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = exp_scaled(s[i], c, mc[(i / 2) % 2]) * rl[(i / 2) % 2];
        uint32_t a[4][4];
        to_frags(s, a);
        st = ring_wait(sm, g++, S);
        fence_acc(o);
        wgmma_fence();
        times_tile<HD>(o, a, sm.ring + st * T::BYTES);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(o);
        ring_release(sm, st);
      }
      store_rows<HD>(o, out + (static_cast<int64_t>(b) * N + qt * kRows) * D + h * HD, D,
                     N - qt * kRows);
      ++cnt;
    }
  }
  if (pingpong && w == 0) turn_wait(w);  // warpgroup 1's last pass
}

// ------------------------------------------------------ backward, dq pass

// The dq pass's S (masked, unscaled) and dP of key tile t, from ring item i
// (a stage of K_t and V_t): the stage.
template <int HD>
__device__ __forceinline__ const unsigned char* row_products(const Smem& sm, int i, int t,
                                                             const unsigned char* q_s,
                                                             const unsigned char* do_s, int N,
                                                             float (&s)[32], float (&dp)[32]) {
  const unsigned char* kv = sm.ring + ring_wait(sm, i, bwd_stages<HD>()) * 2 * Tile<HD>::BYTES;
  zero(s);
  zero(dp);
  fence_acc(s);
  fence_acc(dp);
  wgmma_fence();
  scores<HD>(s, q_s, kv);
  scores<HD>(dp, do_s, kv + Tile<HD>::BYTES);
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(s);
  fence_acc(dp);
  mask_keys(s, t * kRows, N);
  return kv;
}

// dq and the per-row statistics of each query tile: the two consumer
// warpgroups take an item's query tiles in rounds, each its own, and sweep
// the key tiles twice. A stage holds K_t and V_t; up to bwd_stages key
// tiles they stay for all of an item's query tiles, past that each round
// streams them twice.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_rows_kernel(const __grid_constant__ CUtensorMap qkv_map,
                     const __grid_constant__ CUtensorMap do_map,
                     bf16* __restrict__ dqkv, float* __restrict__ stats, int N, int H,
                     float scale, int BH) {
  using T = Tile<HD>;
  constexpr int S = bwd_stages<HD>();
  extern __shared__ unsigned char smem_raw[];
  Smem sm(smem_raw, S, 2 * T::BYTES, 2 * T::BYTES);
  const int nt = (N + kRows - 1) / kRows;
  const int nc = nt < kMaxConsumers ? nt : kMaxConsumers;  // warpgroups with query tiles
  const int rounds = (nt + nc - 1) / nc;
  const bool resident = nt <= S;
  const int items = resident ? nt : 2 * nt;
  const int D = H * HD;
  const float c = scale * kLog2e;  // exp_scaled's exponent scale
  sm.init(S, 4 * nc);

  if (threadIdx.x >= 128 * kMaxConsumers) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kMaxConsumers) {
      int g = 0, cnt[kMaxConsumers] = {0, 0};
      for (int item = blockIdx.x; item < BH; item += gridDim.x) {
        const int h = item % H, b = item / H;
        // the item's streamed tiles; a resident item's go first, so that they
        // load during the previous item
        auto stream = [&]() {
          for (int i = 0; i < items; ++i, ++g) {
            const int st = ring_claim(sm, g, S);
            unsigned char* kv = sm.ring + st * 2 * T::BYTES;
            const int row = (i % nt) * kRows;
            mbar_arrive_expect_tx(&sm.full[st], 2 * T::BYTES);
            T::load(kv, &qkv_map, &sm.full[st], D + h * HD, row, b);
            T::load(kv + T::BYTES, &qkv_map, &sm.full[st], 2 * D + h * HD, row, b);
          }
        };
        if (resident) stream();
        for (int r = 0; r < rounds; ++r) {
          for (int w = 0; w < nc && r * nc + w < nt; ++w) {
            uint64_t* bar = own_claim(sm, w, cnt[w], 2 * T::BYTES);
            unsigned char* dst = sm.own_tiles(w, cnt[w]++);
            T::load(dst, &qkv_map, bar, h * HD, (r * nc + w) * kRows, b);
            T::load(dst + T::BYTES, &do_map, bar, h * HD, (r * nc + w) * kRows, b);
          }
          if (!resident) stream();
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int w = threadIdx.x / 128;
  if (w >= nc) return;  // one query tile: one warpgroup
  int g = 0, cnt = 0;  // ring items, and query tiles this warpgroup did
  for (int item = blockIdx.x; item < BH; item += gridDim.x) {
    const int h = item % H, b = item / H;
    for (int r = 0; r < rounds; ++r) {
      const int qt = r * nc + w;
      if (qt >= nt) {  // no query tile this round; the resident keys are released
        if (resident) {
          for (int i = 0; i < nt; ++i) ring_release(sm, (g + i) % S);
          g += nt;
        } else {
          drain(sm, g, items, S);
        }
        continue;
      }
      unsigned char* q_s = own_wait(sm, w, cnt);
      const unsigned char* do_s = q_s + T::BYTES;
      float s[32], dp[32];
      // sweep 1: row max; sum and sum of e * dp, both rescaled as the max grows
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, du[2] = {0.0f, 0.0f};
      for (int t = 0; t < nt; ++t) {
        row_products<HD>(sm, g + t, t, q_s, do_s, N, s, dp);
        if (!resident) ring_release(sm, (g + t) % S);
        float mn[2] = {m[0], m[1]};
        fold_max(s, mn);
        const float mc[2] = {mn[0] * c, mn[1] * c};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float alpha = exp_scaled(m[j], c, mc[j]);
          l[j] *= alpha;
          du[j] *= alpha;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float e = exp_scaled(s[i], c, mc[(i / 2) % 2]);
          l[(i / 2) % 2] += e;
          du[(i / 2) % 2] += e * dp[i];
        }
        m[0] = mn[0];
        m[1] = mn[1];
      }
      float delta[2], rl[2], mc[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        l[j] = quad_sum(l[j]);
        delta[j] = quad_sum(du[j]) / l[j];
        rl[j] = __frcp_rn(l[j]);
        mc[j] = m[j] * c;
      }
      // sweep 2: dS = p * (dp - delta), dq += ds16 K
      float dq[HD / 2];
      zero(dq);
      const int g2 = resident ? g : g + nt;
      for (int t = 0; t < nt; ++t) {
        const unsigned char* kv = row_products<HD>(sm, g2 + t, t, q_s, do_s, N, s, dp);
        if (t == nt - 1) own_release(sm, w, cnt);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int j = (i / 2) % 2;
          s[i] = exp_scaled(s[i], c, mc[j]) * rl[j] * (dp[i] - delta[j]) * scale;
        }
        uint32_t a[4][4];
        to_frags(s, a);
        fence_acc(dq);
        wgmma_fence();
        times_tile<HD>(dq, a, kv);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(dq);
        if (!resident) ring_release(sm, (g2 + t) % S);
      }
      if (!resident) {
        g += 2 * nt;
      } else if (r == rounds - 1) {
        for (int i = 0; i < nt; ++i) ring_release(sm, (g + i) % S);
        g += nt;
      }
      // the statistics of the tile's rows, for the dk/dv pass
      if (threadIdx.x % 4 == 0) {
        float* out = stats + ((static_cast<int64_t>(b) * H + h) * nt + qt) * kStats * kRows;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int row = acc_row(2 * j);
          out[row] = mc[j];
          out[kRows + row] = rl[j];
          out[2 * kRows + row] = delta[j];
        }
      }
      store_rows<HD>(dq, dqkv + (static_cast<int64_t>(b) * N + qt * kRows) * 3 * D + h * HD,
                     3 * D, N - qt * kRows);
      ++cnt;
    }
  }
}

// --------------------------------------------------- backward, dk/dv pass

// dk and dv of each key tile: the two consumer warpgroups take an item's key
// tiles in rounds, each its own, over the query tiles; a stage holds Q_j,
// dO_j and the statistics of their rows. Up to bwd_stages query tiles the
// stages stay for all of an item's key tiles, past that each round streams
// them again.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_cols_kernel(const __grid_constant__ CUtensorMap qkv_map,
                     const __grid_constant__ CUtensorMap do_map,
                     bf16* __restrict__ dqkv, const float* __restrict__ stats, int N, int H,
                     float scale, int BH) {
  using T = Tile<HD>;
  constexpr int S = bwd_stages<HD>();
  // Q_j, dO_j, the statistics; 1024-byte steps keep every stage's tiles on
  // the swizzle pattern's 1024-byte boundary
  constexpr uint32_t STAGE = 2 * T::BYTES + 1024;
  extern __shared__ unsigned char smem_raw[];
  Smem sm(smem_raw, S, STAGE, 2 * T::BYTES);
  const int nt = (N + kRows - 1) / kRows;
  const int nc = nt < kMaxConsumers ? nt : kMaxConsumers;  // warpgroups with key tiles
  const int rounds = (nt + nc - 1) / nc;
  const bool resident = nt <= S;
  const int D = H * HD;
  const float cs = scale * kLog2e;  // exp_scaled's exponent scale, as the dq pass's
  sm.init(S, 4 * nc);

  if (threadIdx.x >= 128 * kMaxConsumers) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kMaxConsumers) {
      int g = 0, cnt[kMaxConsumers] = {0, 0};
      for (int item = blockIdx.x; item < BH; item += gridDim.x) {
        const int h = item % H, b = item / H;
        const float* head_stats = stats + static_cast<int64_t>(item) * nt * kStats * kRows;
        // the item's streamed tiles; a resident item's go first, so that they
        // load during the previous item
        auto stream = [&]() {
          for (int j = 0; j < nt; ++j, ++g) {
            const int st = ring_claim(sm, g, S);
            unsigned char* dst = sm.ring + st * STAGE;
            mbar_arrive_expect_tx(&sm.full[st], 2 * T::BYTES + kStatsBytes);
            T::load(dst, &qkv_map, &sm.full[st], h * HD, j * kRows, b);
            T::load(dst + T::BYTES, &do_map, &sm.full[st], h * HD, j * kRows, b);
            bulk_load(dst + 2 * T::BYTES, head_stats + j * kStats * kRows, kStatsBytes,
                      &sm.full[st]);
          }
        };
        if (resident) stream();
        for (int r = 0; r < rounds; ++r) {
          for (int w = 0; w < nc && r * nc + w < nt; ++w) {
            uint64_t* bar = own_claim(sm, w, cnt[w], 2 * T::BYTES);
            unsigned char* dst = sm.own_tiles(w, cnt[w]++);
            const int row = (r * nc + w) * kRows;
            T::load(dst, &qkv_map, bar, D + h * HD, row, b);
            T::load(dst + T::BYTES, &qkv_map, bar, 2 * D + h * HD, row, b);
          }
          if (!resident) stream();
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int w = threadIdx.x / 128;
  if (w >= nc) return;  // one key tile: one warpgroup
  int g = 0, cnt = 0;  // ring items, and key tiles this warpgroup did
  for (int item = blockIdx.x; item < BH; item += gridDim.x) {
    const int h = item % H, b = item / H;
    for (int r = 0; r < rounds; ++r) {
      const int kt = r * nc + w;
      if (kt >= nt) {  // no key tile this round; the resident query tiles are released
        if (resident) {
          for (int j = 0; j < nt; ++j) ring_release(sm, (g + j) % S);
          g += nt;
        } else {
          drain(sm, g, nt, S);
        }
        continue;
      }
      unsigned char* k_s = own_wait(sm, w, cnt);
      unsigned char* v_s = k_s + T::BYTES;
      float dk[HD / 2], dv[HD / 2];
      zero(dk);
      zero(dv);
      const bool key_live = kt * kRows + acc_row(0) < N;
      const bool key_live8 = kt * kRows + acc_row(2) < N;
      for (int j = 0; j < nt; ++j) {
        const int st = ring_wait(sm, g + j, S);
        const unsigned char* q_s = sm.ring + st * STAGE;
        const unsigned char* do_s = q_s + T::BYTES;
        const float* st_s = reinterpret_cast<const float*>(q_s + 2 * T::BYTES);
        float s[32], dp[32];  // S^T and dP^T: rows are keys, columns queries
        zero(s);
        zero(dp);
        fence_acc(s);
        fence_acc(dp);
        wgmma_fence();
        scores<HD>(s, k_s, q_s);
        scores<HD>(dp, v_s, do_s);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(s);
        fence_acc(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = acc_col(i);
          const bool live = ((i / 2) % 2 ? key_live8 : key_live) && j * kRows + c < N;
          const float p =
              live ? exp_scaled(s[i], cs, st_s[c]) * st_s[kRows + c] : 0.0f;
          s[i] = p;
          dp[i] = p * (dp[i] - st_s[2 * kRows + c]) * scale;
        }
        uint32_t pa[4][4], da[4][4];
        to_frags(s, pa);
        to_frags(dp, da);
        fence_acc(dv);
        fence_acc(dk);
        wgmma_fence();
        times_tile<HD>(dv, pa, do_s);
        times_tile<HD>(dk, da, q_s);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(dv);
        fence_acc(dk);
        if (!resident) ring_release(sm, st);
      }
      own_release(sm, w, cnt++);
      if (!resident) {
        g += nt;
      } else if (r == rounds - 1) {
        for (int j = 0; j < nt; ++j) ring_release(sm, (g + j) % S);
        g += nt;
      }
      bf16* drow = dqkv + (static_cast<int64_t>(b) * N + kt * kRows) * 3 * D + h * HD;
      store_rows<HD>(dk, drow + D, 3 * D, N - kt * kRows);
      store_rows<HD>(dv, drow + 2 * D, 3 * D, N - kt * kRows);
    }
  }
}

// ------------------------------------------------------------------- host

// [B, N, cols] bf16 as a 3-D tensor map in boxes of Tile<HD>'s BOXW columns
// and 64 rows, with its swizzle; rows past N read as zeros
template <int HD>
bool make_map(CUtensorMap* map, const void* base, int B, int N, int cols) {
  using T = Tile<HD>;
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(cols) * 2 * N};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(T::BOXW), kRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = T::ROW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : T::ROW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Persistent blocks, one per SM (at most one per (head, image)), each
// walking the (head, image) items.
template <typename K, typename... A>
int launch(K kern, size_t smem, int B, int H, cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  const int blocks = B * H < sms ? B * H : sms;
  kern<<<blocks, kThreads, smem, stream>>>(args..., B * H);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int fwd(const void* qkv, void* out, int B, int N, int H, float scale, cudaStream_t stream) {
  using T = Tile<HD>;
  CUtensorMap in;
  if (!make_map<HD>(&in, qkv, B, N, 3 * H * HD)) return -2;
  // the last key tile holds at most 8 keys (and the keys are resident)
  const bool short_last = N <= kResident * kRows && (N - 1) % kRows < 8;
  return launch(short_last ? attn_fwd_kernel<HD, true> : attn_fwd_kernel<HD, false>,
                smem_bytes(fwd_stages<HD>(), T::BYTES, T::BYTES), B,
                H, stream, in, static_cast<bf16*>(out), N, H, scale);
}

template <int HD>
int bwd_rows(const void* qkv, const void* dout, void* stats, void* dqkv, int B, int N, int H,
             float scale, cudaStream_t stream) {
  using T = Tile<HD>;
  CUtensorMap in, d;
  if (!make_map<HD>(&in, qkv, B, N, 3 * H * HD) || !make_map<HD>(&d, dout, B, N, H * HD))
    return -2;
  return launch(attn_bwd_rows_kernel<HD>,
                smem_bytes(bwd_stages<HD>(), 2 * T::BYTES, 2 * T::BYTES),
                B, H, stream, in, d, static_cast<bf16*>(dqkv), static_cast<float*>(stats), N, H,
                scale);
}

template <int HD>
int bwd_cols(const void* qkv, const void* dout, const void* stats, void* dqkv, int B, int N,
             int H, float scale, cudaStream_t stream) {
  using T = Tile<HD>;
  CUtensorMap in, d;
  if (!make_map<HD>(&in, qkv, B, N, 3 * H * HD) || !make_map<HD>(&d, dout, B, N, H * HD))
    return -2;
  return launch(attn_bwd_cols_kernel<HD>,
                smem_bytes(bwd_stages<HD>(), 2 * T::BYTES + 1024, 2 * T::BYTES),
                B, H, stream, in, d, static_cast<bf16*>(dqkv), static_cast<const float*>(stats), N,
                H, scale);
}

bool takes(int B, int N, int H) { return B >= 1 && N >= 1 && H >= 1 && int64_t{B} * H < (1 << 30); }

}  // namespace

// Head widths built: every multiple of 16 up to 128.
#define ATT_HEAD_WIDTHS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

extern "C" {

// o [B, N, H * hd] from qkv [B, N, 3 * H * hd], bf16.
int attention_fwd(const void* qkv, void* out, int B, int N, int H, int hd, float scale,
                  void* stream) {
  if (!takes(B, N, H)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CASE(W) if (hd == W) return fwd<W>(qkv, out, B, N, H, scale, st);
  ATT_HEAD_WIDTHS(CASE)
#undef CASE
  return -1;
}

// The dq pass: the dq third of dqkv [B, N, 3 * H * hd] and stats, f32
// [B, H, ceil(N / 64), 3, 64] (per query row: max * c, 1 / sum, delta), which the
// dk/dv pass reads.
int attention_bwd_rows(const void* qkv, const void* dout, void* stats, void* dqkv, int B, int N,
                       int H, int hd, float scale, void* stream) {
  if (!takes(B, N, H)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CASE(W) if (hd == W) return bwd_rows<W>(qkv, dout, stats, dqkv, B, N, H, scale, st);
  ATT_HEAD_WIDTHS(CASE)
#undef CASE
  return -1;
}

// The dk/dv pass: the dk and dv thirds of dqkv, from the dq pass's stats.
int attention_bwd_cols(const void* qkv, const void* dout, const void* stats, void* dqkv, int B,
                       int N, int H, int hd, float scale, void* stream) {
  if (!takes(B, N, H)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CASE(W) if (hd == W) return bwd_cols<W>(qkv, dout, stats, dqkv, B, N, H, scale, st);
  ATT_HEAD_WIDTHS(CASE)
#undef CASE
  return -1;
}

}  // extern "C"
