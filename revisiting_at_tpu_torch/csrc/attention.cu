// Fused multi-head self-attention for Hopper (sm_90a), straight from the
// qkv Dense output of a ViT block:
//   o[b, n, g*64 + c] = sum_m p[b, g, n, m] * v[b, m, g, c],
//   p = softmax_m(q[b, n, g, :] . k[b, m, g, :] * 64^-0.5)
// with head g's q, k and v read in place as the column slices [g*64, g*64 +
// 64) of qkv [B, N, 3D], offset by 0, D and 2D (row stride 3D, no
// transposes), and the backward writing one dqkv [B, N, 3D] at the same
// offsets.
//
// Replaces the TPU kernels of revisiting_at_tpu/ops/attention.py:
//   attn_fwd_kernel                            <- _fwd_qkv_kernel (forward)
//   attn_bwd_rows_kernel, attn_bwd_cols_kernel <- _bwd_qkv_kernel (dqkv)
// They also serve `_fwd_kernel`/`_bwd_kernel` of the [B*H, N, hd] layout,
// whose wrapper in ops/attention.py packs q, k, v into [B, N, 3D].
//
// Numerics follow the TPU kernels: bf16 operands, f32 accumulation; s is
// the f32 product times the scale (0.125, exact); keys past N get -1e30 and
// rows past N are zero-filled before use; p = e / sum(e), e = exp(s - max),
// in f32, cast to bf16 before PV. Backward: dv = p16^T dO, dp = dO v^T,
// dS = p * (dp - rowsum(dp * p)) with the f32 p, ds16 = bf16(dS * scale),
// dq = ds16 k, dk = ds16^T q.
//
// What bounds it on the H100: at ViT-S (N = 197, hd = 64, batch 80) the
// forward does 4*B*H*N^2*hd = 4.8 GFLOP against 48 MB of qkv and o: the
// bytes bound it (14.5 us at 3.35 TB/s against 4.8 us of tensor-core
// time), and the backward likewise (85 MB, 25 us). The TPU kernel holds a
// whole [npad, npad] score matrix per head in VMEM; here a block owns a
// tile of 64 query rows of one head of one image and keeps that tile's f32
// scores for every key (64 x 448 at most, 115 KB) in shared memory, so the
// softmax is taken over the whole row at once and p is rounded to bf16
// after normalising, where JAX rounds it (an online-softmax rescale would
// round elsewhere). Each of the 4 warps owns 16 rows; the products are
// WMMA 16x16x16 bf16 fragments from shared-memory tiles of 64 keys, loaded
// with 16-byte reads and zero-filled past N.
//
// The backward has no float atomics, so dqkv is the same bits every run:
//   attn_bwd_rows_kernel, per (query tile, head, image): the scores and the
//     softmax as in the forward, delta = rowsum(dp * p) over every key
//     tile, then dS and dq = ds16 k; it writes dq and, per query row, the
//     max, the sum and delta into a small f32 side buffer [B, H, 3, Npad];
//   attn_bwd_cols_kernel, per (key tile, head, image): loops over the query
//     tiles, recomputes s (the same fragments in the same order as the row
//     kernel, so the same bits) and p from the stored max and sum, dp and
//     dS, and accumulates dv = p16^T dO and dk = ds16^T q in registers.
// The side buffer and the recomputed products are this design's own cost.
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after its launch, or -1 for a token count it does not take (1..448).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kHd = 64;                 // head width
constexpr int kTile = 64;               // query rows or keys per tile
constexpr int kWarps = 4;               // each warp owns 16 rows of a tile
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTiles = 7;            // N <= 448
constexpr int kLd = kHd + 8;            // bf16 [64][64] tile row stride
constexpr int kLdF = kTile + 4;         // f32 [16][64] per-warp scratch row stride
constexpr int kTileElems = kTile * kLd;
constexpr int kScratch = 16 * kLdF;     // floats per warp scratch
constexpr float kScale = 0.125f;        // 64^-0.5
constexpr float kNegInf = -1e30f;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BCol;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Rows [row0, row0 + 64) of a 64-column slice of a [N, ld] bf16 array into a
// [64][kLd] shared tile, 16 bytes per thread and step; rows past N are 0.
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src, int64_t ld, int N,
                                          int row0, bf16* dst) {
  for (int i = threadIdx.x; i < kTile * 8; i += kThreads) {
    const int r = i / 8, c8 = (i % 8) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < N) v = *reinterpret_cast<const uint4*>(src + (row0 + r) * ld + c8);
    *reinterpret_cast<uint4*>(dst + r * kLd + c8) = v;
  }
}

// A warp's 16 x 64 f32 scratch (row stride kLdF) to rows [row0, row0 + 16)
// of a 64-column slice of a [N, ld] bf16 array, as bf16; rows past N are
// not written.
__device__ __forceinline__ void store_rows(const float* scr, bf16* __restrict__ dst,
                                           int64_t ld, int N, int row0) {
  const int lane = threadIdx.x % 32;
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = i / 8, c8 = (i % 8) * 8;
    if (row0 + r >= N) continue;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(scr[r * kLdF + c8 + e]);
    *reinterpret_cast<uint4*>(dst + (row0 + r) * ld + c8) = *reinterpret_cast<uint4*>(v);
  }
}

// acc[j] = this warp's 16 rows of `a` (a [64][kLd] tile) times the 16 rows
// j*16.. of `bt` transposed: 16 x 64 products of 64-deep dot products.
__device__ __forceinline__ void rows_times_tile_t(const bf16* a, const bf16* bt, AccFrag* acc) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int k = 0; k < kHd; k += 16) {
    ARow fa;
    wmma::load_matrix_sync(fa, a + warp * 16 * kLd + k, kLd);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      BCol fb;  // B(k, n) = bt[n][k]
      wmma::load_matrix_sync(fb, bt + j * 16 * kLd + k, kLd);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

template <int NT>
constexpr size_t fwd_smem_bytes() {
  return 2 * kTileElems * sizeof(bf16) + kTile * (NT * kTile + 4) * sizeof(float);
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int H) {
  constexpr int LDS = NT * kTile + 4;  // f32 score row stride; bf16 p16 rows are 2 * LDS
  constexpr int VPL = NT * kTile / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = q_s + kTileElems;
  float* s_s = reinterpret_cast<float*>(kv_s + kTileElems);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kTile, g = blockIdx.y, b = blockIdx.z;
  const int D = H * kHd;
  const int64_t ld = 3 * static_cast<int64_t>(D);
  const bf16* base = qkv + static_cast<int64_t>(b) * N * ld;

  load_tile(base + g * kHd, ld, N, q0, q_s);
  // s = q k^T * scale for every key, one tile of 64 keys at a time
  for (int t = 0; t < NT; ++t) {
    __syncthreads();  // kv_s is free
    load_tile(base + D + g * kHd, ld, N, t * kTile, kv_s);
    __syncthreads();
    AccFrag acc[4];
    rows_times_tile_t(q_s, kv_s, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < acc[j].num_elements; ++e) acc[j].x[e] *= kScale;
      wmma::store_matrix_sync(s_s + warp * 16 * LDS + t * kTile + 16 * j, acc[j], LDS,
                              wmma::mem_row_major);
    }
  }
  __syncwarp();
  // softmax of this warp's rows over all keys; p16 overwrites each f32 row
  // from its start once the whole row is in registers
  for (int rr = 0; rr < 16; ++rr) {
    float* srow = s_s + (warp * 16 + rr) * LDS;
    float v[VPL];
    float m = kNegInf;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < N ? srow[c] : kNegInf;
      m = fmaxf(m, v[i]);
    }
    m = warp_max(m);
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) { v[i] = expf(v[i] - m); sum += v[i]; }
    sum = warp_sum(sum);
    __syncwarp();
    bf16* prow = reinterpret_cast<bf16*>(srow);
#pragma unroll
    for (int i = 0; i < VPL; ++i) prow[lane + 32 * i] = __float2bfloat16(v[i] / sum);
    __syncwarp();
  }
  // o = p16 v, accumulated over the key tiles
  const bf16* p16 = reinterpret_cast<const bf16*>(s_s);
  AccFrag o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(o[j], 0.0f);
  for (int t = 0; t < NT; ++t) {
    __syncthreads();
    load_tile(base + 2 * D + g * kHd, ld, N, t * kTile, kv_s);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTile; k += 16) {
      ARow fa;
      wmma::load_matrix_sync(fa, p16 + warp * 16 * (2 * LDS) + t * kTile + k, 2 * LDS);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        BRow fb;
        wmma::load_matrix_sync(fb, kv_s + k * kLd + 16 * j, kLd);
        wmma::mma_sync(o[j], fa, fb, o[j]);
      }
    }
  }
  __syncwarp();
  // the warp's own score rows are free now: stage o there as f32
  float* scr = s_s + warp * 16 * LDS;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(scr + 16 * j, o[j], LDS, wmma::mem_row_major);
  __syncwarp();
  bf16* orow = out + static_cast<int64_t>(b) * N * D + g * kHd;
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = i / 8, c8 = (i % 8) * 8, q = q0 + warp * 16 + r;
    if (q >= N) continue;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(scr[r * LDS + c8 + e]);
    *reinterpret_cast<uint4*>(orow + static_cast<int64_t>(q) * D + c8) =
        *reinterpret_cast<uint4*>(v);
  }
}

template <int NT>
constexpr size_t bwd_rows_smem_bytes() {
  return 4 * kTileElems * sizeof(bf16) + kTile * (NT * kTile + 4) * sizeof(float) +
         kWarps * kScratch * sizeof(float) + kWarps * 16 * kLd * sizeof(bf16);
}

// dq and the per-row statistics (max, sum, delta) of one query tile.
template <int NT>
__global__ void __launch_bounds__(kThreads)
attn_bwd_rows_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                     float* __restrict__ stats, bf16* __restrict__ dqkv, int N, int H) {
  constexpr int LDS = NT * kTile + 4;
  constexpr int VPL = NT * kTile / 32;
  constexpr int NP = NT * kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kTileElems;
  bf16* k_s = do_s + kTileElems;
  bf16* v_s = k_s + kTileElems;
  float* p_s = reinterpret_cast<float*>(v_s + kTileElems);  // f32 p, [64][LDS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* dp_s = p_s + kTile * LDS + warp * kScratch;       // this warp's [16][kLdF]
  bf16* ds_s = reinterpret_cast<bf16*>(p_s + kTile * LDS + kWarps * kScratch) + warp * 16 * kLd;
  const int q0 = blockIdx.x * kTile, g = blockIdx.y, b = blockIdx.z;
  const int D = H * kHd;
  const int64_t ld = 3 * static_cast<int64_t>(D);
  const bf16* base = qkv + static_cast<int64_t>(b) * N * ld;
  float* st = stats + (static_cast<int64_t>(b) * H + g) * 3 * NP;

  load_tile(base + g * kHd, ld, N, q0, q_s);
  load_tile(dout + static_cast<int64_t>(b) * N * D + g * kHd, D, N, q0, do_s);
  for (int t = 0; t < NT; ++t) {
    __syncthreads();
    load_tile(base + D + g * kHd, ld, N, t * kTile, k_s);
    __syncthreads();
    AccFrag acc[4];
    rows_times_tile_t(q_s, k_s, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < acc[j].num_elements; ++e) acc[j].x[e] *= kScale;
      wmma::store_matrix_sync(p_s + warp * 16 * LDS + t * kTile + 16 * j, acc[j], LDS,
                              wmma::mem_row_major);
    }
  }
  __syncwarp();
  // p in f32, in place; max and sum to the side buffer
  for (int rr = 0; rr < 16; ++rr) {
    float* prow = p_s + (warp * 16 + rr) * LDS;
    float v[VPL];
    float m = kNegInf;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < N ? prow[c] : kNegInf;
      m = fmaxf(m, v[i]);
    }
    m = warp_max(m);
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) { v[i] = expf(v[i] - m); sum += v[i]; }
    sum = warp_sum(sum);
#pragma unroll
    for (int i = 0; i < VPL; ++i) prow[lane + 32 * i] = v[i] / sum;
    if (lane == 0) {
      st[q0 + warp * 16 + rr] = m;
      st[NP + q0 + warp * 16 + rr] = sum;
    }
  }
  __syncwarp();
  // delta = rowsum(dp * p): lanes 2r and 2r + 1 hold row r, 32 columns each
  const int r = lane / 2, half = (lane % 2) * 32;
  const float* prow = p_s + (warp * 16 + r) * LDS;
  float delta = 0.0f;
  for (int t = 0; t < NT; ++t) {
    __syncthreads();
    load_tile(base + 2 * D + g * kHd, ld, N, t * kTile, v_s);
    __syncthreads();
    AccFrag acc[4];
    rows_times_tile_t(do_s, v_s, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(dp_s + 16 * j, acc[j], kLdF, wmma::mem_row_major);
    __syncwarp();
    float part = 0.0f;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) part += dp_s[r * kLdF + half + c] * prow[t * kTile + half + c];
    delta += part + __shfl_xor_sync(0xffffffffu, part, 1);
    __syncwarp();
  }
  if (lane % 2 == 0) st[2 * NP + q0 + warp * 16 + r] = delta;
  // dS = p * (dp - delta), ds16 = bf16(dS * scale), dq += ds16 k per key tile
  AccFrag dq[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(dq[j], 0.0f);
  for (int t = 0; t < NT; ++t) {
    __syncthreads();
    load_tile(base + D + g * kHd, ld, N, t * kTile, k_s);
    load_tile(base + 2 * D + g * kHd, ld, N, t * kTile, v_s);
    __syncthreads();
    AccFrag acc[4];
    rows_times_tile_t(do_s, v_s, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(dp_s + 16 * j, acc[j], kLdF, wmma::mem_row_major);
    __syncwarp();
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float p = prow[t * kTile + half + c];
      const float ds = p * (dp_s[r * kLdF + half + c] - delta);
      ds_s[r * kLd + half + c] = __float2bfloat16(ds * kScale);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kTile; k += 16) {
      ARow fa;
      wmma::load_matrix_sync(fa, ds_s + k, kLd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        BRow fb;
        wmma::load_matrix_sync(fb, k_s + k * kLd + 16 * j, kLd);
        wmma::mma_sync(dq[j], fa, fb, dq[j]);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(dp_s + 16 * j, dq[j], kLdF, wmma::mem_row_major);
  __syncwarp();
  store_rows(dp_s, dqkv + static_cast<int64_t>(b) * N * ld + g * kHd, ld, N, q0 + warp * 16);
}

constexpr size_t bwd_cols_smem_bytes() {
  return 6 * kTileElems * sizeof(bf16) + 2 * kWarps * kScratch * sizeof(float) +
         3 * kTile * sizeof(float);
}

// dk and dv of one key tile, over every query tile.
__global__ void __launch_bounds__(kThreads)
attn_bwd_cols_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                     const float* __restrict__ stats, bf16* __restrict__ dqkv, int N, int H,
                     int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kTileElems;
  bf16* q_s = v_s + kTileElems;
  bf16* do_s = q_s + kTileElems;
  bf16* p16_s = do_s + kTileElems;  // [64 queries][64 keys]
  bf16* ds16_s = p16_s + kTileElems;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* s_w = reinterpret_cast<float*>(ds16_s + kTileElems) + warp * kScratch;
  float* dp_w = s_w + kWarps * kScratch;
  float* st_s = reinterpret_cast<float*>(ds16_s + kTileElems) + 2 * kWarps * kScratch;
  const int k0 = blockIdx.x * kTile, g = blockIdx.y, b = blockIdx.z;
  const int D = H * kHd, NP = n_tiles * kTile;
  const int64_t ld = 3 * static_cast<int64_t>(D);
  const bf16* base = qkv + static_cast<int64_t>(b) * N * ld;
  const float* st = stats + (static_cast<int64_t>(b) * H + g) * 3 * NP;

  load_tile(base + D + g * kHd, ld, N, k0, k_s);
  load_tile(base + 2 * D + g * kHd, ld, N, k0, v_s);
  AccFrag dk[4], dv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) { wmma::fill_fragment(dk[j], 0.0f); wmma::fill_fragment(dv[j], 0.0f); }
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kTile;
    __syncthreads();
    load_tile(base + g * kHd, ld, N, q0, q_s);
    load_tile(dout + static_cast<int64_t>(b) * N * D + g * kHd, D, N, q0, do_s);
    for (int i = threadIdx.x; i < 3 * kTile; i += kThreads)
      st_s[i] = st[(i / kTile) * NP + q0 + i % kTile];
    __syncthreads();
    // this warp's 16 query rows against the 64 keys: s as in the row kernel, and dp
    AccFrag acc[4];
    rows_times_tile_t(q_s, k_s, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < acc[j].num_elements; ++e) acc[j].x[e] *= kScale;
      wmma::store_matrix_sync(s_w + 16 * j, acc[j], kLdF, wmma::mem_row_major);
    }
    rows_times_tile_t(do_s, v_s, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(dp_w + 16 * j, acc[j], kLdF, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * kTile; i += 32) {
      const int r = i / kTile, c = i % kTile, rq = warp * 16 + r;
      float p = 0.0f, ds = 0.0f;
      if (q0 + rq < N && k0 + c < N) {
        p = expf(s_w[r * kLdF + c] - st_s[rq]) / st_s[kTile + rq];
        ds = p * (dp_w[r * kLdF + c] - st_s[2 * kTile + rq]);
      }
      p16_s[rq * kLd + c] = __float2bfloat16(p);
      ds16_s[rq * kLd + c] = __float2bfloat16(ds * kScale);
    }
    __syncthreads();
    // this warp's 16 keys: dv += p16^T dO, dk += ds16^T q over the 64 queries
#pragma unroll
    for (int kq = 0; kq < kTile; kq += 16) {
      ACol fp, fds;  // A(key, query) = p16_s[query][key]
      wmma::load_matrix_sync(fp, p16_s + kq * kLd + warp * 16, kLd);
      wmma::load_matrix_sync(fds, ds16_s + kq * kLd + warp * 16, kLd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        BRow fdo, fq;
        wmma::load_matrix_sync(fdo, do_s + kq * kLd + 16 * j, kLd);
        wmma::mma_sync(dv[j], fp, fdo, dv[j]);
        wmma::load_matrix_sync(fq, q_s + kq * kLd + 16 * j, kLd);
        wmma::mma_sync(dk[j], fds, fq, dk[j]);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::store_matrix_sync(s_w + 16 * j, dk[j], kLdF, wmma::mem_row_major);
    wmma::store_matrix_sync(dp_w + 16 * j, dv[j], kLdF, wmma::mem_row_major);
  }
  __syncwarp();
  bf16* drow = dqkv + static_cast<int64_t>(b) * N * ld + g * kHd;
  store_rows(s_w, drow + D, ld, N, k0 + warp * 16);
  store_rows(dp_w, drow + 2 * D, ld, N, k0 + warp * 16);
}

template <int NT>
int launch_fwd(const bf16* qkv, bf16* out, int B, int N, int H, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<NT>();
  auto kern = attn_fwd_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(NT, H, B), kThreads, smem, stream>>>(qkv, out, N, H);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_bwd_rows(const bf16* qkv, const bf16* dout, float* stats, bf16* dqkv, int B, int N,
                    int H, cudaStream_t stream) {
  constexpr size_t smem = bwd_rows_smem_bytes<NT>();
  auto kern = attn_bwd_rows_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(NT, H, B), kThreads, smem, stream>>>(qkv, dout, stats, dqkv, N, H);
  return static_cast<int>(cudaGetLastError());
}

int tiles_of(int N) { return (N + kTile - 1) / kTile; }

}  // namespace

extern "C" {

int attention_fwd(const void* qkv, void* out, int B, int N, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  switch (N < 1 ? 0 : tiles_of(N)) {
    case 1: return launch_fwd<1>(x, o, B, N, H, st);
    case 2: return launch_fwd<2>(x, o, B, N, H, st);
    case 3: return launch_fwd<3>(x, o, B, N, H, st);
    case 4: return launch_fwd<4>(x, o, B, N, H, st);
    case 5: return launch_fwd<5>(x, o, B, N, H, st);
    case 6: return launch_fwd<6>(x, o, B, N, H, st);
    case 7: return launch_fwd<7>(x, o, B, N, H, st);
    default: return -1;
  }
}

// stats: f32 [B, H, 3, 64 * ceil(N / 64)], written here, read by the column pass.
int attention_bwd_rows(const void* qkv, const void* dout, void* stats, void* dqkv, int B, int N,
                       int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(qkv);
  const bf16* d = static_cast<const bf16*>(dout);
  float* s = static_cast<float*>(stats);
  bf16* dx = static_cast<bf16*>(dqkv);
  switch (N < 1 ? 0 : tiles_of(N)) {
    case 1: return launch_bwd_rows<1>(x, d, s, dx, B, N, H, st);
    case 2: return launch_bwd_rows<2>(x, d, s, dx, B, N, H, st);
    case 3: return launch_bwd_rows<3>(x, d, s, dx, B, N, H, st);
    case 4: return launch_bwd_rows<4>(x, d, s, dx, B, N, H, st);
    case 5: return launch_bwd_rows<5>(x, d, s, dx, B, N, H, st);
    case 6: return launch_bwd_rows<6>(x, d, s, dx, B, N, H, st);
    case 7: return launch_bwd_rows<7>(x, d, s, dx, B, N, H, st);
    default: return -1;
  }
}

int attention_bwd_cols(const void* qkv, const void* dout, void* stats, void* dqkv, int B, int N,
                       int H, void* stream) {
  if (N < 1 || tiles_of(N) > kMaxTiles) return -1;
  constexpr size_t smem = bwd_cols_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_cols_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = tiles_of(N);
  attn_bwd_cols_kernel<<<dim3(n_tiles, H, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<const float*>(stats), static_cast<bf16*>(dqkv), N, H, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
