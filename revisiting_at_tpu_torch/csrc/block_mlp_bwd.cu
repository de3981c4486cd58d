// Full backward of the fused ConvNeXt block tail for Hopper (sm_90a): every
// cotangent of y = r + keep * gamma * (gelu_tanh(LN(s) @ W1 + b1) @ W2 + b2)
// that the TPU kernel computes, with gamma folded into w2g = bf16(W2 * gamma):
//   ds, dW1 = u16^T @ dh16, db1 = sum(dh), A = g16^T @ kdy16,
//   dln_g = sum(du * xhat), dln_b = sum(du).
// The caller recovers dW2 = A * gamma, db2 and dgamma from A, as the JAX
// wrapper does outside its kernel.
//
// Replaces the TPU kernel revisiting_at_tpu/ops/block_mlp.py _bwd_kernel, and
// with it the split pair _bwd_ds_kernel + _bwd_dw1_kernel (`split_bwd`), whose
// cotangents are the same.
//
// The TPU kernel runs its grid in order and accumulates dW1, A, db1 and dLN
// from one grid step to the next in VMEM. Blocks on Hopper run in parallel,
// so the sums over the M rows are reductions across blocks, done in passes:
//   1. bwd_kernel<C, T, true> (block_mlp_common.cuh: TMA + wgmma at every
//      width, at 432, 512 and 768 in clusters of two blocks, at 1024 in
//      clusters of four), the row pass: ds as the input backward computes
//      it, plus bf16 side outputs u16, kdy16, g16 and dh16 ([Mpad, C] and
//      [Mpad, 4C]) and column sums per 64-row tile of the f32 dh (db1,
//      summed before the bf16 cast as JAX does), of du * xhat and of du.
//   2. wgrad_kernel, the weight pass: f32 partials of X^T @ Y over slices of
//      the M rows, for dW1 (X = u16, Y = dh16) and A (X = g16, Y = kdy16).
//   3. reduce_kernel sums partials over their leading axis in a fixed order,
//      one launch a sum (the weight pass's in the same call that launches
//      the pass).
// No float atomics anywhere: ds and the weight cotangents are the same bits
// from run to run. Rows past M (padding to a multiple of 128) are written as
// zeros by the row pass, so they add nothing to any column sum or product.
//
// What bounds the weight pass on the H100: it must read its two bf16
// operands once from HBM, M * 5C * 2 bytes per product (240.8 MB at stage 0,
// batch 80), against 8 * M * C^2 flops: 72 us of bytes against 19 us of
// tensor cores at stage 0, so bytes, at every width. Its design:
//   * TMA (cp.async.bulk.tensor) loads 64-row slices of M of both operands,
//     in 64-column boxes with 128-byte swizzle, into a ring of 4 shared-memory
//     stages guarded by mbarriers; one producer warp keeps the ring full.
//   * Two consumer warpgroups run wgmma.mma_async (bf16 in, f32 accumulators
//     in registers) straight on the swizzled tiles: both operands MN-major,
//     as the side buffers lie. The [M, 4C] operand is wgmma's 64-row side
//     (one warpgroup per 64 columns of 4C, 128 per block) and the [M, C]
//     operand its N side, whole up to C = 256 (N padded to a multiple of 64
//     by TMA's zero fill past C), else in chunks of at most 256, so both
//     products take one template; dW1's epilogue writes the tile transposed.
//   * The wide operand is read once; the narrow one is re-read by each block
//     of the same M slice, and those blocks have adjacent indices and run in
//     the same wave, so the re-reads hit L2.
//   * The M axis is cut into at most 64 slices, chosen from the shapes alone
//     (ops/block_mlp.py wgrad_plan): one wave of as many blocks as keep HBM
//     busy (84 of the 132 SMs, measured) or as the tensor work needs where
//     that is more (C >= 384: all 132). reduce_kernel then sums the
//     partials, launched in the same call as the pass.
// 288 threads (two warpgroups and the producer warp) leave each thread 224
// registers, enough for a 64 x 256 f32 accumulator, so no setmaxnreg. At
// stage 2 (C = 384) the pass is near both of its limits: 18.7 us of
// tensor-core time against 18 us of bytes.
// The side buffers themselves are the two-pass design's cost (2 * 5C bf16
// values per row, written once by the row pass and read once here): the
// TPU kernel accumulates dW1 and A in VMEM inside its row loop.
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after its launch (or -1 for a shape it was not built for, -2 when
// cuTensorMapEncodeTiled fails).

#include <cooperative_groups.h>

#include "block_mlp_common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWRows = 64;        // rows of M per ring stage: the TMA box depth
constexpr int kWBox = 64;         // box width: 64 bf16, one 128-byte swizzled row
constexpr int kWStages = 4;       // ring depth
constexpr int kWTileP = 128;      // columns of the wide operand per block: 2 x 64
constexpr int kWConsumers = 256;  // two warpgroups
constexpr int kWThreads = kWConsumers + 32;  // and the producer warp
constexpr uint32_t kBoxBytes = kWBox * kWRows * 2;  // 8 KB

template <int NCH>  // columns of the narrow operand per block: 128, 192 or 256
struct WCfg {
  static constexpr int NB = NCH / kWBox;  // narrow boxes per stage
  static constexpr uint32_t STAGE = (2 + NB) * kBoxBytes;
  // the ring, its barriers, and slack to align the ring to 1024 bytes
  static constexpr size_t SMEM = kWStages * STAGE + 2 * kWStages * 8 + 1024;
};

// Block b: slice b / tiles of M, tile b % tiles; tile t covers columns
// [128 * (t / n_chunks), + 128) of the wide operand (P of them) and
// [NCH * (t % n_chunks), + NCH) of the narrow one (C of them). It writes
// part[slice] of the f32 partials [n_split, P, C], or [n_split, C, P] when
// `transposed`, over rows [slice * rows_per_split, + rows_per_split) of M.
template <int NCH>
__global__ void __launch_bounds__(kWThreads, 1)
wgrad_kernel(const __grid_constant__ CUtensorMap wide, const __grid_constant__ CUtensorMap narrow,
             int P, int C, int n_chunks, int64_t Mpad, int64_t rows_per_split, int transposed,
             float* __restrict__ part) {
  using W = WCfg<NCH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWStages * W::STAGE);
  uint64_t* empty = full + kWStages;

  const int tiles = ((P + kWTileP - 1) / kWTileP) * n_chunks;
  const int split = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int p0 = (tile / n_chunks) * kWTileP, q0 = (tile % n_chunks) * NCH;
  const int64_t m_begin = split * rows_per_split;
  const int64_t m_end = m_begin + rows_per_split < Mpad ? m_begin + rows_per_split : Mpad;
  const int n_k = static_cast<int>((m_end - m_begin) / kWRows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kWStages; ++st) {
      mbar_init(&full[st], 1);                   // the producer's arrive with its bytes
      mbar_init(&empty[st], kWConsumers / 32);   // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWConsumers / 32) {
    // producer: one thread keeps the ring full; boxes wholly past P or C
    // are not loaded (their columns are never stored)
    if (lane == 0) {
      int n_wide = 0, n_narrow = 0;
      for (int w = 0; w < 2; ++w) n_wide += p0 + w * kWBox < P;
      for (int j = 0; j < W::NB; ++j) n_narrow += q0 + j * kWBox < C;
      const uint32_t bytes = (n_wide + n_narrow) * kBoxBytes;
      for (int kb = 0; kb < n_k; ++kb) {
        const int st = kb % kWStages, round = kb / kWStages;
        if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
        unsigned char* stage = ring + st * W::STAGE;
        const int m = static_cast<int>(m_begin + kb * kWRows);
        mbar_arrive_expect_tx(&full[st], bytes);
        for (int w = 0; w < n_wide; ++w)
          tma_load_2d(stage + w * kBoxBytes, &wide, &full[st], p0 + w * kWBox, m);
        for (int j = 0; j < n_narrow; ++j)
          tma_load_2d(stage + (2 + j) * kBoxBytes, &narrow, &full[st], q0 + j * kWBox, m);
      }
    }
    return;
  }

  // consumers: warpgroup g owns wide columns p0 + 64 g .. + 64
  const int g = warp / 4;
  float acc[NCH / 2];
#pragma unroll
  for (int i = 0; i < NCH / 2; ++i) acc[i] = 0.0f;
  for (int kb = 0; kb < n_k; ++kb) {
    const int st = kb % kWStages;
    mbar_wait(&full[st], (kb / kWStages) & 1);
    const unsigned char* stage = ring + st * W::STAGE;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kWRows / 16; ++k) {  // 16 rows of M = 2048 bytes of a box
      const uint64_t a = desc_mn_sw128(stage + g * kBoxBytes + k * 2048, kBoxBytes);
      const uint64_t b = desc_mn_sw128(stage + 2 * kBoxBytes + k * 2048, kBoxBytes);
      wgmma_bf16<NCH>(acc, a, b);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // acc[i]: wide column p, narrow column q of this warpgroup's 64 x NCH tile
  float* out = part + static_cast<size_t>(split) * P * C;
  const int wq = warp % 4;
#pragma unroll
  for (int i = 0; i < NCH / 2; i += 2) {
    const int p = p0 + g * 64 + wq * 16 + lane / 4 + 8 * ((i / 2) % 2);
    const int q = q0 + 8 * (i / 4) + 2 * (lane % 4);
    if (p < P && q < C) {
      if (transposed) {
        out[static_cast<size_t>(q) * P + p] = acc[i];
        out[static_cast<size_t>(q + 1) * P + p] = acc[i + 1];
      } else {
        *reinterpret_cast<float2*>(out + static_cast<size_t>(p) * C + q) =
            make_float2(acc[i], acc[i + 1]);
      }
    }
  }
}

// The column reduction: out[n] = sum over r of part[r, n] for f32 part [R,
// N], in one launch at any R, in an order fixed by the plan alone (no
// atomics), so two launches give the same bits. What bounds it on the
// H100: its bytes, read once (2-12 MB a call on the main path, 1-4 us at
// 3.35 TB/s), and the latency of the loads, since no call is large: the
// row pass's partials are tall and narrow (R = 245-3,920 rows of N =
// 96-1,536), the weight pass's short and wide (R = 5-28 slices of N up to
// 589,824). So a block of 256 threads takes a strip of `lanes` column
// lanes, each V = 4 consecutive columns wide (16-byte loads) where N
// allows, and its 256 / lanes row lanes take every (256 / lanes)-th row of
// the block's rows, with kRedBatch loads in flight a thread. Where the
// strips alone leave the card empty, the rows are split over the blocks of
// a thread-block cluster (`splits` of them, at most 8), which combine
// their strips' sums through distributed shared memory in rank order. The
// plan (lanes, splits, rows per split) comes from the shapes alone
// (ops/block_mlp.py reduce_plan). Order: each thread's rows ascending, the
// row lanes of a warp by a butterfly, the warps (or row lanes) in index
// order, the cluster's blocks in rank order.
constexpr int kRedThreads = 256;
constexpr int kRedBatch = 8;       // loads in flight per thread
constexpr int kRedMaxSplits = 8;   // blocks of a cluster: the portable maximum

__device__ __forceinline__ void vadd(float& a, float b) { a += b; }
__device__ __forceinline__ void vadd(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}
__device__ __forceinline__ float shfl_xor(float v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ float4 shfl_xor(float4 v, int o) {
  return make_float4(shfl_xor(v.x, o), shfl_xor(v.y, o), shfl_xor(v.z, o), shfl_xor(v.w, o));
}

// T: float4 (N a multiple of 4, part 16-byte aligned) or float. Block b:
// cluster rank `split` = b % splits sums rows [split * rows_per_split, +
// rows_per_split) of the strip b / splits, columns [strip * lanes * V, +
// lanes * V).
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
reduce_kernel(const float* __restrict__ part, int64_t R, int64_t N, int lanes, int splits,
              int64_t rows_per_split, float* __restrict__ out) {
  constexpr int V = sizeof(T) / sizeof(float);
  __shared__ T red[kRedThreads];
  __shared__ T strip_sum[kRedThreads];
  const int split = static_cast<int>(blockIdx.x % splits);
  const int64_t strip = blockIdx.x / splits;
  const int t = threadIdx.x, cl = t % lanes, rl = t / lanes, row_lanes = kRedThreads / lanes;
  const int64_t n = (strip * lanes + cl) * V;
  const int64_t r0 = split * rows_per_split;
  const int64_t r1 = r0 + rows_per_split < R ? r0 + rows_per_split : R;
  T acc{};
  if (n < N) {
    const T* col = reinterpret_cast<const T*>(part + n);
    const int64_t ld = N / V;  // a row, in T
    int64_t r = r0 + rl;
    for (; r + (kRedBatch - 1) * row_lanes < r1; r += kRedBatch * row_lanes) {
      T v[kRedBatch];
#pragma unroll
      for (int i = 0; i < kRedBatch; ++i) v[i] = __ldg(col + (r + i * row_lanes) * ld);
#pragma unroll
      for (int i = 0; i < kRedBatch; ++i) vadd(acc, v[i]);
    }
    for (; r < r1; r += row_lanes) vadd(acc, __ldg(col + r * ld));
  }
  // the row lanes within a warp (lanes < 32): lanes apart by `lanes`
  for (int o = lanes; o < 32; o <<= 1) vadd(acc, shfl_xor(acc, o));
  // one sum per group and column lane: the warps (lanes < 32) or the row lanes
  const int groups = lanes < 32 ? kRedThreads / 32 : row_lanes;
  if (lanes >= 32 || t % 32 < lanes) red[(lanes < 32 ? t / 32 : rl) * lanes + cl] = acc;
  __syncthreads();
  if (t < lanes) {
    T s = red[t];
    for (int g = 1; g < groups; ++g) vadd(s, red[g * lanes + t]);
    if (splits == 1) {
      if (n < N) *reinterpret_cast<T*>(out + n) = s;
    } else {
      strip_sum[t] = s;
    }
  }
  if (splits == 1) return;
  // the cluster's blocks: block `split` writes column lanes split, split +
  // splits, ..., each the sum of the blocks' strip sums in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int c = split + splits * t;  // splits * 256 > lanes: one lane a thread at most
  const int64_t nc = (strip * lanes + c) * V;
  if (c < lanes && nc < N) {
    T s = *cluster.map_shared_rank(&strip_sum[c], 0);
    for (int k = 1; k < splits; ++k) vadd(s, *cluster.map_shared_rank(&strip_sum[c], k));
    *reinterpret_cast<T*>(out + nc) = s;
  }
  cluster.sync();  // every block's strip sums stay until the cluster has read them
}

// Launch the reduction of part [R, N] into out [N] with the plan (lanes,
// splits, rows_per_split); -1 for a plan that does not cover the rows.
int launch_reduce(const float* part, int64_t R, int64_t N, int lanes, int splits,
                  int64_t rows_per_split, float* out, cudaStream_t stream) {
  if (R <= 0 || N <= 0 || lanes <= 0 || lanes > kRedThreads || kRedThreads % lanes != 0 ||
      splits <= 0 || splits > kRedMaxSplits || rows_per_split <= 0 ||
      (splits - 1) * rows_per_split >= R || splits * rows_per_split < R)
    return -1;
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(part) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t width = int64_t{lanes} * (vec ? 4 : 1);
  const int64_t blocks = (N + width - 1) / width * splits;
  if (blocks >= (int64_t{1} << 31)) return -1;
  if (splits == 1) {  // no cluster: a plain launch, which costs the host less
    if (vec)
      reduce_kernel<float4><<<static_cast<unsigned>(blocks), kRedThreads, 0, stream>>>(
          part, R, N, lanes, splits, rows_per_split, out);
    else
      reduce_kernel<float><<<static_cast<unsigned>(blocks), kRedThreads, 0, stream>>>(
          part, R, N, lanes, splits, rows_per_split, out);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kRedThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      vec ? cudaLaunchKernelEx(&cfg, reduce_kernel<float4>, part, R, N, lanes, splits,
                               rows_per_split, out)
          : cudaLaunchKernelEx(&cfg, reduce_kernel<float>, part, R, N, lanes, splits,
                               rows_per_split, out);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int NCH>
int launch_wgrad(const CUtensorMap& wide, const CUtensorMap& narrow, int P, int C, int n_chunks,
                 int64_t Mpad, int64_t rows_per_split, int n_split, int transposed, void* part,
                 cudaStream_t stream) {
  constexpr size_t smem = WCfg<NCH>::SMEM;
  auto kern = wgrad_kernel<NCH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((P + kWTileP - 1) / kWTileP) * n_chunks;
  kern<<<static_cast<unsigned>(tiles * n_split), kWThreads, smem, stream>>>(
      wide, narrow, P, C, n_chunks, Mpad, rows_per_split, transposed, static_cast<float*>(part));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The row pass. dtype: 0 = float32, 1 = bfloat16 (for s, dy, ds). keep may
// be null (all ones). Mpad is M rounded up to a multiple of kRowPad (128);
// u16, kdy16 are [Mpad, C], g16, dh16 [Mpad, 4C] (bf16); db1_part is
// [Mpad / part_rows, 4C], dlng_part and dlnb_part [Mpad / part_rows, C]
// (f32), part_rows being the plan's (64). w1 and the plan as for
// block_mlp_fwd (block_mlp.cu).
int block_mlp_bwd_full_rows(int C, int dtype, const void* s, const void* keep,
                            int rows_per_keep, const void* ln_g, const void* ln_b,
                            const void* w1, const void* b1, const void* w2g, const void* dy,
                            void* ds, int64_t M, int64_t Mpad, void* u16, void* kdy16,
                            void* g16, void* dh16, void* db1_part, void* dlng_part,
                            void* dlnb_part, int rows, int chunk, int threads, int split,
                            int smem, int cluster, int padded, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Mpad % kRowPad != 0 || Mpad < M) return -1;
  const PlanArgs plan{rows, chunk, threads, split, smem, cluster, padded};
  const FullOut out{static_cast<bf16*>(u16), static_cast<bf16*>(kdy16), static_cast<bf16*>(g16),
                    static_cast<bf16*>(dh16), static_cast<float*>(db1_part),
                    static_cast<float*>(dlng_part), static_cast<float*>(dlnb_part)};
#define CASE(W)                                                                              \
  if (C == W)                                                                                \
    return dtype == 0                                                                        \
        ? launch_bwd<W, float, true>(plan, s, (const float*)keep, rows_per_keep,            \
                                     (const float*)ln_g, (const float*)ln_b,                \
                                     (const bf16*)w1, (const float*)b1, (const bf16*)w2g,   \
                                     dy, ds, M, Mpad, out, st)                              \
        : launch_bwd<W, bf16, true>(plan, s, (const float*)keep, rows_per_keep,             \
                                    (const float*)ln_g, (const float*)ln_b,                 \
                                    (const bf16*)w1, (const float*)b1, (const bf16*)w2g,    \
                                    dy, ds, M, Mpad, out, st);
  BLOCK_MLP_WIDTHS(CASE)
#undef CASE
  return -1;
}

// The weight pass: part[n_split, P, Q] (f32), split k summing rows
// [k * rows_per_split, min(Mpad, (k + 1) * rows_per_split)) of
// x[Mpad, P]^T @ y[Mpad, Q] (bf16, row-major). One of P, Q is 4 times the
// other (C, a multiple of 8 from 16 to 1024: every width the row pass is
// built for); Mpad and rows_per_split are multiples of 64 and every split
// holds rows. When out is not null, reduce_kernel then sums the partials
// in split order into out[P, Q] (f32) with the plan (red_lanes,
// red_splits, red_rows) for [n_split, P * Q], in the same call: the
// wrapper's host work is one call for the whole product.
int block_mlp_wgrad(const void* x, int P, const void* y, int Q, int64_t Mpad,
                    int64_t rows_per_split, int n_split, void* part, void* out, int red_lanes,
                    int red_splits, int64_t red_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool x_wide = P == 4 * Q;
  if (!x_wide && Q != 4 * P) return -1;
  const int C = x_wide ? Q : P;
  if (C <= 0 || C % 8 != 0 || C > 1024 || Mpad % kWRows != 0 || rows_per_split <= 0 ||
      rows_per_split % kWRows != 0 || n_split <= 0 ||
      static_cast<int64_t>(n_split - 1) * rows_per_split >= Mpad ||
      static_cast<int64_t>(n_split) * rows_per_split < Mpad || Mpad >= (int64_t{1} << 31))
    return -1;
  // the narrow operand in n_chunks chunks of NCH columns, NCH a multiple of 64
  const int n_chunks = (C + 255) / 256;
  // (at least 128, the narrowest instantiation: below C = 128 the second box
  // is neither loaded nor stored)
  const int nch = max(128, ((C + n_chunks - 1) / n_chunks + kWBox - 1) / kWBox * kWBox);
  CUtensorMap wide, narrow;
  if (!make_map(&wide, x_wide ? x : y, Mpad, 4 * C) || !make_map(&narrow, x_wide ? y : x, Mpad, C))
    return -2;
  const int transposed = x_wide ? 0 : 1;  // dW1 = u16^T @ dh16 is [C, 4C]
  int err = -1;
#define LAUNCH(N)                                                                         \
  if (nch == N)                                                                           \
    err = launch_wgrad<N>(wide, narrow, 4 * C, C, n_chunks, Mpad, rows_per_split, n_split, \
                          transposed, part, st);
  LAUNCH(128) LAUNCH(192) LAUNCH(256)
#undef LAUNCH
  if (err != 0 || out == nullptr) return err;
  return launch_reduce(static_cast<const float*>(part), n_split, int64_t{P} * Q, red_lanes,
                       red_splits, red_rows, static_cast<float*>(out), st);
}

// The thread-block clusters of the bf16 row pass at width C that the card
// holds at a time, as block_mlp_max_clusters (block_mlp.cu) gives them.
int block_mlp_rows_max_clusters(int C) {
#define CASE(W) \
  if (C == W) return clusters_of<W, kBwdRows>(bwd_kernel<W, bf16, true>);
  BLOCK_MLP_WIDTHS(CASE)
#undef CASE
  return -1;
}

// out[N] = the sum of part[R, N] (f32) over R, in one launch with the plan
// (lanes, splits, rows_per_split) from ops/block_mlp.py reduce_plan.
int block_mlp_reduce(const void* part, int64_t R, int64_t N, int lanes, int splits,
                     int64_t rows_per_split, void* out, void* stream) {
  return launch_reduce(static_cast<const float*>(part), R, N, lanes, splits, rows_per_split,
                       static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}

}  // extern "C"
