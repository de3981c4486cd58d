// Fused ConvNeXt block tail for Hopper (sm_90a): the forward
//   y = r + keep * gamma * (gelu_tanh(LN(s) @ W1 + b1) @ W2 + b2)
// and its input-only backward ds (dr = dy is passed through by the caller).
//
// Replaces the TPU kernels of revisiting_at_tpu/ops/block_mlp.py:
//   fwd_kernel               <- _fwd_kernel        (forward)
//   bwd_kernel<..., false>   <- _bwd_input_kernel  (ds only, gamma folded into W2)
// The full backward (_bwd_kernel) is in block_mlp_bwd.cu.
//
// What bounds them on the H100, and the design (TMA rings of weight chunks,
// warpgroup MMAs from swizzled shared tiles, GELU in registers, named
// barriers instead of __syncthreads), are in block_mlp_common.cuh, which
// holds the device code both libraries share. At every width built the
// forward runs fwd_kernel below, one ring item per product: chunk j of
// W1^T (h = u W1c, K-major B) then of W2 (o += g W2c, MN-major B), with the
// g chunk through a swizzled shared tile and o in registers until the
// epilogue adds b2, keep * gamma and the residual; at C = 432, 512 and 768
// in clusters of two blocks, at 1024 in clusters of four, each block
// holding its part of C (432 padded to 512, 16 and 32 to 64). On the H100,
// 64-row tiles at C = 384 measured 8-13% faster than 32-row ones there.
// Rows past M (the ragged edge, 49 * B at stage 3) are zero-filled on load
// and masked on store.
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after its launch, -1 for a width or plan it was not built for, -2 when
// cuTensorMapEncodeTiled fails, -3 when the card cannot hold a cluster of
// the plan.

#include "block_mlp_common.cuh"

namespace {

// The forward. Ring items: chunk j of W1^T (2 j) and of W2 (2 j + 1). In a
// cluster (C = 432, 512, 768: two blocks; 1024: four) each block holds CB =
// CP / CL of the padded columns: its part of u, of every W1^T and W2 chunk
// and of o; the blocks exchange their partial h over their parts of C, and
// each forms g for its N1 / CL of a warpgroup's chunk columns into every
// block's g tile (block_mlp_common.cuh: xch_send, xch_add); its ring order
// is below.
template <int C, typename T>
__global__ void __launch_bounds__(Plan<C, kFwd>::THREADS, 1)
fwd_kernel(const __grid_constant__ CUtensorMap w1t_map, const __grid_constant__ CUtensorMap w2_map,
           const T* __restrict__ s, const T* __restrict__ r, const float* __restrict__ keep,
           int rows_per_keep, const float* __restrict__ ln_g, const float* __restrict__ ln_b,
           const float* __restrict__ b1, const float* __restrict__ b2,
           const float* __restrict__ gamma, T* __restrict__ y, int64_t M) {
  using P = Plan<C, kFwd>;
  extern __shared__ unsigned char smem_raw[];
  const TailSmem<P> sm(smem_raw);
  const uint32_t rank = block_rank<P>();
  const int c0 = P::CB * rank;  // the block's first column of C
  ring_init(sm);
  if (threadIdx.x >= 128 * P::NWG) {
    produce<P, P::CL == 1 ? 0 : 1>(sm, &w1t_map, &w2_map, c0);
    block_end<P>();
    return;
  }
  setmaxnreg_inc<P::CREGS>();
  // the warpgroup, uniform to the compiler (see bwd_kernel)
  const int w = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  const int rt = w / P::G, cg = w % P::G;
  const int64_t row0 = (static_cast<int64_t>(blockIdx.x / P::CL) * P::R + rt) * 64;
  const int bar = 1 + rt, bar_n = 128 * P::G;
  unsigned char* u = sm.u + rt * P::TILE;
  unsigned char* gt = sm.g + rt * 2 * kBox;

  ln_rows<C, P, T, false>(s, ln_g, ln_b, nullptr, keep, rows_per_keep, row0, M, cg, rank, u,
                          nullptr, nullptr, nullptr);
  fence_proxy_async();
  named_bar_sync(bar, bar_n);

  float acc[P::CW / 2];
  zero(acc);
  if constexpr (P::CL == 1) {
    for (int j = 0; j < P::NCH; ++j) {
      const int ia = 2 * j, ib = 2 * j + 1;
      float h[P::N1 / 2];
      zero(h);
      fence_acc(h);
      wgmma_fence();
      ring_wait(sm, ia);
      const unsigned char* wa = sm.ring + (ia % P::S) * P::TILE + cg * P::N1 * 128;
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) wgmma_ss<P::N1, 0>(h, kdesc(u, kk), kdesc(wa, kk));
      wgmma_commit();
      wgmma_wait<0>();  // h and the previous chunk's o
      fence_acc(h);
      fence_acc(acc);
      ring_release(sm, ia);
      if (j > 0) ring_release(sm, ib - 2);
      // g = bf16(gelu(h + b1)) into this chunk's tile
      unsigned char* g_s = gt + (j & 1) * kBox;
#pragma unroll
      for (int i = 0; i < P::N1 / 2; i += 2) {
        const int c = cg * P::N1 + acc_col(i);
        const float2 bb = load2(b1 + 64 * j + c);
        *reinterpret_cast<uint32_t*>(g_s + swz(acc_row(i), c)) =
            pack_bf16(gelu_tanh(h[i] + bb.x), gelu_tanh(h[i + 1] + bb.y));
      }
      fence_proxy_async();
      named_bar_sync(bar, bar_n);
      // o += g @ W2c: the W2 stage as an MN-major B, this warpgroup's columns
      ring_wait(sm, ib);
      const unsigned char* wb = sm.ring + (ib % P::S) * P::TILE + (cg * P::CW / 64) * kBox;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss<P::CW, 1>(acc, kdesc(g_s, kk), mndesc(wb, kk));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc(acc);
    ring_release(sm, 2 * P::NCH - 1);
  } else {
    // The cluster, software-pipelined by one chunk: chunk j + 1's h runs on
    // the tensor cores while chunk j's partial h crosses the cluster and
    // its GELU runs; then chunk j's o. The producer keeps W1^T one chunk
    // ahead of W2 (produce<P, 1>): W1^T chunk c is ring item w1_item(c), W2
    // chunk c item w2_item(c). Per chunk: the blocks' partial h of this
    // block's columns summed in rank order, g = bf16(gelu(h + b1)) of them
    // into every block's g tile, o += g W2c.
    auto w1_item = [](int c) { return c ? 2 * c - 1 : 0; };
    auto w2_item = [](int c) { return c < P::NCH - 1 ? 2 * c + 2 : 2 * P::NCH - 1; };
    auto issue_h = [&](int c, float (&d)[P::N1 / 2]) {
      zero(d);
      fence_acc(d);
      wgmma_fence();
      const int it = w1_item(c);
      ring_wait(sm, it);
      const unsigned char* wa = sm.ring + (it % P::S) * P::TILE + cg * P::N1 * 128;
#pragma unroll
      for (int kk = 0; kk < P::CB / 16; ++kk) wgmma_ss<P::N1, 0>(d, kdesc(u, kk), kdesc(wa, kk));
      wgmma_commit();
    };
    // NEXT: whether chunk j + 1 exists, known at compile time (ptxas
    // serialises every wgmma of a kernel that issues one under a run-time
    // condition)
    auto step = [&](auto next, int j, float (&hc)[P::N1 / 2], float (&hn)[P::N1 / 2]) {
      constexpr bool NEXT = decltype(next)::value;
      if constexpr (NEXT) issue_h(j + 1, hn);
      unsigned char* g_s = gt + (j & 1) * kBox;
      float hs[P::NK];
      expect_peer(sm.xfull, P::XCH_BYTES);
      mbar_wait_cluster(sm.xfull, j & 1);
      xch_add(sm, hc, 0, rank, hs);
      const TilePeers<P> g_peers(g_s, &sm.gfull[j & 1], rank);
#pragma unroll
      for (int i = 0; i < P::NK; i += 2) {
        const int c = cg * P::N1 + P::N1 / P::CL * rank + acc_col(i);
        const float2 bb = load2(b1 + 64 * j + c);
        const uint32_t gp = pack_bf16(gelu_tanh(hs[i] + bb.x), gelu_tanh(hs[i + 1] + bb.y));
        const uint32_t off = swz(acc_row(i), c);
        *reinterpret_cast<uint32_t*>(g_s + off) = gp;
        g_peers.send(off, gp);
      }
      // a proxy fence after this thread's writes to its own tile, and one
      // after the wait for the peers' writes, before the wgmma reads them
      fence_proxy_async();
      arrive_tile<P>(&sm.gfull[j & 1]);
      mbar_wait_cluster(&sm.gfull[j & 1], (j >> 1) & 1);
      fence_proxy_async();
      const int it = w2_item(j);
      ring_wait(sm, it);
      const unsigned char* wb = sm.ring + (it % P::S) * P::TILE + (cg * P::CW / 64) * kBox;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss<P::CW, 1>(acc, kdesc(g_s, kk), mndesc(wb, kk));
      wgmma_commit();
      if constexpr (NEXT) {
        wgmma_wait<1>();  // chunk j + 1's h: its partial to the peers
        fence_acc(hn);
        ring_release(sm, w1_item(j + 1));
        xch_send(sm, hn, 0, rank);
      }
      wgmma_wait<0>();  // o
      fence_acc(acc);
      ring_release(sm, it);
    };
    float ha[P::N1 / 2], hb[P::N1 / 2];
    issue_h(0, ha);
    wgmma_wait<0>();
    fence_acc(ha);
    ring_release(sm, w1_item(0));
    xch_send(sm, ha, 0, rank);
    // chunks in pairs (ha, hb), then the last one or two (C = 432: 27)
    for (int j = 0; j + 2 < P::NCH; j += 2) {
      step(std::true_type{}, j, ha, hb);
      step(std::true_type{}, j + 1, hb, ha);
    }
    if constexpr (P::NCH % 2 == 0) {
      step(std::true_type{}, P::NCH - 2, ha, hb);
      step(std::false_type{}, P::NCH - 1, hb, ha);
    } else {
      step(std::false_type{}, P::NCH - 1, ha, hb);
    }
  }

  // y = r + keep * gamma * (o + b2), a pair of columns at a time
#pragma unroll
  for (int i = 0; i < P::CW / 2; i += 2) {
    const int64_t row = row0 + acc_row(i);
    const int col = c0 + cg * P::CW + acc_col(i);
    if (row < M && in_c<C>(col)) {  // a pair of channels (C is even), not of the pad
      const float kp = keep_of(keep, rows_per_keep, row);
      const float2 rv = load2(r + row * C + col);
      const float2 bv = load2(b2 + col);
      const float2 gv = load2(gamma + col);
      store2(y + row * C + col, rv.x + kp * gv.x * (acc[i] + bv.x),
             rv.y + kp * gv.y * (acc[i + 1] + bv.y));
    }
  }
  block_end<P>();
}

// The forward at width C: w1 is W1^T [4C, C].
template <int C, typename T>
int launch_fwd(const PlanArgs& plan, const void* s, const void* r, const float* keep,
               int rows_per_keep, const float* ln_g, const float* ln_b, const bf16* w1t,
               const float* b1, const bf16* w2, const float* b2, const float* gamma, void* y,
               int64_t M, cudaStream_t stream) {
  using P = Plan<C, kFwd>;
  if (!plan_ok<C, kFwd>(plan)) return -1;
  CUtensorMap a, b;
  if (!make_map(&a, w1t, 4 * C, C) || !make_map(&b, w2, 4 * C, C)) return -2;
  return launch_plan<P>(fwd_kernel<C, T>, M, stream, a, b, static_cast<const T*>(s),
                        static_cast<const T*>(r), keep, rows_per_keep, ln_g, ln_b, b1, b2, gamma,
                        static_cast<T*>(y), M);
}

}  // namespace

extern "C" {

int block_mlp_supports(int C) {
#define CASE(W) if (C == W) return 1;
  BLOCK_MLP_WIDTHS(CASE)
#undef CASE
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (for s, r, y). keep may be null (all
// ones). w1 is W1^T [4C, C]; the plan (rows, chunk, threads, split, smem,
// cluster, padded) must be the one built for C.
int block_mlp_fwd(int C, int dtype, const void* s, const void* r, const void* keep,
                  int rows_per_keep, const void* ln_g, const void* ln_b, const void* w1,
                  const void* b1, const void* w2, const void* b2, const void* gamma, void* y,
                  int64_t M, int rows, int chunk, int threads, int split, int smem,
                  int cluster, int padded, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PlanArgs plan{rows, chunk, threads, split, smem, cluster, padded};
#define CASE(W)                                                                              \
  if (C == W)                                                                                \
    return dtype == 0                                                                        \
        ? launch_fwd<W, float>(plan, s, r, (const float*)keep, rows_per_keep,               \
                               (const float*)ln_g, (const float*)ln_b, (const bf16*)w1,     \
                               (const float*)b1, (const bf16*)w2, (const float*)b2,         \
                               (const float*)gamma, y, M, st)                               \
        : launch_fwd<W, bf16>(plan, s, r, (const float*)keep, rows_per_keep,                \
                              (const float*)ln_g, (const float*)ln_b, (const bf16*)w1,      \
                              (const float*)b1, (const bf16*)w2, (const float*)b2,          \
                              (const float*)gamma, y, M, st);
  BLOCK_MLP_WIDTHS(CASE)
#undef CASE
  return -1;
}

// dtype as above, for s, dy, ds. w2g = bf16(W2 * gamma); w1 and the plan as
// for block_mlp_fwd.
int block_mlp_bwd_input(int C, int dtype, const void* s, const void* keep, int rows_per_keep,
                        const void* ln_g, const void* ln_b, const void* w1, const void* b1,
                        const void* w2g, const void* dy, void* ds, int64_t M, int rows,
                        int chunk, int threads, int split, int smem, int cluster,
                        int padded, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PlanArgs plan{rows, chunk, threads, split, smem, cluster, padded};
  const FullOut none{};
#define CASE(W)                                                                              \
  if (C == W)                                                                                \
    return dtype == 0                                                                        \
        ? launch_bwd<W, float, false>(plan, s, (const float*)keep, rows_per_keep,           \
                                      (const float*)ln_g, (const float*)ln_b,               \
                                      (const bf16*)w1, (const float*)b1, (const bf16*)w2g,  \
                                      dy, ds, M, M, none, st)                               \
        : launch_bwd<W, bf16, false>(plan, s, (const float*)keep, rows_per_keep,            \
                                     (const float*)ln_g, (const float*)ln_b,                \
                                     (const bf16*)w1, (const float*)b1, (const bf16*)w2g,   \
                                     dy, ds, M, M, none, st);
  BLOCK_MLP_WIDTHS(CASE)
#undef CASE
  return -1;
}

// The thread-block clusters of the bf16 forward (mode 0) or input backward
// (mode 1) at width C that the card holds at a time
// (cudaOccupancyMaxActiveClusters; 0: not one); -1 where the plan has no
// clusters or for a width or mode not built; minus the CUDA error where
// the query fails.
int block_mlp_max_clusters(int C, int mode) {
#define CASE(W)                                                                              \
  if (C == W)                                                                                \
    return mode == 0   ? clusters_of<W, kFwd>(fwd_kernel<W, bf16>)                         \
           : mode == 1 ? clusters_of<W, kBwdInput>(bwd_kernel<W, bf16, false>)               \
                       : -1;
  BLOCK_MLP_WIDTHS(CASE)
#undef CASE
  return -1;
}

}  // extern "C"
