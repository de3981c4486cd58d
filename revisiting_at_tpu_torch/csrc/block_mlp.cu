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
// holds the device code both libraries share. At C = 96, 128, 192, 256 and
// 384 the forward runs fwd_kernel below, one ring item per product: chunk
// j of W1^T (h = u W1c, K-major B) then of W2 (o += g W2c, MN-major B),
// with the g chunk through a swizzled shared tile and o in registers until
// the epilogue adds b2, keep * gamma and the residual. The other widths
// keep the WMMA kernels (fwd_kernel_wmma, bwd_kernel_wmma): on the H100,
// 64-row tiles at C = 384 measured 8-13% faster than 32-row ones there, and
// unrolling its k loops gained nothing. Rows past M (the ragged edge, 49 *
// B at stage 3) are zero-filled on load and masked on store.
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after its launch, -1 for a width or plan it was not built for, -2 when
// cuTensorMapEncodeTiled fails.

#include "block_mlp_common.cuh"

namespace {

template <int C, typename T>
__global__ void __launch_bounds__(Cfg<C>::NTHREADS)
fwd_kernel_wmma(const T* __restrict__ s, const T* __restrict__ r, const float* __restrict__ keep,
           int rows_per_keep, const float* __restrict__ ln_g, const float* __restrict__ ln_b,
           const bf16* __restrict__ w1, const float* __restrict__ b1,
           const bf16* __restrict__ w2, const float* __restrict__ b2,
           const float* __restrict__ gamma, T* __restrict__ y, int64_t M) {
  using K = Cfg<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* u16 = reinterpret_cast<bf16*>(smem);
  float* hbuf = reinterpret_cast<float*>(smem + align128(K::BM * K::LDU * 2));
  bf16* g16 = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(hbuf) +
                                      align128(K::BM * K::LDH * 4));
  float* scratch = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(g16) +
                                            align128(K::BM * K::LDG * 2));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * K::BM;

  layer_norm_rows<C, T>(s, ln_g, ln_b, row0, M, u16, nullptr, nullptr);
  __syncthreads();

  AccFrag acc[K::MT][K::CPW];
#pragma unroll
  for (int mi = 0; mi < K::MT; ++mi)
#pragma unroll
    for (int ci = 0; ci < K::CPW; ++ci) wmma::fill_fragment(acc[mi][ci], 0.0f);

  for (int h0 = 0; h0 < K::H; h0 += K::BH) {
    // h[:, this warp's 16 columns] = u16 @ W1[:, h0 + 16 * warp ...]
    AccFrag hf[K::MT];
#pragma unroll
    for (int mi = 0; mi < K::MT; ++mi) wmma::fill_fragment(hf[mi], 0.0f);
    for (int k = 0; k < C; k += 16) {
      BRowFrag b;
      wmma::load_matrix_sync(b, w1 + static_cast<size_t>(k) * K::H + h0 + 16 * warp, K::H);
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
    __syncthreads();
    for (int i = threadIdx.x; i < K::BM * K::BH; i += K::NTHREADS) {
      const int rr = i / K::BH, cc = i % K::BH;
      g16[rr * K::LDG + cc] = __float2bfloat16(gelu_tanh(hbuf[rr * K::LDH + cc] + b1[h0 + cc]));
    }
    __syncthreads();
    // o[:, this warp's columns] += g16 @ W2[h0 ..., columns]
#pragma unroll
    for (int k = 0; k < K::BH; k += 16) {
      AFrag a[K::MT];
#pragma unroll
      for (int mi = 0; mi < K::MT; ++mi)
        wmma::load_matrix_sync(a[mi], g16 + mi * 16 * K::LDG + k, K::LDG);
#pragma unroll
      for (int ci = 0; ci < K::CPW; ++ci) {
        BRowFrag b;
        wmma::load_matrix_sync(b, w2 + static_cast<size_t>(h0 + k) * C + (warp * K::CPW + ci) * 16, C);
#pragma unroll
        for (int mi = 0; mi < K::MT; ++mi) wmma::mma_sync(acc[mi][ci], a[mi], b, acc[mi][ci]);
      }
    }
  }

  // epilogue: y = r + keep * gamma * (o + b2), one 16x16 tile at a time
  float* scr = scratch + warp * 256;
#pragma unroll
  for (int mi = 0; mi < K::MT; ++mi) {
#pragma unroll
    for (int ci = 0; ci < K::CPW; ++ci) {
      wmma::store_matrix_sync(scr, acc[mi][ci], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = lane + 32 * e, rr = idx / 16, cc = idx % 16;
        const int64_t row = row0 + mi * 16 + rr;
        const int col = (warp * K::CPW + ci) * 16 + cc;
        if (row < M) {
          const float o = scr[idx] + b2[col];
          const float kg = keep_of(keep, rows_per_keep, row) * gamma[col];
          y[row * C + col] = from_f32<T>(to_f32(r[row * C + col]) + kg * o);
        }
      }
      __syncwarp();
    }
  }
}

template <int C, typename T>
int launch_fwd_wmma(const void* s, const void* r, const float* keep, int rows_per_keep,
               const float* ln_g, const float* ln_b, const bf16* w1, const float* b1,
               const bf16* w2, const float* b2, const float* gamma, void* y, int64_t M,
               cudaStream_t stream) {
  using K = Cfg<C>;
  constexpr size_t smem = fwd_smem_bytes<C>();
  auto kern = fwd_kernel_wmma<C, T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((M + K::BM - 1) / K::BM);
  kern<<<grid, K::NTHREADS, smem, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(r), keep, rows_per_keep, ln_g, ln_b, w1,
      b1, w2, b2, gamma, static_cast<T*>(y), M);
  return static_cast<int>(cudaGetLastError());
}

// The forward at the kWgmma widths. Ring items: chunk j of W1^T (2 j) and
// of W2 (2 j + 1).
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
  ring_init(sm);
  if (threadIdx.x >= 128 * P::NWG) {
    produce(sm, &w1t_map, &w2_map);
    return;
  }
  setmaxnreg_inc<P::CREGS>();
  // the warpgroup, uniform to the compiler (see bwd_kernel)
  const int w = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  const int rt = w / P::G, cg = w % P::G;
  const int64_t row0 = (static_cast<int64_t>(blockIdx.x) * P::R + rt) * 64;
  const int bar = 1 + rt, bar_n = 128 * P::G;
  unsigned char* u = sm.u + rt * P::TILE;
  unsigned char* gt = sm.g + rt * 2 * kBox;

  ln_rows<C, P, T, false>(s, ln_g, ln_b, nullptr, keep, rows_per_keep, row0, M, cg, u, nullptr,
                          nullptr, nullptr);
  fence_proxy_async();
  named_bar_sync(bar, bar_n);

  float acc[P::CW / 2];
  zero(acc);
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

  // y = r + keep * gamma * (o + b2), a pair of columns at a time
#pragma unroll
  for (int i = 0; i < P::CW / 2; i += 2) {
    const int64_t row = row0 + acc_row(i);
    const int col = cg * P::CW + acc_col(i);
    if (row < M) {
      const float kp = keep_of(keep, rows_per_keep, row);
      const float2 rv = load2(r + row * C + col);
      const float2 bv = load2(b2 + col);
      const float2 gv = load2(gamma + col);
      store2(y + row * C + col, rv.x + kp * gv.x * (acc[i] + bv.x),
             rv.y + kp * gv.y * (acc[i + 1] + bv.y));
    }
  }
}

template <int C, typename T>
int launch_fwd_wgmma(const void* s, const void* r, const float* keep, int rows_per_keep,
                     const float* ln_g, const float* ln_b, const bf16* w1t, const float* b1,
                     const bf16* w2, const float* b2, const float* gamma, void* y, int64_t M,
                     cudaStream_t stream) {
  using P = Plan<C, kFwd>;
  CUtensorMap a, b;
  if (!make_map(&a, w1t, 4 * C, C) || !make_map(&b, w2, 4 * C, C)) return -2;
  auto kern = fwd_kernel<C, T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((M + P::BM - 1) / P::BM);
  kern<<<grid, P::THREADS, P::SMEM, stream>>>(
      a, b, static_cast<const T*>(s), static_cast<const T*>(r), keep, rows_per_keep, ln_g, ln_b,
      b1, b2, gamma, static_cast<T*>(y), M);
  return static_cast<int>(cudaGetLastError());
}

// The forward at width C in the design built for it: w1 is W1^T [4C, C] for
// the kWgmma widths, W1 [C, 4C] for the others.
template <int C, typename T>
int launch_fwd(const PlanArgs& plan, const void* s, const void* r, const float* keep,
               int rows_per_keep, const float* ln_g, const float* ln_b, const bf16* w1,
               const float* b1, const bf16* w2, const float* b2, const float* gamma, void* y,
               int64_t M, cudaStream_t stream) {
  if (!plan_ok<C, kFwd>(plan)) return -1;
  if constexpr (kWgmma<C>)
    return launch_fwd_wgmma<C, T>(s, r, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2, gamma, y,
                                  M, stream);
  else
    return launch_fwd_wmma<C, T>(s, r, keep, rows_per_keep, ln_g, ln_b, w1, b1, w2, b2, gamma, y,
                                 M, stream);
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
// ones). w1 is W1^T [4C, C] at the kWgmma widths, W1 [C, 4C] at the others;
// the plan (rows, chunk, threads, split, smem) must be the one built for C.
int block_mlp_fwd(int C, int dtype, const void* s, const void* r, const void* keep,
                  int rows_per_keep, const void* ln_g, const void* ln_b, const void* w1,
                  const void* b1, const void* w2, const void* b2, const void* gamma, void* y,
                  int64_t M, int rows, int chunk, int threads, int split, int smem,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PlanArgs plan{rows, chunk, threads, split, smem};
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
                        int chunk, int threads, int split, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PlanArgs plan{rows, chunk, threads, split, smem};
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

}  // extern "C"
