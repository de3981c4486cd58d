// Fused ConvNeXt block tail for Hopper (sm_90a): the forward
//   y = r + keep * gamma * (gelu_tanh(LN(s) @ W1 + b1) @ W2 + b2)
// and its input-only backward ds (dr = dy is passed through by the caller).
//
// Replaces the TPU kernels of revisiting_at_tpu/ops/block_mlp.py:
//   fwd_kernel               <- _fwd_kernel        (forward)
//   bwd_kernel<..., false>   <- _bwd_input_kernel  (ds only, gamma folded into W2)
// The full backward (_bwd_kernel) is in block_mlp_bwd.cu; the device code
// both share, and the design of the row tiling, is in block_mlp_common.cuh.
//
// What bounds it on the H100: per row the forward does 16*C^2 flops against
// about 6*C bytes of activation traffic, so from stage 0 (C = 96) on it is
// bound by the tensor cores, not by HBM. The TPU kernel keeps W1 and W2
// resident in VMEM; a Hopper block has 227 KB of shared memory and the bf16
// weights of stage 3 are 9.4 MB, so they cannot be resident: the row tiling
// streams the 4C axis and reads weight fragments from L2. On the H100,
// 64-row tiles at C = 384 measured 8-13% faster than 32-row ones, and
// unrolling the k loops gained nothing. Rows past M (the ragged edge, 49 * B
// at stage 3) are zero-filled on load and masked on store.
// The input backward runs the same loop with two more products (dg = kdy16 @
// w2g^T and du += dh16 @ W1^T) and finishes with the LayerNorm backward,
// whose row means are summed per warp in shared memory, then over the warps
// in a fixed order, so ds is the same bits from run to run.
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after its launch (or -1 for a width it was not built for).

#include "block_mlp_common.cuh"

namespace {

template <int C>
constexpr size_t fwd_smem_bytes() {
  using K = Cfg<C>;
  return align128(K::BM * K::LDU * 2) + align128(K::BM * K::LDH * 4) +
         align128(K::BM * K::LDG * 2) + align128(K::NW * 256 * 4);
}

template <int C, typename T>
__global__ void __launch_bounds__(Cfg<C>::NTHREADS)
fwd_kernel(const T* __restrict__ s, const T* __restrict__ r, const float* __restrict__ keep,
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
int launch_fwd(const void* s, const void* r, const float* keep, int rows_per_keep,
               const float* ln_g, const float* ln_b, const bf16* w1, const float* b1,
               const bf16* w2, const float* b2, const float* gamma, void* y, int64_t M,
               cudaStream_t stream) {
  using K = Cfg<C>;
  constexpr size_t smem = fwd_smem_bytes<C>();
  auto kern = fwd_kernel<C, T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((M + K::BM - 1) / K::BM);
  kern<<<grid, K::NTHREADS, smem, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(r), keep, rows_per_keep, ln_g, ln_b, w1,
      b1, w2, b2, gamma, static_cast<T*>(y), M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int block_mlp_supports(int C) {
#define CASE(W) if (C == W) return 1;
  BLOCK_MLP_WIDTHS(CASE)
#undef CASE
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (for s, r, y). keep may be null (all ones).
int block_mlp_fwd(int C, int dtype, const void* s, const void* r, const void* keep,
                  int rows_per_keep, const void* ln_g, const void* ln_b, const void* w1,
                  const void* b1, const void* w2, const void* b2, const void* gamma, void* y,
                  int64_t M, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CASE(W)                                                                              \
  if (C == W)                                                                                \
    return dtype == 0                                                                        \
        ? launch_fwd<W, float>(s, r, (const float*)keep, rows_per_keep, (const float*)ln_g, \
                               (const float*)ln_b, (const bf16*)w1, (const float*)b1,       \
                               (const bf16*)w2, (const float*)b2, (const float*)gamma, y, M, \
                               st)                                                           \
        : launch_fwd<W, bf16>(s, r, (const float*)keep, rows_per_keep, (const float*)ln_g,  \
                              (const float*)ln_b, (const bf16*)w1, (const float*)b1,        \
                              (const bf16*)w2, (const float*)b2, (const float*)gamma, y, M, \
                              st);
  BLOCK_MLP_WIDTHS(CASE)
#undef CASE
  return -1;
}

// dtype as above, for s, dy, ds. w2g = bf16(W2 * gamma).
int block_mlp_bwd_input(int C, int dtype, const void* s, const void* keep, int rows_per_keep,
                        const void* ln_g, const void* ln_b, const void* w1, const void* b1,
                        const void* w2g, const void* dy, void* ds, int64_t M, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FullOut none{};
#define CASE(W)                                                                              \
  if (C == W)                                                                                \
    return dtype == 0                                                                        \
        ? launch_bwd<W, float, false>(s, (const float*)keep, rows_per_keep,                 \
                                      (const float*)ln_g, (const float*)ln_b,               \
                                      (const bf16*)w1, (const float*)b1, (const bf16*)w2g,  \
                                      dy, ds, M, M, none, st)                               \
        : launch_bwd<W, bf16, false>(s, (const float*)keep, rows_per_keep,                  \
                                     (const float*)ln_g, (const float*)ln_b,                \
                                     (const bf16*)w1, (const float*)b1, (const bf16*)w2g,   \
                                     dy, ds, M, M, none, st);
  BLOCK_MLP_WIDTHS(CASE)
#undef CASE
  return -1;
}

}  // extern "C"
