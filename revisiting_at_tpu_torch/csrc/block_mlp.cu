// Fused ConvNeXt block tail for Hopper (sm_90a):
//   y = r + keep * gamma * (gelu_tanh(LN(s) @ W1 + b1) @ W2 + b2)
// and its input-only backward ds (dr = dy is passed through by the caller).
//
// Replaces the TPU kernels of revisiting_at_tpu/ops/block_mlp.py:
//   fwd_kernel        <- _fwd_kernel        (forward)
//   bwd_input_kernel  <- _bwd_input_kernel  (ds only, gamma folded into W2)
//
// What bounds it on the H100: per row the forward does 16*C^2 flops against
// about 6*C bytes of activation traffic, so from stage 0 (C = 96) on it is
// bound by the tensor cores, not by HBM. The TPU kernel keeps W1 and W2
// resident in VMEM; a Hopper block has 227 KB of shared memory and the bf16
// weights of stage 3 are 9.4 MB, so they cannot be resident.
//
// Design: each block owns BM rows. It normalises them once (f32 statistics,
// eps 1e-6) into a bf16 tile in shared memory and then streams the 4C axis
// in chunks of BH columns. Per chunk, every warp computes one 16-wide column
// tile of h = u16 @ W1[:, chunk] for all BM rows, the block applies b1 and
// GELU in shared memory (f32, then bf16), and every warp accumulates
// o += g16 @ W2[chunk, its columns] into WMMA accumulators in registers.
// The [M, 4C] activation never reaches device memory. The weights are read
// as WMMA fragments straight from global memory: they are small enough to
// stay in L2, and every block reuses each fragment for all of its BM rows.
// Per-C tiles (Cfg below) keep the register accumulator at <= 12 fragments
// per warp, which is what makes C = 768 fit. On the H100, 64-row tiles at
// C = 384 measured 8-13% faster than 32-row ones, and unrolling the k loops
// gained nothing. Rows past M (the ragged edge, 49 * B at stage 3) are
// zero-filled on load and masked on store.
// The backward runs the same loop with two more products (dg = kdy16 @ w2g^T
// and du += dh16 @ W1^T) and finishes with the LayerNorm backward, whose row
// means are reduced across warps through shared-memory atomics.
//
// Numerics follow the TPU kernel: bf16 operands with f32 accumulation,
// u16 = bf16(LN(s)), g16 = bf16(gelu(h)), kdy16 = bf16(keep * dy),
// dh16 = bf16(dg * gelu'(h)); GELU is the tanh form.
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after its launch (or -1 for a width it was not built for).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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
  static constexpr int NW = (NT % 8 == 0) ? 8 : 6;    // warps per block
  static constexpr int NTHREADS = NW * 32;
  static constexpr int BM = C <= 384 ? 64 : (C <= 768 ? 32 : 16);  // rows per block
  static constexpr int MT = BM / 16;                  // 16-row tiles per block
  static constexpr int BH = 16 * NW;                  // 4C chunk: one tile per warp
  static constexpr int CPW = NT / NW;                 // C column tiles per warp
  static constexpr int VPL = C / 32;                  // values per lane in a row
  static constexpr int LDU = C + 8;                   // bf16 [BM][C] row stride
  static constexpr int LDH = BH + 4;                  // f32 [BM][BH] row stride
  static constexpr int LDG = BH + 8;                  // bf16 [BM][BH] row stride
  static_assert(C % 32 == 0, "C must be a multiple of 32");
  static_assert(NT % NW == 0, "column tiles must split evenly over warps");
  static_assert(H % BH == 0, "4C must split into whole chunks");
};

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

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

__device__ __forceinline__ float keep_of(const float* keep, int rows_per_keep, int64_t row) {
  return keep ? keep[row / rows_per_keep] : 1.0f;
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> AFrag;
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
      for (int i = 0; i < K::VPL; ++i) urow[lane + 32 * i] = __float2bfloat16(0.0f);
      if (lane == 0 && mean_out) { mean_out[rr] = 0.0f; inv_out[rr] = 0.0f; }
      continue;
    }
    const T* srow = s + row * C;
    float v[K::VPL];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < K::VPL; ++i) { v[i] = to_f32(srow[lane + 32 * i]); sum += v[i]; }
    const float mu = warp_sum(sum) / C;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < K::VPL; ++i) { float d = v[i] - mu; sq += d * d; }
    const float inv = rsqrtf(warp_sum(sq) / C + kEps);
#pragma unroll
    for (int i = 0; i < K::VPL; ++i) {
      const int c = lane + 32 * i;
      urow[c] = __float2bfloat16((v[i] - mu) * inv * ln_g[c] + ln_b[c]);
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

template <int C>
constexpr size_t bwd_smem_bytes() {
  using K = Cfg<C>;
  return 2 * align128(K::BM * K::LDU * 2) + 2 * align128(K::BM * K::LDH * 4) +
         align128(K::BM * K::LDG * 2) + align128(K::NW * 256 * 4) + align128(4 * K::BM * 4);
}

template <int C, typename T>
__global__ void __launch_bounds__(Cfg<C>::NTHREADS)
bwd_input_kernel(const T* __restrict__ s, const float* __restrict__ keep, int rows_per_keep,
                 const float* __restrict__ ln_g, const float* __restrict__ ln_b,
                 const bf16* __restrict__ w1, const float* __restrict__ b1,
                 const bf16* __restrict__ w2g, const T* __restrict__ dy,
                 T* __restrict__ ds, int64_t M) {
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
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * K::BM;

  layer_norm_rows<C, T>(s, ln_g, ln_b, row0, M, u16, mean, inv);
  for (int i = threadIdx.x; i < K::BM * C; i += K::NTHREADS) {
    const int rr = i / C, c = i % C;
    const int64_t row = row0 + rr;
    const float v = row < M ? keep_of(keep, rows_per_keep, row) * to_f32(dy[row * C + c]) : 0.0f;
    kdy16[rr * K::LDU + c] = __float2bfloat16(v);
  }
  for (int i = threadIdx.x; i < K::BM; i += K::NTHREADS) { sum1[i] = 0.0f; sum2[i] = 0.0f; }
  __syncthreads();

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
    for (int i = threadIdx.x; i < K::BM * K::BH; i += K::NTHREADS) {
      const int rr = i / K::BH, cc = i % K::BH;
      const float h = hbuf[rr * K::LDH + cc] + b1[h0 + cc];
      dh16[rr * K::LDG + cc] = __float2bfloat16(dgbuf[rr * K::LDH + cc] * dgelu_tanh(h));
    }
    __syncthreads();
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

  // LayerNorm backward: ds = inv * (dxh - mean(dxh) - xhat * mean(dxh * xhat)),
  // dxh = du * ln_g. Pass 1 reduces the row sums, pass 2 writes ds.
  float* scr = scratch + warp * 256;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) __syncthreads();
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
            // lanes 0-15 hold one row, lanes 16-31 the next: reduce over 16 lanes
            float p1 = dxh, p2 = dxh * xhat;
#pragma unroll
            for (int o = 8; o > 0; o >>= 1) {
              p1 += __shfl_xor_sync(0xffffffffu, p1, o);
              p2 += __shfl_xor_sync(0xffffffffu, p2, o);
            }
            if (cc == 0) { atomicAdd(sum1 + rr, p1); atomicAdd(sum2 + rr, p2); }
          } else if (live) {
            const float m1 = sum1[rr] / C, m2 = sum2[rr] / C;
            ds[row * C + col] = from_f32<T>(inv[rr] * (dxh - m1 - xhat * m2));
          }
        }
        __syncwarp();
      }
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

template <int C, typename T>
int launch_bwd_input(const void* s, const float* keep, int rows_per_keep, const float* ln_g,
                     const float* ln_b, const bf16* w1, const float* b1, const bf16* w2g,
                     const void* dy, void* ds, int64_t M, cudaStream_t stream) {
  using K = Cfg<C>;
  constexpr size_t smem = bwd_smem_bytes<C>();
  auto kern = bwd_input_kernel<C, T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((M + K::BM - 1) / K::BM);
  kern<<<grid, K::NTHREADS, smem, stream>>>(
      static_cast<const T*>(s), keep, rows_per_keep, ln_g, ln_b, w1, b1, w2g,
      static_cast<const T*>(dy), static_cast<T*>(ds), M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Channel widths built: every ConvNeXt stage width the input-mode gate admits
// (T/S: 96-768, B: 128-1024, L: 192-768).
#define BLOCK_MLP_WIDTHS(X) X(96) X(128) X(192) X(256) X(384) X(512) X(768) X(1024)

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
#define CASE(W)                                                                              \
  if (C == W)                                                                                \
    return dtype == 0                                                                        \
        ? launch_bwd_input<W, float>(s, (const float*)keep, rows_per_keep,                  \
                                     (const float*)ln_g, (const float*)ln_b,                \
                                     (const bf16*)w1, (const float*)b1, (const bf16*)w2g,   \
                                     dy, ds, M, st)                                          \
        : launch_bwd_input<W, bf16>(s, (const float*)keep, rows_per_keep,                   \
                                    (const float*)ln_g, (const float*)ln_b, (const bf16*)w1, \
                                    (const float*)b1, (const bf16*)w2g, dy, ds, M, st);
  BLOCK_MLP_WIDTHS(CASE)
#undef CASE
  return -1;
}

}  // extern "C"
