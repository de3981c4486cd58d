// Shared device code of the fused ConvNeXt block tail for Hopper (sm_90a):
//   y = r + keep * gamma * (gelu_tanh(LN(s) @ W1 + b1) @ W2 + b2)
// block_mlp.cu instantiates the forward and the input-only backward,
// block_mlp_bwd.cu the full backward; each is built into its own library.
//
// Numerics follow the TPU kernels of revisiting_at_tpu/ops/block_mlp.py:
// bf16 operands with f32 accumulation, u16 = bf16(LN(s)), g16 =
// bf16(gelu(h)), kdy16 = bf16(keep * dy), dh16 = bf16(dg * gelu'(h)); GELU
// is the tanh form; LN statistics are f32, eps 1e-6.
//
// Row tiling: each block owns BM rows. It normalises them once into a bf16
// tile in shared memory and streams the 4C axis in chunks of BH columns. Per
// chunk every warp computes one 16-wide column tile of h = u16 @ W1[:, chunk]
// for all BM rows, the block applies b1 and GELU in shared memory, and every
// warp accumulates its C columns of the next product into WMMA accumulators
// in registers. The [M, 4C] activation never reaches device memory (except
// as the full backward's bf16 side outputs). Weights are read as WMMA
// fragments straight from global memory: they stay in L2, and every block
// reuses each fragment for all of its BM rows. Per-C tiles (Cfg) keep the
// register accumulator at <= 12 fragments per warp up to C = 768.
//
// Widths that are not a multiple of 32 (C = 432, convnext_iso's width with
// updated=1: 27 column tiles over 9 warps) leave the last lanes of a row
// without a channel; the row code masks them behind `if constexpr`, so the
// code built for the other widths is what it was.

#pragma once

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
// (a multiple of every BM and of the weight kernel's depth step).
constexpr int kRowPad = 64;

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
  float* db1_part;  // [Mpad / BM, 4C] per-block column sums of the f32 dh
  float* dlng_part; // [Mpad / BM, C]  per-block column sums of du * xhat
  float* dlnb_part; // [Mpad / BM, C]  per-block column sums of du
};

// Backward of the tail for BM rows: ds from dy, with w2g = bf16(W2 * gamma).
// FULL = false is the input-only backward (_bwd_input_kernel). FULL = true
// is the row pass of the full backward (_bwd_kernel): the same ds, bit for
// bit, plus the side outputs above. Every partial sum is taken in a fixed
// order, so the full backward is deterministic.
template <int C, typename T, bool FULL>
__global__ void __launch_bounds__(Cfg<C>::NTHREADS)
bwd_kernel(const T* __restrict__ s, const float* __restrict__ keep, int rows_per_keep,
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
int launch_bwd(const void* s, const float* keep, int rows_per_keep, const float* ln_g,
               const float* ln_b, const bf16* w1, const float* b1, const bf16* w2g,
               const void* dy, void* ds, int64_t M, int64_t rows, FullOut out,
               cudaStream_t stream) {
  using K = Cfg<C>;
  constexpr size_t smem = bwd_smem_bytes<C>();
  auto kern = bwd_kernel<C, T, FULL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((rows + K::BM - 1) / K::BM);
  kern<<<grid, K::NTHREADS, smem, stream>>>(
      static_cast<const T*>(s), keep, rows_per_keep, ln_g, ln_b, w1, b1, w2g,
      static_cast<const T*>(dy), static_cast<T*>(ds), M, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Channel widths built: every ConvNeXt stage width the gates admit
// (T/S: 96-768, B: 128-1024, L: 192-768), convnext_iso's 432, and the micro
// models' 16, 32, 64 (convnext_micro's stages 0-2, vit_micro's width 32).
#define BLOCK_MLP_WIDTHS(X) X(16) X(32) X(64) X(96) X(128) X(192) X(256) X(384) X(432) X(512) X(768) X(1024)
