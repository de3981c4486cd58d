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
//   1. bwd_kernel<C, T, true> (block_mlp_common.cuh), the row pass: ds as the
//      input backward computes it, plus bf16 side outputs u16, kdy16, g16 and
//      dh16 ([Mpad, C] and [Mpad, 4C]) and per-block column sums of the f32 dh
//      (db1, summed before the bf16 cast as JAX does), of du * xhat and of du.
//   2. wgrad_kernel, the weight pass: out[P, Q] = X^T @ Y over the M rows with
//      bf16 operands and f32 accumulation, for dW1 (X = u16, Y = dh16) and A
//      (X = g16, Y = kdy16). Stage 0's dW1 is 96 x 384: without a split of M
//      the card would sit mostly idle, so each block sums a slice of M rows
//      for one output tile into its own f32 partial.
//   3. reduce_kernel sums partials over their leading axis in a fixed order.
// No float atomics anywhere: ds and the weight cotangents are the same bits
// from run to run. Rows past M (padding to a multiple of 64) are written as
// zeros by the row pass, so they add nothing to any column sum or product.
//
// What bounds it on the H100: 40 * M * C^2 flops (h, dg and du in the row
// pass, dW1 and A in the weight pass) against s, dy and ds, so the tensor
// cores, as for the forward. The side buffers are this design's cost: 2 * 4C
// bf16 values per row written once and read once (193 MB each at stage 0,
// batch 80). The weight pass stages 32-row slices of X and Y in shared
// memory with 16-byte loads and runs WMMA on them; it has no pipelining yet.
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after its launch (or -1 for a shape it was not built for).

#include "block_mlp_common.cuh"

namespace {

constexpr int kWThreads = 128;  // four warps, each a 32 x 32 output tile
constexpr int kWDepth = 32;     // rows of M per shared-memory stage

// out_part[split, P, Q] = X[m, p0:p0+TP]^T @ Y[m, q0:q0+TQ] over this split's
// rows m. X is [Mpad, P], Y is [Mpad, Q], both bf16 row-major.
template <int TP, int TQ>
__global__ void __launch_bounds__(kWThreads)
wgrad_kernel(const bf16* __restrict__ x, int P, const bf16* __restrict__ y, int Q,
             int64_t Mpad, int64_t rows_per_split, float* __restrict__ part) {
  constexpr int WQ = TQ / 32;
  static_assert((TP / 32) * WQ == 4, "four warps of 32 x 32");
  constexpr int LDX = TP + 8, LDY = TQ + 8;
  __shared__ __align__(128) bf16 xs[kWDepth * LDX];
  __shared__ __align__(128) bf16 ys[kWDepth * LDY];
  const int tiles_q = Q / TQ;
  const int p0 = (blockIdx.x / tiles_q) * TP, q0 = (blockIdx.x % tiles_q) * TQ;
  const int64_t m_begin = static_cast<int64_t>(blockIdx.y) * rows_per_split;
  const int64_t m_end = m_begin + rows_per_split < Mpad ? m_begin + rows_per_split : Mpad;
  const int warp = threadIdx.x / 32;
  const int wp = warp / WQ, wq = warp % WQ;

  AccFrag acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int64_t m0 = m_begin; m0 < m_end; m0 += kWDepth) {
    for (int v = threadIdx.x; v < kWDepth * (TP / 8); v += kWThreads) {
      const int r = v / (TP / 8), c8 = (v % (TP / 8)) * 8;
      *reinterpret_cast<uint4*>(xs + r * LDX + c8) =
          *reinterpret_cast<const uint4*>(x + (m0 + r) * P + p0 + c8);
    }
    for (int v = threadIdx.x; v < kWDepth * (TQ / 8); v += kWThreads) {
      const int r = v / (TQ / 8), c8 = (v % (TQ / 8)) * 8;
      *reinterpret_cast<uint4*>(ys + r * LDY + c8) =
          *reinterpret_cast<const uint4*>(y + (m0 + r) * Q + q0 + c8);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWDepth; k += 16) {
      AColFrag a[2];  // X^T[p, m] = xs[m * LDX + p]: column-major with ld LDX
      BRowFrag b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + k * LDX + wp * 32 + i * 16, LDX);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], ys + k * LDY + wq * 32 + j * 16, LDY);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + static_cast<size_t>(blockIdx.y) * P * Q;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          out + static_cast<size_t>(p0 + wp * 32 + i * 16) * Q + q0 + wq * 32 + j * 16,
          acc[i][j], Q, wmma::mem_row_major);
}

// out[g, n] = sum of part[r, n] over r in [g * G, min(R, (g + 1) * G)), in
// ascending r: one thread per column, consecutive threads on consecutive n.
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ part, int64_t R, int64_t N, int G,
              float* __restrict__ out) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (n >= N) return;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * G;
  const int64_t r1 = r0 + G < R ? r0 + G : R;
  float acc = 0.0f;
  for (int64_t r = r0; r < r1; ++r) acc += part[r * N + n];
  out[static_cast<int64_t>(blockIdx.y) * N + n] = acc;
}

template <int TP, int TQ>
int launch_wgrad(const void* x, int P, const void* y, int Q, int64_t Mpad,
                 int64_t rows_per_split, int n_split, void* part, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((P / TP) * (Q / TQ)), static_cast<unsigned>(n_split));
  wgrad_kernel<TP, TQ><<<grid, kWThreads, 0, stream>>>(
      static_cast<const bf16*>(x), P, static_cast<const bf16*>(y), Q, Mpad, rows_per_split,
      static_cast<float*>(part));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows per block of the row pass: the partial-sum buffers have Mpad / BM rows.
int block_mlp_rows_per_block(int C) {
#define CASE(W) if (C == W) return Cfg<W>::BM;
  BLOCK_MLP_WIDTHS(CASE)
#undef CASE
  return -1;
}

int block_mlp_row_pad() { return kRowPad; }

// The row pass. dtype: 0 = float32, 1 = bfloat16 (for s, dy, ds). keep may be
// null (all ones). Mpad is M rounded up to a multiple of block_mlp_row_pad();
// u16, kdy16 are [Mpad, C], g16, dh16 [Mpad, 4C] (bf16); db1_part is
// [Mpad / BM, 4C], dlng_part and dlnb_part [Mpad / BM, C] (f32).
int block_mlp_bwd_full_rows(int C, int dtype, const void* s, const void* keep,
                            int rows_per_keep, const void* ln_g, const void* ln_b,
                            const void* w1, const void* b1, const void* w2g, const void* dy,
                            void* ds, int64_t M, int64_t Mpad, void* u16, void* kdy16,
                            void* g16, void* dh16, void* db1_part, void* dlng_part,
                            void* dlnb_part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Mpad % kRowPad != 0 || Mpad < M) return -1;
  const FullOut out{static_cast<bf16*>(u16), static_cast<bf16*>(kdy16), static_cast<bf16*>(g16),
                    static_cast<bf16*>(dh16), static_cast<float*>(db1_part),
                    static_cast<float*>(dlng_part), static_cast<float*>(dlnb_part)};
#define CASE(W)                                                                              \
  if (C == W)                                                                                \
    return dtype == 0                                                                        \
        ? launch_bwd<W, float, true>(s, (const float*)keep, rows_per_keep,                  \
                                     (const float*)ln_g, (const float*)ln_b,                \
                                     (const bf16*)w1, (const float*)b1, (const bf16*)w2g,   \
                                     dy, ds, M, Mpad, out, st)                              \
        : launch_bwd<W, bf16, true>(s, (const float*)keep, rows_per_keep,                   \
                                    (const float*)ln_g, (const float*)ln_b,                 \
                                    (const bf16*)w1, (const float*)b1, (const bf16*)w2g,    \
                                    dy, ds, M, Mpad, out, st);
  BLOCK_MLP_WIDTHS(CASE)
#undef CASE
  return -1;
}

// The weight pass: part[n_split, P, Q], split k summing rows
// [k * rows_per_split, min(Mpad, (k + 1) * rows_per_split)) of x [Mpad, P] and
// y [Mpad, Q] (bf16). One of P, Q is a multiple of 32, the other of 128;
// Mpad and rows_per_split are multiples of 32.
int block_mlp_wgrad(const void* x, int P, const void* y, int Q, int64_t Mpad,
                    int64_t rows_per_split, int n_split, void* part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Mpad % kWDepth != 0 || rows_per_split % kWDepth != 0 || n_split <= 0 ||
      static_cast<int64_t>(n_split - 1) * rows_per_split >= Mpad)
    return -1;
  if (P % 32 == 0 && Q % 128 == 0 && P <= Q)
    return launch_wgrad<32, 128>(x, P, y, Q, Mpad, rows_per_split, n_split, part, st);
  if (P % 128 == 0 && Q % 32 == 0)
    return launch_wgrad<128, 32>(x, P, y, Q, Mpad, rows_per_split, n_split, part, st);
  return -1;
}

// out[ceil(R / G), N] = sums of G consecutive rows of part[R, N] (f32).
int block_mlp_reduce(const void* part, int64_t R, int64_t N, int G, void* out, void* stream) {
  if (R <= 0 || N <= 0 || G <= 0) return -1;
  const int64_t groups = (R + G - 1) / G;
  if (groups > 65535) return -1;
  const dim3 grid(static_cast<unsigned>((N + 255) / 256), static_cast<unsigned>(groups));
  reduce_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), R, N, G, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
