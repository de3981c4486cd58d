// 7x7 depthwise convolution (SAME padding, bias) of NHWC maps for Hopper
// (sm_90a), and its backward:
//   y[b,h,w,c]    = bias[c] + sum_{i,j} wt[i*7 + j, c] * xpad[b, h+i, w+j, c]
//   dx[b,h,w,c]   = sum_{i,j} wt[48 - (i*7 + j), c] * dypad[b, h+i, w+j, c]
//   dw[i*7 + j,c] = sum_{b,h,w} xpad[b, h+i, w+j, c] * dy[b,h,w,c]
//   db[c]         = sum_{b,h,w} dy[b,h,w,c]
// xpad is x zero-padded by 3 rows and columns on each side; wt is the
// tap-major [49, C] f32 weight (flax's [7, 7, 1, C] flattened).
//
// Replaces the TPU kernels of revisiting_at_tpu/ops/dwconv.py:
//   dwconv_fwd_kernel<T, false> <- _fwd_kernel (forward)
//   dwconv_fwd_kernel<T, true>  <- _bwd_kernel's dx (the same stencil on dy,
//                                  flipped taps, no bias)
//   dwconv_wgrad_kernel, then dwconv_reduce_kernel
//                               <- _bwd_kernel's dw and db (the TPU grid
//                                  carries them in VMEM from step to step)
// and their v2 twins (_fwd_kernel_v2, _bwd_kernel_v2), which differ from v1
// only in how the TPU schedules its sublane shifts: the same function.
//
// Numbers follow the TPU kernels: x and dy are read as f32, the weights and
// the bias stay f32, the forward's accumulator starts at the bias and adds
// the taps in (i, j) row-major order, dx starts at zero, y and dx are
// rounded to x's type, dw and db are f32.
//
// What bounds it on the H100: 49 fp32 FMAs (98 flops) per output element
// against 2 bytes read and 2 written in bf16, 24.5 flops a byte, above the
// 20 at which 67 TFLOP/s of fp32 outside the tensor cores meets 3.35 TB/s.
// So the forward, dx and wgrad are bound by the fp32 pipes at every gated
// ConvNeXt-T stage (stage 0 at batch 80: 2.36 GFLOP, 35.2 us, against
// 96.3 MB, 28.8 us; stages 1 and 2 half and a quarter of both); with f32
// maps the bytes bound them. The design keeps the FMA pipes fed from
// registers, not from memory:
//   * a block owns one image, a tile of TH = 14 output rows by TW = 8
//     columns and a group of 32 channels (one per lane; one column per
//     warp). It loads the (TH + 6) x (TW + 6) halo of its tile into shared
//     memory with 16-byte loads, zero-filled outside the image: a tile's
//     halo rows inside the image are the image's rows, so tiles join
//     without seams. 14 divides the 56, 28 and 14 rows of the stage maps at
//     224 px; ragged tiles are masked on store.
//   * thread (channel, column) holds its channel's 49 weights and the 14
//     accumulators of its column in registers and slides down the halo:
//     each halo row is read from shared memory once (7 values) and feeds
//     the 49 FMAs of the 7 outputs it touches, each output's in the taps'
//     row-major order.
//   * wgrad: thread (channel, column) keeps its 49 dw sums and its db sum in
//     registers over a chunk of (image, band) tiles, with its column's 14 dy
//     values in registers; then the 8 columns are summed in shared memory in
//     a fixed order and the block writes one partial row [50, C slice].
//     No float atomics: dw and db are the same bits on every launch.
// The halo (2.5x the tile's outputs) is re-read from L2, not from HBM.
//
// dwconv_reduce_kernel sums the weight pass's R partial rows of N = 50 * C
// f32 values (R = 322, 160, 80 at ConvNeXt-T's stages 0-2, batch 80) in one
// launch, whatever R. It is bound by the bytes it must move, the partials
// read once and the row written once (6.2 MB at stage 0, 1.8 us at HBM
// rate), but at that size a launch lasts a few microseconds, so what counts
// is how many loads are in flight: a block owns a strip of 32 columns
// (16-byte loads, 8 lanes to a 128-byte row segment), each of its 8 warps a
// fixed contiguous range of rows, 4 rows at a time with 8 independent loads
// in flight per thread; the 4 row lanes are added by shuffles and the warps'
// sums in shared memory in warp order. The order depends on (R, N) only, so
// the sum is the same bits every launch; N / 32 blocks (150 at stage 0).
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after its launch, or -1 for a shape it does not take (C a multiple of 8
// and at most 384, the JAX package's gate).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kK = 7;                 // taps per side
constexpr int kTaps = kK * kK;        // 49
constexpr int kPad = kK / 2;          // SAME padding, 3
constexpr int kTH = 14;               // output rows per tile
constexpr int kTW = 8;                // output columns per tile, one per warp
constexpr int kCG = 32;               // channels per block, one per lane
constexpr int kHR = kTH + kK - 1;     // halo rows
constexpr int kHC = kTW + kK - 1;     // halo columns
constexpr int kThreads = kCG * kTW;   // 256
constexpr int kMaxC = 384;
constexpr int kParts = kTaps + 1;     // a partial row: 49 dw taps, then db

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// s[kHR][kHC][kCG] = x[b, h0 - 3 + r, w0 - 3 + col, c0 + lane], zero outside
// the image and past C, in 16-byte vectors. C is a multiple of 8, so every
// vector is wholly inside or wholly past C.
template <typename T>
__device__ __forceinline__ void load_halo(const T* __restrict__ x, int b, int h0, int w0, int c0,
                                          int H, int W, int C, T* __restrict__ s) {
  constexpr int kVec = 16 / sizeof(T);   // elements per vector
  constexpr int kVpp = kCG / kVec;       // vectors per halo pixel
  for (int v = threadIdx.x; v < kHR * kHC * kVpp; v += kThreads) {
    const int pix = v / kVpp, e = (v % kVpp) * kVec;
    const int h = h0 - kPad + pix / kHC, w = w0 - kPad + pix % kHC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (h >= 0 && h < H && w >= 0 && w < W && c0 + e < C)
      val = *reinterpret_cast<const uint4*>(
          x + ((static_cast<int64_t>(b) * H + h) * W + w) * C + c0 + e);
    *reinterpret_cast<uint4*>(s + pix * kCG + e) = val;
  }
}

// One (image, band, column tile) per blockIdx.x, column tiles fastest; a
// channel group per blockIdx.y. kDx: dx from dy (flipped taps, no bias).
template <typename T, bool kDx>
__global__ void __launch_bounds__(kThreads)
dwconv_fwd_kernel(const T* __restrict__ x, const float* __restrict__ wt,
                  const float* __restrict__ bias, T* __restrict__ y, int H, int W, int C,
                  int bands, int ctiles) {
  __shared__ __align__(16) T s[kHR * kHC * kCG];
  const int lane = threadIdx.x % 32, q = threadIdx.x / 32;
  const int64_t t = blockIdx.x;
  const int ct = static_cast<int>(t % ctiles);
  const int band = static_cast<int>((t / ctiles) % bands);
  const int b = static_cast<int>(t / ctiles / bands);
  const int h0 = band * kTH, w0 = ct * kTW, c0 = blockIdx.y * kCG, c = c0 + lane;
  const bool c_ok = c < C;
  load_halo<T>(x, b, h0, w0, c0, H, W, C, s);

  float w[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) w[k] = c_ok ? wt[(kDx ? kTaps - 1 - k : k) * C + c] : 0.0f;
  float acc[kTH];
  const float a0 = (!kDx && c_ok) ? bias[c] : 0.0f;
#pragma unroll
  for (int p = 0; p < kTH; ++p) acc[p] = a0;
  __syncthreads();

  // halo row r feeds output rows p = r - i through tap row i
#pragma unroll
  for (int r = 0; r < kHR; ++r) {
    float in[kK];
#pragma unroll
    for (int j = 0; j < kK; ++j) in[j] = to_f(s[(r * kHC + q + j) * kCG + lane]);
#pragma unroll
    for (int i = 0; i < kK; ++i) {
      const int p = r - i;
      if (p >= 0 && p < kTH) {
#pragma unroll
        for (int j = 0; j < kK; ++j) acc[p] = fmaf(w[i * kK + j], in[j], acc[p]);
      }
    }
  }

  const int wq = w0 + q;
  if (!c_ok || wq >= W) return;
#pragma unroll
  for (int p = 0; p < kTH; ++p) {
    const int h = h0 + p;
    if (h < H) y[((static_cast<int64_t>(b) * H + h) * W + wq) * C + c] = from_f<T>(acc[p]);
  }
}

// blockIdx.x = chunk * ctiles + column tile, blockIdx.y = channel group. The
// block sums over items [chunk * per_chunk, min(n_items, (chunk + 1) *
// per_chunk)), item = image * bands + band, and writes partial row
// blockIdx.x of part [n_chunks * ctiles, kParts, C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
dwconv_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy, int H, int W, int C,
                    int bands, int ctiles, int64_t per_chunk, int64_t n_items,
                    float* __restrict__ part) {
  __shared__ __align__(16) T s[kHR * kHC * kCG];
  __shared__ float red[kTW * kK * kCG];
  const int lane = threadIdx.x % 32, q = threadIdx.x / 32;
  const int chunk = blockIdx.x / ctiles, ct = blockIdx.x % ctiles;
  const int w0 = ct * kTW, wq = w0 + q, c0 = blockIdx.y * kCG, c = c0 + lane;
  const bool col_ok = c < C && wq < W;
  const int64_t begin = chunk * per_chunk;
  const int64_t end = begin + per_chunk < n_items ? begin + per_chunk : n_items;

  float acc[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) acc[k] = 0.0f;
  float db = 0.0f;
  for (int64_t it = begin; it < end; ++it) {
    const int b = static_cast<int>(it / bands), h0 = static_cast<int>(it % bands) * kTH;
    __syncthreads();  // the previous item's halo reads are done
    load_halo<T>(x, b, h0, w0, c0, H, W, C, s);
    float d[kTH];
#pragma unroll
    for (int p = 0; p < kTH; ++p) {
      const int h = h0 + p;
      d[p] = (col_ok && h < H) ? to_f(dy[((static_cast<int64_t>(b) * H + h) * W + wq) * C + c])
                               : 0.0f;
      db += d[p];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kHR; ++r) {
      float in[kK];
#pragma unroll
      for (int j = 0; j < kK; ++j) in[j] = to_f(s[(r * kHC + q + j) * kCG + lane]);
#pragma unroll
      for (int i = 0; i < kK; ++i) {
        const int p = r - i;
        if (p >= 0 && p < kTH) {
#pragma unroll
          for (int j = 0; j < kK; ++j) acc[i * kK + j] = fmaf(in[j], d[p], acc[i * kK + j]);
        }
      }
    }
  }

  // the 8 columns summed in column order: tap row i (7 taps) per pass, then db
  float* out = part + static_cast<int64_t>(blockIdx.x) * kParts * C;
#pragma unroll
  for (int i = 0; i <= kK; ++i) {
    __syncthreads();
    if (i < kK) {
#pragma unroll
      for (int j = 0; j < kK; ++j) red[(q * kK + j) * kCG + lane] = acc[i * kK + j];
    } else {
      red[q * kK * kCG + lane] = db;
    }
    __syncthreads();
    if (threadIdx.x < (i < kK ? kK * kCG : kCG)) {
      const int j = threadIdx.x / kCG, cc = threadIdx.x % kCG;
      float sum = 0.0f;
      for (int qq = 0; qq < kTW; ++qq) sum += red[(qq * kK + j) * kCG + cc];
      if (c0 + cc < C) out[(i * kK + j) * C + c0 + cc] = sum;
    }
  }
}

constexpr int kRedWarps = 8;
constexpr int kRedStrip = 32;    // columns per block: 8 lanes of 4
constexpr int kRedBatch = 8;     // loads in flight per thread

// out[n] = sum over r of part[r, n] for the block's 32 columns. Warp w sums
// rows [R * w / 8, R * (w + 1) / 8); its row lane l (lane / 8) takes every
// fourth of them from the l-th on.
__global__ void __launch_bounds__(kRedWarps * 32)
dwconv_reduce_kernel(const float* __restrict__ part, int64_t R, int64_t N,
                     float* __restrict__ out) {
  __shared__ float4 sums[kRedWarps][kRedStrip / 4];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rl = lane / 8, cl = lane % 8;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kRedStrip + 4 * cl;
  const int64_t r0 = R * warp / kRedWarps, r1 = R * (warp + 1) / kRedWarps;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (n < N) {
    const float* col = part + n;
    int64_t r = r0 + rl;
    for (; r + 4 * (kRedBatch - 1) < r1; r += 4 * kRedBatch) {
      float4 v[kRedBatch];
#pragma unroll
      for (int i = 0; i < kRedBatch; ++i)
        v[i] = __ldg(reinterpret_cast<const float4*>(col + (r + 4 * i) * N));
#pragma unroll
      for (int i = 0; i < kRedBatch; ++i) {
        acc.x += v[i].x; acc.y += v[i].y; acc.z += v[i].z; acc.w += v[i].w;
      }
    }
    for (; r < r1; r += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(col + r * N));
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
  }
#pragma unroll
  for (int o = 8; o < 32; o <<= 1) {
    acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o);
    acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
    acc.z += __shfl_xor_sync(0xffffffffu, acc.z, o);
    acc.w += __shfl_xor_sync(0xffffffffu, acc.w, o);
  }
  if (rl == 0) sums[warp][cl] = acc;
  __syncthreads();
  if (threadIdx.x < kRedStrip / 4 && n < N) {
    float4 t = sums[0][threadIdx.x];
    for (int w = 1; w < kRedWarps; ++w) {
      const float4 v = sums[w][threadIdx.x];
      t.x += v.x; t.y += v.y; t.z += v.z; t.w += v.w;
    }
    *reinterpret_cast<float4*>(out + n) = t;
  }
}

bool shape_ok(int B, int H, int W, int C) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 != 0 || C > kMaxC) return false;
  const int64_t tiles = static_cast<int64_t>(B) * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  return tiles < (int64_t{1} << 31);
}

template <typename T, bool kDx>
int launch_fwd(const void* x, const void* wt, const void* bias, void* y, int B, int H, int W,
               int C, cudaStream_t st) {
  const int bands = (H + kTH - 1) / kTH, ctiles = (W + kTW - 1) / kTW;
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(B) * bands * ctiles),
                  static_cast<unsigned>((C + kCG - 1) / kCG));
  dwconv_fwd_kernel<T, kDx><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(wt), static_cast<const float*>(bias),
      static_cast<T*>(y), H, W, C, bands, ctiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wgrad(const void* x, const void* dy, int B, int H, int W, int C, int64_t per_chunk,
                 int n_chunks, void* part, cudaStream_t st) {
  const int bands = (H + kTH - 1) / kTH, ctiles = (W + kTW - 1) / kTW;
  const dim3 grid(static_cast<unsigned>(n_chunks * ctiles),
                  static_cast<unsigned>((C + kCG - 1) / kCG));
  dwconv_wgrad_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), H, W, C, bands, ctiles, per_chunk,
      static_cast<int64_t>(B) * bands, static_cast<float*>(part));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dwconv_supports(int C) { return C > 0 && C % 8 == 0 && C <= kMaxC; }

int dwconv_tile_rows() { return kTH; }

int dwconv_tile_cols() { return kTW; }

int dwconv_parts() { return kParts; }

// dtype: 0 = float32, 1 = bfloat16 (x and y). dx = 0: y from x, bias [C]
// f32; dx = 1: dx from dy (passed as x, written to y), flipped taps, bias
// unused. wt is [49, C] f32. Maps are contiguous NHWC, 16-byte aligned.
int dwconv_fwd(int dtype, int dx, const void* x, const void* wt, const void* bias, void* y,
               int B, int H, int W, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, H, W, C) || (dtype != 0 && dtype != 1)) return -1;
  if (dtype == 0)
    return dx ? launch_fwd<float, true>(x, wt, bias, y, B, H, W, C, st)
              : launch_fwd<float, false>(x, wt, bias, y, B, H, W, C, st);
  return dx ? launch_fwd<bf16, true>(x, wt, bias, y, B, H, W, C, st)
            : launch_fwd<bf16, false>(x, wt, bias, y, B, H, W, C, st);
}

// part: f32 [n_chunks * ceil(W / 8), 50, C]; chunk k sums the (image, band)
// items [k * per_chunk, (k + 1) * per_chunk) of the B * ceil(H / 14).
int dwconv_wgrad(int dtype, const void* x, const void* dy, int B, int H, int W, int C,
                 int64_t per_chunk, int n_chunks, void* part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t items = static_cast<int64_t>(B) * ((H + kTH - 1) / kTH);
  if (!shape_ok(B, H, W, C) || (dtype != 0 && dtype != 1) || per_chunk <= 0 || n_chunks <= 0 ||
      (n_chunks - 1) * per_chunk >= items || static_cast<int64_t>(n_chunks) * per_chunk < items ||
      static_cast<int64_t>(n_chunks) * ((W + kTW - 1) / kTW) >= (int64_t{1} << 31))
    return -1;
  return dtype == 0 ? launch_wgrad<float>(x, dy, B, H, W, C, per_chunk, n_chunks, part, st)
                    : launch_wgrad<bf16>(x, dy, B, H, W, C, per_chunk, n_chunks, part, st);
}

// out[N] = the sum of part[R, N] over R (f32), in one launch. N is a
// multiple of 4 and both pointers are 16-byte aligned.
int dwconv_reduce(const void* part, int64_t R, int64_t N, void* out, void* stream) {
  if (R <= 0 || N <= 0 || N % 4 != 0 || reinterpret_cast<uintptr_t>(part) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || (N + kRedStrip - 1) / kRedStrip >= (1 << 30))
    return -1;
  dwconv_reduce_kernel<<<static_cast<unsigned>((N + kRedStrip - 1) / kRedStrip),
                         kRedWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), R, N, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
