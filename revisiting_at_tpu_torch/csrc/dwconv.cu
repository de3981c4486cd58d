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
// the taps in (i, j) row-major order with fmaf, dx starts at zero, y and dx
// are rounded to x's type, dw and db are f32.
//
// What bounds it on the H100: 49 fp32 FMAs (98 flops) per output element
// against 2 bytes read and 2 written in bf16, 24.5 flops a byte, above the
// 20 at which 67 TFLOP/s of fp32 outside the tensor cores meets 3.35 TB/s.
// So the forward, dx and wgrad are bound by the fp32 pipes at every gated
// ConvNeXt-T stage (stage 0 at batch 80: 2.36 GFLOP, 35.2 us, against
// 96.3 MB, 28.8 us; stages 1 and 2 half and a quarter of both); with f32
// maps the bytes bound them. An SM sub-partition dispatches one warp
// instruction a clock and retires one warp FFMA a clock, so every other
// instruction costs an FFMA: the design keeps them few per FFMA.
//   * Tiles. A tile is 14 x 14 output pixels of one image and a group of 32
//     channels (14 divides the 56, 28 and 14 rows and columns of the gated
//     stages at 224 px; a map of another size has a ragged last tile,
//     masked on store). Its 20 x 20 halo comes by TMA through a 4-D tensor
//     map over the NHWC map (C, W, H, B) in one box; the tensor map's
//     out-of-bounds zero fill at negative and past-the-edge coordinates is
//     the SAME padding (and zeros past C), so no thread tests a border.
//   * Persistent blocks and a ring. dwconv_plan (ops/dwconv.py, mirrored
//     here and checked by the entry points) launches a few blocks per SM
//     (kFwdBlocks, kWgradBlocks) and gives each a contiguous run of tiles,
//     channel group slowest. A producer warp keeps the next tile's halo in
//     flight through a ring of kStages shared-memory stages (full and
//     empty mbarriers) while four consumer warps compute this one.
//   * Register blocking. Each consumer warp takes one 7 x 7 quadrant of the
//     tile, a channel per lane, 7 output columns a thread. A warp's shared
//     load is the 32 channels of one pixel (one wavefront; 32-bit shared
//     addresses with immediate offsets). The 49 weights stay in registers
//     across the block's tiles and reload only when its channel group
//     changes. Every output keeps its own f32 accumulator, starting at the
//     bias, and takes its taps in row-major order with fmaf, so y and dx
//     are the bits of the one-output-per-thread loop.
//   * The stencil's loop: output rows two at a time (three pairs, then the
//     seventh row alone), each pair reading its 8 halo rows of 13 values
//     once for 686 FMAs: 403 shared loads for 2,401 FMAs a tile. Unrolling
//     the whole tile instead (each of the 13 halo rows read once, 169
//     loads) gives 58 KB of straight code per tile and measured slower at
//     any blocks per SM; the one-row loop ran 1.5x slower unrolled than
//     rolled, the same instructions: the code's size, not its mix, held
//     it back (tools/dwconv_variants.py, PERF.md).
//   * The stencil's outputs are staged in shared memory and leave by one
//     TMA store a tile, which clips the map's edges and C; direct stores
//     masked per column cost about 90 instructions a row.
//   * wgrad: a ring stage holds a tile's x halo and its dy tile, both by
//     TMA on one mbarrier. A lane keeps its channel's 49 dw sums and its db
//     sum in registers over all of its block's tiles (49 dy values of the
//     quadrant in registers per tile) and slides down the quadrant's 13
//     halo rows, each read once; the block then sums its four warps in
//     shared memory in warp order and writes one partial row [50, 32
//     channels]. The plan (blocks, tiles per block, partial rows) depends
//     on the shapes and the SM count alone, and there are no float
//     atomics: dw and db are the same bits on every launch.
// The halo (2.04x the tile's pixels) is re-read from L2, not from HBM.
//
// dwconv_reduce_kernel sums the weight pass's R partial rows of N = 50 * C
// f32 values (R = 86, 40, 20 at ConvNeXt-T's stages 0-2, batch 80, on 132
// SMs) in one launch, whatever R. It is bound by the bytes it must move,
// the partials read once and the row written once, but at that size a
// launch lasts a few microseconds, so what counts is how many loads are in
// flight: a block owns a strip of 32 columns (16-byte loads, 8 lanes to a
// 128-byte row segment), each of its 8 warps a fixed contiguous range of
// rows, 4 rows at a time with 8 independent loads in flight per thread;
// the 4 row lanes are added by shuffles and the warps' sums in shared
// memory in warp order. The order depends on (R, N) only, so the sum is
// the same bits every launch; N / 32 blocks.
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after its launch, -1 for a shape it does not take (C a multiple of 8 and
// at most 384, the JAX package's gate) or a plan that is not dwconv_plan's,
// -2 when the tensor map cannot be made.

#include <cuda_bf16.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kK = 7;                 // taps per side
constexpr int kTaps = kK * kK;        // 49
constexpr int kPad = kK / 2;          // SAME padding, 3
constexpr int kTile = 14;             // output rows and columns of a tile
constexpr int kHalo = kTile + kK - 1; // its halo's rows and columns, 20
constexpr int kQ = kTile / 2;         // a consumer warp's quadrant, 7 x 7
constexpr int kQH = kQ + kK - 1;      // the quadrant's halo rows and columns, 13
constexpr int kCG = 32;               // channels per tile, one per lane
constexpr int kConsumers = 4;         // consumer warps, one quadrant each
constexpr int kThreads = 32 * (kConsumers + 1);  // and the producer warp
constexpr int kStages = 2;            // ring stages
constexpr int kMaxC = 384;
constexpr int kParts = kTaps + 1;     // a partial row: 49 dw taps, then db

// blocks per SM the plan counts on: bf16 3 (128 registers a thread), f32
// 1 (the ring's and the output tile's bytes); the weight pass 2 and 1
template <typename T>
__host__ __device__ constexpr int fwd_blocks() { return sizeof(T) == 2 ? 3 : 1; }
template <typename T>
__host__ __device__ constexpr int wgrad_blocks() { return sizeof(T) == 2 ? 2 : 1; }
template <typename T>
__host__ __device__ constexpr int halo_bytes() { return kHalo * kHalo * kCG * sizeof(T); }
template <typename T>
__host__ __device__ constexpr int dy_bytes() { return kTile * kTile * kCG * sizeof(T); }
// the ring (128-byte aligned, slack included), the stencil's output tile,
// then 2 * kStages mbarriers
template <typename T>
__host__ __device__ constexpr int fwd_smem() {
  return 128 + kStages * halo_bytes<T>() + dy_bytes<T>() + 2 * kStages * 8;
}
template <typename T>
__host__ __device__ constexpr int wgrad_smem() {
  return 128 + kStages * (halo_bytes<T>() + dy_bytes<T>()) + 2 * kStages * 8;
}
// the weight pass's end: the four warps' sums, in the ring
static_assert(kConsumers * kParts * kCG * 4 <= kStages * (halo_bytes<bf16>() + dy_bytes<bf16>()),
              "the block's sums must fit the ring");

// One element at shared address `a` (the shared window's own 32-bit
// address, so every load of a tile is one LDS off a base register with an
// immediate offset; a generic pointer into the ring compiled to generic
// loads and their 64-bit address arithmetic), as f32.
template <typename T> __device__ __forceinline__ float lds(uint32_t a);
template <> __device__ __forceinline__ float lds<float>(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}
template <> __device__ __forceinline__ float lds<bf16>(uint32_t a) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a));
  return __uint_as_float(static_cast<uint32_t>(v) << 16);  // bf16 -> f32 is exact
}

__device__ __forceinline__ unsigned char* align128(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 127) &
                                          ~static_cast<uintptr_t>(127));
}

// One f32 value stored as T at shared address `a`.
template <typename T> __device__ __forceinline__ void sts(uint32_t a, float v);
template <> __device__ __forceinline__ void sts<float>(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}
template <> __device__ __forceinline__ void sts<bf16>(uint32_t a, float v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(a), "h"(__bfloat16_as_ushort(__float2bfloat16(v)))
               : "memory");
}

// A tile's place: channel group slowest, then image, band (of 14 rows),
// column tile.
struct Tile {
  int g, b, band, ct;
  __device__ Tile(int t, int B, int bands, int ctiles) {
    ct = t % ctiles;
    t /= ctiles;
    band = t % bands;
    t /= bands;
    b = t % B;
    g = t / B;
  }
};

// The ring: kStages stages of `stage_bytes`, then `extra` bytes of the
// kernel's own, then a full barrier (the producer's arrive with its bytes)
// and an empty barrier (one arrive per consumer warp) per stage.
struct Ring {
  unsigned char* base;
  uint32_t base_s;  // base's shared address
  uint64_t* full;
  uint64_t* empty;
  __device__ Ring(unsigned char* raw, int stage_bytes, int extra) {
    base = align128(raw);
    base_s = smem_u32(base);
    full = reinterpret_cast<uint64_t*>(base + kStages * stage_bytes + extra);
    empty = full + kStages;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kConsumers);
      }
      mbar_fence_init();
    }
    __syncthreads();
  }
  // the producer: stage of the n-th tile, once its consumers gave it back
  __device__ int claim(int n) const {
    const int s = n % kStages;
    if (n >= kStages) mbar_wait(&empty[s], ((n / kStages) - 1) & 1);
    return s;
  }
  // a consumer warp: stage of the n-th tile, once its bytes have landed
  __device__ int wait(int n) const {
    const int s = n % kStages;
    mbar_wait(&full[s], (n / kStages) & 1);
    return s;
  }
  // a consumer warp is done reading stage s
  __device__ void release(int s) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[s]);
  }
};

// The stencil. Block blockIdx.x takes tiles [tiles * i / G, tiles * (i + 1)
// / G) of the (group, image, band, column tile) order, G = gridDim.x.
// kDx: dx from dy (flipped taps, no bias). A tile's outputs are staged in
// shared memory after the ring and leave by one TMA store through ymap,
// whose box clips the map's edges and C (no thread tests a border).
template <typename T, bool kDx>
__global__ void __launch_bounds__(kThreads, fwd_blocks<T>())
dwconv_fwd_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap ymap, const float* __restrict__ wt,
                  const float* __restrict__ bias, int B, int C, int bands, int ctiles,
                  int tiles) {
  extern __shared__ unsigned char smem_raw[];
  const Ring ring(smem_raw, halo_bytes<T>(), dy_bytes<T>());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t0 = static_cast<int>(static_cast<int64_t>(tiles) * blockIdx.x / gridDim.x);
  const int t1 = static_cast<int>(static_cast<int64_t>(tiles) * (blockIdx.x + 1) / gridDim.x);

  if (warp == kConsumers) {  // the producer
    if (lane == 0) {
      for (int t = t0, n = 0; t < t1; ++t, ++n) {
        const Tile tl(t, B, bands, ctiles);
        const int s = ring.claim(n);
        mbar_arrive_expect_tx(&ring.full[s], halo_bytes<T>());
        tma_load_4d(ring.base + s * halo_bytes<T>(), &xmap, &ring.full[s], tl.g * kCG,
                    tl.ct * kTile - kPad, tl.band * kTile - kPad, tl.b);
      }
    }
    return;
  }

  const int qr = warp / 2, qc = warp % 2;  // the quadrant: row and column half
  unsigned char* const out_tile = ring.base + kStages * halo_bytes<T>();
  // this lane's quadrant in the staged output tile [14][14][32]
  const uint32_t os = smem_u32(out_tile) + ((qr * kQ * kTile + qc * kQ) * kCG + lane) * sizeof(T);
  float w[kTaps];
  float a0 = 0.0f;
  int g_loaded = -1;
  for (int t = t0, n = 0; t < t1; ++t, ++n) {
    const Tile tl(t, B, bands, ctiles);
    if (tl.g != g_loaded) {  // the weights of this lane's channel, once per run of its group
      g_loaded = tl.g;
      const int c = tl.g * kCG + lane;
      const bool c_ok = c < C;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) w[k] = c_ok ? wt[(kDx ? kTaps - 1 - k : k) * C + c] : 0.0f;
      a0 = (!kDx && c_ok) ? bias[c] : 0.0f;
    }

    const int s = ring.wait(n);
    // the quadrant's halo in the stage, at this lane's channel
    const uint32_t hs = ring.base_s + s * halo_bytes<T>() +
                        ((qr * kQ * kHalo + qc * kQ) * kCG + lane) * sizeof(T);
    // the outputs are staged once the previous tile's store has read them
    if (threadIdx.x == 0) bulk_wait_read();
    named_bar_sync(1, 32 * kConsumers);
    // output rows p and p + 1 take halo rows p..p+7, row p through tap
    // rows 0..6 and row p + 1 through tap rows 0..6 one halo row later; a
    // loop (not unrolled) keeps the code small enough for the SM's
    // instruction cache
#pragma unroll 1
    for (int p = 0; p + 1 < kQ; p += 2) {
      float a[kQ], b[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) a[q] = b[q] = a0;
#pragma unroll
      for (int k = 0; k <= kK; ++k) {
        float in[kQH];
#pragma unroll
        for (int j = 0; j < kQH; ++j)
          in[j] = lds<T>(hs + ((p + k) * kHalo + j) * kCG * sizeof(T));
        if (k < kK) {
#pragma unroll
          for (int q = 0; q < kQ; ++q)
#pragma unroll
            for (int j = 0; j < kK; ++j) a[q] = fmaf(w[k * kK + j], in[q + j], a[q]);
        }
        if (k > 0) {
#pragma unroll
          for (int q = 0; q < kQ; ++q)
#pragma unroll
            for (int j = 0; j < kK; ++j) b[q] = fmaf(w[(k - 1) * kK + j], in[q + j], b[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        sts<T>(os + (p * kTile + q) * kCG * sizeof(T), a[q]);
        sts<T>(os + ((p + 1) * kTile + q) * kCG * sizeof(T), b[q]);
      }
    }
    {  // the last row
      float a[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) a[q] = a0;
#pragma unroll
      for (int i = 0; i < kK; ++i) {
        float in[kQH];
#pragma unroll
        for (int j = 0; j < kQH; ++j)
          in[j] = lds<T>(hs + ((kQ - 1 + i) * kHalo + j) * kCG * sizeof(T));
#pragma unroll
        for (int q = 0; q < kQ; ++q)
#pragma unroll
          for (int j = 0; j < kK; ++j) a[q] = fmaf(w[i * kK + j], in[q + j], a[q]);
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) sts<T>(os + ((kQ - 1) * kTile + q) * kCG * sizeof(T), a[q]);
    }
    ring.release(s);
    // then one thread stores the tile
    fence_proxy_async();
    named_bar_sync(1, 32 * kConsumers);
    if (threadIdx.x == 0) {
      tma_store_4d(&ymap, out_tile, tl.g * kCG, tl.ct * kTile, tl.band * kTile, tl.b);
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait();  // the stores are done before the block's memory goes
}

// The weight pass. blockIdx.x = chunk * groups + channel group; the block
// sums the (image, band, column tile) items [chunk * per_chunk,
// min(items, (chunk + 1) * per_chunk)) of its group and writes row `chunk`
// of part [chunks, kParts, C], its group's 32 columns of each tap.
template <typename T>
__global__ void __launch_bounds__(kThreads, wgrad_blocks<T>())
dwconv_wgrad_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap dymap, int C, int bands, int ctiles,
                    int groups, int64_t per_chunk, int64_t items, float* __restrict__ part) {
  constexpr int kStage = halo_bytes<T>() + dy_bytes<T>();
  extern __shared__ unsigned char smem_raw[];
  const Ring ring(smem_raw, kStage, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.x % groups, chunk = blockIdx.x / groups;
  const int64_t i0 = chunk * per_chunk;
  const int64_t i1 = i0 + per_chunk < items ? i0 + per_chunk : items;
  const int per_image = bands * ctiles;

  if (warp == kConsumers) {  // the producer
    if (lane == 0) {
      int n = 0;
      for (int64_t it = i0; it < i1; ++it, ++n) {
        const int b = static_cast<int>(it / per_image), r = static_cast<int>(it % per_image);
        const int band = r / ctiles, ct = r % ctiles;
        const int s = ring.claim(n);
        unsigned char* st = ring.base + s * kStage;
        mbar_arrive_expect_tx(&ring.full[s], kStage);
        tma_load_4d(st, &xmap, &ring.full[s], g * kCG, ct * kTile - kPad, band * kTile - kPad, b);
        tma_load_4d(st + halo_bytes<T>(), &dymap, &ring.full[s], g * kCG, ct * kTile,
                    band * kTile, b);
      }
    }
    return;
  }

  const int qr = warp / 2, qc = warp % 2;
  float acc[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) acc[k] = 0.0f;
  float db = 0.0f;
  int n = 0;
  for (int64_t it = i0; it < i1; ++it, ++n) {
    const int s = ring.wait(n);
    // the quadrant's x halo and dy in the stage, at this lane's channel
    const uint32_t hs = ring.base_s + s * kStage +
                        ((qr * kQ * kHalo + qc * kQ) * kCG + lane) * sizeof(T);
    const uint32_t ds = ring.base_s + s * kStage + halo_bytes<T>() +
                        ((qr * kQ * kTile + qc * kQ) * kCG + lane) * sizeof(T);
    // the quadrant's dy (zero past the map and past C: the box's fill)
    float d[kQ][kQ];
#pragma unroll
    for (int p = 0; p < kQ; ++p)
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        d[p][q] = lds<T>(ds + (p * kTile + q) * kCG * sizeof(T));
        db += d[p][q];
      }
#pragma unroll
    for (int r = 0; r < kQH; ++r) {
      float in[kQH];
#pragma unroll
      for (int j = 0; j < kQH; ++j) in[j] = lds<T>(hs + (r * kHalo + j) * kCG * sizeof(T));
#pragma unroll
      for (int i = 0; i < kK; ++i) {
        const int p = r - i;
        if (p >= 0 && p < kQ) {
#pragma unroll
          for (int q = 0; q < kQ; ++q)
#pragma unroll
            for (int j = 0; j < kK; ++j)
              acc[i * kK + j] = fmaf(in[q + j], d[p][q], acc[i * kK + j]);
        }
      }
    }
    ring.release(s);
  }

  // the four warps' sums, added in warp order, in the ring (every stage
  // has been read: the consumers meet first)
  named_bar_sync(1, 32 * kConsumers);
  float* red = reinterpret_cast<float*>(ring.base);  // [kConsumers][kParts][kCG]
#pragma unroll
  for (int k = 0; k < kTaps; ++k) red[(warp * kParts + k) * kCG + lane] = acc[k];
  red[(warp * kParts + kTaps) * kCG + lane] = db;
  named_bar_sync(1, 32 * kConsumers);
  float* out = part + static_cast<int64_t>(chunk) * kParts * C + g * kCG;
  for (int e = threadIdx.x; e < kParts * kCG; e += 32 * kConsumers) {
    const int k = e / kCG, cc = e % kCG;
    float sum = red[k * kCG + cc];
#pragma unroll
    for (int q = 1; q < kConsumers; ++q) sum += red[(q * kParts + k) * kCG + cc];
    if (g * kCG + cc < C) out[k * C + cc] = sum;
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

// ------------------------------------------------------------------- host

bool shape_ok(int B, int H, int W, int C) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 != 0 || C > kMaxC) return false;
  const int64_t tiles = static_cast<int64_t>(B) * ((H + kTile - 1) / kTile) *
                        ((W + kTile - 1) / kTile) * ((C + kCG - 1) / kCG);
  return tiles < (int64_t{1} << 31);
}

int sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return static_cast<int>(err);
}

// dwconv_plan of ops/dwconv.py: the grid of each kernel and the weight
// pass's chunks, from the shapes and the SM count alone
struct Plan {
  int64_t tiles;      // the stencil's (group, image, band, column tile) tiles
  int fwd_grid;       // min(tiles, SMs * fwd_blocks)
  int64_t per_chunk;  // the weight pass's items (image, band, column tile) a block
  int chunks;         // its partial rows
  int wgrad_grid;     // groups * chunks
};

template <typename T>
Plan make_plan(int B, int H, int W, int C, int sms) {
  const int64_t bands = (H + kTile - 1) / kTile, ctiles = (W + kTile - 1) / kTile;
  const int64_t groups = (C + kCG - 1) / kCG, items = B * bands * ctiles;
  Plan p;
  p.tiles = groups * items;  // below 2^31 (shape_ok)
  const int64_t slots = static_cast<int64_t>(sms) * fwd_blocks<T>();
  p.fwd_grid = static_cast<int>(p.tiles < slots ? p.tiles : slots);
  int64_t want = static_cast<int64_t>(sms) * wgrad_blocks<T>() / groups;
  want = want < 1 ? 1 : (want > items ? items : want);
  p.per_chunk = (items + want - 1) / want;
  p.chunks = static_cast<int>((items + p.per_chunk - 1) / p.per_chunk);
  p.wgrad_grid = static_cast<int>(groups * p.chunks);
  return p;
}

// [B, H, W, C] as a 4-D tensor map (C, W, H, B) in boxes of 32 channels x
// `box` columns x `box` rows x 1 image; zeros outside the map
template <typename T>
bool make_map(CUtensorMap* map, const void* base, int B, int H, int W, int C, int box) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {dims[0] * es, dims[0] * dims[1] * es,
                                 dims[0] * dims[1] * dims[2] * es};
  const cuuint32_t boxes[4] = {kCG, static_cast<cuuint32_t>(box), static_cast<cuuint32_t>(box),
                               1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, boxes, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
cudaError_t allow_smem(K kern, int smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, bool kDx>
int launch_fwd(const void* x, const void* wt, const void* bias, void* y, int B, int H, int W,
               int C, int grid, int stages, int smem, cudaStream_t st) {
  int sms = 0;
  if (int err = sm_count(&sms)) return err;
  const Plan p = make_plan<T>(B, H, W, C, sms);
  if (grid != p.fwd_grid || stages != kStages || smem != fwd_smem<T>()) return -1;
  CUtensorMap xmap, ymap;
  if (!make_map<T>(&xmap, x, B, H, W, C, kHalo) || !make_map<T>(&ymap, y, B, H, W, C, kTile))
    return -2;
  auto kern = dwconv_fwd_kernel<T, kDx>;
  if (cudaError_t err = allow_smem(kern, smem)) return static_cast<int>(err);
  kern<<<grid, kThreads, smem, st>>>(xmap, ymap, static_cast<const float*>(wt),
                                     static_cast<const float*>(bias), B, C,
                                     (H + kTile - 1) / kTile, (W + kTile - 1) / kTile,
                                     static_cast<int>(p.tiles));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wgrad(const void* x, const void* dy, int B, int H, int W, int C, int grid,
                 int stages, int smem, int64_t per_chunk, int chunks, void* part,
                 cudaStream_t st) {
  int sms = 0;
  if (int err = sm_count(&sms)) return err;
  const Plan p = make_plan<T>(B, H, W, C, sms);
  if (grid != p.wgrad_grid || stages != kStages || smem != wgrad_smem<T>() ||
      per_chunk != p.per_chunk || chunks != p.chunks)
    return -1;
  CUtensorMap xmap, dymap;
  if (!make_map<T>(&xmap, x, B, H, W, C, kHalo) || !make_map<T>(&dymap, dy, B, H, W, C, kTile))
    return -2;
  auto kern = dwconv_wgrad_kernel<T>;
  if (cudaError_t err = allow_smem(kern, smem)) return static_cast<int>(err);
  const int64_t items = static_cast<int64_t>(B) * ((H + kTile - 1) / kTile) *
                        ((W + kTile - 1) / kTile);
  kern<<<grid, kThreads, smem, st>>>(xmap, dymap, C, (H + kTile - 1) / kTile,
                                     (W + kTile - 1) / kTile, (C + kCG - 1) / kCG, per_chunk,
                                     items, static_cast<float*>(part));
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int occupancy(K kern, int smem) {
  int blocks = 0;
  if (allow_smem(kern, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads, smem) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

extern "C" {

int dwconv_supports(int C) { return C > 0 && C % 8 == 0 && C <= kMaxC; }

// Blocks of a kernel that fit on one SM at the plan's shared memory, as
// the occupancy calculator gives them (kind 0: forward and dx, 1: weight
// pass; dtype as below); -1 on an error. The plan counts on fwd_blocks
// and wgrad_blocks.
int dwconv_occupancy(int kind, int dtype) {
  if (kind == 0)
    return dtype == 0 ? occupancy(dwconv_fwd_kernel<float, false>, fwd_smem<float>())
                      : occupancy(dwconv_fwd_kernel<bf16, false>, fwd_smem<bf16>());
  return dtype == 0 ? occupancy(dwconv_wgrad_kernel<float>, wgrad_smem<float>())
                    : occupancy(dwconv_wgrad_kernel<bf16>, wgrad_smem<bf16>());
}

// dtype: 0 = float32, 1 = bfloat16 (x and y). dx = 0: y from x, bias [C]
// f32; dx = 1: dx from dy (passed as x, written to y), flipped taps, bias
// unused. wt is [49, C] f32. Maps are contiguous NHWC, 16-byte aligned.
// grid, stages and smem are dwconv_plan's.
int dwconv_fwd(int dtype, int dx, const void* x, const void* wt, const void* bias, void* y,
               int B, int H, int W, int C, int grid, int stages, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, H, W, C) || (dtype != 0 && dtype != 1)) return -1;
  if (dtype == 0)
    return dx ? launch_fwd<float, true>(x, wt, bias, y, B, H, W, C, grid, stages, smem, st)
              : launch_fwd<float, false>(x, wt, bias, y, B, H, W, C, grid, stages, smem, st);
  return dx ? launch_fwd<bf16, true>(x, wt, bias, y, B, H, W, C, grid, stages, smem, st)
            : launch_fwd<bf16, false>(x, wt, bias, y, B, H, W, C, grid, stages, smem, st);
}

// part: f32 [chunks, 50, C]; chunk k sums the (image, band, column tile)
// items [k * per_chunk, (k + 1) * per_chunk) of the B * ceil(H / 14) *
// ceil(W / 14). grid, stages, smem, per_chunk and chunks are dwconv_plan's.
int dwconv_wgrad(int dtype, const void* x, const void* dy, int B, int H, int W, int C, int grid,
                 int stages, int smem, int64_t per_chunk, int chunks, void* part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, H, W, C) || (dtype != 0 && dtype != 1)) return -1;
  return dtype == 0 ? launch_wgrad<float>(x, dy, B, H, W, C, grid, stages, smem, per_chunk,
                                          chunks, part, st)
                    : launch_wgrad<bf16>(x, dy, B, H, W, C, grid, stages, smem, per_chunk,
                                         chunks, part, st);
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
