// Kernel A, front_dct: pixels -> quantized zig-zag DCT coefficients.
//
// Replaces the front half of jpeg_tpu's mega kernel
// (kernels/front.py::front_place -> _mega_place_kernel, via _front_slab),
// the pixel front kernels/front.py::front_analyze -> _front_kernel, and the
// DCT + quantize of kernels/fused.py::_dct_attach_kernel and
// _dct_symbolize_chunk_v, at every chroma subsampling those take.  Input
// is [B, H, W*3] u8; output is [B * n_mcus * period, 64] int16 zig-zag
// coefficients in one of two orders:
//   kOrderMcu:  the interleaved MCU order (MCUs in raster order, each its
//               Y blocks in raster order, then Cb and Cr): 4:2:0 is a
//               16x16 MCU of Y00 Y01 Y10 Y11 Cb Cr, 4:2:2 a 16x8 MCU of
//               Y0 Y1 Cb Cr, 4:4:4 an 8x8 MCU of Y Cb Cr;
//   kOrderScan: the 3-scan order of jpeg_tpu's JpegEncoder
//               (pipelines/encode.py::analyze_fn, to_blocks per plane):
//               every image's Y blocks in raster order, one image after
//               another, then per image its Cb blocks and its Cr blocks in
//               raster order.  Each image's Y scan and each image's Cb + Cr
//               scans are then contiguous, so kernels B-F take them as
//               uniform segments with no copy pass: the order is an
//               output-index map applied at the store.
// The chroma average is 2x2 (4:2:0) or 1x2 (4:2:2) and truncating, as
// jpeg_tpu/ops/color.py::_avg2x2 and _avg1x2; 4:4:4 keeps every sample.
// The subsampling is a template parameter: each mode is its own kernel.
// The gray mode ([B, H, W] u8 planes, H and W multiples of 8) gives raster
// 8x8 blocks with the luma quantizer and no color conversion (jpeg_tpu's
// encode_gray, pipelines/encode.py::_analyze_gray_fn).
//
// The pixel-block mode (jt_front_dct_px) takes f32 pixel blocks,
// color-converted and un-level-shifted, in a segment's MCU order ([N, 64],
// or transposed [64, N] as jpeg_tpu's xt), and picks the luma or chroma
// quantizer by each block's position in the layout's period: the DCT of
// fused.py::dct_attach_pack_segments (K7) and dct_index_xt (K18a).
//
// What bounds it on an H100: operations.  The DCT is 64 multiply-adds per
// coefficient (about 25 MFLOP per 640x640 4:2:0 image) against 1.5 bytes
// of pixels read and 2 bytes of coefficients written per output, so the
// FP32 pipe sets the floor; the TPU's permutation matmuls and slab layout
// have no counterpart here.  Next to the FMA pipe, the path from shared
// memory to the registers (128 bytes a clock an SM, broadcasts included)
// can bound it: a thread that keeps one basis row in registers needs one
// pixel delivered per FMA, a quarter of the FMA rate.  So each thread
// computes a register tile, 8 coefficients of 6 blocks (48 chains), and
// per pixel index i reads 6 pixels and 8 basis values from shared memory
// for its 48 FMAs.  Design: every mode is one kernel skeleton
// (front_dct_kernel): CTAs of 128 threads, three an SM, walk groups of 96
// blocks (grid-stride).  A CTA keeps the transposed [64, 64] basis and the
// group's pixels, [64 pixel indices][96 blocks], in shared memory, with the
// output block and the quantizer of each block of the group.  The next
// group's source bytes (the MCUs' pixel rows, 16 or 8 bytes a copy; a gray
// block row; f32 pixel blocks) are copied to shared memory with cp.async
// before the current group's DCT, so their latency hides behind the FMAs;
// after the DCT a barrier, the color conversion and chroma average of that
// group into the pixel array, and a barrier.  Each thread stores a block's
// 8 coefficients as two 8-byte writes.
//
// Exactness (no fast math): color is integer fixed point, y = y_t / 1000
// and cb = (cb_t >> 6) / 15625, which equal the reference's f32 floor
// form because every dividend is < 2^24.  The quantize is the f32 quotient
// rounded to nearest (as an IEEE divide gives it; see quantize), truncf
// and a clip to [-2048, 2047]; each coefficient's 64-term dot is one chain
// of FMAs in index order, and the bias add is rounded on its own
// (__fadd_rn), as the reference adds it after the dot.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;            // a CTA
constexpr int kCtasPerSm = 3;            // the grid: at most this many an SM
constexpr int kKt = 8;                   // coefficients of a thread's tile
constexpr int kC = 6;                    // blocks of a thread's tile
constexpr int kGroup = kThreads / (64 / kKt) * kC;  // blocks a group: 96
constexpr int kXStride = kGroup + 2;     // floats a pixel row: 2-way banks
constexpr int kRawBytes = kGroup * 64 * 4;  // the largest source: f32 blocks
constexpr int kOrderMcu = 0, kOrderScan = 1, kOrderGray = 2;
constexpr int kS420 = 0, kS422 = 1, kS444 = 2;

// A CTA's shared memory
struct Smem {
  float basis[64][64];               // basis[i][k]: the transposed m
  float x[64][kXStride];             // x[i][b]: pixel i of block b
  alignas(16) unsigned char raw[kRawBytes];  // the next group's source
  long long ob[kGroup];              // output block of block b (-1: none)
  unsigned char luma[kGroup];        // block b takes the luma quantizer
};

// The quantized coefficient of one block from its dot `d`: the bias added
// on its own, then f / q rounded to f32, truncf and the clip.  The quotient
// is f times r = RN64(1 / q), the double nearest 1 / q, rounded to f32: the
// same f32 as the IEEE divide __fdiv_rn(f, q) for every f and q, without
// its range check and slow-path branch, which keep a thread's 48 divides
// from overlapping.  Proof: f * r in double is t = f / q within a relative 2^-52
// (two roundings of 2^-53).  A rounding boundary of f32 is a midpoint m =
// M 2^c, M odd of 25 bits; with f = F 2^a (|F| < 2^24) and q = Q 2^b (Q
// odd, < 2^24), f - q m is a nonzero multiple of 2^min(a, b + c) (q m has
// the odd significand Q M of at least 25 bits, so it is no f32), hence |t -
// m| / |t| is at least 1 / |F| > 2^-24 or about 1 / (Q M) > 2^-49: no
// midpoint lies between t and f * r, and both round to the same f32.
__device__ __forceinline__ int quantize(float d, float bk, double r) {
  const float f = __fadd_rn(d, bk);
  float v = truncf(__double2float_rn(__dmul_rn((double)f, r)));
  v = fminf(fmaxf(v, -2048.0f), 2047.0f);
  return (int)v;
}

// The kernel skeleton of every mode.  Mode gives n_groups, fetch (start
// the copies of group g's source into raw, cp.async) and stage (raw into
// the group's pixels x, and each block's output block and quantizer).
template <class Mode>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
front_dct_kernel(const Mode mode, const float* __restrict__ m,
                 const float* __restrict__ bias, const float* __restrict__ ql,
                 const float* __restrict__ qc, int16_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& sm = *(Smem*)smem;
  const int t = threadIdx.x;
  // the thread's tile: coefficients k0..k0+3 and k0+32..k0+35 (so that a
  // warp's basis loads are conflict-free), blocks b0..b0+5
  const int k0 = (t & 7) * 4, b0 = (t >> 3) * kC;
  long long g = blockIdx.x;
  mode.fetch(g, t, sm.raw);
  __pipeline_commit();
  for (int e = t; e < 64 * 64; e += kThreads)
    sm.basis[e & 63][e >> 6] = __ldg(m + e);
  float bk[kKt];
  double rl[kKt], rc[kKt];  // the quantizers' reciprocals (see quantize)
#pragma unroll
  for (int kk = 0; kk < kKt; ++kk) {
    const int k = k0 + (kk & 3) + (kk >> 2) * 32;
    bk[kk] = __ldg(bias + k);
    rl[kk] = __drcp_rn((double)__ldg(ql + k));
    rc[kk] = __drcp_rn((double)__ldg(qc + k));
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  mode.stage(g, t, sm);
  __syncthreads();
  for (; g < mode.n_groups; g += gridDim.x) {
    const long long next = g + gridDim.x;
    if (next < mode.n_groups) mode.fetch(next, t, sm.raw);  // in flight now
    __pipeline_commit();
    float acc[kKt][kC];
#pragma unroll
    for (int kk = 0; kk < kKt; ++kk)
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[kk][c] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < 64; ++i) {
      const float2 x01 = *(const float2*)&sm.x[i][b0];
      const float2 x23 = *(const float2*)&sm.x[i][b0 + 2];
      const float2 x45 = *(const float2*)&sm.x[i][b0 + 4];
      const float4 m03 = *(const float4*)&sm.basis[i][k0];
      const float4 m47 = *(const float4*)&sm.basis[i][k0 + 32];
      const float xv[kC] = {x01.x, x01.y, x23.x, x23.y, x45.x, x45.y};
      const float mv[kKt] = {m03.x, m03.y, m03.z, m03.w,
                             m47.x, m47.y, m47.z, m47.w};
#pragma unroll
      for (int kk = 0; kk < kKt; ++kk)
#pragma unroll
        for (int c = 0; c < kC; ++c)
          acc[kk][c] = __fmaf_rn(mv[kk], xv[c], acc[kk][c]);
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const long long ob = sm.ob[b0 + c];
      if (ob < 0) continue;
      const bool luma = sm.luma[b0 + c] != 0;
      int v[kKt];
#pragma unroll
      for (int kk = 0; kk < kKt; ++kk)
        v[kk] = quantize(acc[kk][c], bk[kk], luma ? rl[kk] : rc[kk]);
      int16_t* o = out + ob * 64 + k0;
      *(uint2*)o = make_uint2((unsigned)(v[0] & 0xFFFF) | (unsigned)v[1] << 16,
                              (unsigned)(v[2] & 0xFFFF) | (unsigned)v[3] << 16);
      *(uint2*)(o + 32) =
          make_uint2((unsigned)(v[4] & 0xFFFF) | (unsigned)v[5] << 16,
                     (unsigned)(v[6] & 0xFFFF) | (unsigned)v[7] << 16);
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    if (next < mode.n_groups) mode.stage(next, t, sm);
    __syncthreads();
  }
}

// fixed-point RGB -> Y, Cb, Cr of the pixel in the low 3 bytes of w
__device__ __forceinline__ void ycc(uint64_t w, int* y, int* cb, int* cr) {
  const int R = (int)(w & 0xFF), G = (int)(w >> 8 & 0xFF),
            B = (int)(w >> 16 & 0xFF);
  *y = (int)((unsigned)(299 * R + 587 * G + 114 * B) / 1000u);
  // both dividends lie in [500000, 255500000]: unsigned and exact
  *cb = (int)(((unsigned)(128000000 + (-168736 * R - 331264 * G +
                                       500000 * B)) >> 6) / 15625u);
  *cr = (int)(((unsigned)(128000000 + (500000 * R - 418688 * G -
                                       81312 * B)) >> 6) / 15625u);
}

// The color modes: kSamp's MCU of kW x kH pixels, kYv x kYh Y blocks, and
// 96 / period MCUs a group.  The source of a group: each MCU's kH pixel
// rows of 3 kW bytes, copied in 16-byte pieces (4:4:4: 8).  The conversion
// takes a unit a step: two adjacent pixels of one row, at 4:2:0 of two
// rows (a 2x2 chroma cell).
template <int kSamp>
struct ColorMode {
  static constexpr int kW = kSamp == kS444 ? 8 : 16;
  static constexpr int kH = kSamp == kS420 ? 16 : 8;
  static constexpr int kYh = kW / 8, kYv = kH / 8, kYpm = kYh * kYv;
  static constexpr int kMcuBlocks = kYpm + 2;
  static constexpr int kMcus = kGroup / kMcuBlocks;
  static constexpr int kRow = 3 * kW;                   // bytes
  static constexpr int kSrc = kH * kRow + 16;  // an MCU's source, padded
  static constexpr int kPiece = kSamp == kS444 ? 8 : 16;
  static constexpr int kPieces = kMcus * kH * (kRow / kPiece);
  static constexpr int kUr = kSamp == kS420 ? 2 : 1;   // rows of a unit
  static constexpr int kUx = kW / 2;                   // units across
  static constexpr int kUnits = kUx * (kH / kUr);      // units of an MCU
  static_assert(kMcus * kMcuBlocks == kGroup, "whole MCUs a group");
  static_assert(kMcus * kSrc <= kRawBytes, "the source fits");

  const uint8_t* rgb;
  int height, width, mcus_x, mcus_per_img, total_mcus, order;
  long long n_groups;

  __device__ __forceinline__ void fetch(long long g, int t,
                                        unsigned char* raw) const {
    for (int q = t; q < kPieces; q += kThreads) {
      const int mi = q / (kH * (kRow / kPiece));
      const int rest = q - mi * (kH * (kRow / kPiece));
      const int row = rest / (kRow / kPiece);
      const int piece = rest - row * (kRow / kPiece);
      const long long mcu = g * kMcus + mi;
      if (mcu >= total_mcus) continue;
      const int img = (int)mcu / mcus_per_img;
      const int r = (int)mcu - img * mcus_per_img;
      const int my = r / mcus_x, mx = r - my * mcus_x;
      __pipeline_memcpy_async(
          raw + mi * kSrc + row * kRow + piece * kPiece,
          rgb + ((long long)img * height + my * kH + row) * (3LL * width) +
              mx * kRow + piece * kPiece,
          kPiece);
    }
  }

  __device__ __forceinline__ void stage(long long g, int t, Smem& sm) const {
    // unit u: ux fastest, then the MCU, then uy, so that a warp's stores
    // spread over the banks
    for (int u = t; u < kMcus * kUnits; u += kThreads) {
      const int ux = u % kUx, mi = u / kUx % kMcus, uy = u / (kUx * kMcus);
      const int blk0 = mi * kMcuBlocks;
      int cb_sum = 0, cr_sum = 0;
#pragma unroll
      for (int r = 0; r < kUr; ++r) {
        const int py = uy * kUr + r, x0 = 2 * ux;
        const uint16_t* p =
            (const uint16_t*)(sm.raw + mi * kSrc + py * kRow + 6 * ux);
        const uint64_t w =
            (uint64_t)p[0] | (uint64_t)p[1] << 16 | (uint64_t)p[2] << 32;
        int y0, cb0, cr0, y1, cb1, cr1;
        ycc(w, &y0, &cb0, &cr0);
        ycc(w >> 24, &y1, &cb1, &cr1);
        const int i = ((py & 7) << 3) | (x0 & 7);
        const int b = blk0 + (py >> 3) * kYh + (x0 >> 3);
        sm.x[i][b] = (float)y0;
        sm.x[i + 1][b] = (float)y1;
        if constexpr (kSamp == kS444) {
          sm.x[i][blk0 + 1] = (float)cb0;
          sm.x[i + 1][blk0 + 1] = (float)cb1;
          sm.x[i][blk0 + 2] = (float)cr0;
          sm.x[i + 1][blk0 + 2] = (float)cr1;
        } else {
          cb_sum += cb0 + cb1;
          cr_sum += cr0 + cr1;
        }
      }
      if constexpr (kSamp != kS444) {  // the truncating average of the cell
        const int i = (uy << 3) | ux;
        sm.x[i][blk0 + kYpm] = (float)(cb_sum >> (kUr == 2 ? 2 : 1));
        sm.x[i][blk0 + kYpm + 1] = (float)(cr_sum >> (kUr == 2 ? 2 : 1));
      }
    }
    if (t < kGroup) {
      const int mi = t / kMcuBlocks, blk = t - mi * kMcuBlocks;
      const long long mcu = g * kMcus + mi;
      sm.luma[t] = blk < kYpm;
      sm.ob[t] = mcu < total_mcus ? out_block(mcu, blk) : -1;
    }
  }

  __device__ __forceinline__ long long out_block(long long mcu,
                                                 int blk) const {
    if (order == kOrderMcu) return mcu * kMcuBlocks + blk;
    const int img = (int)mcu / mcus_per_img;
    const int r = (int)mcu - img * mcus_per_img;
    if (blk < kYpm) {  // Y: raster block of the Y plane
      const int my = r / mcus_x, mx = r - my * mcus_x;
      return (long long)img * kYpm * mcus_per_img +
             (long long)(kYv * my + blk / kYh) * (kYh * mcus_x) + kYh * mx +
             blk % kYh;
    }
    // Cb, Cr: after every image's Y blocks
    return (long long)kYpm * total_mcus + (long long)img * 2 * mcus_per_img +
           (long long)(blk - kYpm) * mcus_per_img + r;
  }
};

// Gray: raster 8x8 blocks of [B, H, W] u8 planes; the source of a group is
// its blocks' rows, 8 bytes each.
struct GrayMode {
  const uint8_t* plane;
  int height, width, blocks_x, blocks_per_img, total;
  long long n_groups;

  __device__ __forceinline__ void fetch(long long g, int t,
                                        unsigned char* raw) const {
    for (int q = t; q < kGroup * 8; q += kThreads) {
      const long long gb = g * kGroup + (q >> 3);
      if (gb >= total) continue;
      const int img = (int)gb / blocks_per_img;
      const int r = (int)gb - img * blocks_per_img;
      const int by = r / blocks_x, bx = r - by * blocks_x;
      __pipeline_memcpy_async(
          raw + q * 8,
          plane + ((long long)img * height + by * 8 + (q & 7)) * width +
              bx * 8,
          8);
    }
  }

  __device__ __forceinline__ void stage(long long g, int t, Smem& sm) const {
    for (int q = t; q < kGroup * 8; q += kThreads) {
      const uint64_t w = *(const uint64_t*)(sm.raw + q * 8);
      const int b = q >> 3, i = (q & 7) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) sm.x[i + e][b] = (float)(w >> (8 * e) & 0xFF);
    }
    if (t < kGroup) {
      const long long gb = g * kGroup + t;
      sm.luma[t] = 1;
      sm.ob[t] = gb < total ? gb : -1;
    }
  }
};

// Pixel blocks: pixel i of block b is px[b * 64 + i] ([N, 64], copied 16
// bytes at a time) or px[i * N + b] (the transposed [64, N], 4 bytes at a
// time).  Block b is luma when its position in its segment of nblk_seg
// blocks, modulo period, is below y_per_mcu.
struct PxMode {
  const float* px;
  long long total;
  int nblk_seg, period, y_per_mcu, transposed;
  long long n_groups;

  __device__ __forceinline__ void fetch(long long g, int t,
                                        unsigned char* raw) const {
    if (!transposed) {
      for (int q = t; q < kGroup * 16; q += kThreads) {
        const long long gb = g * kGroup + (q >> 4);
        if (gb < total)
          __pipeline_memcpy_async(raw + q * 16, px + gb * 64 + (q & 15) * 4,
                                  16);
      }
      return;
    }
    for (int q = t; q < kGroup * 64; q += kThreads) {  // raw[i][b]
      const int i = q / kGroup, b = q - i * kGroup;
      const long long gb = g * kGroup + b;
      if (gb < total)
        __pipeline_memcpy_async(raw + q * 4, px + (long long)i * total + gb,
                                4);
    }
  }

  __device__ __forceinline__ void stage(long long g, int t, Smem& sm) const {
    const float* raw = (const float*)sm.raw;
    if (!transposed) {
      for (int q = t; q < kGroup * 16; q += kThreads) {
        const float4 v = *(const float4*)(raw + q * 4);
        const int b = q >> 4, i = (q & 15) * 4;
        sm.x[i][b] = v.x;
        sm.x[i + 1][b] = v.y;
        sm.x[i + 2][b] = v.z;
        sm.x[i + 3][b] = v.w;
      }
    } else {
      for (int q = t; q < kGroup * 64; q += kThreads) {
        const int i = q / kGroup, b = q - i * kGroup;
        sm.x[i][b] = raw[q];
      }
    }
    if (t < kGroup) {
      const long long gb = g * kGroup + t;
      sm.luma[t] = (int)(gb % nblk_seg) % period < y_per_mcu;
      sm.ob[t] = gb < total ? gb : -1;
    }
  }
};

// The grid: a CTA a group, at most kCtasPerSm an SM (grid-stride beyond)
template <class Mode>
int launch(const Mode& mode, const void* m, const void* bias, const void* ql,
           const void* qc, void* out, cudaStream_t stream) {
  if (mode.n_groups == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long cap = (long long)kCtasPerSm * (sms > 0 ? sms : 1);
  cudaError_t rc = cudaFuncSetAttribute(
      front_dct_kernel<Mode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (rc != cudaSuccess) return (int)rc;
  front_dct_kernel<Mode><<<(int)(mode.n_groups < cap ? mode.n_groups : cap),
                       kThreads, sizeof(Smem), stream>>>(
      mode, (const float*)m, (const float*)bias, (const float*)ql,
      (const float*)qc, (int16_t*)out);
  return (int)cudaGetLastError();
}

constexpr long long kMaxUnits = 0x7fffffffLL;  // block and MCU counts: int

template <int kSamp>
int launch_color(const void* rgb, const void* m, const void* bias,
                 const void* ql, const void* qc, void* out, int n_images,
                 int height, int width, int order, cudaStream_t stream) {
  using M = ColorMode<kSamp>;
  if (height % M::kH || width % M::kW || ((uintptr_t)rgb & (M::kPiece - 1)))
    return (int)cudaErrorInvalidValue;
  const long long per_img = (long long)(height / M::kH) * (width / M::kW);
  const long long total = n_images * per_img;
  if (total * M::kMcuBlocks > kMaxUnits) return (int)cudaErrorInvalidValue;
  const M mode{(const uint8_t*)rgb, height, width, width / M::kW,
               (int)per_img, (int)total, order,
               (total + M::kMcus - 1) / M::kMcus};
  return launch(mode, m, bias, ql, qc, out, stream);
}

}  // namespace

// order: kOrderMcu, kOrderScan (sampling 0: 4:2:0, 1: 4:2:2, 2: 4:4:4) or
// kOrderGray (sampling ignored).  The pixels must be 16-byte aligned
// (4:4:4 and gray: 8-byte).
extern "C" int jt_front_dct(const void* rgb, const void* m, const void* bias,
                            const void* ql, const void* qc, void* out,
                            int n_images, int height, int width, int order,
                            int sampling, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (order == kOrderGray) {
    if (height % 8 || width % 8 || ((uintptr_t)rgb & 7))
      return (int)cudaErrorInvalidValue;
    const long long per_img = (long long)(height / 8) * (width / 8);
    const long long total = n_images * per_img;
    if (total > kMaxUnits) return (int)cudaErrorInvalidValue;
    const GrayMode mode{(const uint8_t*)rgb, height, width, width / 8,
                        (int)per_img, (int)total,
                        (total + kGroup - 1) / kGroup};
    return launch(mode, m, bias, ql, ql, out, s);
  }
  if (order != kOrderMcu && order != kOrderScan)
    return (int)cudaErrorInvalidValue;
  switch (sampling) {
    case kS420:
      return launch_color<kS420>(rgb, m, bias, ql, qc, out, n_images, height,
                                 width, order, s);
    case kS422:
      return launch_color<kS422>(rgb, m, bias, ql, qc, out, n_images, height,
                                 width, order, s);
    case kS444:
      return launch_color<kS444>(rgb, m, bias, ql, qc, out, n_images, height,
                                 width, order, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The pixels must be 16-byte aligned ([N, 64]) or 4-byte ([64, N]).
extern "C" int jt_front_dct_px(const void* px, const void* m,
                               const void* bias, const void* ql,
                               const void* qc, void* out, int n_segments,
                               int nblk_seg, int period, int y_per_mcu,
                               int transposed, void* stream) {
  if (n_segments < 0 || nblk_seg < 0 || period < 1 || y_per_mcu < 0 ||
      y_per_mcu > period || ((uintptr_t)px & (transposed ? 3 : 15)))
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)n_segments * nblk_seg;
  const PxMode mode{(const float*)px, total, nblk_seg, period, y_per_mcu,
                    transposed,
                    (total + kGroup - 1) / kGroup};
  return launch(mode, m, bias, ql, qc, out, (cudaStream_t)stream);
}
