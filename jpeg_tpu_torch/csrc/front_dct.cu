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
// kOrderGray is front_dct_gray_kernel: [B, H, W] u8 planes (H, W multiples
// of 8) -> raster 8x8 blocks with the luma quantizer, no color conversion
// (jpeg_tpu's encode_gray, pipelines/encode.py::_analyze_gray_fn).
//
// The pixel-block mode (jt_front_dct_px, front_dct_px_kernel) takes f32
// pixel blocks, color-converted and un-level-shifted, in a segment's MCU
// order ([N, 64], or transposed [64, N] as jpeg_tpu's xt), and picks the
// luma or chroma quantizer by each block's position in the layout's
// period: the DCT of fused.py::dct_attach_pack_segments (K7) and
// dct_index_xt (K18a).
//
// What bounds it on an H100: the DCT is 64 multiply-adds per coefficient
// (about 25 MFLOP per 640x640 4:2:0 image) against 1.5 bytes of pixels
// read and 2 bytes of coefficients written per output, so it is a light
// mix of memory traffic and FP32 work; the TPU's permutation matmuls and
// slab layout have no counterpart here.  Design: a block of 256 threads
// walks groups of 4 MCUs (grid-stride, so each block loads the basis
// once).  Each thread keeps one row of the [64, 64] zig-zag DCT basis in
// registers and computes that coefficient for the 3, 4 or 6 blocks of its
// MCU, reading the staged pixels from shared memory as warp-wide
// broadcasts; writes of consecutive coefficients are coalesced.
//
// Exactness (no fast math): color is integer fixed point, y = y_t / 1000
// and cb = (cb_t >> 6) / 15625, which equal the reference's f32 floor
// form because every dividend is < 2^24.  The quantize is an IEEE
// round-to-nearest divide (__fdiv_rn), truncf and a clip to
// [-2048, 2047]; the 64-term dot is a chain of FMAs and the bias add is
// rounded on its own (__fadd_rn), as the reference adds it after the dot.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMcusPerIter = 4;
constexpr int kThreads = 64 * kMcusPerIter;
constexpr int kOrderMcu = 0, kOrderScan = 1, kOrderGray = 2;
constexpr int kS420 = 0, kS422 = 1, kS444 = 2;

// MCU geometry of a subsampling: kW x kH pixels, kYv x kYh Y blocks
template <int kSamp>
struct Mcu {
  static constexpr int kW = kSamp == kS444 ? 8 : 16;
  static constexpr int kH = kSamp == kS420 ? 16 : 8;
  static constexpr int kYh = kW / 8, kYv = kH / 8;
  static constexpr int kYpm = kYh * kYv;
  static constexpr int kBlocks = kYpm + 2;
  static constexpr int kPixPerThread = kW * kH / 64;
};

// The quantized coefficient k of one block, from its 64 staged pixels:
// a chain of FMAs, the bias added on its own, an IEEE divide and truncf.
__device__ __forceinline__ int16_t dct_coef(const float* mk, const float* x,
                                            float bk, float qk) {
  float d = 0.0f;
#pragma unroll
  for (int i = 0; i < 64; ++i) d = __fmaf_rn(mk[i], x[i], d);
  const float f = __fadd_rn(d, bk);
  float v = truncf(__fdiv_rn(f, qk));
  v = fminf(fmaxf(v, -2048.0f), 2047.0f);
  return (int16_t)v;
}

template <int kSamp>
__global__ void __launch_bounds__(kThreads)
front_dct_kernel(const uint8_t* __restrict__ rgb, const float* __restrict__ m,
                 const float* __restrict__ bias, const float* __restrict__ ql,
                 const float* __restrict__ qc, int16_t* __restrict__ out,
                 int height, int width, long long total_mcus, int order) {
  using G = Mcu<kSamp>;
  __shared__ float s_px[kMcusPerIter][G::kBlocks][64];
  // full-resolution chroma of the MCU before its average (4:2:0, 4:2:2)
  __shared__ int s_chroma[kMcusPerIter][2][kSamp == kS444 ? 1 : 16 * G::kH];

  const int t = threadIdx.x;
  const int local = t >> 6;  // MCU of this thread within the group
  const int k = t & 63;      // zig-zag coefficient this thread computes

  float mk[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) mk[i] = m[k * 64 + i];
  const float bk = bias[k];
  const float qlk = ql[k];
  const float qck = qc[k];

  const int mcus_x = width / G::kW;
  const long long mcus_per_img = (long long)mcus_x * (height / G::kH);
  const long long row_bytes = 3LL * width;
  const long long n_groups = (total_mcus + kMcusPerIter - 1) / kMcusPerIter;

  for (long long g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const long long mcu = g * kMcusPerIter + local;
    const bool live = mcu < total_mcus;
    const long long img = mcu / mcus_per_img;
    const long long r = mcu - img * mcus_per_img;
    const int my = (int)(r / mcus_x);
    const int mx = (int)(r - (long long)my * mcus_x);
    if (live) {
      const uint8_t* base = rgb + (img * height + (long long)my * G::kH) *
                                      row_bytes + mx * (3 * G::kW);
#pragma unroll
      for (int j = 0; j < G::kPixPerThread; ++j) {
        const int p = k + 64 * j;  // pixel of the MCU, raster order
        const int py = p / G::kW, px = p % G::kW;
        const uint8_t* q = base + py * row_bytes + px * 3;
        const int R = q[0], Gr = q[1], B = q[2];
        const int y = (299 * R + 587 * Gr + 114 * B) / 1000;
        const int cb_t = 128000000 + (-168736 * R - 331264 * Gr + 500000 * B);
        const int cr_t = 128000000 + (500000 * R - 418688 * Gr - 81312 * B);
        s_px[local][(py >> 3) * G::kYh + (px >> 3)]
            [((py & 7) << 3) | (px & 7)] = (float)y;
        if constexpr (kSamp == kS444) {  // p == k: chroma pixel k
          s_px[local][1][k] = (float)((cb_t >> 6) / 15625);
          s_px[local][2][k] = (float)((cr_t >> 6) / 15625);
        } else {
          s_chroma[local][0][p] = (cb_t >> 6) / 15625;
          s_chroma[local][1][p] = (cr_t >> 6) / 15625;
        }
      }
    }
    if constexpr (kSamp != kS444) {
      __syncthreads();
      if (live) {
        // truncating chroma average: chroma pixel k of the 8x8 block
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int* s = s_chroma[local][c];
          int v;
          if constexpr (kSamp == kS420) {  // 2x2: rows 2cy, 2cy + 1
            const int p = ((k >> 3) << 5) | ((k & 7) << 1);
            v = (s[p] + s[p + 1] + s[p + 16] + s[p + 17]) >> 2;
          } else {  // 1x2: row cy
            const int p = ((k >> 3) << 4) | ((k & 7) << 1);
            v = (s[p] + s[p + 1]) >> 1;
          }
          s_px[local][G::kYpm + c][k] = (float)v;
        }
      }
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int blk = 0; blk < G::kBlocks; ++blk) {
        long long ob;  // the output block of this MCU's block blk
        if (order == kOrderMcu) {
          ob = mcu * G::kBlocks + blk;
        } else if (blk < G::kYpm) {  // Y: raster block of the Y plane
          const int by = G::kYv * my + blk / G::kYh;
          const int bx = G::kYh * mx + blk % G::kYh;
          ob = img * G::kYpm * mcus_per_img +
               (long long)by * (G::kYh * mcus_x) + bx;
        } else {  // Cb, Cr: after every image's Y blocks
          ob = G::kYpm * total_mcus + img * 2 * mcus_per_img +
               (blk - G::kYpm) * mcus_per_img + r;
        }
        out[ob * 64 + k] =
            dct_coef(mk, s_px[local][blk], bk, blk < G::kYpm ? qlk : qck);
      }
    }
    __syncthreads();
  }
}

// Grayscale: one thread per (block, coefficient), 4 blocks per iteration
// of a grid-stride loop; the 64 pixels of each block are staged in shared
// memory and the DCT is the color kernel's FMA chain.
__global__ void __launch_bounds__(kThreads)
front_dct_gray_kernel(const uint8_t* __restrict__ plane,
                      const float* __restrict__ m,
                      const float* __restrict__ bias,
                      const float* __restrict__ ql, int16_t* __restrict__ out,
                      int height, int width, long long total_blocks) {
  __shared__ float s_px[kMcusPerIter][64];
  const int t = threadIdx.x;
  const int local = t >> 6;  // block of this thread within the group
  const int k = t & 63;      // coefficient (and, for the load, pixel)

  float mk[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) mk[i] = m[k * 64 + i];
  const float bk = bias[k];
  const float qlk = ql[k];

  const int bx_n = width / 8;
  const long long blocks_per_img = (long long)bx_n * (height / 8);
  const long long n_groups = (total_blocks + kMcusPerIter - 1) / kMcusPerIter;
  for (long long g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const long long gb = g * kMcusPerIter + local;
    const bool live = gb < total_blocks;
    if (live) {
      const long long img = gb / blocks_per_img;
      const long long r = gb - img * blocks_per_img;
      const int by = (int)(r / bx_n);
      const int bx = (int)(r - (long long)by * bx_n);
      s_px[local][k] = (float)plane[(img * height + by * 8 + (k >> 3)) *
                                        (long long)width +
                                    bx * 8 + (k & 7)];
    }
    __syncthreads();
    if (live) out[gb * 64 + k] = dct_coef(mk, s_px[local], bk, qlk);
    __syncthreads();
  }
}

// Pixel blocks: pixel i of block b is px[b * block_stride + i *
// elem_stride] ([N, 64]: 64, 1; the transposed [64, N]: 1, N).  One
// thread per (block, coefficient), 4 blocks per iteration; the load maps
// threads so that neighbours read neighbouring addresses in either
// layout.  Block b is luma when its position in its segment of nblk_seg
// blocks, modulo period, is below y_per_mcu.
__global__ void __launch_bounds__(kThreads)
front_dct_px_kernel(const float* __restrict__ px,
                    const float* __restrict__ m,
                    const float* __restrict__ bias,
                    const float* __restrict__ ql,
                    const float* __restrict__ qc, int16_t* __restrict__ out,
                    long long total_blocks, int nblk_seg, int period,
                    int y_per_mcu, long long block_stride,
                    long long elem_stride) {
  __shared__ float s_px[kMcusPerIter][64];
  const int t = threadIdx.x;
  const int local = t >> 6;  // block of this thread within the group
  const int k = t & 63;      // coefficient this thread computes
  const bool rows = elem_stride == 1;
  const int ld_block = rows ? local : (t & (kMcusPerIter - 1));
  const int ld_pixel = rows ? k : (t / kMcusPerIter);

  float mk[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) mk[i] = m[k * 64 + i];
  const float bk = bias[k];
  const float qlk = ql[k];
  const float qck = qc[k];

  const long long n_groups = (total_blocks + kMcusPerIter - 1) / kMcusPerIter;
  for (long long g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const long long lb = g * kMcusPerIter + ld_block;
    if (lb < total_blocks)
      s_px[ld_block][ld_pixel] =
          px[lb * block_stride + (long long)ld_pixel * elem_stride];
    __syncthreads();
    const long long gb = g * kMcusPerIter + local;
    if (gb < total_blocks) {
      const bool luma = (int)(gb % nblk_seg) % period < y_per_mcu;
      out[gb * 64 + k] = dct_coef(mk, s_px[local], bk, luma ? qlk : qck);
    }
    __syncthreads();
  }
}

// grid: enough blocks to cover the work, at most 8 per SM (grid-stride)
int grid_for(long long units) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long groups = (units + kMcusPerIter - 1) / kMcusPerIter;
  const long long cap = 8LL * (sms > 0 ? sms : 1);
  return (int)(groups < cap ? groups : cap);
}

template <int kSamp>
int launch_color(const void* rgb, const void* m, const void* bias,
                 const void* ql, const void* qc, void* out, int n_images,
                 int height, int width, int order, cudaStream_t stream) {
  using G = Mcu<kSamp>;
  if (height % G::kH || width % G::kW) return (int)cudaErrorInvalidValue;
  const long long total =
      (long long)n_images * (height / G::kH) * (width / G::kW);
  if (total == 0) return (int)cudaGetLastError();
  front_dct_kernel<kSamp><<<grid_for(total), kThreads, 0, stream>>>(
      (const uint8_t*)rgb, (const float*)m, (const float*)bias,
      (const float*)ql, (const float*)qc, (int16_t*)out, height, width,
      total, order);
  return (int)cudaGetLastError();
}

}  // namespace

// order: kOrderMcu, kOrderScan (sampling 0: 4:2:0, 1: 4:2:2, 2: 4:4:4) or
// kOrderGray (sampling ignored).
extern "C" int jt_front_dct(const void* rgb, const void* m, const void* bias,
                            const void* ql, const void* qc, void* out,
                            int n_images, int height, int width, int order,
                            int sampling, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (order == kOrderGray) {
    if (height % 8 || width % 8) return (int)cudaErrorInvalidValue;
    const long long total = (long long)n_images * (height / 8) * (width / 8);
    if (total == 0) return (int)cudaGetLastError();
    front_dct_gray_kernel<<<grid_for(total), kThreads, 0, s>>>(
        (const uint8_t*)rgb, (const float*)m, (const float*)bias,
        (const float*)ql, (int16_t*)out, height, width, total);
    return (int)cudaGetLastError();
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

extern "C" int jt_front_dct_px(const void* px, const void* m,
                               const void* bias, const void* ql,
                               const void* qc, void* out, int n_segments,
                               int nblk_seg, int period, int y_per_mcu,
                               int transposed, void* stream) {
  if (n_segments < 0 || nblk_seg < 0 || period < 1 || y_per_mcu < 0 ||
      y_per_mcu > period)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)n_segments * nblk_seg;
  if (total == 0) return (int)cudaGetLastError();
  const long long block_stride = transposed ? 1 : 64;
  const long long elem_stride = transposed ? total : 1;
  front_dct_px_kernel<<<grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)px, (const float*)m, (const float*)bias,
      (const float*)ql, (const float*)qc, (int16_t*)out, total, nblk_seg,
      period, y_per_mcu, block_stride, elem_stride);
  return (int)cudaGetLastError();
}
