// Kernel A, front_dct: u8 RGB -> quantized zig-zag DCT coefficients.
//
// Replaces the front half of jpeg_tpu's mega kernel
// (kernels/front.py::front_place -> _mega_place_kernel, via _front_slab),
// the pixel front kernels/front.py::front_analyze -> _front_kernel, and the
// DCT + quantize of kernels/fused.py::_dct_attach_kernel and
// _dct_symbolize_chunk_v.  Input is [B, H, W*3] u8; output is
// [B * n_mcus * 6, 64] int16 zig-zag coefficients in one of two orders:
//   kOrderMcu:  the interleaved MCU order (MCUs in raster order, each
//               Y00 Y01 Y10 Y11 Cb Cr);
//   kOrderScan: the 3-scan order of jpeg_tpu's JpegEncoder
//               (pipelines/encode.py::analyze_fn, to_blocks per plane):
//               every image's Y blocks in raster order, one image after
//               another, then per image its Cb blocks and its Cr blocks in
//               raster order.  Each image's Y scan and each image's Cb + Cr
//               scans are then contiguous, so kernels B-F take them as
//               uniform segments with no copy pass: the order is an
//               output-index map applied at the store.
// kOrderGray is front_dct_gray_kernel: [B, H, W] u8 planes (H, W multiples
// of 8) -> raster 8x8 blocks with the luma quantizer, no color conversion
// (jpeg_tpu's encode_gray, pipelines/encode.py::_analyze_gray_fn).
//
// What bounds it on an H100: the DCT is 64 multiply-adds per coefficient
// (about 25 MFLOP per 640x640 image) against 1.5 bytes of pixels read and
// 2 bytes of coefficients written per output, so it is a light mix of
// memory traffic and FP32 work; the TPU's permutation matmuls and slab
// layout have no counterpart here.  Design: a block of 256 threads walks
// groups of 4 MCUs (grid-stride, so each block loads the basis once).
// Each thread keeps one row of the [64, 64] zig-zag DCT basis in registers
// and computes that coefficient for the 6 blocks of its MCU, reading the
// staged pixels from shared memory as warp-wide broadcasts; writes of
// consecutive coefficients are coalesced.
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

__global__ void __launch_bounds__(kThreads)
front_dct_kernel(const uint8_t* __restrict__ rgb, const float* __restrict__ m,
                 const float* __restrict__ bias, const float* __restrict__ ql,
                 const float* __restrict__ qc, int16_t* __restrict__ out,
                 int height, int width, long long total_mcus, int order) {
  __shared__ float s_px[kMcusPerIter][6][64];
  __shared__ int s_chroma[kMcusPerIter][2][256];

  const int t = threadIdx.x;
  const int local = t >> 6;  // MCU of this thread within the group
  const int k = t & 63;      // zig-zag coefficient this thread computes

  float mk[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) mk[i] = m[k * 64 + i];
  const float bk = bias[k];
  const float qlk = ql[k];
  const float qck = qc[k];

  const int mcus_x = width / 16;
  const long long mcus_per_img = (long long)mcus_x * (height / 16);
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
      const uint8_t* base = rgb + (img * height + my * 16) * row_bytes +
                            mx * 48;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = k + 64 * j;  // pixel of the 16x16 MCU, raster order
        const int py = p >> 4, px = p & 15;
        const uint8_t* q = base + py * row_bytes + px * 3;
        const int R = q[0], G = q[1], B = q[2];
        const int y = (299 * R + 587 * G + 114 * B) / 1000;
        const int cb_t = 128000000 + (-168736 * R - 331264 * G + 500000 * B);
        const int cr_t = 128000000 + (500000 * R - 418688 * G - 81312 * B);
        s_px[local][((py >> 3) << 1) | (px >> 3)][((py & 7) << 3) | (px & 7)] =
            (float)y;
        s_chroma[local][0][p] = (cb_t >> 6) / 15625;
        s_chroma[local][1][p] = (cr_t >> 6) / 15625;
      }
    }
    __syncthreads();
    if (live) {
      // 2x2 truncating chroma average: chroma pixel k of the 8x8 block
      const int p = ((k >> 3) << 5) | ((k & 7) << 1);  // (2cy)*16 + 2cx
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int* s = s_chroma[local][c];
        const int sum = s[p] + s[p + 1] + s[p + 16] + s[p + 17];
        s_px[local][4 + c][k] = (float)(sum >> 2);
      }
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int blk = 0; blk < 6; ++blk) {
        long long ob;  // the output block of this MCU's block blk
        if (order == kOrderMcu) {
          ob = mcu * 6 + blk;
        } else if (blk < 4) {  // Y: raster block (2my + dy, 2mx + dx)
          ob = img * 4 * mcus_per_img +
               (long long)(2 * my + (blk >> 1)) * (2 * mcus_x) + 2 * mx +
               (blk & 1);
        } else {               // Cb, Cr: after every image's Y blocks
          ob = 4 * total_mcus + img * 2 * mcus_per_img +
               (blk - 4) * mcus_per_img + r;
        }
        out[ob * 64 + k] =
            dct_coef(mk, s_px[local][blk], bk, blk < 4 ? qlk : qck);
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

}  // namespace

extern "C" int jt_front_dct(const void* rgb, const void* m, const void* bias,
                            const void* ql, const void* qc, void* out,
                            int n_images, int height, int width, int order,
                            void* stream) {
  if (order != kOrderMcu && order != kOrderScan && order != kOrderGray)
    return (int)cudaErrorInvalidValue;
  const int unit = order == kOrderGray ? 8 : 16;  // block or MCU side
  if (height % unit || width % unit) return (int)cudaErrorInvalidValue;
  const long long total =
      (long long)n_images * (height / unit) * (width / unit);
  if (total == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long groups = (total + kMcusPerIter - 1) / kMcusPerIter;
  const long long cap = 8LL * (sms > 0 ? sms : 1);
  const int grid = (int)(groups < cap ? groups : cap);
  if (order == kOrderGray) {
    front_dct_gray_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)rgb, (const float*)m, (const float*)bias,
        (const float*)ql, (int16_t*)out, height, width, total);
  } else {
    front_dct_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)rgb, (const float*)m, (const float*)bias,
        (const float*)ql, (const float*)qc, (int16_t*)out, height, width,
        total, order);
  }
  return (int)cudaGetLastError();
}
