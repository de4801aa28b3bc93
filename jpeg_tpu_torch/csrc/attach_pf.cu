// Kernel F, attach_pf: packed symbol fields + per-image LUTs -> Huffman
// fields and block bits (dynamic-table stage 2, before C and D place).
//
// Replaces the unpack + attach of jpeg_tpu's kernels/fused.py::
// _pf_place_kernel (attach_pack_pf, K3: _unpack_fields, then _attach_chunk
// with the image's LUT) and of _attach_grouped_kernel (attach_pack_grouped,
// K11); with one LUT, the combined-LUT lookup of kernels/lut.py::attach ->
// _attach_kernel (K14, on jpeg_tpu's 3-scan path), and with one LUT per
// group, attach_grouped -> _attach_kernel_grouped (K18c): the port's
// kernels/lut.py packs their slot arrays into fields and calls this kernel.
// Input pf [S, nblk, 64] int32 (kernel E's), luts [n_images, 1024] int32
// combined LUTs (code | length << 16); segment s uses LUT
// s / (S / n_images).  Outputs are kernel B's: value uint32 and nbits uint8
// [S, nblk, 64] (code then amplitude bits, right-aligned) and bits int32
// [S, nblk], so kernels C and D place them unchanged.
//
// What bounds it on an H100: memory traffic (4 bytes in, 5 bytes out per
// slot).  Design: one warp per 8x8 block, one slot pair per lane (one
// 8-byte load); every CTA covers blocks of one image only (grid y =
// image) and loads that image's LUT into shared memory once; unpack is
// shift and mask, the field assembly is kernel B's, and the block's bit
// count is a warp reduction.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ void attach_slot(int p, const int* s_lut,
                                            uint32_t* val, int* nb) {
  const int idx = p & 1023;
  const int extra_n = (p >> 10) & 15;
  const uint32_t extra = (uint32_t)p >> 14;
  const int e = s_lut[idx];
  *nb = (e >> 16) + extra_n;
  *val = ((uint32_t)(e & 0xffff) << extra_n) | extra;
}

__global__ void __launch_bounds__(kWarps * 32)
attach_pf_kernel(const int* __restrict__ pf, const int* __restrict__ luts,
                 uint32_t* __restrict__ value, uint8_t* __restrict__ nbits,
                 int* __restrict__ bits, long long blocks_per_image) {
  __shared__ int s_lut[1024];
  const int* lut = luts + (long long)blockIdx.y * 1024;
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) s_lut[i] = lut[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned full = 0xffffffffu;
  const long long base = (long long)blockIdx.y * blocks_per_image;
  for (long long k = (long long)blockIdx.x * kWarps + warp;
       k < blocks_per_image; k += (long long)gridDim.x * kWarps) {
    const long long gb = base + k;
    const int2 p = reinterpret_cast<const int2*>(pf + gb * 64)[lane];
    uint32_t val0, val1;
    int nb0, nb1;
    attach_slot(p.x, s_lut, &val0, &nb0);
    attach_slot(p.y, s_lut, &val1, &nb1);
    reinterpret_cast<uint2*>(value + gb * 64)[lane] = make_uint2(val0, val1);
    reinterpret_cast<uchar2*>(nbits + gb * 64)[lane] =
        make_uchar2((unsigned char)nb0, (unsigned char)nb1);
    int sum = nb0 + nb1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_down_sync(full, sum, off);
    if (lane == 0) bits[gb] = sum;
  }
}

}  // namespace

extern "C" int jt_attach_pf(const void* pf, const void* luts, void* value,
                            void* nbits, void* bits, int n_images,
                            int segs_per_image, int nblk, void* stream) {
  const long long per_image = (long long)segs_per_image * nblk;
  if (n_images == 0 || per_image == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // about 8 CTAs per SM over the whole batch, at least one per image
  const long long need = (per_image + kWarps - 1) / kWarps;
  long long per = 8LL * (sms > 0 ? sms : 1) / n_images;
  if (per < 1) per = 1;
  const dim3 grid((unsigned)(need < per ? need : per), (unsigned)n_images);
  attach_pf_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int*)pf, (const int*)luts, (uint32_t*)value, (uint8_t*)nbits,
      (int*)bits, per_image);
  return (int)cudaGetLastError();
}
