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
// The fields contract is kernel B's (block_slots.cuh, store_fields):
// nbits and bits are written whole; value only in the 16-byte groups
// (slots 4g..4g+3 of a block) that hold a slot with non-zero nbits, the
// groups kernel D reads.  The other groups keep what the buffer held.
//
// What bounds it on an H100: memory traffic.  The work is 4 bytes in and
// 1 byte of nbits out a slot, 16 bytes a group that holds a symbol and 4
// bytes a block.  Design: kernel B's lane layout: a warp holds four blocks
// at a time, eight lanes a block, each lane loading its eight fields in
// slot8 order as two 16-byte streaming loads (pf is read once), the next
// four blocks loaded before these are attached; every CTA covers blocks of
// one image only (grid y = image) and loads that image's LUT into shared
// memory once; unpack is shift and mask, and the output stage is kernel
// B's store_fields.  The grid is the device's resident CTAs (asked once a
// device) over the images.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_slots.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Lane q's eight packed fields of block k of the image at base, or zeros
// (an invalid block) past per_image.
struct LaneFields {
  int4 lo, hi;  // slots 4q..4q+3, 32+4q..32+4q+3
  bool valid;
};

__device__ __forceinline__ LaneFields load_fields(const int* __restrict__ pf,
                                                  long long base, int k,
                                                  int per_image, int q) {
  LaneFields in{make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0), false};
  if (k >= per_image) return in;
  const int4* p = reinterpret_cast<const int4*>(pf + (base + k) * 64);
  in.lo = __ldcs(p + q);
  in.hi = __ldcs(p + 8 + q);
  in.valid = true;
  return in;
}

__global__ void __launch_bounds__(kThreads)
attach_pf_kernel(const int* __restrict__ pf, const int* __restrict__ luts,
                 uint32_t* __restrict__ value, uint8_t* __restrict__ nbits,
                 int* __restrict__ bits, int per_image) {
  __shared__ __align__(16) int s_lut[1024];
  const int tid = threadIdx.x;
  const int4* lut =
      reinterpret_cast<const int4*>(luts + (long long)blockIdx.y * 1024);
  for (int i = tid; i < 256; i += kThreads)
    reinterpret_cast<int4*>(s_lut)[i] = lut[i];
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int q = lane & 7, j = lane >> 3;  // eighth of the block, block
  const long long base = (long long)blockIdx.y * per_image;
  const int groups = (per_image + 3) / 4;
  const int stride = gridDim.x * kWarps;
  int g = blockIdx.x * kWarps + warp;
  LaneFields cur =
      load_fields(pf, base, g * 4 + j, g < groups ? per_image : 0, q);
  for (; g < groups; g += stride) {
    const int gn = g + stride;
    const LaneFields nxt =
        load_fields(pf, base, gn * 4 + j, gn < groups ? per_image : 0, q);
    const int p[8] = {cur.lo.x, cur.lo.y, cur.lo.z, cur.lo.w,
                      cur.hi.x, cur.hi.y, cur.hi.z, cur.hi.w};
    uint32_t val[8];
    int nb[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)  // idx | extra_n << 10 | extra << 14
      jt::attach_field(s_lut[p[i] & 1023], (int)((uint32_t)p[i] >> 14),
                       (p[i] >> 10) & 15, &val[i], &nb[i]);
    jt::store_fields(val, nb, cur.valid, base + g * 4 + j, q, value, nbits,
                     bits);
    cur = nxt;
  }
}

}  // namespace

extern "C" int jt_attach_pf(const void* pf, const void* luts, void* value,
                            void* nbits, void* bits, int n_images,
                            int segs_per_image, int nblk, void* stream) {
  const long long per_image = (long long)segs_per_image * nblk;
  if (per_image >= (1LL << 31) - 4LL * kThreads * 65536)
    return (int)cudaErrorInvalidValue;  // block indices stay int32
  if (n_images == 0 || per_image == 0) return (int)cudaGetLastError();
  static int cached[jt::kMaxDevices];
  // the resident CTAs over the batch, at least one per image
  const long long need = ((per_image + 3) / 4 + kWarps - 1) / kWarps;
  long long per =
      jt::resident_ctas(cached, attach_pf_kernel, kThreads) / n_images;
  if (per < 1) per = 1;
  const dim3 grid((unsigned)(need < per ? need : per), (unsigned)n_images);
  attach_pf_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)pf, (const int*)luts, (uint32_t*)value, (uint8_t*)nbits,
      (int*)bits, (int)per_image);
  return (int)cudaGetLastError();
}
