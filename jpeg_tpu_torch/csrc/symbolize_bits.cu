// Kernel B, symbolize_bits: coefficients -> Huffman fields + block bits.
//
// Replaces the DC chain of jpeg_tpu's kernels/fused.py::
// _dct_symbolize_chunk_v (the prev_ref carry across the sequential TPU
// grid), the run-length symbolization kernels/fused.py::_symbolize, and
// the combined-LUT attach _attach_chunk, i.e. the outputs of
// _dct_attach_kernel (value, nbits, bits) on the two-phase route and the
// middle of _mega_place_kernel.  Input is [S, nblk, 64] int16 zig-zag
// coefficients (S segments of one block pattern: the interleaved MCU, or a
// single-component scan of Y or of chroma, see block_slots.cuh); outputs
// are per-slot value uint32 and nbits uint8 [S, nblk, 64] and per-block
// bit counts int32 [S, nblk].  With a single-component pattern it also
// replaces the LUT attach of jpeg_tpu's 3-scan path, kernels/lut.py::attach
// (K14), whose slot fields it computes itself.
//
// The explicit entry jt_symbolize_bits_explicit takes each block's DC
// difference and luma flag (1, 0, or -1 for a padding block: NULL slots)
// from int32 [S, nblk] arrays, as jpeg_tpu's f64 fixed-table path hands
// them to kernels/fused.py::analyze_attach_pack_segments (K13:
// _symbolize_attach_kernel, then K4); with C and D after it, it replaces
// K13.  The coefficients' DC slot is ignored there.
//
// What bounds it on an H100: memory traffic (2 bytes in, 5 bytes out per
// slot) and the serial dependence of each slot on the last nonzero slot
// before it.  Design: one warp per 8x8 block, two slots per lane; the slot
// logic (DC difference by index, warp max-scan) is block_slots.cuh, shared
// with kernel E.  The 1024-entry LUT sits in shared memory, loaded once
// per block of a grid-stride loop.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_slots.cuh"

namespace {

constexpr int kWarps = 8;

// kExplicit: DC differences and luma flags from dc_diff / is_luma (see
// block_slots_explicit); else from the block pattern layout.
template <bool kExplicit>
__global__ void __launch_bounds__(kWarps * 32)
symbolize_bits_kernel(const int16_t* __restrict__ coef,
                      const int* __restrict__ dc_diff,
                      const int* __restrict__ is_luma,
                      const int* __restrict__ lut, uint32_t* __restrict__ value,
                      uint8_t* __restrict__ nbits, int* __restrict__ bits,
                      int nblk, long long total_blocks, jt::McuLayout layout) {
  __shared__ int s_lut[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) s_lut[i] = lut[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned full = 0xffffffffu;
  for (long long gb = (long long)blockIdx.x * kWarps + warp;
       gb < total_blocks; gb += (long long)gridDim.x * kWarps) {
    const jt::SlotPair s =
        kExplicit
            ? jt::block_slots_explicit(coef, dc_diff, is_luma, gb, lane)
            // b: the block's index within its segment
            : jt::block_slots(coef, gb, (int)(gb % nblk), lane, layout);
    const int idx0 = s.idx0, ex0 = s.ex0, en0 = s.en0;
    const int idx1 = s.idx1, ex1 = s.ex1, en1 = s.en1;
    const int e0 = s_lut[idx0], e1 = s_lut[idx1];
    const int nb0 = (e0 >> 16) + en0, nb1 = (e1 >> 16) + en1;
    const uint32_t val0 = ((uint32_t)(e0 & 0xffff) << en0) | (uint32_t)ex0;
    const uint32_t val1 = ((uint32_t)(e1 & 0xffff) << en1) | (uint32_t)ex1;

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

template <bool kExplicit>
int launch(const void* coef, const void* dc_diff, const void* is_luma,
           const void* lut, void* value, void* nbits, void* bits,
           int n_segs, int nblk, jt::McuLayout layout, void* stream) {
  const long long total = (long long)n_segs * nblk;
  if (total == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (total + kWarps - 1) / kWarps;
  const long long cap = 8LL * (sms > 0 ? sms : 1);
  const int grid = (int)(need < cap ? need : cap);
  symbolize_bits_kernel<kExplicit>
      <<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
          (const int16_t*)coef, (const int*)dc_diff, (const int*)is_luma,
          (const int*)lut, (uint32_t*)value, (uint8_t*)nbits, (int*)bits,
          nblk, total, layout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jt_symbolize_bits(const void* coef, const void* lut,
                                 void* value, void* nbits, void* bits,
                                 int n_segs, int nblk, int period,
                                 int y_per_mcu, void* stream) {
  const jt::McuLayout layout{period, y_per_mcu};
  if (!jt::layout_ok(layout) || nblk % period)
    return (int)cudaErrorInvalidValue;
  return launch<false>(coef, nullptr, nullptr, lut, value, nbits, bits,
                       n_segs, nblk, layout, stream);
}

extern "C" int jt_symbolize_bits_explicit(const void* coef,
                                          const void* dc_diff,
                                          const void* is_luma,
                                          const void* lut, void* value,
                                          void* nbits, void* bits, int n_segs,
                                          int nblk, void* stream) {
  return launch<true>(coef, dc_diff, is_luma, lut, value, nbits, bits,
                      n_segs, nblk, jt::McuLayout{1, 1}, stream);
}
