// Kernel B, symbolize_bits: coefficients -> Huffman fields + block bits.
//
// Replaces the DC chain of jpeg_tpu's kernels/fused.py::
// _dct_symbolize_chunk_v (the prev_ref carry across the sequential TPU
// grid), the run-length symbolization kernels/fused.py::_symbolize, and
// the combined-LUT attach _attach_chunk, i.e. the outputs of
// _dct_attach_kernel (value, nbits, bits) on the two-phase route and the
// middle of _mega_place_kernel.  Input is [S, nblk, 64] int16 zig-zag
// coefficients (S segments); outputs are per-slot value uint32 and nbits
// uint8 [S, nblk, 64] and per-block bit counts int32 [S, nblk].
//
// What bounds it on an H100: memory traffic (2 bytes in, 5 bytes out per
// slot) and the serial dependence of each slot on the last nonzero slot
// before it.  Design: one warp per 8x8 block, two slots per lane.  The
// DC difference reads the previous same-component DC straight from the
// input by index (3 back for the first Y of an MCU, 1 for the other Y
// blocks, 6 for Cb and Cr; 0 at a segment start), so no carry crosses
// blocks.  The "last nonzero before me" that drives runs, ZRL and EOB is
// one warp max-scan; bit lengths are 32 - __clz; the 1024-entry LUT
// sits in shared memory, loaded once per block of a grid-stride loop.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kNullIndex = 1023;

__device__ __forceinline__ int bit_length(int a) { return 32 - __clz(a); }

// One slot's LUT index and amplitude field for the symbol at slot kslot
// with (DC-differenced) value v; prev = last nonzero AC slot before it
// (0 if none), last = last nonzero AC slot of the block (0 if none).
__device__ __forceinline__ void slot_fields(int kslot, int v, int prev,
                                            int last, int luma, int* idx,
                                            int* extra, int* extra_n) {
  const int a = v < 0 ? -v : v;
  const int cls = bit_length(a);
  const int amp = v < 0 ? v + (1 << cls) - 1 : v;
  int sym = 0, valid = 0, ex = 0, en = 0, dc = 0;
  if (kslot == 0) {
    sym = cls; ex = amp; en = cls; valid = 1; dc = 1;
  } else if (v != 0) {
    sym = (((kslot - prev - 1) & 15) << 4) | cls; ex = amp; en = cls;
    valid = 1;
  } else if (kslot < last && ((kslot - prev) & 15) == 0) {
    sym = 0xF0; valid = 1;            // ZRL
  } else if (kslot == last + 1) {
    sym = 0x00; valid = 1;            // EOB (kslot <= 63, so last < 63)
  }
  *idx = valid ? (sym | (dc << 8) | (luma << 9)) : kNullIndex;
  *extra = valid ? ex : 0;
  *extra_n = valid ? en : 0;
}

__global__ void __launch_bounds__(kWarps * 32)
symbolize_bits_kernel(const int16_t* __restrict__ coef,
                      const int* __restrict__ lut, uint32_t* __restrict__ value,
                      uint8_t* __restrict__ nbits, int* __restrict__ bits,
                      int nblk, long long total_blocks) {
  __shared__ int s_lut[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) s_lut[i] = lut[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned full = 0xffffffffu;
  for (long long gb = (long long)blockIdx.x * kWarps + warp;
       gb < total_blocks; gb += (long long)gridDim.x * kWarps) {
    const int b = (int)(gb % nblk);  // block index within its segment
    const int pos = b % 6;
    const int luma = pos < 4;
    const uint32_t pair =
        reinterpret_cast<const uint32_t*>(coef + gb * 64)[lane];
    int v0 = (int)(int16_t)(pair & 0xffffu);   // slot 2*lane
    int v1 = (int)(int16_t)(pair >> 16);       // slot 2*lane + 1
    if (lane == 0) {
      const int d = pos == 0 ? 3 : (pos < 4 ? 1 : 6);
      const int prev_dc = b >= d ? (int)coef[(gb - d) * 64] : 0;
      v0 -= prev_dc;
    }
    const int k0 = 2 * lane, k1 = k0 + 1;
    const int nz0 = lane > 0 && v0 != 0;
    const int nz1 = v1 != 0;
    // inclusive max-scan of "last nonzero AC slot" over the lanes
    int incl = nz1 ? k1 : (nz0 ? k0 : 0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(full, incl, off);
      if (lane >= off) incl = max(incl, o);
    }
    int excl = __shfl_up_sync(full, incl, 1);
    if (lane == 0) excl = 0;
    const int last = __shfl_sync(full, incl, 31);
    const int prev1 = nz0 ? k0 : excl;

    int idx0, ex0, en0, idx1, ex1, en1;
    slot_fields(k0, v0, excl, last, luma, &idx0, &ex0, &en0);
    slot_fields(k1, v1, prev1, last, luma, &idx1, &ex1, &en1);
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

}  // namespace

extern "C" int jt_symbolize_bits(const void* coef, const void* lut,
                                 void* value, void* nbits, void* bits,
                                 int n_segs, int nblk, void* stream) {
  const long long total = (long long)n_segs * nblk;
  if (total == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (total + kWarps - 1) / kWarps;
  const long long cap = 8LL * (sms > 0 ? sms : 1);
  const int grid = (int)(need < cap ? need : cap);
  symbolize_bits_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coef, (const int*)lut, (uint32_t*)value,
      (uint8_t*)nbits, (int*)bits, nblk, total);
  return (int)cudaGetLastError();
}
