// Kernel D, place: Huffman fields + block offsets -> packed segment words.
//
// Replaces the place tail of jpeg_tpu: kernels/fused.py::_place_tail_full
// and _rowacc_mxu (local pack, bit shift, lane rotate and one-hot row
// accumulation into the VMEM-resident words buffer of the mega kernel),
// and _place_acc_kernel plus the XLA scatter_add of
// kernels/fused.py::_segment_place on the two-phase route, and (after
// kernel C) kernels/pack.py::pack_segments -> block_windows_t ->
// _pack_kernel_t plus its row scatter_add (K15, jpeg_tpu's 3-scan pack).
// Inputs are value uint32 and nbits uint8 [S, nblk, 64] and the exclusive
// block bit offsets int32 [S, nblk]; the output is the words buffer uint32
// [S, seg_words], zeroed by the entry point before the launch.  Bit i of
// a segment's stream is bit 31 - (i & 31) of word i >> 5 (big-endian,
// jpeg_tpu/ops/pack.py).
//
// What bounds it on an H100: memory traffic (5 bytes read per slot, the
// words written once) and atomics, one or two 32-bit atomicOr per valid
// field.  Design: one warp per 8x8 block, two slots per lane; a warp sum
// scan of the slot bit counts gives each field's offset inside its block,
// and each field of <= 27 bits lands in at most 2 words.  The bit ranges
// of all fields are disjoint, so the ORs commute and the result does not
// depend on the order the atomics land in.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ void put_field(uint32_t* words, uint32_t v, int n,
                                          int o) {
  if (n == 0) return;
  const int w = o >> 5;
  const int e = (o & 31) + n;  // end of the field within word w, in bits
  if (e <= 32) {
    atomicOr(words + w, v << (32 - e));
  } else {
    atomicOr(words + w, v >> (e - 32));
    atomicOr(words + w + 1, v << (64 - e));
  }
}

__global__ void __launch_bounds__(kWarps * 32)
place_kernel(const uint32_t* __restrict__ value,
             const uint8_t* __restrict__ nbits, const int* __restrict__ offs,
             uint32_t* __restrict__ words, int nblk, int seg_words,
             long long total_blocks) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned full = 0xffffffffu;
  for (long long gb = (long long)blockIdx.x * kWarps + warp;
       gb < total_blocks; gb += (long long)gridDim.x * kWarps) {
    const long long seg = gb / nblk;
    const uint2 v = reinterpret_cast<const uint2*>(value + gb * 64)[lane];
    const uchar2 n = reinterpret_cast<const uchar2*>(nbits + gb * 64)[lane];
    const int n0 = n.x, n1 = n.y;
    int incl = n0 + n1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(full, incl, off);
      if (lane >= off) incl += o;
    }
    const int o0 = offs[gb] + incl - n0 - n1;
    uint32_t* ws = words + seg * seg_words;
    put_field(ws, v.x, n0, o0);
    put_field(ws, v.y, n1, o0 + n0);
  }
}

}  // namespace

extern "C" int jt_place(const void* value, const void* nbits, const void* offs,
                        void* words, int n_segs, int nblk, int seg_words,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      words, 0, sizeof(uint32_t) * (size_t)n_segs * seg_words, s);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)n_segs * nblk;
  if (total == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (total + kWarps - 1) / kWarps;
  const long long cap = 16LL * (sms > 0 ? sms : 1);
  const int grid = (int)(need < cap ? need : cap);
  place_kernel<<<grid, kWarps * 32, 0, s>>>(
      (const uint32_t*)value, (const uint8_t*)nbits, (const int*)offs,
      (uint32_t*)words, nblk, seg_words, total);
  return (int)cudaGetLastError();
}
