// Kernel C, segment_offsets: per-block bit counts -> exclusive bit offsets.
//
// Replaces the bit-offset carry of jpeg_tpu's place kernels: carry_ref and
// _cumsum_lanes in kernels/fused.py::_place_body (the running sum that
// the TPU's sequential grid carries from tile to tile), and the XLA
// cumsum in kernels/fused.py::_segment_place on the two-phase route, and
// the block offsets and totals of kernels/pack.py::pack_segments (K15).
// Input is [S, nblk] int32 block bit counts; outputs are the exclusive
// in-segment offsets [S, nblk] int32 and the segment totals [S] int32.
//
// What bounds it on an H100: almost nothing (8 bytes of traffic per
// block, a few hundred thousand blocks per batch); it exists because the
// carry is a true cross-block dependence that GPU blocks, running in no
// order, cannot share.  Design: one CUDA block per segment walks the
// segment in chunks of 4096 blocks: each thread sums 4 consecutive
// counts, a warp-shuffle scan plus a scan of the 32 warp totals gives the
// block-wide exclusive prefix, and a running carry links the chunks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 4;

__global__ void __launch_bounds__(kThreads)
segment_offsets_kernel(const int* __restrict__ bits, int* __restrict__ offs,
                       int* __restrict__ totals, int nblk) {
  __shared__ int s_warp[32];
  __shared__ int s_carry;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const unsigned full = 0xffffffffu;
  const long long seg = blockIdx.x;
  const int* in = bits + seg * nblk;
  int* out = offs + seg * nblk;
  if (t == 0) s_carry = 0;
  __syncthreads();

  for (int base = 0; base < nblk; base += kThreads * kItems) {
    int x[kItems];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = base + t * kItems + j;
      x[j] = i < nblk ? in[i] : 0;
      sum += x[j];
    }
    int incl = sum;  // inclusive scan of the thread sums within the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(full, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = s_warp[lane];
      int wi = w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(full, wi, off);
        if (lane >= off) wi += o;
      }
      s_warp[lane] = wi - w;  // exclusive prefix of the warp totals
    }
    __syncthreads();
    const int carry = s_carry;
    int run = carry + s_warp[warp] + incl - sum;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = base + t * kItems + j;
      if (i < nblk) out[i] = run;
      run += x[j];
    }
    __syncthreads();  // every thread has read s_carry and s_warp
    if (t == kThreads - 1) s_carry = run;
    __syncthreads();
  }
  if (t == 0) totals[seg] = s_carry;
}

}  // namespace

extern "C" int jt_segment_offsets(const void* bits, void* offs, void* totals,
                                  int n_segs, int nblk, void* stream) {
  if (n_segs == 0) return (int)cudaGetLastError();
  segment_offsets_kernel<<<n_segs, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)bits, (int*)offs, (int*)totals, nblk);
  return (int)cudaGetLastError();
}
