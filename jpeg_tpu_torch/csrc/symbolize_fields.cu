// Kernel E, symbolize_fields: coefficients -> packed symbol fields and
// per-image symbol histograms (dynamic-table stage 1).
//
// Replaces the symbolize half of jpeg_tpu's kernels/front.py::
// _mega_index_kernel with emit_fields=True (front_index, K2), the index
// and field outputs of kernels/fused.py::dct_index_segments (K9) and
// dct_symbolize_segments (K10), and the XLA histogram hist_1024_t of
// pipelines/fast.py, and, with a single-component block pattern (see
// block_slots.cuh), the symbolize + histograms of jpeg_tpu's 3-scan
// analyze (pipelines/encode.py::analyze_fn).  Input is [S, nblk, 64] int16
// zig-zag coefficients of n_images images (S / n_images consecutive
// segments each, all of one pattern).  Outputs:
//   pf   [S, nblk, 64] int32: idx | extra_n << 10 | extra << 14 per slot
//        (fused.py::_pack_fields; extra < 2^12, so bit 25 is the top);
//   hist [n_images, 1024] int32: the count of each LUT index over the
//        image's slots, or over the slots of the blocks whose mask byte
//        is non-zero ("dynamic-sampled").  NULL slots (index 1023) are not
//        counted: that bin is dropped downstream, and counting it would
//        put most of the shared-memory atomics on one address.
//
// The explicit entry jt_symbolize_fields_explicit takes each block's DC
// difference and luma flag (1, 0, or -1 for a padding block: NULL slots)
// from int32 [S, nblk] arrays (the coefficients' DC slot is ignored), has
// no mask and always zeroes hist first: it replaces jpeg_tpu's
// kernels/fused.py::symbolize_segments (K12, _symbolize_idx_kernel) and
// the hist_1024_t after it on the f64 dynamic-table path.
//
// What bounds it on an H100: memory traffic (2 bytes in, 4 bytes out per
// slot).  Design: one warp per 8x8 block, two slots per lane, the slot
// logic of block_slots.cuh (shared with kernel B).  Every CTA covers
// blocks of one image only (grid y = image) and keeps a 1024-bin
// histogram in shared memory, then adds its non-zero bins to hist[image]
// with global atomics.  The entry point zeroes hist first
// (cudaMemsetAsync) unless it is told to accumulate: a 3-scan image runs
// one launch for its Y scan and one for its Cb and Cr scans into the same
// rows, whose counts land in disjoint (luma, chroma) bins.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_slots.cuh"

namespace {

constexpr int kWarps = 8;

// kExplicit: DC differences and luma flags from dc_diff / is_luma (see
// block_slots_explicit); else from the block pattern layout.
template <bool kExplicit>
__global__ void __launch_bounds__(kWarps * 32)
symbolize_fields_kernel(const int16_t* __restrict__ coef,
                        const int* __restrict__ dc_diff,
                        const int* __restrict__ is_luma,
                        const uint8_t* __restrict__ mask,
                        int* __restrict__ pf, int* __restrict__ hist,
                        int nblk, long long blocks_per_image,
                        jt::McuLayout layout) {
  __shared__ int s_hist[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.y * blocks_per_image;
  for (long long k = (long long)blockIdx.x * kWarps + warp;
       k < blocks_per_image; k += (long long)gridDim.x * kWarps) {
    const long long gb = base + k;
    const jt::SlotPair s =
        kExplicit
            ? jt::block_slots_explicit(coef, dc_diff, is_luma, gb, lane)
            // b: the block's index within its segment
            : jt::block_slots(coef, gb, (int)(k % nblk), lane, layout);
    const int p0 = s.idx0 | (s.en0 << 10) | (s.ex0 << 14);
    const int p1 = s.idx1 | (s.en1 << 10) | (s.ex1 << 14);
    reinterpret_cast<int2*>(pf + gb * 64)[lane] = make_int2(p0, p1);
    if (mask == nullptr || mask[k]) {
      if (s.idx0 != jt::kNullIndex) atomicAdd(&s_hist[s.idx0], 1);
      if (s.idx1 != jt::kNullIndex) atomicAdd(&s_hist[s.idx1], 1);
    }
  }
  __syncthreads();
  int* h = hist + (long long)blockIdx.y * 1024;
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) {
    const int c = s_hist[i];
    if (c) atomicAdd(&h[i], c);
  }
}

template <bool kExplicit>
int launch(const void* coef, const void* dc_diff, const void* is_luma,
           const void* mask, void* pf, void* hist, int n_images,
           int segs_per_image, int nblk, jt::McuLayout layout,
           int accumulate, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long per_image = (long long)segs_per_image * nblk;
  if (n_images == 0) return (int)cudaGetLastError();
  if (!accumulate) {
    const cudaError_t rc = cudaMemsetAsync(
        hist, 0, (size_t)n_images * 1024 * sizeof(int), st);
    if (rc != cudaSuccess) return (int)rc;
  }
  if (per_image == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // about 8 CTAs per SM over the whole batch, at least one per image
  const long long need = (per_image + kWarps - 1) / kWarps;
  long long per = 8LL * (sms > 0 ? sms : 1) / n_images;
  if (per < 1) per = 1;
  const dim3 grid((unsigned)(need < per ? need : per), (unsigned)n_images);
  symbolize_fields_kernel<kExplicit><<<grid, kWarps * 32, 0, st>>>(
      (const int16_t*)coef, (const int*)dc_diff, (const int*)is_luma,
      (const uint8_t*)mask, (int*)pf, (int*)hist, nblk, per_image, layout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jt_symbolize_fields(const void* coef, const void* mask,
                                   void* pf, void* hist, int n_images,
                                   int segs_per_image, int nblk, int period,
                                   int y_per_mcu, int accumulate,
                                   void* stream) {
  const jt::McuLayout layout{period, y_per_mcu};
  if (!jt::layout_ok(layout) || nblk % period)
    return (int)cudaErrorInvalidValue;
  return launch<false>(coef, nullptr, nullptr, mask, pf, hist, n_images,
                       segs_per_image, nblk, layout, accumulate, stream);
}

extern "C" int jt_symbolize_fields_explicit(const void* coef,
                                            const void* dc_diff,
                                            const void* is_luma, void* pf,
                                            void* hist, int n_images,
                                            int segs_per_image, int nblk,
                                            void* stream) {
  return launch<true>(coef, dc_diff, is_luma, nullptr, pf, hist, n_images,
                      segs_per_image, nblk, jt::McuLayout{1, 1}, 0, stream);
}
