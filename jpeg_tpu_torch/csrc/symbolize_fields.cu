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
//        counted: that bin is dropped downstream.  Given accumulate, the
//        counts are added to hist: a 3-scan image runs one launch for its
//        Y scan and one for its Cb and Cr scans into the same rows, whose
//        counts land in disjoint (luma, chroma) bins.
//
// The explicit entry jt_symbolize_fields_explicit takes each block's DC
// difference and luma flag (1, 0, or -1 for a padding block: NULL slots)
// from int32 [S, nblk] arrays (the coefficients' DC slot is ignored) and
// has no mask: it replaces jpeg_tpu's kernels/fused.py::symbolize_segments
// (K12, _symbolize_idx_kernel) and the hist_1024_t after it on the f64
// dynamic-table path.  Both entries run one kernel skeleton.
//
// What bounds it on an H100: memory traffic (2 bytes in, 4 bytes out per
// slot), a write-heavy stream.  Design: a warp holds four blocks at a
// time, eight lanes a block and eight slots a lane, four of each half
// block (two 8-byte loads; load_lane, lane_values and slots8 of
// block_slots.cuh, shared with kernel B), and loads its next four blocks
// before it symbolizes these; each lane stores its
// fields in two 16-byte streaming stores, every store instruction whole
// half blocks.  The second halves' slot logic runs only where a block of
// the warp has a symbol there (most blocks end early).  A block's DC
// predecessor comes from the warp's registers (a shuffle) where it lies
// among the four blocks, else from a load issued with the block's own.
// Every CTA covers blocks of one image only (grid y = image) and counts
// into a private 1024-bin histogram per warp in shared memory, so blocks
// of different warps never meet on a bin (most blocks end in one of two
// EOB bins).  At its end a CTA adds its non-zero bins to the image's row
// of a workspace that the caller keeps zeroed; the image's last CTA to
// finish (a release/acquire counter) moves the row into hist (or adds it,
// accumulating) and zeroes the row and its counter again: no memset
// launch.
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_slots.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBins = 1024;
static_assert(kThreads * 4 == kBins, "the epilogue moves 4 bins a thread");

using Counter = cuda::atomic_ref<unsigned int, cuda::thread_scope_device>;

template <bool kExplicit>
__global__ void __launch_bounds__(kThreads)
symbolize_fields_kernel(const int16_t* __restrict__ coef,
                        const int* __restrict__ dc_diff,
                        const int* __restrict__ is_luma,
                        const uint8_t* __restrict__ mask,
                        int* __restrict__ pf, int* __restrict__ hist,
                        int* __restrict__ work, int nblk, int per_image,
                        jt::McuLayout layout, int accumulate) {
  __shared__ __align__(16) int s_hist[kWarps][kBins];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  for (int i = tid; i < kWarps * kBins / 4; i += kThreads)
    reinterpret_cast<int4*>(&s_hist[0][0])[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int q = lane & 7, j = lane >> 3;  // eighth of the block, block
  const long long base = (long long)blockIdx.y * per_image;
  const int groups = (per_image + 3) / 4;
  const int stride = gridDim.x * kWarps;
  int* sh = s_hist[warp];
  int g = blockIdx.x * kWarps + warp;
  jt::LaneIn cur = jt::load_lane<kExplicit>(
      coef, dc_diff, is_luma, mask, base, g * 4 + j,
      g < groups ? per_image : 0, nblk, q, layout);
  for (; g < groups; g += stride) {
    const int gn = g + stride;
    jt::LaneIn nxt = jt::load_lane<kExplicit>(
        coef, dc_diff, is_luma, mask, base, gn * 4 + j,
        gn < groups ? per_image : 0, nblk, q, layout);
    int v[8];
    const int luma = jt::lane_values<kExplicit>(cur, lane, v);
    int f[8];
    jt::slots8(v, q, luma, [&](int i, int idx, int ex, int en) {
      f[i] = idx | (en << 10) | (ex << 14);
    });
    if (cur.valid) {
      int4* out = reinterpret_cast<int4*>(pf + (base + g * 4 + j) * 64);
      // read once, by kernel F after the host's table build: streaming
      __stcs(out + q, make_int4(f[0], f[1], f[2], f[3]));
      __stcs(out + 8 + q, make_int4(f[4], f[5], f[6], f[7]));
      if (cur.keep) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int idx = f[i] & 1023;
          if (idx != jt::kNullIndex) atomicAdd(sh + idx, 1);
        }
      }
    }
    cur = nxt;
  }
  __syncthreads();

  // the CTA's counts into the image's workspace row: 4 bins a thread
  int* row = work + (long long)blockIdx.y * kBins;
  {
    int4 c = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int4 h = reinterpret_cast<const int4*>(s_hist[w])[tid];
      c.x += h.x; c.y += h.y; c.z += h.z; c.w += h.w;
    }
    if (c.x) atomicAdd(row + 4 * tid, c.x);
    if (c.y) atomicAdd(row + 4 * tid + 1, c.y);
    if (c.z) atomicAdd(row + 4 * tid + 2, c.z);
    if (c.w) atomicAdd(row + 4 * tid + 3, c.w);
  }
  __syncthreads();
  unsigned* done = reinterpret_cast<unsigned*>(work) +
                   (long long)gridDim.y * kBins + blockIdx.y;
  if (tid == 0)  // releases the CTA's counts, acquires the others'
    s_last = Counter(*done).fetch_add(1u, cuda::memory_order_acq_rel) ==
             gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  // the image's last CTA: every CTA's counts are in the row; move it
  // (from L2) into hist, or add it there, and zero it and the counter
  const int4 c = __ldcg(reinterpret_cast<const int4*>(row) + tid);
  int4* h = reinterpret_cast<int4*>(hist + (long long)blockIdx.y * kBins) +
            tid;
  if (accumulate) {
    const int4 o = *h;
    *h = make_int4(o.x + c.x, o.y + c.y, o.z + c.z, o.w + c.w);
  } else {
    *h = c;
  }
  reinterpret_cast<int4*>(row)[tid] = make_int4(0, 0, 0, 0);
  if (tid == 0) *done = 0;
}

// CTAs of the kernel resident on the current device at once
template <bool kExplicit>
int resident_ctas() {
  static int cached[jt::kMaxDevices];
  return jt::resident_ctas(cached, symbolize_fields_kernel<kExplicit>,
                           kThreads);
}

template <bool kExplicit>
int launch(const void* coef, const void* dc_diff, const void* is_luma,
           const void* mask, void* pf, void* hist, void* work, int n_images,
           int segs_per_image, int nblk, jt::McuLayout layout,
           int accumulate, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long per_image = (long long)segs_per_image * nblk;
  if (per_image >= (1LL << 31) - 4 * kThreads * 65536LL)
    return (int)cudaErrorInvalidValue;  // block indices stay int32
  if (n_images == 0) return (int)cudaGetLastError();
  if (per_image == 0) {  // no block: the counts are 0
    if (accumulate) return (int)cudaGetLastError();
    return (int)cudaMemsetAsync(hist, 0, (size_t)n_images * kBins * 4, st);
  }
  // the resident CTAs over the batch, at least one per image
  const long long need = ((per_image + 3) / 4 + kWarps - 1) / kWarps;
  long long per = resident_ctas<kExplicit>() / n_images;
  if (per < 1) per = 1;
  const dim3 grid((unsigned)(need < per ? need : per), (unsigned)n_images);
  symbolize_fields_kernel<kExplicit><<<grid, kThreads, 0, st>>>(
      (const int16_t*)coef, (const int*)dc_diff, (const int*)is_luma,
      (const uint8_t*)mask, (int*)pf, (int*)hist, (int*)work, nblk,
      (int)per_image, layout, accumulate);
  return (int)cudaGetLastError();
}

}  // namespace

// work: int32 [n_images * 1025], zeroed before the first launch; every
// launch leaves it zeroed (its bins, then a counter per image)
extern "C" int jt_symbolize_fields(const void* coef, const void* mask,
                                   void* pf, void* hist, void* work,
                                   int n_images, int segs_per_image,
                                   int nblk, int period, int y_per_mcu,
                                   int accumulate, void* stream) {
  const jt::McuLayout layout{period, y_per_mcu};
  if (!jt::layout_ok(layout) || nblk % period)
    return (int)cudaErrorInvalidValue;
  return launch<false>(coef, nullptr, nullptr, mask, pf, hist, work,
                       n_images, segs_per_image, nblk, layout, accumulate,
                       stream);
}

extern "C" int jt_symbolize_fields_explicit(const void* coef,
                                            const void* dc_diff,
                                            const void* is_luma, void* pf,
                                            void* hist, void* work,
                                            int n_images, int segs_per_image,
                                            int nblk, void* stream) {
  return launch<true>(coef, dc_diff, is_luma, nullptr, pf, hist, work,
                      n_images, segs_per_image, nblk, jt::McuLayout{1, 1}, 0,
                      stream);
}
