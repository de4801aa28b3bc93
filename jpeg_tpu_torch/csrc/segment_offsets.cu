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
// block, a few hundred thousand blocks per batch), so a launch costs its
// latency.  The carry is a true cross-block dependence; this design
// carries it in one pass over many CTAs with a decoupled look-back scan
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016).  A CTA scans one tile of kTile blocks of one
// segment: each thread sums 4 consecutive counts, a warp-shuffle scan
// plus a scan of the 32 warp totals gives the tile-wide exclusive
// prefix.  The tile then publishes its aggregate in its status word
// (flag and value packed in 64 bits), and warp 0 looks back over the
// status words of the tiles before it in its segment, 32 at a time,
// summing aggregates until it meets a published inclusive prefix; then
// it publishes its own inclusive prefix.  The first tile of a segment
// starts from 0 and the last writes the segment's total.  Tiles take
// their index from an atomic counter in the order they start, so a tile
// only ever waits on tiles that are already running.  The status words
// and the counters live in a workspace that the caller keeps zeroed: the
// last CTA to finish zeroes what the launch used, so a launch costs no
// memset.
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // blocks a CTA scans
// status word: flag in bits 32-33, the int32 value in bits 0-31
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;
constexpr unsigned long long kFlags = 3ull << 32;

using Status = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;
using Counter = cuda::atomic_ref<unsigned int, cuda::thread_scope_device>;

// counters[0]: tiles taken, counters[1]: tiles done
__global__ void __launch_bounds__(kThreads)
segment_offsets_kernel(const int* __restrict__ bits, int* __restrict__ offs,
                       int* __restrict__ totals,
                       unsigned int* __restrict__ counters,
                       unsigned long long* __restrict__ status, int nblk,
                       int tiles) {
  __shared__ int s_warp[32];
  __shared__ int s_id;
  __shared__ int s_excl;
  __shared__ bool s_last;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const unsigned full = 0xffffffffu;
  if (t == 0) s_id = (int)atomicAdd(counters, 1u);
  __syncthreads();
  const int id = s_id;
  const int seg = id / tiles, tile = id - seg * tiles;
  const int* in = bits + (long long)seg * nblk;
  int* out = offs + (long long)seg * nblk;
  const int base = tile * kTile + t * kItems;

  int x[kItems];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    x[j] = base + j < nblk ? in[base + j] : 0;
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
    const int w = s_warp[lane];
    int wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(full, wi, off);
      if (lane >= off) wi += o;
    }
    s_warp[lane] = wi - w;  // exclusive prefix of the warp totals
    const int agg = __shfl_sync(full, wi, 31);
    unsigned long long* seg_status = status + (long long)seg * tiles;
    int excl = 0;
    if (tile == 0) {
      if (lane == 0)
        Status(seg_status[0]).store(kPrefix | (unsigned)agg,
                                    cuda::memory_order_release);
    } else {
      if (lane == 0)
        Status(seg_status[tile]).store(kAggregate | (unsigned)agg,
                                       cuda::memory_order_release);
      // look back over tiles tile-1, tile-2, ...: lane l reads tile
      // `last - l`; the nearest published prefix ends the walk
      for (int last = tile - 1;; last -= 32) {
        const int i = last - lane;
        unsigned long long st = kPrefix;  // before tile 0: a prefix of 0
        if (i >= 0) {
          do {
            st = Status(seg_status[i]).load(cuda::memory_order_acquire);
          } while ((st & kFlags) == 0);
        }
        const unsigned done = __ballot_sync(full, (st & kFlags) == kPrefix);
        // sum the values of lanes up to the first prefix (all if none)
        const int upto = done ? __ffs(done) - 1 : 31;
        int v = lane <= upto ? (int)(unsigned)st : 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(full, v, off);
        excl += v;
        if (done) break;
      }
      if (lane == 0)
        Status(seg_status[tile]).store(kPrefix | (unsigned)(excl + agg),
                                       cuda::memory_order_release);
    }
    if (lane == 0) {
      s_excl = excl;
      if (tile == tiles - 1) totals[seg] = excl + agg;
      // this tile reads no status word any more: the last one done
      // zeroes the workspace for the next launch on the stream
      s_last = Counter(counters[1]).fetch_add(
                   1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
    }
  }
  __syncthreads();
  int run = s_excl + s_warp[warp] + incl - sum;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (base + j < nblk) out[base + j] = run;
    run += x[j];
  }
  if (s_last) {
    for (unsigned i = t; i < gridDim.x; i += kThreads) status[i] = 0;
    if (t == 0) counters[0] = counters[1] = 0;
  }
}

}  // namespace

// Tiles of one segment
static int segment_tiles(int nblk) {
  return nblk > kTile ? (nblk + kTile - 1) / kTile : 1;
}

// The 64-bit words of jt_segment_offsets' workspace at [n_segs, nblk]:
// the counters, then a status word per tile.
extern "C" int jt_segment_offsets_words(int n_segs, int nblk) {
  return n_segs * segment_tiles(nblk) + 1;
}

// `work` holds jt_segment_offsets_words(n_segs, nblk) words, all zero;
// the launch leaves them zero again.
extern "C" int jt_segment_offsets(const void* bits, void* offs, void* totals,
                                  void* work, int n_segs, int nblk,
                                  void* stream) {
  if (n_segs == 0) return (int)cudaGetLastError();
  const int tiles = segment_tiles(nblk);
  const long long n_tiles = (long long)n_segs * tiles;
  unsigned long long* words = (unsigned long long*)work;
  segment_offsets_kernel<<<(unsigned)n_tiles, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int*)bits, (int*)offs, (int*)totals, (unsigned int*)words,
      words + 1, nblk, tiles);
  return (int)cudaGetLastError();
}
