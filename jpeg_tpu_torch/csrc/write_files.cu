// Kernel I, write_files: each segment's packed words -> whole JPEG files,
// back to back in one buffer.
//
// Replaces no jpeg_tpu kernel: jpeg_tpu writes its files on the host
// (native jt_assemble_interleaved), and so did the port.  It was added
// because that host byte loop (every entropy byte read, stuffed and
// copied, on threads spawned anew each batch) took most of the host time
// of the encode stream, and the stream's host, not the card, sets its
// pace; with it the host only copies finished files.  Its bytes are
// jt_finish_scan's and jt_assemble_interleaved's (native/host.cpp): a
// file is its header (SOI .. SOS header), then each segment's full bytes
// with a 0x00 after every 0xFF and its tail byte (the last partial byte
// padded with 1-bits, and stuffed if that makes it 0xFF; a bare 0xFF fill
// byte where the stream ends on a byte boundary), FF D0+((s-1)&7) before
// segment s > 0, and FF D9 at the end.
//
// What bounds it on an H100: bytes, about 1.5 MB in and 1.5 MB out for a
// batch of sixteen 1920x1280 frames, 1 us at 3.35 TB/s, so a launch costs
// its latency.  Where a byte lands depends on every 0xFF before it in the
// whole batch: a prefix over all segments of all images.  One pass takes
// it with a decoupled look-back scan, as kernel C does
// (segment_offsets.cu).  The launch cuts each segment into `chunks` items
// of its own bytes (read from its total on the card, so the items are
// even whatever the streams' lengths), enough that the batch's items make
// about two CTAs an SM.  A CTA takes its item's index from an atomic
// counter in the order CTAs start, so it only ever waits on items that are
// already running.  It counts its 0xFF bytes four to a word
// (__vcmpeq4, popc) and adds its header or RST marker, its tail byte and
// EOI, publishes that aggregate in its status word, and warp 0 looks back
// 32 status words at a time until it meets a published inclusive prefix:
// that is the item's output offset.  Then the CTA writes, in rounds of 16
// bytes a thread: a scan of the threads' stuffed lengths places each
// thread's bytes in a shared-memory image of the round's output, which
// the CTA copies out with neighbouring threads on neighbouring bytes (the
// words come from L2 the second time).  The item that ends a file writes
// its end in `bounds`.  The status words and the counters live in a
// workspace that the caller keeps zeroed: the last CTA to finish its
// look-back zeroes what the launch used, so a launch costs no memset.
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;                   // bytes a thread takes a round
constexpr int kRound = kThreads * kGroup;    // bytes a CTA takes a round
constexpr int kTargetItems = 2 * 132;        // two CTAs an SM of an H100
// status word: flag in bits 62-63, the byte count in bits 0-61
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kFlags = 3ull << 62;
constexpr unsigned long long kValue = kAggregate - 1;

using Status = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;
using Counter = cuda::atomic_ref<unsigned int, cuda::thread_scope_device>;

// Byte k (0 = first in the stream) of a group of four big-endian words.
__device__ __forceinline__ unsigned group_byte(const uint4& v, int k) {
  const unsigned w = k < 4 ? v.x : k < 8 ? v.y : k < 12 ? v.z : v.w;
  return (w >> (24 - 8 * (k & 3))) & 0xFFu;
}

// 0xFF bytes among the first n (of 16) stream bytes of a group.
__device__ __forceinline__ int group_ffs(const uint4& v, int n) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  int count = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int valid = min(max(n - 4 * j, 0), 4);
    // the first `valid` stream bytes are the most significant ones
    const unsigned mask = valid == 0 ? 0u : 0xFFFFFFFFu << (32 - 8 * valid);
    count += __popc(__vcmpeq4(w[j], 0xFFFFFFFFu) & mask) >> 3;
  }
  return count;
}

// counters[0]: items taken, counters[1]: look-backs done
__global__ void __launch_bounds__(kThreads)
write_files_kernel(const uint32_t* __restrict__ words,
                   const int* __restrict__ totals,
                   const uint8_t* __restrict__ hdr,
                   const int* __restrict__ hdr_offs, int hdr_len,
                   uint8_t* __restrict__ out, long long* __restrict__ bounds,
                   unsigned int* __restrict__ counters,
                   unsigned long long* __restrict__ status, int n_segs,
                   int seg_words, int chunks) {
  __shared__ uint8_t s_out[2 * kRound];
  __shared__ int s_warp[kWarps];
  __shared__ int s_id, s_round;
  __shared__ long long s_excl;
  __shared__ bool s_last;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const unsigned full = 0xffffffffu;
  if (t == 0) s_id = (int)atomicAdd(counters, 1u);
  __syncthreads();
  const int id = s_id;
  const int seg = id / chunks, c = id - seg * chunks;
  const int img = seg / n_segs, s = seg - img * n_segs;
  const uint32_t* row = words + (long long)seg * seg_words;
  const int total = totals[seg];
  const int nfull = total >> 3, rem = total & 7;
  // the item's full bytes [lo, hi): a share of the segment's 16-byte groups
  const int groups = (nfull + kGroup - 1) / kGroup;
  const int lo = (int)((long long)groups * c / chunks) * kGroup;
  const int hi = min((int)((long long)groups * (c + 1) / chunks) * kGroup,
                     nfull);
  int h0 = 0, hl = hdr_len;
  if (hdr_offs != nullptr) {
    h0 = hdr_offs[img];
    hl = hdr_offs[img + 1] - h0;
  }
  const int head = c == 0 ? (s == 0 ? hl : 2) : 0;
  const bool ends_seg = c == chunks - 1;
  const bool ends_file = ends_seg && s == n_segs - 1;
  unsigned tail = 0xFFu;  // a bare fill byte where the stream ends on a byte
  int tail_len = 0;
  if (ends_seg) {
    tail_len = 1;
    if (rem) {
      const unsigned b = (row[nfull >> 2] >> (24 - 8 * (nfull & 3))) & 0xFFu;
      tail = b | ((1u << (8 - rem)) - 1u);
      if (tail == 0xFFu) tail_len = 2;  // a data-carrying 0xFF is stuffed
    }
  }

  // pass 1: the item's 0xFF bytes
  int ff = 0;
  for (int base = lo; base < hi; base += kRound) {
    const int p = base + t * kGroup;
    if (p < hi)
      ff += group_ffs(*reinterpret_cast<const uint4*>(row + (p >> 2)),
                      hi - p);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ff += __shfl_xor_sync(full, ff, off);
  if (lane == 0) s_warp[warp] = ff;
  __syncthreads();

  if (warp == 0) {
    int sum = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(full, sum, off);
    const long long agg = (long long)head + (hi - lo) + sum + tail_len +
                          (ends_file ? 2 : 0);
    long long excl = 0;
    if (id == 0) {
      if (lane == 0)
        Status(status[0]).store(kPrefix | (unsigned long long)agg,
                                cuda::memory_order_release);
    } else {
      if (lane == 0)
        Status(status[id]).store(kAggregate | (unsigned long long)agg,
                                 cuda::memory_order_release);
      // look back over items id-1, id-2, ...: lane l reads item
      // `last - l`; the nearest published prefix ends the walk
      for (int last = id - 1;; last -= 32) {
        const int i = last - lane;
        unsigned long long st = kPrefix;  // before item 0: a prefix of 0
        if (i >= 0) {
          do {
            st = Status(status[i]).load(cuda::memory_order_acquire);
          } while ((st & kFlags) == 0);
        }
        const unsigned done = __ballot_sync(full, (st & kFlags) == kPrefix);
        // sum the values of lanes up to the first prefix (all if none)
        const int upto = done ? __ffs(done) - 1 : 31;
        long long v = lane <= upto ? (long long)(st & kValue) : 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(full, v, off);
        excl += v;
        if (done) break;
      }
      if (lane == 0)
        Status(status[id]).store(
            kPrefix | (unsigned long long)(excl + agg),
            cuda::memory_order_release);
    }
    if (lane == 0) {
      s_excl = excl;
      // this item reads no status word any more: the last one done
      // zeroes the workspace for the next launch on the stream
      s_last = Counter(counters[1]).fetch_add(
                   1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
    }
  }
  __syncthreads();

  // pass 2: the header or RST marker, the stuffed bytes, the tail and EOI
  long long o = s_excl;
  if (head) {
    if (s == 0) {
      for (int j = t; j < hl; j += kThreads) out[o + j] = hdr[h0 + j];
    } else if (t == 0) {
      out[o] = 0xFF;
      out[o + 1] = (uint8_t)(0xD0 + ((s - 1) & 7));
    }
    o += head;
  }
  for (int base = lo; base < hi; base += kRound) {
    const int p = base + t * kGroup;
    uint4 v = make_uint4(0, 0, 0, 0);
    int n = 0, len = 0;
    if (p < hi) {
      v = *reinterpret_cast<const uint4*>(row + (p >> 2));
      n = min(hi - p, kGroup);
      len = n + group_ffs(v, n);
    }
    int incl = len;  // inclusive scan of the stuffed lengths in the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(full, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = lane < kWarps ? s_warp[lane] : 0;
      int wi = w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(full, wi, off);
        if (lane >= off) wi += y;
      }
      if (lane < kWarps) s_warp[lane] = wi - w;
      if (lane == kWarps - 1) s_round = wi;
    }
    __syncthreads();
    int q = s_warp[warp] + incl - len;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (k < n) {
        const unsigned b = group_byte(v, k);
        s_out[q++] = (uint8_t)b;
        if (b == 0xFFu) s_out[q++] = 0;
      }
    }
    __syncthreads();
    const int m = s_round;
    for (int j = t; j < m; j += kThreads) out[o + j] = s_out[j];
    o += m;
    __syncthreads();  // s_out and s_warp are refilled by the next round
  }
  if (ends_seg && t == 0) {
    out[o++] = (uint8_t)tail;
    if (tail_len == 2) out[o++] = 0;
    if (ends_file) {
      out[o++] = 0xFF;  // EOI
      out[o++] = 0xD9;
      bounds[img + 1] = o;
    }
  }
  if (id == 0 && t == 0) bounds[0] = 0;
  if (s_last) {
    for (unsigned i = t; i < gridDim.x; i += kThreads) status[i] = 0;
    if (t == 0) counters[0] = counters[1] = 0;
  }
}

}  // namespace

// Items of one segment: about kTargetItems over the launch, and no more
// than a segment's worst case holds rounds.
static int segment_chunks(int n_segments, int seg_words) {
  const long long rounds = ((long long)seg_words * 4 + kRound - 1) / kRound;
  long long k = (kTargetItems + n_segments - 1) / n_segments;
  if (k > rounds) k = rounds;
  return k > 1 ? (int)k : 1;
}

// The 64-bit words of jt_write_files' workspace for n_segments segments of
// seg_words words: the counters, then a status word per item.
extern "C" int jt_write_files_words(int n_segments, int seg_words) {
  return n_segments * segment_chunks(n_segments, seg_words) + 1;
}

// words [n_images * n_segs, seg_words] u32 (seg_words a multiple of 4, the
// buffer 16-byte aligned), totals [n_images * n_segs] int32 bit counts;
// image i's header is hdr[hdr_offs[i] .. hdr_offs[i + 1]), or hdr[0 ..
// hdr_len) for every image where hdr_offs is null.  out takes the files
// back to back (it must hold the worst case, see kernels/files.py) and
// bounds [n_images + 1] int64 their ends, bounds[0] = 0.  `work` holds
// jt_write_files_words(n_images * n_segs, seg_words) words, all zero; the
// launch leaves them zero again.
extern "C" int jt_write_files(const void* words, const void* totals,
                              const void* hdr, const void* hdr_offs,
                              void* out, void* bounds, void* work,
                              int hdr_len, int n_images, int n_segs,
                              int seg_words, void* stream) {
  const long long n_segments = (long long)n_images * n_segs;
  if (n_segments == 0) return (int)cudaGetLastError();
  const int chunks = segment_chunks((int)n_segments, seg_words);
  unsigned long long* w = (unsigned long long*)work;
  write_files_kernel<<<(unsigned)(n_segments * chunks), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int*)totals, (const uint8_t*)hdr,
      (const int*)hdr_offs, hdr_len, (uint8_t*)out, (long long*)bounds,
      (unsigned int*)w, w + 1, n_segs, seg_words, chunks);
  return (int)cudaGetLastError();
}
