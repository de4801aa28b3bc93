// Kernel D, place: Huffman fields + block offsets -> packed segment words.
//
// Replaces the place tail of jpeg_tpu: kernels/fused.py::_place_tail_full
// and _rowacc_mxu (local pack, bit shift, lane rotate and one-hot row
// accumulation into the VMEM-resident words buffer of the mega kernel),
// and _place_acc_kernel plus the XLA scatter_add of
// kernels/fused.py::_segment_place on the two-phase route, and (after
// kernel C) kernels/pack.py::pack_segments -> block_windows_t ->
// _pack_kernel_t plus its row scatter_add (K15, jpeg_tpu's 3-scan pack).
// Inputs are value uint32 and nbits uint8 [S, nblk, 64] (a field of at
// most 32 bits per slot, right-aligned, value < 2^nbits), the exclusive
// block bit offsets int32 [S, nblk] and the segment totals int32 [S]; the
// output is the words buffer uint32 [S, seg_words].  Bit i of a segment's
// stream is bit 31 - (i & 31) of word i >> 5 (big-endian,
// jpeg_tpu/ops/pack.py).  The contract: each word in [0, ceil(totals[s] /
// 32)) of segment s is written exactly once, with the bits after the
// stream's end 0; the words after them are not written (the buffer is
// sized for the worst case of 30 bits a slot, ~150x what real streams
// hold, and every consumer reads only the stream).
//
// What bounds it on an H100: reading the fields.  Most slots are NULL
// (nbits 0), and a NULL slot's value is not needed: the bytes the function
// must move are the nbits, the values of the non-NULL slots, the offsets
// and the stream's words.  Design: a CTA of 256 threads places a tile of
// 64 consecutive blocks of one segment, 4 threads a block, 16 slots a
// thread.  A thread loads its 16 nbits in one 16-byte load and each group
// of 4 values (16 bytes) only where one of their nbits is non-zero; a
// 2-step shuffle scan over the block's 4 threads gives its first bit.  It
// then packs its fields through a 64-bit accumulator into a shared-memory
// image of the tile's words: a word it fills alone is a plain store, the
// (at most two) words it shares with a neighbour an atomicOr.  The tile
// owns the words whose first bit lies in its bit range; for the last one,
// warp 0 reads ahead into the next blocks' leading fields (bits past the
// owned words are dropped), so every word has one owner and no word is
// read, zeroed or ORed in global memory: the tile's words go out in
// 16-byte stores where aligned.  No memset, no device query at launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;              // blocks a CTA places
constexpr int kThreads = kTile * 4;    // 4 threads a block, 16 slots each
// shared words: a tile of 32-bit fields fills 64 * 64 words, plus the
// word its first bit starts in, plus up to 3 words of alignment
constexpr int kCap = kTile * 64 + 8;

// One thread's 16 slots (a quarter of a block): load, scan, pack into the
// shared image s_w of words [lo, hi) (shared index = word - sbase).  All
// lanes of the warp call it together (the scan shuffles over the block's
// 4 lanes); ok = false gives a thread no fields.
__device__ __forceinline__ void place_quarter(
    const uint32_t* __restrict__ value, const uint8_t* __restrict__ nbits,
    const int* __restrict__ so, long long gb, int b, int q, bool ok,
    uint32_t* s_w, int lo, int hi, int sbase) {
  uint4 nb4 = make_uint4(0, 0, 0, 0);
  int base = 0;
  if (ok) {
    nb4 = reinterpret_cast<const uint4*>(nbits + gb * 64)[q];
    base = so[b];
  }
  const uint32_t nw[4] = {nb4.x, nb4.y, nb4.z, nb4.w};
  uint4 val[4];
  const uint4* vp = reinterpret_cast<const uint4*>(value + gb * 64) + q * 4;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    val[c] = nw[c] ? vp[c] : make_uint4(0, 0, 0, 0);
  int sum = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    sum += (nw[c] & 0xff) + ((nw[c] >> 8) & 0xff) + ((nw[c] >> 16) & 0xff) +
           (nw[c] >> 24);
  // exclusive scan of the 4 threads' bit counts within the block
  const unsigned full = 0xffffffffu;
  int incl = sum;
  int o = __shfl_up_sync(full, incl, 1, 4);
  if (q >= 1) incl += o;
  o = __shfl_up_sync(full, incl, 2, 4);
  if (q >= 2) incl += o;
  if (sum == 0) return;
  const int t = base + incl - sum;  // the thread's first bit
  const int w0 = t >> 5;
  int w = w0;
  int fill = t & 31;                // bits of word w already taken
  unsigned long long acc = 0;       // the low `fill` bits of word w
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t vv[4] = {val[c].x, val[c].y, val[c].z, val[c].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = (nw[c] >> (8 * e)) & 0xff;
      if (n == 0) continue;
      acc = (acc << n) | vv[e];
      fill += n;
      if (fill >= 32) {
        fill -= 32;
        const uint32_t word = (uint32_t)(acc >> fill);
        if (w >= lo && w < hi) {
          // the first word is shared with the thread before unless the
          // stream of this thread starts on it
          if (w == w0 && (t & 31)) atomicOr(s_w + (w - sbase), word);
          else s_w[w - sbase] = word;
        }
        ++w;
        acc &= (1ull << fill) - 1;
      }
    }
  }
  if (fill > 0 && w >= lo && w < hi)
    atomicOr(s_w + (w - sbase), (uint32_t)(acc << (32 - fill)));
}

__global__ void __launch_bounds__(kThreads)
place_kernel(const uint32_t* __restrict__ value,
             const uint8_t* __restrict__ nbits, const int* __restrict__ offs,
             const int* __restrict__ totals, uint32_t* __restrict__ words,
             int nblk, int seg_words, int tiles) {
  __shared__ __align__(16) uint32_t s_w[kCap];
  const int seg = blockIdx.x / tiles;
  const int b0 = (blockIdx.x - seg * tiles) * kTile;
  const int b1 = min(b0 + kTile, nblk);
  const int* so = offs + (long long)seg * nblk;
  const int o_end = b1 < nblk ? so[b1] : totals[seg];
  // the words whose first bit lies in [so[b0], o_end): [lo, hi)
  const int lo = (int)(((long long)so[b0] + 31) >> 5);
  int hi = (int)(((long long)o_end + 31) >> 5);
  hi = min(hi, min(seg_words, lo + kCap - 8));  // (fields over 32 bits)
  if (hi <= lo) return;  // a tile with no word of its own
  const long long gbase = (long long)seg * seg_words;
  // shared word 0 lies on a 16-byte boundary of the global words
  const int sbase = lo - (int)((gbase + lo) & 3);
  const int n_sh = hi - sbase;
  const int tid = threadIdx.x;
  for (int i = tid * 4; i < n_sh; i += kThreads * 4)
    *reinterpret_cast<uint4*>(s_w + i) = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const long long seg_blk = (long long)seg * nblk;
  const int q = tid & 3;
  const int b = b0 + (tid >> 2);
  place_quarter(value, nbits, so, seg_blk + b, b, q, b < b1, s_w, lo, hi,
                sbase);
  // the last word's bits past the tile come from the next blocks' fields
  if (tid < 32) {
    const int end_bit = hi << 5;
    for (int r = b1; r < nblk && so[r] < end_bit; r += 8) {
      const int rb = r + (tid >> 2);
      place_quarter(value, nbits, so, seg_blk + rb, rb, q, rb < nblk, s_w,
                    lo, hi, sbase);
    }
  }
  __syncthreads();

  uint32_t* out = words + gbase + sbase;
  const int i0 = lo - sbase;
  for (int c = tid * 4; c < n_sh; c += kThreads * 4) {
    if (c >= i0 && c + 4 <= n_sh) {
      *reinterpret_cast<uint4*>(out + c) =
          *reinterpret_cast<const uint4*>(s_w + c);
    } else {
      for (int i = max(c, i0); i < min(c + 4, n_sh); ++i) out[i] = s_w[i];
    }
  }
}

}  // namespace

extern "C" int jt_place(const void* value, const void* nbits, const void* offs,
                        const void* totals, void* words, int n_segs, int nblk,
                        int seg_words, void* stream) {
  if (n_segs == 0 || nblk == 0) return (int)cudaGetLastError();
  const int tiles = (nblk + kTile - 1) / kTile;
  const long long grid = (long long)n_segs * tiles;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  place_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)value, (const uint8_t*)nbits, (const int*)offs,
      (const int*)totals, (uint32_t*)words, nblk, seg_words, tiles);
  return (int)cudaGetLastError();
}
