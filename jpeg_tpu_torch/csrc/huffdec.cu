// Kernel G, decode_segments: baseline Huffman decode of restart segments,
// one segment per lane -> zig-zag coefficients [S, nblk_seg, 64] int32.
//
// Replaces the restart mode of jpeg_tpu/kernels/huffdec.py::decode_segments
// (the pallas_call of _hd_kernel at huffdec.py:853, K16; entry bit 0 and no
// per-lane MCU phase).  Inputs are that function's: streams [S, max_words]
// int32 big-endian words, one un-stuffed segment per row; per-lane
// canonical tables from huffdec.py::lane_tables, bound and delta [64, S]
// (4 tables x 16 code lengths) and HUFFVAL [S, 256] (4 symbols a word, low
// byte first); nblk_lane [S], each lane's real block count.  Block b of a
// lane takes its tables and DC predictor from position b % period of the
// MCU (period blocks, the first y_per_mcu of them luma, then Cb and Cr);
// its DC is cumulative from 0 in the lane.  The semantics are _hd_kernel's:
// a code that matches no table entry (length 17) ends its block without
// consuming bits; a run that passes slot 63 writes nothing and ends the
// block; ZRL advances 16 slots; blocks past nblk_lane (or nblk_seg) are
// zeros and consume no bits.  Bits past a row read as zeros: no load ever
// leaves the lane's row, whatever the bits say.
//
// What bounds it on an H100: bytes, as a roofline count: the streams in
// plus the zz out over 3.35 TB/s (at 16x640x640 4:2:0 the zz write alone
// is 16 x 9600 blocks x 256 B = 39.3 MB, about 12 us).  This design is far
// from that: one thread walks each segment's bits serially (a 64-bit bit
// buffer refilled from global memory, a linear search over the 16 code
// lengths per symbol), so its time is the latency of the longest
// segment's symbol chain, and the card holds only S threads (640 at
// 16x640x640 r1, 8 at 2x1920x1088 r17).  Splitting a segment over several
// threads (the speculative decode, K17) is the redesign for a later change.
// The output is zeroed by one cudaMemsetAsync, then each lane writes its
// DC terms and its nonzero AC terms.  One warp per CTA spreads the lanes
// over the SMs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

struct BitReader {
  const uint32_t* row;
  int max_words;
  int next;      // next word of the row to load
  uint64_t buf;  // the next bits of the stream, left-aligned
  int n;         // valid bits in buf

  __device__ void init(const uint32_t* r, int mw) {
    row = r;
    max_words = mw;
    next = 0;
    buf = 0;
    n = 0;
  }
  // at least 32 valid bits after the call (zeros past the row)
  __device__ __forceinline__ void fill() {
    if (n < 32) {
      const uint32_t w = next < max_words ? __ldg(row + next++) : 0u;
      buf |= (uint64_t)w << (32 - n);
      n += 32;
    }
  }
  __device__ __forceinline__ uint32_t peek() const {
    return (uint32_t)(buf >> 32);
  }
  __device__ __forceinline__ void skip(int k) {  // k <= 31 <= n
    buf <<= k;
    n -= k;
  }
};

// One canonical decode of a 32-bit peek against table t of lane s:
// returns the symbol and sets *len to the code length (17: no match).
__device__ __forceinline__ int decode_symbol(uint32_t peek,
                                             const int* __restrict__ bound,
                                             const int* __restrict__ delta,
                                             const uint32_t* __restrict__ hv,
                                             int S, int* len) {
  const int p = (int)(peek >> 16);
  for (int l = 1; l <= 16; ++l) {
    if (p < __ldg(bound + (l - 1) * S)) {
      int v = (p >> (16 - l)) + __ldg(delta + (l - 1) * S);
      v = min(max(v, 0), 255);
      *len = l;
      return (int)((__ldg(hv + (v >> 2)) >> (8 * (v & 3))) & 0xFFu);
    }
  }
  *len = 17;
  return 0;
}

// the `size` bits after a code of length `len` (len + size <= 31), as
// T.81 F.2.2.1's EXTEND gives them
__device__ __forceinline__ int amplitude(uint32_t peek, int len, int size) {
  if (size == 0) return 0;
  const int v = (int)((peek << len) >> (32 - size));
  return v < (1 << (size - 1)) ? v - ((1 << size) - 1) : v;
}

__global__ void __launch_bounds__(kThreads)
decode_segments_kernel(const uint32_t* __restrict__ streams,
                       const int* __restrict__ maxc,
                       const int* __restrict__ delt,
                       const uint32_t* __restrict__ hvp,
                       const int* __restrict__ nblk_lane,
                       int* __restrict__ zz, int S, int max_words,
                       int nblk_seg, int period, int y_per_mcu) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const int nblk = min(__ldg(nblk_lane + s), nblk_seg);
  BitReader br;
  br.init(streams + (size_t)s * max_words, max_words);
  int pred[3] = {0, 0, 0};
  int pos = 0;  // b % period
  for (int b = 0; b < nblk; ++b, pos = (pos + 1 == period ? 0 : pos + 1)) {
    const bool luma = pos < y_per_mcu;
    const int comp = luma ? 0 : pos - y_per_mcu + 1;
    const int dc_t = luma ? 0 : 2;  // table rows: the AC table follows
    int* out = zz + ((size_t)s * nblk_seg + b) * 64;
    br.fill();
    uint32_t peek = br.peek();
    int len;
    int sym = decode_symbol(peek, maxc + dc_t * 16 * S + s,
                            delt + dc_t * 16 * S + s,
                            hvp + (size_t)s * 256 + dc_t * 64, S, &len);
    if (len > 16) continue;  // no match: a zero block, no bits consumed
    int size = sym & 15;
    pred[comp] += amplitude(peek, len, size);
    out[0] = pred[comp];
    br.skip(len + size);
    const int* bound = maxc + (dc_t + 1) * 16 * S + s;
    const int* delta = delt + (dc_t + 1) * 16 * S + s;
    const uint32_t* hv = hvp + (size_t)s * 256 + (dc_t + 1) * 64;
    int slot = 1;
    while (true) {
      br.fill();
      peek = br.peek();
      sym = decode_symbol(peek, bound, delta, hv, S, &len);
      if (len > 16) break;
      size = sym & 15;
      br.skip(len + size);
      if (sym == 0) break;  // EOB
      if (sym == 0xF0) {    // ZRL
        slot += 16;
      } else {
        const int k = slot + (sym >> 4);
        if (size > 0 && k <= 63) out[k] = amplitude(peek, len, size);
        slot = k + 1;
      }
      if (slot > 63) break;
    }
  }
}

}  // namespace

extern "C" int jt_decode_segments(const void* streams, const void* maxc,
                                  const void* delt, const void* hvp,
                                  const void* nblk_lane, void* zz, int S,
                                  int max_words, int nblk_seg, int period,
                                  int y_per_mcu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t out_bytes = (size_t)S * nblk_seg * 64 * sizeof(int);
  if (out_bytes == 0) return (int)cudaGetLastError();
  cudaError_t rc = cudaMemsetAsync(zz, 0, out_bytes, st);
  if (rc != cudaSuccess) return (int)rc;
  decode_segments_kernel<<<(S + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const uint32_t*)streams, (const int*)maxc, (const int*)delt,
      (const uint32_t*)hvp, (const int*)nblk_lane, (int*)zz, S, max_words,
      nblk_seg, period, y_per_mcu);
  return (int)cudaGetLastError();
}
