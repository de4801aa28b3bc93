// Kernels G and H: baseline Huffman decode on the card, one lane per row of
// bits, one thread per lane.
//
// G, decode_segments -> zig-zag coefficients [S, nblk_seg, 64] int32.
// Replaces jpeg_tpu/kernels/huffdec.py::decode_segments (the pallas_call of
// _hd_kernel at huffdec.py:853, K16), in both of its modes.  Inputs are that
// function's: streams [S, max_words] int32 big-endian words, one un-stuffed
// lane a row; per-lane canonical tables from huffdec.py::lane_tables, bound
// and delta [64, S] (4 tables x 16 code lengths) and HUFFVAL [S, 256] (4
// symbols a word, low byte first); nblk_lane [S], each lane's real block
// count.  Restart mode (entry and phase NULL): each lane is a restart
// segment from bit 0, and block b takes its tables and DC predictor from
// position b % period of the MCU (period blocks, the first y_per_mcu of them
// luma, then Cb and Cr).  Speculative mode: the lane starts at bit entry[s],
// and with phase given (jpeg_tpu's phased=True) block b takes position
// (phase[s] + b) % period.  Either way the DC is cumulative from 0 in the
// lane per component.  The semantics are _hd_kernel's: a code that matches
// no table entry (length 17) ends its block without consuming bits; a run
// that passes slot 63 writes nothing and ends the block; ZRL advances 16
// slots; blocks past nblk_lane (or nblk_seg) are zeros and consume no bits.
// Bits past a row read as zeros: no load ever leaves the lane's row,
// whatever the bits say.
//
// H, scan_positions -> exits, counts, bad [3, S] int32.  Replaces
// jpeg_tpu/kernels/huffdec.py::scan_positions (the pallas_call of
// _scan_kernel at huffdec.py:761, K17): the positions-only pass of the
// speculative decode of streams without restart markers.  Each lane walks
// blocks from bit entry[s], at most `steps` of them, and stops at the first
// block step that finds its bit position at or past limit[s] or its bad flag
// set.  A block whose DC or any AC code matches nothing does not count: the
// exit stays at the block's start and the lane is marked bad.  Tables come
// from position (phase[s] + step) % period (phase NULL: position 0 for a
// period-1 pattern, rows 0 and 1).  Nothing but the exit bit, the block
// count and the bad flag is written.
//
// What bounds them on an H100: bytes, as a roofline count: the streams in
// plus the outputs over 3.35 TB/s (at 16x640x640 4:2:0 G's zz write alone
// is 16 x 9600 blocks x 256 B = 39.3 MB, about 12 us; H writes 12 bytes a
// lane).  This design is far from that: one thread walks each lane's bits
// serially (a 64-bit bit buffer refilled from global memory, a linear
// search over the 16 code lengths per symbol), so each launch takes the
// latency of its longest lane's symbol chain, and the card holds only S
// threads (640 at 16x640x640 r1, 8 at 2x1920x1088 r17; the speculative
// split aims at about 640 lanes a launch).  G's output is zeroed by one
// cudaMemsetAsync, then each lane writes its DC terms and its nonzero AC
// terms.  One warp per CTA spreads the lanes over the SMs.
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

  // start at bit `entry` (>= 0) of the row
  __device__ void init(const uint32_t* r, int mw, int entry) {
    row = r;
    max_words = mw;
    next = entry >> 5;
    buf = 0;
    n = 0;
    fill();
    skip(entry & 31);
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

// The tables of MCU position `pos`: the DC table row (the AC row follows
// it) and the component
__device__ __forceinline__ void position(int pos, int y_per_mcu, int* dc_t,
                                         int* comp) {
  const bool luma = pos < y_per_mcu;
  *comp = luma ? 0 : pos - y_per_mcu + 1;
  *dc_t = luma ? 0 : 2;
}

// One lane's AC symbols of a block after its DC, from slot 1: writes the
// nonzero terms into out (when not NULL) and returns false if a code
// matched nothing (the symbol's bits are then not consumed).
__device__ __forceinline__ bool walk_ac(BitReader& br, int* bp,
                                        const int* bound, const int* delta,
                                        const uint32_t* hv, int S, int* out) {
  int slot = 1;
  while (true) {
    br.fill();
    const uint32_t peek = br.peek();
    int len;
    const int sym = decode_symbol(peek, bound, delta, hv, S, &len);
    if (len > 16) return false;
    const int size = sym & 15;
    br.skip(len + size);
    *bp += len + size;
    if (sym == 0) return true;  // EOB
    if (sym == 0xF0) {          // ZRL
      slot += 16;
    } else {
      const int k = slot + (sym >> 4);
      if (out != nullptr && size > 0 && k <= 63)
        out[k] = amplitude(peek, len, size);
      slot = k + 1;
    }
    if (slot > 63) return true;
  }
}

__global__ void __launch_bounds__(kThreads)
decode_segments_kernel(const uint32_t* __restrict__ streams,
                       const int* __restrict__ maxc,
                       const int* __restrict__ delt,
                       const uint32_t* __restrict__ hvp,
                       const int* __restrict__ nblk_lane,
                       const int* __restrict__ entry,
                       const int* __restrict__ phase,
                       int* __restrict__ zz, int S, int max_words,
                       int nblk_seg, int period, int y_per_mcu) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const int nblk = min(__ldg(nblk_lane + s), nblk_seg);
  int bp = entry != nullptr ? __ldg(entry + s) : 0;
  BitReader br;
  br.init(streams + (size_t)s * max_words, max_words, bp);
  int pred[3] = {0, 0, 0};
  int pos = phase != nullptr ? __ldg(phase + s) % period : 0;
  for (int b = 0; b < nblk; ++b, pos = (pos + 1 == period ? 0 : pos + 1)) {
    int dc_t, comp;
    position(pos, y_per_mcu, &dc_t, &comp);
    int* out = zz + ((size_t)s * nblk_seg + b) * 64;
    br.fill();
    const uint32_t peek = br.peek();
    int len;
    const int sym = decode_symbol(peek, maxc + dc_t * 16 * S + s,
                                  delt + dc_t * 16 * S + s,
                                  hvp + (size_t)s * 256 + dc_t * 64, S, &len);
    if (len > 16) continue;  // no match: a zero block, no bits consumed
    const int size = sym & 15;
    pred[comp] += amplitude(peek, len, size);
    out[0] = pred[comp];
    br.skip(len + size);
    bp += len + size;
    walk_ac(br, &bp, maxc + (dc_t + 1) * 16 * S + s,
            delt + (dc_t + 1) * 16 * S + s,
            hvp + (size_t)s * 256 + (dc_t + 1) * 64, S, out);
  }
}

__global__ void __launch_bounds__(kThreads)
scan_positions_kernel(const uint32_t* __restrict__ streams,
                      const int* __restrict__ maxc,
                      const int* __restrict__ delt,
                      const uint32_t* __restrict__ hvp,
                      const int* __restrict__ entry,
                      const int* __restrict__ limit,
                      const int* __restrict__ phase, int* __restrict__ out,
                      int S, int max_words, int steps, int period,
                      int y_per_mcu) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  int bp = __ldg(entry + s);
  const int lim = __ldg(limit + s);
  BitReader br;
  br.init(streams + (size_t)s * max_words, max_words, bp);
  int pos = phase != nullptr ? __ldg(phase + s) % period : 0;
  int count = 0;
  int bad = 0;
  for (int step = 0; step < steps && bp < lim;
       ++step, pos = (pos + 1 == period ? 0 : pos + 1)) {
    int dc_t, comp;
    position(pos, y_per_mcu, &dc_t, &comp);
    br.fill();
    int len;
    const int sym = decode_symbol(br.peek(), maxc + dc_t * 16 * S + s,
                                  delt + dc_t * 16 * S + s,
                                  hvp + (size_t)s * 256 + dc_t * 64, S, &len);
    if (len > 16) {
      bad = 1;
      break;
    }
    int end = bp + len + (sym & 15);
    br.skip(len + (sym & 15));
    if (!walk_ac(br, &end, maxc + (dc_t + 1) * 16 * S + s,
                 delt + (dc_t + 1) * 16 * S + s,
                 hvp + (size_t)s * 256 + (dc_t + 1) * 64, S, nullptr)) {
      bad = 1;  // the block does not count: the exit stays at its start
      break;
    }
    bp = end;
    ++count;
  }
  out[s] = bp;
  out[S + s] = count;
  out[2 * S + s] = bad;
}

}  // namespace

extern "C" int jt_decode_segments(const void* streams, const void* maxc,
                                  const void* delt, const void* hvp,
                                  const void* nblk_lane, const void* entry,
                                  const void* phase, void* zz, int S,
                                  int max_words, int nblk_seg, int period,
                                  int y_per_mcu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t out_bytes = (size_t)S * nblk_seg * 64 * sizeof(int);
  if (out_bytes == 0) return (int)cudaGetLastError();
  cudaError_t rc = cudaMemsetAsync(zz, 0, out_bytes, st);
  if (rc != cudaSuccess) return (int)rc;
  decode_segments_kernel<<<(S + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const uint32_t*)streams, (const int*)maxc, (const int*)delt,
      (const uint32_t*)hvp, (const int*)nblk_lane, (const int*)entry,
      (const int*)phase, (int*)zz, S, max_words, nblk_seg, period, y_per_mcu);
  return (int)cudaGetLastError();
}

extern "C" int jt_scan_positions(const void* streams, const void* maxc,
                                 const void* delt, const void* hvp,
                                 const void* entry, const void* limit,
                                 const void* phase, void* out, int S,
                                 int max_words, int steps, int period,
                                 int y_per_mcu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 0) return (int)cudaGetLastError();
  scan_positions_kernel<<<(S + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const uint32_t*)streams, (const int*)maxc, (const int*)delt,
      (const uint32_t*)hvp, (const int*)entry, (const int*)limit,
      (const int*)phase, (int*)out, S, max_words, steps, period, y_per_mcu);
  return (int)cudaGetLastError();
}
