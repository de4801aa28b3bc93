// Kernels G and H: baseline Huffman decode on the card, one lane per row of
// bits; G walks a lane with one thread, H with one warp.
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
// lane).  Both are far from that, since a Huffman walk is a chain of
// dependent symbol decodes, bounded by latency.  G: one thread walks each
// lane's bits serially (a 64-bit bit buffer refilled from global memory, a
// linear search over the 16 code lengths per symbol), so each launch takes
// the latency of its longest lane's symbol chain; its output is zeroed by
// one cudaMemsetAsync, then each lane writes its DC terms and its nonzero
// AC terms; one warp per CTA spreads the lanes over the SMs.  H keeps the
// one-thread walk but shortens each step: a warp a lane stages the lane's
// row in shared memory (rows too long for the budget stay in global
// memory) and builds a 9-bit lookahead table per table row there, so a
// code of at most 9 bits (DC codes and EOB, most of a block's symbols)
// decodes with one shared load instead of the 16-step search, and a DC
// code followed by an EOB within the prefix ends its block in one load;
// then one thread of the warp walks the lane.  Four lanes a CTA.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

// A lane's bits from bit `entry` of its row; kLdg: the row is in global
// memory and read through the read-only cache
template <bool kLdg>
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
      const uint32_t w =
          next < max_words ? (kLdg ? __ldg(row + next++) : row[next++]) : 0u;
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
// nonzero terms into out and returns false if a code matched nothing (the
// symbol's bits are then not consumed).
__device__ __forceinline__ bool walk_ac(BitReader<true>& br, int* bp,
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
      if (size > 0 && k <= 63)
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
  BitReader<true> br;
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

// -- H: scan_positions, one warp a lane ------------------------------------

constexpr int kLutBits = 9;  // lookahead bits: codes up to 9 bits in one load
constexpr int kLutSize = 1 << kLutBits;
constexpr int kLutBytes = 4 * kLutSize * 2;  // 4 tables of uint16 entries
constexpr int kScanWarps = 4;                // lanes (warps) a CTA
constexpr int kSmemBudget = 200 * 1024;      // dynamic shared memory a CTA
// lookahead entries: the bits a step consumes (code and magnitude) in bits
// 0-4, then in a DC table's entry bit 5 (the block ends here: its DC and
// an EOB both fit the prefix), in an AC table's bits 5-11 the slot
// advance (run + 1; 16 for ZRL; 64 for EOB); 0: not in the table
constexpr unsigned kBlockEnd = 1u << 5;

// the slot advance of AC symbol `sym`
__device__ __forceinline__ unsigned ac_advance(int sym) {
  return sym == 0 ? 64u : sym == 0xF0 ? 16u : (unsigned)(sym >> 4) + 1u;
}

// One lane's tables: the lookahead tables in shared memory, and the
// canonical arrays of the lane (strided by S) for the codes they miss
struct LaneTables {
  const uint16_t* lut;  // [4][kLutSize]
  const int* bound;
  const int* delta;
  const uint32_t* hv;
  int S;
  int period;
  int y_per_mcu;

  __device__ __forceinline__ int search(uint32_t peek, int t,
                                        int* len) const {
    return decode_symbol(peek, bound + t * 16 * S, delta + t * 16 * S,
                         hv + t * 64, S, len);
  }
  // the entry of table row t for `peek`, from the lookahead table or the
  // canonical search; 0: no code matches (length 17)
  __device__ __forceinline__ unsigned step(uint32_t peek, int t) const {
    const unsigned e = lut[t * kLutSize + (peek >> (32 - kLutBits))];
    if (e != 0) return e;
    int len;
    const int sym = search(peek, t, &len);
    if (len > 16) return 0;
    return (unsigned)(len + (sym & 15)) |
           ((t & 1) ? ac_advance(sym) << 5 : 0u);
  }
};

// Build the lookahead tables of the rows the lane's pattern uses, by the
// warp.  An entry is decode_symbol's answer for the 9-bit prefix padded
// with zeros, kept where its code fits the prefix; that answer holds for
// every peek with the prefix when each bound of a length l <= 9 is a
// multiple of 2^(16-l), as canonical tables' are (else the row stays
// empty and every code takes the search).  A DC entry also takes the
// next code (decode_symbol on the AC row) where the DC code, its
// magnitude and that code all fit the prefix and it is an EOB.
__device__ void build_lookahead(uint16_t* lut, const LaneTables& tb, int j) {
  const unsigned full = 0xffffffffu;
  bool aligned[4];
  for (int t = 0; t < 4; ++t) {
    const bool odd =
        j < kLutBits &&
        (__ldg(tb.bound + (t * 16 + j) * tb.S) & ((1 << (15 - j)) - 1)) != 0;
    aligned[t] = __ballot_sync(full, odd) == 0;
  }
  for (int dc = 0; dc < 4; dc += 2) {
    if (dc == 0 ? tb.y_per_mcu <= 0 : tb.y_per_mcu >= tb.period) continue;
    for (int q = j; q < kLutSize; q += 32) {
      const uint32_t peek = (uint32_t)q << (32 - kLutBits);
      unsigned e_dc = 0, e_ac = 0;
      int len;
      if (aligned[dc + 1]) {
        const int sym = tb.search(peek, dc + 1, &len);
        if (len <= kLutBits)
          e_ac = (unsigned)(len + (sym & 15)) | ac_advance(sym) << 5;
      }
      if (aligned[dc]) {
        const int sym = tb.search(peek, dc, &len);
        if (len <= kLutBits) {
          const int used = len + (sym & 15);
          e_dc = (unsigned)used;
          if (used < kLutBits && aligned[dc + 1]) {
            int len2;
            const int sym2 = tb.search(peek << used, dc + 1, &len2);
            if (sym2 == 0 && used + len2 <= kLutBits)
              e_dc = (unsigned)(used + len2) | kBlockEnd;
          }
        }
      }
      lut[dc * kLutSize + q] = (uint16_t)e_dc;
      lut[(dc + 1) * kLutSize + q] = (uint16_t)e_ac;
    }
  }
  __syncwarp();
}

// Walk blocks from bit `bp` at MCU position `pos` while a block starts
// before `end`, at most `max_blocks` of them: returns the blocks walked
// and leaves bp, pos at the exit.  A block whose DC or AC code matches
// nothing stops the walk uncounted, bp at its start, and sets *bad.
__device__ int walk_blocks(const uint32_t* row, int max_words,
                           const LaneTables& tb, int* bp, int* pos, int end,
                           int max_blocks, int* bad) {
  *bad = 0;
  if (max_blocks <= 0 || *bp >= end) return 0;
  BitReader<false> br;  // the row may be in shared memory
  br.init(row, max_words, *bp);
  int count = 0, cur = *bp;
  while (true) {
    int dc_t, comp;
    position(*pos, tb.y_per_mcu, &dc_t, &comp);
    br.fill();
    unsigned e = tb.step(br.peek(), dc_t);
    if (e == 0) break;
    int used = (int)(e & 31);
    br.skip(used);
    if (!(e & kBlockEnd)) {
      for (unsigned slot = 1; slot <= 63;) {
        br.fill();
        e = tb.step(br.peek(), dc_t + 1);
        if (e == 0) break;
        br.skip((int)(e & 31));
        used += (int)(e & 31);
        slot += e >> 5;
      }
      if (e == 0) break;
    }
    cur += used;
    *bp = cur;
    ++count;
    *pos = *pos + 1 == tb.period ? 0 : *pos + 1;
    if (count >= max_blocks || cur >= end) return count;
  }
  *bad = 1;  // the block does not count: bp stays at its start
  return count;
}

// One warp a lane: the warp stages the lane's row in shared memory and
// builds its lookahead tables, then one thread walks the lane.
__global__ void __launch_bounds__(32 * kScanWarps)
scan_positions_kernel(const uint32_t* __restrict__ streams,
                      const int* __restrict__ maxc,
                      const int* __restrict__ delt,
                      const uint32_t* __restrict__ hvp,
                      const int* __restrict__ entry,
                      const int* __restrict__ limit,
                      const int* __restrict__ phase, int* __restrict__ out,
                      int S, int max_words, int steps, int period,
                      int y_per_mcu, int lane_bytes, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, j = threadIdx.x & 31;
  const int s = blockIdx.x * (blockDim.x >> 5) + warp;
  if (s >= S) return;  // the whole warp: no CTA-wide barrier follows
  uint16_t* lut = (uint16_t*)(smem + (size_t)warp * lane_bytes);
  const uint32_t* row = streams + (size_t)s * max_words;
  if (staged) {
    uint32_t* r = (uint32_t*)(smem + (size_t)warp * lane_bytes + kLutBytes);
    for (int w = j; w < max_words; w += 32) r[w] = __ldg(row + w);
    row = r;
  }
  const LaneTables tb{lut,  maxc + s, delt + s, hvp + (size_t)s * 256,
                      S,    period,   y_per_mcu};
  build_lookahead(lut, tb, j);
  const int E = __ldg(entry + s), L = __ldg(limit + s);
  const int P = phase != nullptr ? __ldg(phase + s) % period : 0;
  if (j == 0) {
    int bp = E, pos = P, bad;
    const int count = walk_blocks(row, max_words, tb, &bp, &pos, L, steps,
                                  &bad);
    out[s] = bp;
    out[S + s] = count;
    out[2 * S + s] = bad;
  }
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
  // stage each lane's row beside its tables while kScanWarps lanes or at
  // least one fit in the budget; a longer row stays in global memory
  const long long row_bytes = ((long long)max_words * 4 + 15) & ~15LL;
  long long lane_bytes = kLutBytes + row_bytes;
  int staged = 1, warps = kScanWarps;
  if (lane_bytes > kSmemBudget) {
    staged = 0;
    lane_bytes = kLutBytes;
  } else {
    warps = (int)min((long long)kScanWarps, kSmemBudget / lane_bytes);
  }
  const int smem = (int)(lane_bytes * warps);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        scan_positions_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  scan_positions_kernel<<<(S + warps - 1) / warps, 32 * warps, smem, st>>>(
      (const uint32_t*)streams, (const int*)maxc, (const int*)delt,
      (const uint32_t*)hvp, (const int*)entry, (const int*)limit,
      (const int*)phase, (int*)out, S, max_words, steps < 0 ? 0 : steps,
      period, y_per_mcu, (int)lane_bytes, staged);
  return (int)cudaGetLastError();
}
