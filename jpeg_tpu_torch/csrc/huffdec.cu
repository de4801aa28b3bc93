// Kernels G and H: baseline Huffman decode on the card, one lane per row of
// bits, one warp a lane.
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
// What bounds them on an H100: as a roofline count, bytes: the streams in
// plus the outputs over 3.35 TB/s (at 16x640x640 4:2:0 G's zz write is 16 x
// 9600 blocks x 256 B = 39.3 MB, about 12 us; H writes 12 bytes a lane).  In
// fact a lane's walk is a chain of dependent symbol decodes, bounded by
// latency: a launch takes its longest lane's chain.  So both kernels make
// each step of that chain short.  A warp takes a lane (four lanes a CTA,
// lane_layout): it stages the lane's canonical tables and its row in shared
// memory (rows too long for the budget stay in global memory, read through
// the read-only cache) and builds a 9-bit lookahead table per table row
// there; then one thread walks the lane.  A code of at most 9 bits (DC
// codes and EOB, most of a block's symbols) decodes with one shared load,
// and a DC code with an EOB after it inside the prefix ends its block in
// that load; a longer code searches the staged canonical table from length
// 10.  G's walker adds each term into a shared buffer of 16 blocks; the
// warp flushes it to zz in coalesced 16-byte stores and writes the zeros of
// the blocks past the lane's count, so every element of zz is written once
// and no memset precedes the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A lane's bits from bit `entry` of its row; kLdg: the row is in global
// memory and read through the read-only cache.  The next word is loaded
// one refill ahead, so a refill waits on no load.
template <bool kLdg>
struct BitReader {
  const uint32_t* row;
  int max_words;
  int next;        // the row's word in `ahead`
  uint32_t ahead;  // word `next` of the row (zero past it)
  uint64_t buf;    // the next bits of the stream, left-aligned
  int n;           // valid bits in buf

  __device__ __forceinline__ uint32_t word(int w) const {
    return w < max_words ? (kLdg ? __ldg(row + w) : row[w]) : 0u;
  }
  // start at bit `entry` (>= 0) of the row
  __device__ void init(const uint32_t* r, int mw, int entry) {
    row = r;
    max_words = mw;
    next = entry >> 5;
    ahead = word(next);
    buf = 0;
    n = 0;
    fill();
    skip(entry & 31);
  }
  // at least 32 valid bits after the call (zeros past the row)
  __device__ __forceinline__ void fill() {
    if (n < 32) {
      buf |= (uint64_t)ahead << (32 - n);
      n += 32;
      ahead = word(++next);
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

// the `size` bits after a code of length `len` (len + size <= 31), as
// T.81 F.2.2.1's EXTEND gives them
__device__ __forceinline__ int amplitude(uint32_t peek, int len, int size) {
  if (size == 0) return 0;
  const int v = (int)((peek << len) >> (32 - size));
  return v < (1 << (size - 1)) ? v - ((1 << size) - 1) : v;
}

constexpr int kLutBits = 9;  // lookahead bits: codes up to 9 bits in one load
constexpr int kLutSize = 1 << kLutBits;
constexpr int kLanesPerCta = 4;          // lanes (warps) a CTA
constexpr int kSmemBudget = 200 * 1024;  // dynamic shared memory a CTA
constexpr int kFlushBlocks = 16;         // G's buffered blocks a lane
// a lane's shared memory: its canonical tables (bound, delta: 64 ints
// each; HUFFVAL: 256 words), its lookahead tables (4 x kLutSize uint16),
// for G its block buffer, then its row when staged
constexpr int kCanonWords = 64 + 64 + 256;
constexpr int kTablesBytes = kCanonWords * 4 + 4 * kLutSize * 2;
constexpr int kFlushBytes = kFlushBlocks * 64 * 4;
constexpr int kScanFixedBytes = kTablesBytes;
constexpr int kDecodeFixedBytes = kTablesBytes + kFlushBytes;
static_assert(kTablesBytes % 16 == 0, "lane regions stay 16-byte aligned");

// A lookahead entry (uint16; 0: not in the table, or no code matches):
// bits 0-4 the bits the step consumes (the code and its magnitude; with
// kBlockEnd also the EOB code after them), bits 12-15 the magnitude size;
// in an AC row bits 5-11 the slot advance (run + 1; 16 for ZRL; 64 for
// EOB), in a DC row bit 5 kBlockEnd (the block ends here: its DC and an EOB
// both fit the prefix) and bits 6-9 that EOB's code length.
constexpr unsigned kBlockEnd = 1u << 5;

// the slot advance of AC symbol `sym`
__device__ __forceinline__ unsigned ac_advance(int sym) {
  return sym == 0 ? 64u : sym == 0xF0 ? 16u : (unsigned)(sym >> 4) + 1u;
}

// the entry of symbol `sym` with a code of `len` bits in an AC or DC row
__device__ __forceinline__ unsigned make_entry(int len, int sym, bool ac) {
  const int size = sym & 15;
  return (unsigned)(len + size) | (unsigned)size << 12 |
         (ac ? ac_advance(sym) << 5 : 0u);
}

__device__ __forceinline__ int huffval(const uint32_t* hv, int v) {
  v = min(max(v, 0), 255);
  return (int)((hv[v >> 2] >> (8 * (v & 3))) & 0xFFu);
}

// One lane's tables in shared memory: the canonical rows (for the codes the
// lookahead misses) and the lookahead rows
struct LaneTables {
  const int* bound;     // [4][16]
  const int* delta;     // [4][16]
  const uint32_t* hv;   // [4][64]
  const uint16_t* lut;  // [4][kLutSize]
  unsigned aligned;     // bit t: row t's lookahead row is in use
  int period;
  int y_per_mcu;

  // The canonical decode of a 32-bit peek against row t from code length
  // l0 on (lengths below l0 known not to match): the symbol, and *len the
  // code length (17: no match)
  __device__ __forceinline__ int search(uint32_t peek, int t, int l0,
                                        int* len) const {
    const int p = (int)(peek >> 16);
    for (int l = l0; l <= 16; ++l) {
      if (p < bound[t * 16 + l - 1]) {
        *len = l;
        return huffval(hv + t * 64,
                       (p >> (16 - l)) + delta[t * 16 + l - 1]);
      }
    }
    *len = 17;
    return 0;
  }
  // the entry of row t for `peek` where the lookahead table has none: the
  // search's (from length 10 where the row is in use: no code of at most
  // 9 bits matches where its entry is 0); 0: no code matches
  __device__ __forceinline__ unsigned search_entry(uint32_t peek,
                                                   int t) const {
    int len;
    const int sym =
        search(peek, t, (aligned >> t & 1) ? kLutBits + 1 : 1, &len);
    return len > 16 ? 0u : make_entry(len, sym, t & 1);
  }
  // the lookahead table's entry of row t for `peek` (0: none)
  __device__ __forceinline__ unsigned lookup(uint32_t peek, int t) const {
    return lut[t * kLutSize + (peek >> (32 - kLutBits))];
  }
  // the entry of row t for `peek`; 0: no code matches
  __device__ __forceinline__ unsigned entry(uint32_t peek, int t) const {
    const unsigned e = lookup(peek, t);
    return e != 0 ? e : search_entry(peek, t);
  }
};

// The first code of at most 9 bits that the 16-bit peek p matches in row
// t (the canonical search cut at length 9): the symbol, *len (17: none)
__device__ __forceinline__ int prefix_symbol(const LaneTables& tb, int t,
                                             int p, int* len) {
  int l = 17;
#pragma unroll
  for (int k = kLutBits; k >= 1; --k)
    if (p < tb.bound[t * 16 + k - 1]) l = k;
  *len = l;
  if (l > kLutBits) return 0;
  return huffval(tb.hv + t * 64, (p >> (16 - l)) + tb.delta[t * 16 + l - 1]);
}

// The warp's set-up of lane s: the canonical tables to shared memory, the
// row too when kStaged, and the lookahead rows of the rows the lane's
// pattern uses.  An entry is the canonical search's answer for the 9-bit
// prefix padded with zeros, kept where its code fits the prefix; that
// answer holds for every peek with the prefix when each bound of a length
// l <= 9 is a multiple of 2^(16-l), as canonical tables' are (else the
// row's entries stay 0 and every code takes the full search).  A DC entry
// also takes the EOB after its code and magnitude where all of it fits the
// prefix, read from the AC row's entry (built first) for the bits after.
// Returns the lane's row (in shared or global memory).
template <bool kStaged>
__device__ const uint32_t* lane_setup(unsigned char* lane, int row_offset,
                                      const uint32_t* row, int max_words,
                                      const int* maxc, const int* delt,
                                      const uint32_t* hvp, int S,
                                      int period, int y_per_mcu, int j,
                                      LaneTables* out) {
  int* bound = (int*)lane;
  int* delta = bound + 64;
  uint32_t* hv = (uint32_t*)(delta + 64);
  uint16_t* lut = (uint16_t*)(hv + 256);
  for (int i = j; i < 64; i += 32) {
    bound[i] = __ldg(maxc + i * S);
    delta[i] = __ldg(delt + i * S);
  }
  for (int i = j; i < 256; i += 32) hv[i] = __ldg(hvp + i);
  if (kStaged) {
    uint32_t* r = (uint32_t*)(lane + row_offset);
    for (int w = j; w < max_words; w += 32) r[w] = __ldg(row + w);
    row = r;
  }
  __syncwarp();
  LaneTables tb{bound, delta, hv, lut, 0u, period, y_per_mcu};
  for (int t = 0; t < 4; ++t) {
    const bool odd = j < kLutBits &&
                     (bound[t * 16 + j] & ((1 << (15 - j)) - 1)) != 0;
    if (__ballot_sync(0xffffffffu, odd) == 0) tb.aligned |= 1u << t;
  }
  // the table rows of the pattern: luma (0, 1) where it has luma blocks,
  // chroma (2, 3) where it has chroma blocks
  const unsigned used = (y_per_mcu > 0 ? 3u : 0u) |
                        (y_per_mcu < period ? 12u : 0u);
  tb.aligned &= used;
  for (int t = 1; t < 4; t += 2) {
    if (!(used >> t & 1)) continue;
    const bool on = tb.aligned >> t & 1;
    for (int q = j; q < kLutSize; q += 32) {
      int len;
      const int sym = on ? prefix_symbol(tb, t, q << (16 - kLutBits), &len)
                         : 0;
      lut[t * kLutSize + q] =
          (uint16_t)(on && len <= kLutBits ? make_entry(len, sym, true) : 0u);
    }
  }
  __syncwarp();
  for (int t = 0; t < 4; t += 2) {
    if (!(used >> t & 1)) continue;
    const bool on = tb.aligned >> t & 1;
    for (int q = j; q < kLutSize; q += 32) {
      unsigned e = 0;
      int len;
      const int sym = on ? prefix_symbol(tb, t, q << (16 - kLutBits), &len)
                         : 0;
      if (on && len <= kLutBits) {
        e = make_entry(len, sym, false);
        const int u = (int)(e & 31);
        if (u < kLutBits) {  // an EOB code after it inside the prefix?
          const unsigned e2 =
              lut[(t + 1) * kLutSize + ((q << u) & (kLutSize - 1))];
          const int len2 = (int)(e2 & 31);
          if (e2 != 0 && (e2 >> 5 & 127) == 64 && u + len2 <= kLutBits)
            e = (unsigned)(u + len2) | kBlockEnd | (unsigned)len2 << 6 |
                (unsigned)(sym & 15) << 12;
        }
      }
      lut[t * kLutSize + q] = (uint16_t)e;
    }
  }
  __syncwarp();
  *out = tb;
  return row;
}

// -- G: decode_segments ----------------------------------------------------

// One thread walks blocks [b, bend) of its lane from the reader's position,
// MCU position *pos and DC predictors pred (luma, Cb, Cr), writing each
// block's nonzero terms into its row of `blocks` (zeroed).  The walk is
// pipelined by hand: as soon as a code is consumed, the lookup of the next
// one goes out, and the amplitude and store of the current one are done
// while it is in flight.
template <bool kLdg>
__device__ __forceinline__ void decode_blocks(BitReader<kLdg>& br,
                                              const LaneTables& tb, int b,
                                              int bend, int* pos, int* pred,
                                              int* blocks) {
  for (; b < bend; ++b, blocks += 64) {
    const bool luma = *pos < tb.y_per_mcu;
    const int dc_t = luma ? 0 : 2;
    const int comp = luma ? 0 : *pos - tb.y_per_mcu + 1;
    *pos = *pos + 1 == tb.period ? 0 : *pos + 1;
    br.fill();
    const uint32_t dpeek = br.peek();
    const unsigned d = tb.entry(dpeek, dc_t);
    if (d == 0) continue;  // no match: a zero block, no bits consumed
    br.skip((int)(d & 31));
    const bool ac = !(d & kBlockEnd);
    uint32_t peek = 0;
    unsigned e = 0;
    if (ac) {  // the first AC lookup goes out before the DC's own work
      br.fill();
      peek = br.peek();
      e = tb.lookup(peek, dc_t + 1);
    }
    const int size = (int)(d >> 12);
    // the predictors stay in registers: constant indices only
    const int dc = (comp == 0 ? pred[0] : comp == 1 ? pred[1] : pred[2]) +
                   amplitude(dpeek, (int)(d & 31) - size - (int)(d >> 6 & 15),
                             size);
    if (comp == 0) {
      pred[0] = dc;
    } else if (comp == 1) {
      pred[1] = dc;
    } else {
      pred[2] = dc;
    }
    blocks[0] = dc;
    if (!ac) continue;
    for (unsigned slot = 1; slot <= 63;) {
      if (e == 0) {
        e = tb.search_entry(peek, dc_t + 1);
        if (e == 0) break;  // no match: the block ends, the bits stay
      }
      const uint32_t p = peek;
      const unsigned cur = e;
      br.skip((int)(cur & 31));
      br.fill();
      peek = br.peek();
      e = tb.lookup(peek, dc_t + 1);  // the next code's, maybe unused
      const int sz = (int)(cur >> 12);
      const unsigned adv = cur >> 5 & 127, k = slot + adv - 1;
      if (sz != 0 && k <= 63) blocks[k] = amplitude(p, (int)(cur & 31) - sz, sz);
      slot += adv;
    }
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(32 * kLanesPerCta)
decode_segments_kernel(const uint32_t* __restrict__ streams,
                       const int* __restrict__ maxc,
                       const int* __restrict__ delt,
                       const uint32_t* __restrict__ hvp,
                       const int* __restrict__ nblk_lane,
                       const int* __restrict__ entry,
                       const int* __restrict__ phase,
                       int* __restrict__ zz, int S, int max_words,
                       int nblk_seg, int period, int y_per_mcu,
                       int lane_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, j = threadIdx.x & 31;
  const int s = blockIdx.x * (blockDim.x >> 5) + warp;
  if (s >= S) return;  // the whole warp: no CTA-wide barrier follows
  unsigned char* lane = smem + (size_t)warp * lane_bytes;
  LaneTables tb;
  const uint32_t* row = lane_setup<kStaged>(
      lane, kDecodeFixedBytes, streams + (size_t)s * max_words, max_words,
      maxc + s, delt + s, hvp + (size_t)s * 256, S, period, y_per_mcu, j,
      &tb);
  int4* buf = (int4*)(lane + kTablesBytes);
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int i = j; i < kFlushBlocks * 16; i += 32) buf[i] = zero;
  __syncwarp();
  const int nblk = min(__ldg(nblk_lane + s), nblk_seg);
  BitReader<!kStaged> br;  // thread 0's walk
  int pos = 0, pred[3] = {0, 0, 0};
  if (j == 0) {
    br.init(row, max_words, entry != nullptr ? __ldg(entry + s) : 0);
    pos = phase != nullptr ? __ldg(phase + s) % period : 0;
  }
  int4* out = (int4*)(zz + (size_t)s * nblk_seg * 64);
  int b0 = 0;
  for (; b0 < nblk; b0 += kFlushBlocks) {
    if (j == 0)
      decode_blocks(br, tb, b0, min(b0 + kFlushBlocks, nblk), &pos, pred,
                    (int*)buf);
    __syncwarp();
    const int n16 = min(kFlushBlocks, nblk_seg - b0) * 16;
    int4* dst = out + (size_t)b0 * 16;
    for (int i = j; i < n16; i += 32) {
      dst[i] = buf[i];
      buf[i] = zero;
    }
    __syncwarp();
  }
  for (size_t i = (size_t)b0 * 16 + j; i < (size_t)nblk_seg * 16; i += 32)
    out[i] = zero;
}

// -- H: scan_positions -----------------------------------------------------

// Walk blocks from bit `bp` at MCU position `pos` while a block starts
// before `end`, at most `max_blocks` of them: returns the blocks walked
// and leaves bp, pos at the exit.  A block whose DC or AC code matches
// nothing stops the walk uncounted, bp at its start, and sets *bad.
template <bool kLdg>
__device__ int walk_blocks(const uint32_t* row, int max_words,
                           const LaneTables& tb, int* bp, int* pos, int end,
                           int max_blocks, int* bad) {
  *bad = 0;
  if (max_blocks <= 0 || *bp >= end) return 0;
  BitReader<kLdg> br;
  br.init(row, max_words, *bp);
  int count = 0, cur = *bp;
  while (true) {
    const int dc_t = *pos < tb.y_per_mcu ? 0 : 2;
    br.fill();
    unsigned e = tb.entry(br.peek(), dc_t);
    if (e == 0) break;
    int used = (int)(e & 31);
    br.skip(used);
    if (!(e & kBlockEnd)) {
      for (unsigned slot = 1; slot <= 63;) {
        br.fill();
        e = tb.entry(br.peek(), dc_t + 1);
        if (e == 0) break;
        br.skip((int)(e & 31));
        used += (int)(e & 31);
        slot += e >> 5 & 127;
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

template <bool kStaged>
__global__ void __launch_bounds__(32 * kLanesPerCta)
scan_positions_kernel(const uint32_t* __restrict__ streams,
                      const int* __restrict__ maxc,
                      const int* __restrict__ delt,
                      const uint32_t* __restrict__ hvp,
                      const int* __restrict__ entry,
                      const int* __restrict__ limit,
                      const int* __restrict__ phase, int* __restrict__ out,
                      int S, int max_words, int steps, int period,
                      int y_per_mcu, int lane_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, j = threadIdx.x & 31;
  const int s = blockIdx.x * (blockDim.x >> 5) + warp;
  if (s >= S) return;  // the whole warp: no CTA-wide barrier follows
  LaneTables tb;
  const uint32_t* row = lane_setup<kStaged>(
      smem + (size_t)warp * lane_bytes, kScanFixedBytes,
      streams + (size_t)s * max_words, max_words, maxc + s, delt + s,
      hvp + (size_t)s * 256, S, period, y_per_mcu, j, &tb);
  if (j == 0) {
    int bp = __ldg(entry + s);
    int pos = phase != nullptr ? __ldg(phase + s) % period : 0, bad;
    const int count = walk_blocks<!kStaged>(row, max_words, tb, &bp, &pos,
                                            __ldg(limit + s), steps, &bad);
    out[s] = bp;
    out[S + s] = count;
    out[2 * S + s] = bad;
  }
}

// -- the layout both kernels share ------------------------------------------

struct LaneLayout {
  int lanes;       // lanes (warps) a CTA
  int staged;      // rows in shared memory (else read from global)
  int lane_bytes;  // shared memory a lane
};

// A lane's row is staged beside its `fixed_bytes` of tables and buffers
// while kLanesPerCta lanes, or fewer but at least one, fit the budget; a
// longer row stays in global memory.
LaneLayout lane_layout(int max_words, int fixed_bytes) {
  const long long row_bytes = ((long long)max_words * 4 + 15) & ~15LL;
  if (fixed_bytes + row_bytes > kSmemBudget)
    return {kLanesPerCta, 0, fixed_bytes};
  const int lane_bytes = (int)(fixed_bytes + row_bytes);
  return {kSmemBudget / lane_bytes < kLanesPerCta ? kSmemBudget / lane_bytes
                                                  : kLanesPerCta,
          1, lane_bytes};
}

// Launch a lane kernel (its staged or global instance) over S lanes in
// layout L; the kernel's last argument is the lane's bytes.
template <typename... P, typename... A>
int launch_lanes(void (*staged)(P...), void (*global)(P...),
                 const LaneLayout& L, int S, cudaStream_t st, A... args) {
  void (*kernel)(P...) = L.staged ? staged : global;
  const int smem = L.lane_bytes * L.lanes;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<(S + L.lanes - 1) / L.lanes, 32 * L.lanes, smem, st>>>(
      args..., L.lane_bytes);
  return (int)cudaGetLastError();
}

constexpr int kDecodeSegments = 0, kScanPositions = 1;

int fixed_bytes(int kernel) {
  return kernel == kDecodeSegments ? kDecodeFixedBytes : kScanFixedBytes;
}

}  // namespace

// The layout of kernel `kernel` (0: G, 1: H) for rows of max_words words:
// lanes a CTA x 2 + 1 if the rows are staged in shared memory
extern "C" int jt_lane_layout(int max_words, int kernel) {
  const LaneLayout L = lane_layout(max_words, fixed_bytes(kernel));
  return L.lanes * 2 + L.staged;
}

extern "C" int jt_decode_segments(const void* streams, const void* maxc,
                                  const void* delt, const void* hvp,
                                  const void* nblk_lane, const void* entry,
                                  const void* phase, void* zz, int S,
                                  int max_words, int nblk_seg, int period,
                                  int y_per_mcu, void* stream) {
  if (S == 0 || nblk_seg == 0) return (int)cudaGetLastError();
  return launch_lanes(
      decode_segments_kernel<true>, decode_segments_kernel<false>,
      lane_layout(max_words, fixed_bytes(kDecodeSegments)), S,
      (cudaStream_t)stream, (const uint32_t*)streams, (const int*)maxc,
      (const int*)delt, (const uint32_t*)hvp, (const int*)nblk_lane,
      (const int*)entry, (const int*)phase, (int*)zz, S, max_words, nblk_seg,
      period, y_per_mcu);
}

extern "C" int jt_scan_positions(const void* streams, const void* maxc,
                                 const void* delt, const void* hvp,
                                 const void* entry, const void* limit,
                                 const void* phase, void* out, int S,
                                 int max_words, int steps, int period,
                                 int y_per_mcu, void* stream) {
  if (S == 0) return (int)cudaGetLastError();
  return launch_lanes(
      scan_positions_kernel<true>, scan_positions_kernel<false>,
      lane_layout(max_words, fixed_bytes(kScanPositions)), S,
      (cudaStream_t)stream, (const uint32_t*)streams, (const int*)maxc,
      (const int*)delt, (const uint32_t*)hvp, (const int*)entry,
      (const int*)limit, (const int*)phase, (int*)out, S, max_words,
      steps < 0 ? 0 : steps, period, y_per_mcu);
}
