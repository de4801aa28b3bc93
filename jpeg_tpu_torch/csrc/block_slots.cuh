// Run-length symbolization of 8x8 blocks, four a warp, shared by kernel B
// (symbolize_bits.cu) and kernel E (symbolize_fields.cu), and the output
// stage of the Huffman fields, shared by kernel B and kernel F
// (attach_pf.cu).
//
// Ports jpeg_tpu's kernels/fused.py::_symbolize and the DC chain of
// _dct_symbolize_chunk_v: slot 0 carries the DC difference as (magnitude
// class, amplitude); a nonzero AC slot carries run << 4 | class and its
// amplitude; a zero slot that ends a run of 16 before a later nonzero is a
// ZRL (0xF0); the slot after the last nonzero AC is the EOB (0x00) unless
// that was slot 63.  Every other slot gets kNullIndex and no bits.  The
// combined-LUT index of a slot is sym | is_dc << 8 | is_luma << 9.
//
// The layout of a block over lanes: eight lanes a block, a warp four
// consecutive blocks (a group); lane q of the eight holds slots 4q..4q+3
// and 32+4q..32+4q+3 (slot8), so that each half of a block is 8 lanes'
// contiguous pieces and every load or store instruction covers whole half
// blocks.  load_lane issues a lane's loads (two 8-byte coefficient loads,
// and the DC predecessor where it lies outside the group); lane_values
// forms its eight values, the DC difference taken from the warp's
// registers by a shuffle where the predecessor lies in the group;
// slots8 runs the slot logic: the "last nonzero AC before me" that drives
// runs, ZRL and EOB is one max-scan over the block's eight lanes (both
// halves at once, halfwords of one word), and where no block of the warp
// reaches slot 31 the second halves are NULL without their slot logic (a
// warp vote: most blocks end early).
//
// The explicit mode takes each block's DC difference and luma flag from
// arrays instead of deriving them from a McuLayout, as jpeg_tpu's
// _symbolize does with its dcd and isl inputs (kernels/fused.py:187-240):
// is_luma is 1 for luma, 0 for chroma and -1 for a padding block, whose
// every slot is NULL, DC included.
//
// The fields contract of kernels B and F (store_fields): value uint32 and
// nbits uint8 [S, nblk, 64], bits int32 [S, nblk].  nbits and bits are
// written whole; value is written in every 16-byte group (slots 4g..4g+3
// of a block) that holds a slot with non-zero nbits, and nowhere else.
// Kernel D, the one reader of value, loads a group only where one of its
// nbits is non-zero, so the other groups (most of them: NULL slots) need
// not be written.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace jt {

// The block pattern of a segment: period blocks repeat, and the first
// y_per_mcu of them are luma; each component's DC chain runs through its
// own blocks in segment order.  Interleaved 4:2:0 is (6, 4): Y00 Y01 Y10
// Y11 Cb Cr; 4:2:2 is (4, 2) and 4:4:4 (3, 1).  A single-component
// (non-interleaved) scan is (1, 1) for Y and (1, 0) for Cb or Cr: every
// block has the segment's luma flag and its DC predecessor is block b - 1.
struct McuLayout {
  int period;
  int y_per_mcu;
};

__host__ __device__ inline bool layout_ok(McuLayout l) {
  return l.period >= 1 && l.period <= 6 && l.y_per_mcu >= 0 &&
         l.y_per_mcu <= l.period;
}

constexpr int kNullIndex = 1023;

__device__ __forceinline__ int bit_length(int a) { return 32 - __clz(a); }

// One slot's LUT index and amplitude field for the symbol at slot kslot
// with (DC-differenced) value v; prev = last nonzero AC slot before it
// (0 if none), last = last nonzero AC slot of the block (0 if none).
// amp is non-negative (v + 2^cls - 1 for v < 0), so it packs without sign.
__device__ __forceinline__ void slot_fields(int kslot, int v, int prev,
                                            int last, int luma, int* idx,
                                            int* extra, int* extra_n) {
  const int a = v < 0 ? -v : v;
  const int cls = bit_length(a);
  const int amp = v < 0 ? v + (1 << cls) - 1 : v;
  int sym = 0, valid = 0, ex = 0, en = 0, dc = 0;
  if (kslot == 0) {
    sym = cls; ex = amp; en = cls; valid = 1; dc = 1;
  } else if (v != 0) {
    sym = (((kslot - prev - 1) & 15) << 4) | cls; ex = amp; en = cls;
    valid = 1;
  } else if (kslot < last && ((kslot - prev) & 15) == 0) {
    sym = 0xF0; valid = 1;            // ZRL
  } else if (kslot == last + 1) {
    sym = 0x00; valid = 1;            // EOB (kslot <= 63, so last < 63)
  }
  *idx = valid ? (sym | (dc << 8) | (luma << 9)) : kNullIndex;
  *extra = valid ? ex : 0;
  *extra_n = valid ? en : 0;
}

// The slot of a block that lane q of its eight lanes holds as its i-th:
// 4q..4q+3, then 32+4q..32+4q+3, so that the eight lanes' first (second)
// four slots are the block's first (second) 32 in order.
__device__ __forceinline__ int slot8(int q, int i) {
  return (i < 4 ? 0 : 28) + 4 * q + i;
}

// One lane's inputs for its block of a group of four.
struct LaneIn {
  uint2 lo, hi;  // its slots (slot8): 4q..4q+3, 32+4q..32+4q+3
  int prev_dc;   // the previous same-component DC, where loaded
  int dcd;       // explicit: the DC difference
  int luma;      // luma flag (explicit: -1 for padding)
  int d;         // distance to the DC predecessor (0: none)
  bool valid;    // the block exists
  bool keep;     // its slots are counted (kernel E's mask)
};

// An 8-byte load that asks the L2 for the whole 256 bytes around it: a
// warp's four blocks are 512 contiguous bytes of coefficients, read once.
__device__ __forceinline__ uint2 load_l2_256(const uint2* p) {
  uint2 r;
  asm("ld.global.L2::256B.v2.u32 {%0, %1}, [%2];"
      : "=r"(r.x), "=r"(r.y)
      : "l"(p));
  return r;
}

// Lane q's loads for block k (of per_image blocks from base; k = 4 * group
// + j for the warp's j-th block) of [*, 64] int16 zig-zag coefficients in
// segments of nblk blocks of the pattern l; mask (E's, or nullptr) marks
// the blocks whose slots are counted.  A k past per_image gives an
// invalid block of zeros.
template <bool kExplicit>
__device__ __forceinline__ LaneIn load_lane(
    const int16_t* __restrict__ coef, const int* __restrict__ dc_diff,
    const int* __restrict__ is_luma, const uint8_t* __restrict__ mask,
    long long base, int k, int per_image, int nblk, int q, McuLayout l) {
  LaneIn in{make_uint2(0, 0), make_uint2(0, 0), 0, 0, 0, 0, false, false};
  if (k >= per_image) return in;
  const long long gb = base + k;
  in.valid = true;
  const uint2* c = reinterpret_cast<const uint2*>(coef + gb * 64);
  in.lo = load_l2_256(c + q);
  in.hi = load_l2_256(c + 8 + q);
  if (kExplicit) {
    if (q == 0) {  // lane q == 0 hands the flag to the block's lanes
      in.luma = is_luma[gb];
      in.dcd = dc_diff[gb];
    }
  } else {
    // the previous same-component DC: the last Y of the previous MCU for
    // its first Y block, the previous Y inside an MCU, one MCU back for
    // chroma; none at the segment's start
    const int b = k % nblk;
    const int pos = b % l.period;
    in.luma = pos < l.y_per_mcu;
    const int d = in.luma ? (pos == 0 ? l.period - l.y_per_mcu + 1 : 1)
                          : l.period;
    in.d = b >= d ? d : 0;
    // outside the warp's four blocks: load it now, with the block
    if (q == 0 && in.d > (k & 3)) in.prev_dc = coef[(gb - d) * 64];
    in.keep = mask == nullptr || mask[k];
  }
  return in;
}

// A lane's eight values (slot8 order) from its loads, slot 0's the DC
// difference: the explicit mode's, or the DC minus its predecessor's,
// from the warp's registers (the predecessor's lane 0) where the warp
// holds it.  Returns the block's luma flag (explicit: -1 for padding,
// handed from the block's lane q == 0; then in.keep is also set).  All 32
// lanes of the warp must call it together.
template <bool kExplicit>
__device__ __forceinline__ int lane_values(LaneIn& in, int lane,
                                           int (&v)[8]) {
  const unsigned full = 0xffffffffu;
  const int q = lane & 7, j = lane >> 3;
  v[0] = (int16_t)(in.lo.x & 0xffffu); v[1] = (int16_t)(in.lo.x >> 16);
  v[2] = (int16_t)(in.lo.y & 0xffffu); v[3] = (int16_t)(in.lo.y >> 16);
  v[4] = (int16_t)(in.hi.x & 0xffffu); v[5] = (int16_t)(in.hi.x >> 16);
  v[6] = (int16_t)(in.hi.y & 0xffffu); v[7] = (int16_t)(in.hi.y >> 16);
  if (kExplicit) {
    if (q == 0) v[0] = in.dcd;
    in.luma = __shfl_sync(full, in.luma, lane & ~7);
    in.keep = in.valid && in.luma >= 0;
  } else {
    const int held = __shfl_sync(full, v[0], (lane - 8 * in.d) & 31);
    if (q == 0 && in.d) v[0] -= in.d <= j ? held : in.prev_dc;
  }
  return in.luma;
}

// The fields of lane q's eight slots slot8(q, 0..7) of a block whose
// eight lanes are the aligned lanes 8 * (lane / 8) .. + 7, handed to
// emit(i, idx, extra, extra_n) for i = 0..7; v holds the slots' values,
// slot 0's already the DC difference; luma is the block's flag (-1: a
// padding block, every slot NULL).  The last nonzero AC slot before each
// slot comes from one max-scan over the eight lanes of both halves at
// once (halfwords of one word).  All 32 lanes of the warp must call it
// together; where no block of the warp has a symbol past slot 31, the
// second halves' slots are NULL without their slot logic.
template <typename Emit>
__device__ __forceinline__ void slots8(const int (&v)[8], int q, int luma,
                                       Emit&& emit) {
  const unsigned full = 0xffffffffu;
  unsigned lo = 0, hi = 0;  // last nonzero AC slot of each half here
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (slot8(q, i) > 0 && v[i] != 0) lo = slot8(q, i);
    if (v[i + 4] != 0) hi = slot8(q, i + 4);
  }
  unsigned incl = lo | (hi << 16);
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    const unsigned o = __shfl_up_sync(full, incl, off, 8);
    if (q >= off) incl = __vmaxu2(incl, o);
  }
  unsigned excl = __shfl_up_sync(full, incl, 1, 8);
  if (q == 0) excl = 0;
  const unsigned tot = __shfl_sync(full, incl, 7, 8);
  const int tot_lo = (int)(tot & 0xffffu);
  const int last = max(tot_lo, (int)(tot >> 16));
  int prev[2] = {(int)(excl & 0xffffu),
                 max(tot_lo, (int)(excl >> 16))};
  // the second half holds a symbol only where a nonzero AC or the EOB
  // lies there: skip its slot logic where none of the warp's blocks has one
  const int halves = __any_sync(full, last >= 31) ? 2 : 1;
  const bool pad = luma < 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = slot8(q, i);
    int& p = prev[i >> 2];
    if ((i >> 2) < halves && !pad) {
      int idx, ex, en;
      slot_fields(k, v[i], p, last, luma, &idx, &ex, &en);
      emit(i, idx, ex, en);
      if (k > 0 && v[i] != 0) p = k;
    } else {
      emit(i, kNullIndex, 0, 0);
    }
  }
}

// A slot's Huffman field from its LUT entry e (code | length << 16) and
// amplitude field: the code, then extra_n amplitude bits, right-aligned.
__device__ __forceinline__ void attach_field(int e, int extra, int extra_n,
                                             uint32_t* val, int* nb) {
  *nb = (e >> 16) + extra_n;
  *val = ((uint32_t)(e & 0xffff) << extra_n) | (uint32_t)extra;
}

// The output stage of kernels B and F: lane q's eight fields (slot8
// order) of block gb, valid if the block exists.  The lane's nbits go out
// as two 4-byte stores (a half block's eight lanes fill one 32-byte
// sector); its values as one 16-byte streaming store a half, only where
// one of that group's four nbits is non-zero (read once, by kernel D,
// which reads no other group); the block's bits, an 8-lane shuffle sum,
// by its q == 0 lane.  value must lie on a 16-byte boundary and nbits on
// a 4-byte one.  All 32 lanes of the warp must call it together.
__device__ __forceinline__ void store_fields(
    const uint32_t (&val)[8], const int (&nb)[8], bool valid, long long gb,
    int q, uint32_t* __restrict__ value, uint8_t* __restrict__ nbits,
    int* __restrict__ bits) {
  const unsigned full = 0xffffffffu;
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) sum += nb[i];
  sum += __shfl_xor_sync(full, sum, 1, 8);
  sum += __shfl_xor_sync(full, sum, 2, 8);
  sum += __shfl_xor_sync(full, sum, 4, 8);
  if (!valid) return;
  uint32_t n[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    n[h] = (uint32_t)(nb[4 * h] & 0xff) |
           (uint32_t)(nb[4 * h + 1] & 0xff) << 8 |
           (uint32_t)(nb[4 * h + 2] & 0xff) << 16 |
           (uint32_t)(nb[4 * h + 3] & 0xff) << 24;
  uint32_t* nw = reinterpret_cast<uint32_t*>(nbits + gb * 64);
  nw[q] = n[0];
  nw[8 + q] = n[1];
  uint4* vw = reinterpret_cast<uint4*>(value + gb * 64);
  if (n[0]) __stcs(vw + q, make_uint4(val[0], val[1], val[2], val[3]));
  if (n[1]) __stcs(vw + 8 + q, make_uint4(val[4], val[5], val[6], val[7]));
  if (q == 0) bits[gb] = sum;
}

constexpr int kMaxDevices = 64;

// CTAs of a kernel resident on the current device at once (SMs times CTAs
// an SM at `threads` threads and no dynamic shared memory), asked once a
// device; each caller passes its own cache (one per kernel).
template <typename Kernel>
int resident_ctas(int (&cached)[kMaxDevices], Kernel kernel, int threads) {
  int dev = 0;
  cudaGetDevice(&dev);
  const int slot = dev >= 0 && dev < kMaxDevices ? dev : 0;
  if (cached[slot] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  0);
    cached[slot] = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return cached[slot];
}

}  // namespace jt
