// Run-length symbolization of one 8x8 block by one warp, shared by kernel
// B (symbolize_bits.cu) and kernel E (symbolize_fields.cu).
//
// Ports jpeg_tpu's kernels/fused.py::_symbolize and the DC chain of
// _dct_symbolize_chunk_v: slot 0 carries the DC difference as (magnitude
// class, amplitude); a nonzero AC slot carries run << 4 | class and its
// amplitude; a zero slot that ends a run of 16 before a later nonzero is a
// ZRL (0xF0); the slot after the last nonzero AC is the EOB (0x00) unless
// that was slot 63.  Every other slot gets kNullIndex and no bits.  The
// combined-LUT index of a slot is sym | is_dc << 8 | is_luma << 9.
//
// Two layouts of a block over lanes.  block_slots / block_slots_explicit
// (kernel B): a warp a block, lane l holds slots 2l and 2l+1; the DC
// difference reads the previous same-component DC straight from the input
// by index (no carry crosses blocks); the "last nonzero AC before me" that
// drives runs, ZRL and EOB is one warp max-scan.  slots8_fields (kernel
// E): eight lanes a block, lane q of the eight holds slots 4q..4q+3 and
// 32+4q..32+4q+3 (so that each half of a block is 8 lanes' contiguous
// pieces), a warp four blocks; the max-scan runs over the block's eight
// lanes and then through each lane's slots; the caller supplies the DC
// difference.
//
// The explicit mode (block_slots_explicit) takes each block's DC
// difference and luma flag from arrays instead of deriving them from a
// McuLayout, as jpeg_tpu's _symbolize does with its dcd and isl inputs
// (kernels/fused.py:187-240): is_luma is 1 for luma, 0 for chroma and -1
// for a padding block, whose every slot is NULL, DC included.
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

// The (idx, extra, extra_n) fields of a lane's two slots.
struct SlotPair {
  int idx0, ex0, en0, idx1, ex1, en1;
};

// The fields of a lane's two slots from their values: v0 (slot 2*lane;
// lane 0 holds the DC difference) and v1 (slot 2*lane + 1) of a block
// whose luma flag is luma.  All 32 lanes of the warp must call it together.
__device__ __forceinline__ SlotPair slots_of(int v0, int v1, int lane,
                                             int luma) {
  const unsigned full = 0xffffffffu;
  const int k0 = 2 * lane, k1 = k0 + 1;
  const int nz0 = lane > 0 && v0 != 0;
  const int nz1 = v1 != 0;
  // inclusive max-scan of "last nonzero AC slot" over the lanes
  int incl = nz1 ? k1 : (nz0 ? k0 : 0);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(full, incl, off);
    if (lane >= off) incl = max(incl, o);
  }
  int excl = __shfl_up_sync(full, incl, 1);
  if (lane == 0) excl = 0;
  const int last = __shfl_sync(full, incl, 31);
  const int prev1 = nz0 ? k0 : excl;

  SlotPair s;
  slot_fields(k0, v0, excl, last, luma, &s.idx0, &s.ex0, &s.en0);
  slot_fields(k1, v1, prev1, last, luma, &s.idx1, &s.ex1, &s.en1);
  return s;
}

// Symbolize block gb of [*, 64] int16 zig-zag coefficients; b is its index
// within its segment (the DC chains restart at b = 0), l the segment's
// block pattern.  All 32 lanes of the warp must call it together.
__device__ __forceinline__ SlotPair block_slots(const int16_t* coef,
                                                long long gb, int b,
                                                int lane, McuLayout l) {
  const int pos = b % l.period;
  const int luma = pos < l.y_per_mcu;
  const uint32_t pair =
      reinterpret_cast<const uint32_t*>(coef + gb * 64)[lane];
  int v0 = (int)(int16_t)(pair & 0xffffu);   // slot 2*lane
  const int v1 = (int)(int16_t)(pair >> 16); // slot 2*lane + 1
  if (lane == 0) {
    // previous same-component DC: the last Y of the previous MCU for its
    // first Y block, the previous Y inside an MCU, one MCU back for chroma
    const int d = pos < l.y_per_mcu
                      ? (pos == 0 ? l.period - l.y_per_mcu + 1 : 1)
                      : l.period;
    const int prev_dc = b >= d ? (int)coef[(gb - d) * 64] : 0;
    v0 -= prev_dc;
  }
  return slots_of(v0, v1, lane, luma);
}

// The explicit mode: block gb's DC difference is dc_diff[gb] (its DC slot
// in coef is ignored) and its luma flag is_luma[gb].  A padding block
// (flag -1) gives NULL slots; the flag is the same for the whole warp, so
// the early return keeps the warp together.
__device__ __forceinline__ SlotPair block_slots_explicit(
    const int16_t* coef, const int* dc_diff, const int* is_luma,
    long long gb, int lane) {
  const int flag = is_luma[gb];
  if (flag < 0) return SlotPair{kNullIndex, 0, 0, kNullIndex, 0, 0};
  const uint32_t pair =
      reinterpret_cast<const uint32_t*>(coef + gb * 64)[lane];
  const int v0 = lane == 0 ? dc_diff[gb] : (int)(int16_t)(pair & 0xffffu);
  const int v1 = (int)(int16_t)(pair >> 16);
  return slots_of(v0, v1, lane, flag == 1);
}

// The slot of a block that lane q of its eight lanes holds as its i-th
// (slots8_fields): 4q..4q+3, then 32+4q..32+4q+3, so that the eight lanes'
// first (second) four slots are the block's first (second) 32 in order.
__device__ __forceinline__ int slot8(int q, int i) {
  return (i < 4 ? 0 : 28) + 4 * q + i;
}

// The packed fields (idx | extra_n << 10 | extra << 14) of one lane's
// eight slots slot8(q, 0..7) of a block whose eight lanes are the aligned
// lanes 8 * (lane / 8) .. + 7; v holds the slots' values, slot 0's
// already the DC difference.  The last nonzero AC slot before each slot
// comes from one max-scan over the eight lanes of both halves at once
// (halfwords of one word).  All 32 lanes of the warp must call it
// together; where no block of the warp has a symbol past slot 31, the
// second halves' slots are NULL without their slot logic.
__device__ __forceinline__ void slots8_fields(const int (&v)[8], int q,
                                              int luma, int (&pf)[8]) {
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
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = slot8(q, i);
    int& p = prev[i >> 2];
    if ((i >> 2) < halves) {
      int idx, ex, en;
      slot_fields(k, v[i], p, last, luma, &idx, &ex, &en);
      pf[i] = idx | (en << 10) | (ex << 14);
      if (k > 0 && v[i] != 0) p = k;
    } else {
      pf[i] = kNullIndex;
    }
  }
}

}  // namespace jt
