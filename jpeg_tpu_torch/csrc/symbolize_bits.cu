// Kernel B, symbolize_bits: coefficients -> Huffman fields + block bits.
//
// Replaces the DC chain of jpeg_tpu's kernels/fused.py::
// _dct_symbolize_chunk_v (the prev_ref carry across the sequential TPU
// grid), the run-length symbolization kernels/fused.py::_symbolize, and
// the combined-LUT attach _attach_chunk, i.e. the outputs of
// _dct_attach_kernel (value, nbits, bits) on the two-phase route and the
// middle of _mega_place_kernel.  Input is [S, nblk, 64] int16 zig-zag
// coefficients (S segments of one block pattern: the interleaved MCU, or a
// single-component scan of Y or of chroma, see block_slots.cuh); outputs
// are per-slot value uint32 and nbits uint8 [S, nblk, 64] and per-block
// bit counts int32 [S, nblk].  With a single-component pattern it also
// replaces the LUT attach of jpeg_tpu's 3-scan path, kernels/lut.py::attach
// (K14), whose slot fields it computes itself.
//
// The explicit entry jt_symbolize_bits_explicit takes each block's DC
// difference and luma flag (1, 0, or -1 for a padding block: NULL slots)
// from int32 [S, nblk] arrays, as jpeg_tpu's f64 fixed-table path hands
// them to kernels/fused.py::analyze_attach_pack_segments (K13:
// _symbolize_attach_kernel, then K4); with C and D after it, it replaces
// K13.  The coefficients' DC slot is ignored there.
//
// The fields contract (block_slots.cuh, store_fields): nbits and bits are
// written whole; value only in the 16-byte groups (slots 4g..4g+3 of a
// block) that hold a slot with non-zero nbits, the groups kernel D reads.
// The other groups keep what the buffer held.
//
// What bounds it on an H100: memory traffic.  The work is 2 bytes in and
// 1 byte of nbits out a slot, 16 bytes a group that holds a symbol (about
// 5 % of the slots are not NULL) and 4 bytes a block; the serial
// dependence of each slot on the last nonzero slot before it is a short
// scan.  Design: kernel E's skeleton (block_slots.cuh): a warp holds four
// blocks at a time, eight lanes a block and eight slots a lane in
// half-block pieces (two 8-byte loads), and loads its next four blocks
// before it symbolizes these; a block's DC predecessor comes from the
// warp's registers where it lies among the four, else from a load issued
// with the block; the second halves' slot logic runs only where a block of
// the warp has a symbol there; the slots it skips, and padding blocks,
// take the NULL entry held in a register (a shared-memory lookup for each
// of them made the compiler spill inside the loop, a far slower B).  The
// 1024-entry LUT sits in shared memory, loaded once per CTA of a grid of
// the device's resident CTAs (asked once a device).  Coefficients are
// loaded with a 256-byte L2 fetch hint (read once, 512 contiguous bytes a
// warp).  The output stage (store_fields) is kernel F's too.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_slots.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// kExplicit: DC differences and luma flags from dc_diff / is_luma; else
// from the block pattern layout.
template <bool kExplicit>
__global__ void __launch_bounds__(kThreads)
symbolize_bits_kernel(const int16_t* __restrict__ coef,
                      const int* __restrict__ dc_diff,
                      const int* __restrict__ is_luma,
                      const int* __restrict__ lut, uint32_t* __restrict__ value,
                      uint8_t* __restrict__ nbits, int* __restrict__ bits,
                      int nblk, int total, jt::McuLayout layout) {
  __shared__ __align__(16) int s_lut[1024];
  const int tid = threadIdx.x;
  for (int i = tid; i < 256; i += kThreads)
    reinterpret_cast<int4*>(s_lut)[i] =
        reinterpret_cast<const int4*>(lut)[i];
  __syncthreads();

  // the NULL entry, for the slots the vote skips and padding blocks (a
  // register, not a shared-memory load a slot)
  const int null_e = s_lut[jt::kNullIndex];
  const int lane = tid & 31, warp = tid >> 5;
  const int q = lane & 7, j = lane >> 3;  // eighth of the block, block
  const int groups = (total + 3) / 4;
  const int stride = gridDim.x * kWarps;
  int g = blockIdx.x * kWarps + warp;
  jt::LaneIn cur = jt::load_lane<kExplicit>(
      coef, dc_diff, is_luma, nullptr, 0, g * 4 + j, g < groups ? total : 0,
      nblk, q, layout);
  for (; g < groups; g += stride) {
    const int gn = g + stride;
    jt::LaneIn nxt = jt::load_lane<kExplicit>(
        coef, dc_diff, is_luma, nullptr, 0, gn * 4 + j,
        gn < groups ? total : 0, nblk, q, layout);
    int v[8];
    const int luma = jt::lane_values<kExplicit>(cur, lane, v);
    uint32_t val[8];
    int nb[8];
    jt::slots8(v, q, luma, [&](int i, int idx, int ex, int en) {
      jt::attach_field(idx == jt::kNullIndex ? null_e : s_lut[idx], ex, en,
                       &val[i], &nb[i]);
    });
    jt::store_fields(val, nb, cur.valid, g * 4 + j, q, value, nbits, bits);
    cur = nxt;
  }
}

template <bool kExplicit>
int launch(const void* coef, const void* dc_diff, const void* is_luma,
           const void* lut, void* value, void* nbits, void* bits,
           int n_segs, int nblk, jt::McuLayout layout, void* stream) {
  const long long total = (long long)n_segs * nblk;
  if (total >= (1LL << 31) - 4LL * kThreads * 65536)
    return (int)cudaErrorInvalidValue;  // block indices stay int32
  if (total == 0) return (int)cudaGetLastError();
  static int cached[jt::kMaxDevices];
  const long long need = ((total + 3) / 4 + kWarps - 1) / kWarps;
  const long long cap = jt::resident_ctas(
      cached, symbolize_bits_kernel<kExplicit>, kThreads);
  const int grid = (int)(need < cap ? need : cap);
  symbolize_bits_kernel<kExplicit>
      <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          (const int16_t*)coef, (const int*)dc_diff, (const int*)is_luma,
          (const int*)lut, (uint32_t*)value, (uint8_t*)nbits, (int*)bits,
          nblk, (int)total, layout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jt_symbolize_bits(const void* coef, const void* lut,
                                 void* value, void* nbits, void* bits,
                                 int n_segs, int nblk, int period,
                                 int y_per_mcu, void* stream) {
  const jt::McuLayout layout{period, y_per_mcu};
  if (!jt::layout_ok(layout) || nblk % period)
    return (int)cudaErrorInvalidValue;
  return launch<false>(coef, nullptr, nullptr, lut, value, nbits, bits,
                       n_segs, nblk, layout, stream);
}

extern "C" int jt_symbolize_bits_explicit(const void* coef,
                                          const void* dc_diff,
                                          const void* is_luma,
                                          const void* lut, void* value,
                                          void* nbits, void* bits, int n_segs,
                                          int nblk, void* stream) {
  return launch<true>(coef, dc_diff, is_luma, lut, value, nbits, bits,
                      n_segs, nblk, jt::McuLayout{1, 1}, stream);
}
