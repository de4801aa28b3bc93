// Host runtime of jpeg_tpu_torch: scan finalization, file assembly and
// the Annex K.2 Huffman builder, with C linkage for ctypes.
//
// The port's own copy of the parts of jpeg_tpu's native/jpeg_tpu_host.cpp
// that the port uses (jt_finish_scan(s), jt_assemble_interleaved,
// jt_build_huff_tables, the baseline scan decoder jt_decode_scan(_mt), and
// the progressive encode's AC refinement coder jt_ac_refine_fields);
// outputs equal the original's byte for byte (tests/test_torch_host.py).
//
// The device produces each entropy segment as big-endian-packed u32 words
// plus a bit count.  Finalization serializes the bytes, stuffs a 0x00
// after every 0xFF data byte and pads the tail byte with 1-bits (a bare
// 0xFF when the stream ends on a byte boundary).  No Python.h dependency.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Worst-case output size for a scan of total_bits (callers size buffers):
// every full byte could be 0xFF (stuffed) + tail byte + its stuffing.
int64_t jt_finish_scan_max_out(int64_t total_bits) {
  return 2 * (total_bits / 8) + 2;
}

// words:      big-endian-packed stream, words[i] holds bits [32i, 32i+32)
//             with bit 32i at the MSB.  Length must cover total_bits plus
//             the partial tail word.
// total_bits: payload length in bits.
// out:        receives the stuffed scan payload; must hold at least
//             jt_finish_scan_max_out(total_bits) bytes.
// returns     bytes written.
int64_t jt_finish_scan(const uint32_t* words, int64_t total_bits,
                       uint8_t* out) {
  const int64_t nfull = total_bits / 8;
  const int rem = static_cast<int>(total_bits % 8);
  int64_t o = 0;
  for (int64_t i = 0; i < nfull; ++i) {
    const uint32_t w = words[i >> 2];
    const uint8_t b = static_cast<uint8_t>(w >> (8 * (3 - (i & 3))));
    out[o++] = b;
    if (b == 0xFF) out[o++] = 0x00;
  }
  if (rem) {
    const uint32_t w = words[nfull >> 2];
    const uint8_t b = static_cast<uint8_t>(w >> (8 * (3 - (nfull & 3))));
    const uint8_t tail = static_cast<uint8_t>(b | ((1u << (8 - rem)) - 1u));
    out[o++] = tail;
    // T.81 B.1.1.5: a data-carrying 0xFF must be stuffed.  The reference
    // omits this (fill_last_byte, main/encoder.c:425-432) — a spec defect
    // we deliberately fix (divergence documented in PARITY.md).
    if (tail == 0xFF) out[o++] = 0x00;
  } else {
    // pure ones-pad with no data bits: a legal fill byte before the next
    // marker, matching the reference byte-for-byte
    out[o++] = 0xFF;
  }
  return o;
}

// Batch variant: S segments laid out contiguously, each with stride_words
// u32 words and its own bit count.  Offsets[i] receives the start of
// segment i's payload in out; returns total bytes written.
int64_t jt_finish_scans(const uint32_t* words, int64_t stride_words,
                        const int32_t* total_bits, int64_t n_segments,
                        uint8_t* out, int64_t* offsets) {
  int64_t o = 0;
  for (int64_t s = 0; s < n_segments; ++s) {
    offsets[s] = o;
    o += jt_finish_scan(words + s * stride_words, total_bits[s], out + o);
  }
  return o;
}

// ---------------------------------------------------------------------------
// Annex K.2 Huffman table construction (the reference's init_huff_table,
// main/encoder.c:180-301).  Identical outputs to the Python builder in
// huffman/build.py; this native version exists because the tree derivation is a
// serial O(n^2) walk that costs ~6 ms per table in Python — the dominant
// host cost of dynamic-Huffman batch encoding (per-image tables, 4 builds
// per image).
//
// freqs:   [n_tables, 257] int64, freq[256] == 1 (reserved code point).
// bits:    [n_tables, 17]  int32 out (DHT BITS list, bits[0] unused).
// huffval: [n_tables, 256] int32 out (symbols in code order; valid count
//          is sum(bits[1..16]); the tail is left as-is).
// code:    [n_tables, 256] int32 out (-1 where absent).
// length:  [n_tables, 256] int32 out (0 where absent).
// Returns 0 on success; 1 if any table's histogram is empty; 2 on code
// length overflow (>= 32 bits, the K.2 limiter's assumption).

static int build_one_huff_table(const int64_t* freq_in, int32_t* bits,
                                int32_t* huffval, int32_t* code,
                                int32_t* length) {
  int64_t freq[257];
  int64_t code_len[257];
  int next[257];
  for (int i = 0; i < 257; ++i) {
    freq[i] = freq_in[i];
    code_len[i] = 0;
    next[i] = -1;
  }
  {
    int64_t total = 0;
    for (int i = 0; i < 256; ++i) total += freq[i];
    if (total == 0) return 1;
  }

  // Pairwise merge with the reference's exact tie-breaking: ascending
  // scan, <= comparisons (largest index among equal minima wins).  The
  // scan walks only the ACTIVE (nonzero) symbols, kept in ascending
  // index order, so the comparison sequence is identical to the full
  // 257-entry scan — most real histograms have ~100 live symbols, which
  // cuts the O(n^2) merge cost ~4x.
  int act[257];
  int na = 0;
  for (int i = 0; i < 257; ++i)
    if (freq[i]) act[na++] = i;
  for (;;) {
    int p1 = -1, p2 = -1;  // positions within act[]
    for (int k = 0; k < na; ++k) {
      int i = act[k];
      if (p1 == -1 || freq[i] <= freq[act[p1]]) {
        p2 = p1;
        p1 = k;
      } else if (p2 == -1 || freq[i] <= freq[act[p2]]) {
        p2 = k;
      }
    }
    if (p2 == -1) break;
    int v1 = act[p1], v2 = act[p2];

    freq[v1] += freq[v2];
    freq[v2] = 0;
    memmove(act + p2, act + p2 + 1, (size_t)(na - 1 - p2) * sizeof(int));
    --na;
    int w = v1;
    for (;;) {
      code_len[w] += 1;
      if (next[w] == -1) break;
      w = next[w];
    }
    next[w] = v2;
    w = v2;
    for (;;) {
      code_len[w] += 1;
      if (next[w] == -1) break;
      w = next[w];
    }
  }

  int64_t clf[32];
  for (int i = 0; i < 32; ++i) clf[i] = 0;
  for (int i = 0; i < 257; ++i) {
    if (code_len[i] >= 32) return 2;
    if (code_len[i]) clf[code_len[i]] += 1;
  }

  // 16-bit limiting by leaf lifting (main/encoder.c:239-259); the final
  // step drops the reserved symbol 256's deepest leaf.
  {
    int i = 31;
    for (;;) {
      if (clf[i] > 0) {
        int j = i - 2;
        while (clf[j] <= 0) --j;
        clf[i] -= 2;
        clf[i - 1] += 1;
        clf[j + 1] += 2;
        clf[j] -= 1;
        continue;
      }
      --i;
      if (i != 16) continue;
      while (clf[i] == 0) --i;
      clf[i] -= 1;
      break;
    }
  }

  // Real symbols sorted by (pre-limit length, index); 256 excluded.
  int sym_sorted[256];
  int n_sorted = 0;
  for (int len = 1; len < 32; ++len)
    for (int s = 0; s < 256; ++s)
      if (code_len[s] == len) sym_sorted[n_sorted++] = s;

  for (int s = 0; s < 256; ++s) {
    code[s] = -1;
    length[s] = 0;
  }
  {
    int k = 0;
    for (int len = 1; len <= 16; ++len)
      for (int64_t c = 0; c < clf[len]; ++c) length[sym_sorted[k++]] = len;
    if (k != n_sorted) return 2;
  }

  // Canonical code assignment (main/encoder.c:279-300).
  {
    int32_t c = 0;
    int prev_len = -1;
    for (int k = 0; k < n_sorted; ++k) {
      int s = sym_sorted[k];
      int len = length[s];
      if (prev_len == -1) prev_len = len;
      c <<= (len - prev_len);
      prev_len = len;
      code[s] = c;
      c += 1;
    }
  }

  for (int i = 0; i < 17; ++i) bits[i] = (i >= 1) ? (int32_t)clf[i] : 0;
  for (int k = 0; k < n_sorted; ++k) huffval[k] = sym_sorted[k];
  for (int k = n_sorted; k < 256; ++k) huffval[k] = 0;
  return 0;
}

// Full-file assembly for interleaved restart-delimited scans: header
// bytes + finalized segments with RSTn markers interposed + EOI, one
// complete JPEG per image, emitted in a single native call over the
// batch (the last per-image Python work in batch encoding).  Marker
// semantics match bitstream/jfif.py::assemble_interleaved (RST counter
// 0xD0 + (i-1) % 8 before segment i, T.81 B.2.1.2); header bytes are
// caller-provided and must run through the SOS header inclusive.
//
// words:       [n_images * n_segs, stride_words] big-endian-packed u32.
// totals:      [n_images * n_segs] bit counts.
// headers:     concatenated per-image header bytes (SOI..SOS header).
// header_offs: [n_images + 1] offsets into headers.
// out:         n_images * out_stride bytes; image i writes at
//              i * out_stride.  out_stride must cover the worst case:
//              header + sum(jt_finish_scan_max_out(bits)) + 2 * n_segs.
// out_lens:    [n_images] receives each file's byte length.
// Threads over images (independent outputs, fixed strides).
int64_t jt_assemble_interleaved(const uint32_t* words, int64_t stride_words,
                                const int32_t* totals, int64_t n_images,
                                int64_t n_segs, const uint8_t* headers,
                                const int64_t* header_offs, uint8_t* out,
                                int64_t out_stride, int64_t* out_lens,
                                int64_t n_threads) {
  auto one = [&](int64_t i) {
    uint8_t* dst = out + i * out_stride;
    int64_t o = header_offs[i + 1] - header_offs[i];
    std::memcpy(dst, headers + header_offs[i], (size_t)o);
    for (int64_t s = 0; s < n_segs; ++s) {
      if (s) {
        dst[o++] = 0xFF;
        dst[o++] = (uint8_t)(0xD0 + ((s - 1) & 7));
      }
      const int64_t seg = i * n_segs + s;
      o += jt_finish_scan(words + seg * stride_words, totals[seg], dst + o);
    }
    dst[o++] = 0xFF;  // EOI
    dst[o++] = 0xD9;
    out_lens[i] = o;
  };
  int nt = (int)(n_threads < n_images ? n_threads : n_images);
  if (nt <= 1) {
    for (int64_t i = 0; i < n_images; ++i) one(i);
    return 0;
  }
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int t = 0; t < nt; ++t)
    workers.emplace_back([&, t]() {
      for (int64_t i = t; i < n_images; i += nt) one(i);
    });
  for (auto& w : workers) w.join();
  return 0;
}

int64_t jt_build_huff_tables(const int64_t* freqs, int64_t n_tables,
                             int32_t* bits, int32_t* huffval, int32_t* code,
                             int32_t* length) {
  // Tables are independent: build in parallel (round-robin over
  // hardware threads), reporting the lowest-index failure so error
  // codes are deterministic.
  int hw = (int)std::thread::hardware_concurrency();
  int nt = hw > 1 ? (int)(n_tables < hw ? n_tables : hw) : 1;
  if (nt <= 1 || n_tables < 4) {
    for (int64_t t = 0; t < n_tables; ++t) {
      int rc = build_one_huff_table(freqs + t * 257, bits + t * 17,
                                    huffval + t * 256, code + t * 256,
                                    length + t * 256);
      if (rc) return rc;
    }
    return 0;
  }
  std::vector<int64_t> first_bad(nt, -1);
  std::vector<int> bad_rc(nt, 0);
  std::vector<std::thread> workers;
  for (int w = 0; w < nt; ++w) {
    workers.emplace_back([&, w]() {
      for (int64_t t = w; t < n_tables; t += nt) {
        int rc = build_one_huff_table(freqs + t * 257, bits + t * 17,
                                      huffval + t * 256, code + t * 256,
                                      length + t * 256);
        if (rc && (first_bad[w] == -1 || t < first_bad[w])) {
          first_bad[w] = t;
          bad_rc[w] = rc;
        }
      }
    });
  }
  for (auto& th : workers) th.join();
  int64_t bad = -1;
  int rc = 0;
  for (int w = 0; w < nt; ++w) {
    if (first_bad[w] != -1 && (bad == -1 || first_bad[w] < bad)) {
      bad = first_bad[w];
      rc = bad_rc[w];
    }
  }
  return rc;
}


// ---------------------------------------------------------------------------
// Baseline entropy decode: the host-serial Huffman bit-walk, natively.
//
// The port's baseline scan path: golden/decoder.py::_decode_scan, which is
// the host entropy route of pipelines/decode.py and, in chip_smoke.py, the
// full-size oracle of the device decoder.  This decodes one baseline scan
// into zig-zag
// coefficient blocks in SCAN EMISSION ORDER; the Python caller (which
// still parses markers) reorders blocks into component planes with one
// vectorized scatter.
//
// data:        the full JPEG byte buffer.
// start:       offset of the first entropy byte (after the SOS header).
// dc_specs/ac_specs: [4][17+256] int32 per table id: DHT BITS list
//              (entry 0 unused) followed by HUFFVAL.
// pattern:     [pattern_len] component slot per block within one MCU
//              (e.g. [0,0,0,0,1,2] for 4:2:0 interleaved; [0] for a
//              non-interleaved scan).
// comp_dc/comp_ac: [n_comps] table ids per component slot.
// n_mcus:      MCU count (block count for non-interleaved).
// restart_interval: MCUs between RSTn markers (0 = none).
// out_zz:      [n_mcus * pattern_len, 64] int32, zig-zag order, DC
//              prediction resolved.
// Returns the byte offset just past the last consumed entropy byte
// (pointing at the next marker's 0xFF when one follows), or -1 on a
// malformed stream.

namespace {

struct HuffDecodeTable {
  // canonical decode: per length l, first code value and huffval index
  int32_t mincode[17];
  int32_t maxcode[17];  // -1 where no codes of this length
  int32_t valptr[17];
  const int32_t* huffval;
};

static void build_decode_table(const int32_t* spec, HuffDecodeTable* t) {
  const int32_t* bits = spec;        // [17]
  t->huffval = spec + 17;            // [256]
  int32_t code = 0;
  int32_t k = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l] > 0) {
      t->valptr[l] = k;
      t->mincode[l] = code;
      code += bits[l];
      k += bits[l];
      t->maxcode[l] = code - 1;
    } else {
      t->maxcode[l] = -1;
      t->mincode[l] = 0;
      t->valptr[l] = 0;
    }
    code <<= 1;
  }
}

struct BitReader {
  const uint8_t* data;
  int64_t len;
  int64_t pos;
  uint64_t buf;
  int nbits;
  bool at_marker;  // hit a non-stuffing 0xFF: feed 1-padding

  void init(const uint8_t* d, int64_t l, int64_t p) {
    data = d;
    len = l;
    pos = p;
    buf = 0;
    nbits = 0;
    at_marker = false;
  }

  void fill() {
    while (nbits <= 56) {
      if (at_marker || pos >= len) {
        buf = (buf << 8) | 0xFF;  // ones past the end (padding semantics)
        nbits += 8;
        continue;
      }
      uint8_t b = data[pos];
      if (b == 0xFF) {
        uint8_t nxt = (pos + 1 < len) ? data[pos + 1] : 0xD9;
        if (nxt == 0x00) {
          pos += 2;
          buf = (buf << 8) | 0xFF;
          nbits += 8;
          continue;
        }
        at_marker = true;
        continue;
      }
      ++pos;
      buf = (buf << 8) | b;
      nbits += 8;
    }
  }

  inline int bit() {
    if (nbits == 0) fill();
    --nbits;
    return (int)((buf >> nbits) & 1);
  }

  inline int32_t bits(int n) {
    int32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | bit();
    return v;
  }

  // skip to and consume the pending marker; returns its code byte
  int consume_marker() {
    buf = 0;
    nbits = 0;
    at_marker = false;
    while (pos < len && data[pos] != 0xFF) ++pos;
    while (pos + 1 < len && data[pos + 1] == 0xFF) ++pos;  // fill bytes
    if (pos + 1 >= len) return -1;
    int code = data[pos + 1];
    pos += 2;
    return code;
  }
};

static int decode_symbol(BitReader* br, const HuffDecodeTable* t) {
  int32_t code = br->bit();
  for (int l = 1; l <= 16; ++l) {
    if (t->maxcode[l] >= 0 && code <= t->maxcode[l])
      return t->huffval[t->valptr[l] + (code - t->mincode[l])];
    code = (code << 1) | br->bit();
  }
  return -1;
}

static inline int32_t extend(int32_t v, int n) {
  if (n == 0) return 0;
  if (v < (1 << (n - 1))) return v - (1 << n) + 1;
  return v;
}

}  // namespace

int64_t jt_decode_scan(const uint8_t* data, int64_t len, int64_t start,
                       const int32_t* dc_specs, const int32_t* ac_specs,
                       const int32_t* pattern, int64_t pattern_len,
                       const int32_t* comp_dc, const int32_t* comp_ac,
                       int64_t n_comps, int64_t n_mcus,
                       int64_t restart_interval, int32_t* out_zz) {
  HuffDecodeTable dc_tabs[4], ac_tabs[4];
  for (int i = 0; i < 4; ++i) {
    build_decode_table(dc_specs + i * (17 + 256), &dc_tabs[i]);
    build_decode_table(ac_specs + i * (17 + 256), &ac_tabs[i]);
  }
  int32_t preds[4] = {0, 0, 0, 0};
  BitReader br;
  br.init(data, len, start);

  int64_t since_rst = 0;
  int32_t* out = out_zz;
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (restart_interval && since_rst == restart_interval) {
      int code = br.consume_marker();
      if (code < 0xD0 || code > 0xD7) return -1;
      for (int i = 0; i < 4; ++i) preds[i] = 0;
      since_rst = 0;
    }
    for (int64_t pb = 0; pb < pattern_len; ++pb, out += 64) {
      int comp = pattern[pb];
      const HuffDecodeTable* dt = &dc_tabs[comp_dc[comp]];
      const HuffDecodeTable* at = &ac_tabs[comp_ac[comp]];
      for (int i = 0; i < 64; ++i) out[i] = 0;
      int cls = decode_symbol(&br, dt);
      if (cls < 0 || cls > 15) return -1;
      preds[comp] += extend(br.bits(cls), cls);
      out[0] = preds[comp];
      int k = 1;
      while (k < 64) {
        int sym = decode_symbol(&br, at);
        if (sym < 0) return -1;
        if (sym == 0x00) break;  // EOB
        if (sym == 0xF0) {       // ZRL
          k += 16;
          continue;
        }
        k += sym >> 4;
        int size = sym & 0x0F;
        if (k > 63) return -1;
        out[k] = extend(br.bits(size), size);
        ++k;
      }
    }
    ++since_rst;
  }
  return br.pos;
}

// Segment-parallel baseline decode.  With restart markers every
// ``restart_interval`` MCUs, each RSTn-delimited segment is independent
// (DC predictors reset at the marker, T.81 F.2.1.3.1) — the encoder's
// device-parallel packing has an exact decode-side dual.  Boundaries come
// from one linear marker scan (0xFF followed by 0xD0-0xD7; stuffed 0xFF00
// pairs are skipped, 0xFF fill bytes fall through), then segments decode
// on ``n_threads`` std::threads via static round-robin.  Returns the byte
// offset past the final segment's entropy bytes, or -1 on a malformed
// stream (any segment).
int64_t jt_decode_scan_mt(const uint8_t* data, int64_t len, int64_t start,
                          const int32_t* dc_specs, const int32_t* ac_specs,
                          const int32_t* pattern, int64_t pattern_len,
                          const int32_t* comp_dc, const int32_t* comp_ac,
                          int64_t n_comps, int64_t n_mcus,
                          int64_t restart_interval, int64_t n_threads,
                          int32_t* out_zz) {
  if (restart_interval <= 0 || n_threads <= 1 ||
      n_mcus <= restart_interval) {
    return jt_decode_scan(data, len, start, dc_specs, ac_specs, pattern,
                          pattern_len, comp_dc, comp_ac, n_comps, n_mcus,
                          restart_interval, out_zz);
  }
  const int64_t nseg = (n_mcus + restart_interval - 1) / restart_interval;
  // marker scan: segment s spans [starts[s], ends[s]) entropy bytes
  std::vector<int64_t> seg_start(nseg), seg_end(nseg);
  seg_start[0] = start;
  int64_t p = start;
  int64_t s = 0;
  while (s < nseg - 1) {
    if (p + 1 >= len) return -1;
    if (data[p] != 0xFF) {
      ++p;
      continue;
    }
    const uint8_t nxt = data[p + 1];
    if (nxt == 0x00) {
      p += 2;  // stuffing
      continue;
    }
    if (nxt >= 0xD0 && nxt <= 0xD7) {
      seg_end[s] = p;
      ++s;
      p += 2;
      seg_start[s] = p;
      continue;
    }
    if (nxt == 0xFF) {
      ++p;  // fill byte
      continue;
    }
    return -1;  // foreign marker before all restart intervals were seen
  }
  seg_end[nseg - 1] = len;  // last segment: reader stops at the next marker

  std::atomic<bool> failed(false);
  std::atomic<int64_t> end_pos(-1);
  const int64_t blocks_per_mcu = pattern_len;
  int nt = (int)(n_threads < nseg ? n_threads : nseg);
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    workers.emplace_back([&, t]() {
      for (int64_t i = t; i < nseg && !failed.load(); i += nt) {
        const int64_t mcu0 = i * restart_interval;
        const int64_t mcus =
            (n_mcus - mcu0 < restart_interval) ? (n_mcus - mcu0)
                                               : restart_interval;
        int64_t e = jt_decode_scan(
            data, seg_end[i], seg_start[i], dc_specs, ac_specs, pattern,
            pattern_len, comp_dc, comp_ac, n_comps, mcus, 0,
            out_zz + mcu0 * blocks_per_mcu * 64);
        if (e < 0) failed.store(true);
        if (i == nseg - 1) end_pos.store(e);
      }
    });
  }
  for (auto& w : workers) w.join();
  if (failed.load()) return -1;
  return end_pos.load();
}

// Successive-approximation AC refinement field coder (T.81 G.1.2.3):
// one correction bit per nonzero-history coefficient, newly-significant
// coefficients as run-coded +-1, correction bits buffered across EOB
// runs — the serial per-band emission order that keeps this on the host
// (pipelines/progressive.py::ac_refine_fields_plain is its plain version,
// which the tests hold it to element for element; no path falls back).
//
// band:    [n, w] int32 band coefficients (zz[:, ss:se+1], NOT shifted).
// al, ah:  successive approximation bit positions (ah == al + 1).
// max_run: EOBRUN cap (0x7FFF dynamic tables, 1 fixed).
// max_buf: buffered-correction-bit flush cap (_MAX_REFINE_BUFFER).
// sym/extra/extra_n: outputs; sym -1 means raw extra_n bits of extra.
//   Caller sizes them at n*(w + w/16 + 2) + 8 entries.
// returns  emitted field count.
int64_t jt_ac_refine_fields(const int32_t* band, int64_t n, int64_t w,
                            int64_t al, int64_t max_run, int64_t max_buf,
                            int32_t* sym, int32_t* extra,
                            int32_t* extra_n) {
  int64_t m = 0;
  int64_t eobrun = 0;
  std::vector<int32_t> be;  // correction bits buffered across the EOB run
  std::vector<int32_t> br;  // correction bits buffered within a block run
  be.reserve(1024);
  br.reserve(64);
  auto emit_sym = [&](int32_t s, int32_t e, int32_t en) {
    sym[m] = s; extra[m] = e; extra_n[m] = en; ++m;
  };
  auto emit_bit = [&](int32_t v) {
    sym[m] = -1; extra[m] = v; extra_n[m] = 1; ++m;
  };
  auto flush_eobrun = [&]() {
    if (!eobrun) return;
    int r = 0;
    while ((int64_t(1) << (r + 1)) <= eobrun) ++r;
    emit_sym(r << 4, static_cast<int32_t>(eobrun - (int64_t(1) << r)), r);
    for (int32_t b : be) emit_bit(b);
    be.clear();
    eobrun = 0;
  };
  for (int64_t blk = 0; blk < n; ++blk) {
    const int32_t* row = band + blk * w;
    int64_t eob = -1;
    bool has_any = false;
    for (int64_t k = 0; k < w; ++k) {
      int32_t t = (row[k] < 0 ? -row[k] : row[k]) >> al;
      if (t) {
        has_any = true;
        if (t == 1) eob = k;
      }
    }
    if (!has_any) {
      if (++eobrun == max_run) flush_eobrun();
      continue;
    }
    int r = 0;
    br.clear();
    for (int64_t k = 0; k < w; ++k) {
      int32_t t = (row[k] < 0 ? -row[k] : row[k]) >> al;
      if (t == 0) {
        ++r;
        continue;
      }
      while (r > 15 && k <= eob) {
        flush_eobrun();
        r -= 16;
        emit_sym(0xF0, 0, 0);
        for (int32_t b : br) emit_bit(b);
        br.clear();
      }
      if (t > 1) {
        br.push_back(t & 1);
        continue;
      }
      flush_eobrun();
      emit_sym((r << 4) | 1, row[k] > 0 ? 1 : 0, 1);
      for (int32_t b : br) emit_bit(b);
      br.clear();
      r = 0;
    }
    if (r > 0 || !br.empty()) {
      ++eobrun;
      be.insert(be.end(), br.begin(), br.end());
      if (eobrun == max_run || static_cast<int64_t>(be.size()) > max_buf) {
        flush_eobrun();
      }
    }
  }
  flush_eobrun();
  return m;
}

}  // extern "C"
