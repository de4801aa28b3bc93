// Host runtime of jpeg_tpu_torch: scan finalization, file assembly and
// the Annex K.2 Huffman builder, with C linkage for ctypes.
//
// The port's own copy of the parts of jpeg_tpu's native/jpeg_tpu_host.cpp
// that the batch encoder uses (jt_finish_scan(s), jt_assemble_interleaved,
// jt_build_huff_tables); outputs equal the original's byte for byte
// (tests/test_torch_host.py).
//
// The device produces each entropy segment as big-endian-packed u32 words
// plus a bit count.  Finalization serializes the bytes, stuffs a 0x00
// after every 0xFF data byte and pads the tail byte with 1-bits (a bare
// 0xFF when the stream ends on a byte boundary).  No Python.h dependency.

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

}  // extern "C"
