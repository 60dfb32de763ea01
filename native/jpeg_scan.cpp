// jpeg_scan — streaming baseline-JPEG entropy decoder.
//
// Purpose: extract quantized DCT coefficient planes with ONE pass and no
// intermediate buffering, so the host-side cost of device-side JPEG decode is
// the Huffman work alone. libjpeg's jpeg_read_coefficients buffers the
// whole image through virtual block arrays and costs as much as a full
// SIMD decode (see PERF.md); this decoder writes int16 planes (natural
// order, spatial block layout, MCU-aligned dims) directly.
//
// Scope: baseline sequential DCT (single interleaved scan) AND
// progressive DCT (DC first/refine, AC first/refine with EOB runs, per
// ITU T.81 G.1.2 — the common camera / PIL / libjpeg / web-export
// outputs), Huffman coding, 8-bit samples, 1 or 3 components.
// Arithmetic-coded and lossless files return an error and callers fall
// back to libjpeg.
//
// Validated bit-exactly against libjpeg's coefficient output across
// sizes, qualities, subsampling modes, restart intervals, and
// progressive scan scripts (tests/test_jpeg_scan.py).

#include <cstdint>
#include <cstring>

#include <thread>
#include <vector>

namespace {

constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

inline int extend(int v, int s) {
  return (v < (1 << (s - 1))) ? v - (1 << s) + 1 : v;
}

// Branchless EXTEND (F.2.2.1) for the LUT-covered paths: the sign of
// an s-bit RECEIVE field is its MSB; a mispredicted conditional here
// is a coin flip on photographic noise (the emit side measured the
// same branch at ~1.7x the whole pass cost — see jpeg_emit.cpp).
// Callers guarantee s >= 1.
inline int extend_nb(int v, int s) {
  const int m = (v >> (s - 1)) - 1;  // 0 if positive, -1 if negative
  return v + (m & static_cast<int>((~0u << s) + 1));
}

struct HuffTable {
  // Canonical decode tables (F.2.2.3) + an 8-bit fast lookup + the
  // 12-bit combined lookahead below.
  int32_t maxcode[18];
  int32_t valptr[17];
  int32_t mincode[17];
  uint8_t values[256];
  int16_t fast[256];  // (len << 8) | value, or -1
  // One L1 load resolves code length, zero-run, size category, AND —
  // when code+value bits fit the 12-bit window — the sign-extended
  // coefficient value itself (multi-field Huffman decode; at q85 the
  // window fully covers ~97% of coefficients, and codes of 9..16 bits
  // no longer take the canonical length-by-length walk).
  // Entry layout: bits 0..4 total bits to consume (code, or
  // code+value when bit 9 is set); bits 5..8 zero-run; bit 9 value
  // included; bits 10..13 size category s; bits 16..31 extended value
  // (int16). 0 = slow path (code >12 bits, invalid prefix, or a
  // category the scan class forbids: DC s>11 / AC s>10).
  uint32_t lut[4096];
  bool present = false;
  // Raw DHT spec (BITS counts; values[] above holds HUFFVAL): retained
  // so ip_jpeg_scan_tables can hand the exact input tables to the
  // splice emitter (ip_jpeg_emit_transcode re-declares them, which is
  // what makes copied bit spans decodable).
  uint8_t spec_bits[17] = {};
  int spec_nvals = 0;

  // Returns false for a non-canonical table: a DHT claiming more codes
  // at some length than fit (code >= 1 << l, the same validation
  // libjpeg's jdhuff performs). Without this check the fast-table fill
  // below computes base = code << (8 - l) past fast[256] — a crafted
  // ~300-byte upload could overwrite the stack-resident Decoder.
  bool build(const uint8_t* bits, const uint8_t* vals, int nvals,
             bool is_dc) {
    memcpy(values, vals, static_cast<size_t>(nvals));
    memcpy(spec_bits + 1, bits, 16);
    spec_nvals = nvals;
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += bits[l - 1];
      k += bits[l - 1];
      if (code > (1 << l)) return false;  // over-subscribed length
      maxcode[l] = code - 1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    for (int i = 0; i < 256; ++i) fast[i] = -1;
    code = 0;
    k = 0;
    for (int l = 1; l <= 8; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
        const int shift = 8 - l;
        const int base = code << shift;
        for (int f = 0; f < (1 << shift); ++f)
          fast[base + f] = static_cast<int16_t>((l << 8) | vals[k]);
      }
      code <<= 1;
    }
    // 12-bit combined lookahead: canonical-decode every window once at
    // DHT parse time (~4096 x <=12 compares, microseconds).
    for (int w = 0; w < 4096; ++w) {
      int sym = -1, len = 0;
      for (int l = 1; l <= 12; ++l) {
        const int cd = w >> (12 - l);
        if (cd <= maxcode[l]) {
          sym = values[valptr[l] + (cd - mincode[l])];
          len = l;
          break;
        }
      }
      if (sym < 0) {
        lut[w] = 0;
        continue;
      }
      const int run = is_dc ? 0 : (sym >> 4);
      const int s = is_dc ? sym : (sym & 15);
      if (s > (is_dc ? 11 : 10)) {  // category the scan class forbids
        lut[w] = 0;
        continue;
      }
      // DC s==0 combines to value 0 (uniform path); AC s==0 stays
      // non-combined — EOB/ZRL have control-flow semantics.
      if ((s > 0 || is_dc) && len + s <= 12) {
        const int v = s ? ((w >> (12 - len - s)) & ((1 << s) - 1)) : 0;
        const int ext = s ? extend(v, s) : 0;
        lut[w] = static_cast<uint32_t>(len + s)
                 | (static_cast<uint32_t>(run) << 5) | (1u << 9)
                 | (static_cast<uint32_t>(s) << 10)
                 | (static_cast<uint32_t>(static_cast<uint16_t>(
                        static_cast<int16_t>(ext)))
                    << 16);
      } else {
        lut[w] = static_cast<uint32_t>(len)
                 | (static_cast<uint32_t>(run) << 5)
                 | (static_cast<uint32_t>(s) << 10);
      }
    }
    present = true;
    return true;
  }
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;  // unconsumed bits live in the TOP `nbits` bits
  int nbits = 0;
  bool saw_marker = false;
  uint8_t marker = 0;
  // Optional destuffed-stream recording (the splice emitter's input):
  // every byte fed into `acc` is appended to `dump` (bounded by
  // dump_cap), so `fed * 8 - nbits` is a bit position into the dumped
  // stream. Synthetic zero-fill bytes past the stream end are counted
  // in `fed` (position accounting needs them) but only real entropy
  // bytes advance `real_fed` — they always form a prefix of the dump,
  // since zero-fill begins only once the stream/marker is reached.
  uint8_t* dump = nullptr;
  int64_t dump_cap = 0;
  int64_t fed = 0;       // bytes fed to acc (incl. synthetic tail)
  int64_t real_fed = 0;  // real destuffed bytes (prefix of dump)

  int64_t bit_pos() const { return fed * 8 - nbits; }  // consumed bits

  void fill() {  // refill to >= 57 bits
    while (nbits <= 56) {
      // Bulk path: 8 raw bytes with no 0xFF anywhere — append whole
      // bytes with one 64-bit load instead of per-byte stuffing checks
      // (the common case away from markers).
      if (!saw_marker && p + 8 <= end) {
        uint64_t chunk;
        memcpy(&chunk, p, 8);
        const uint64_t inv = ~chunk;  // 0xFF byte <=> zero byte in ~chunk
        if (((inv - 0x0101010101010101ull) & ~inv
             & 0x8080808080808080ull) == 0) {
          const int k = (64 - nbits) >> 3;  // whole bytes that fit
          const uint64_t be = __builtin_bswap64(chunk);
          acc |= (be >> (64 - 8 * k)) << (64 - nbits - 8 * k);
          nbits += 8 * k;
          if (dump != nullptr) {
            if (fed + k <= dump_cap) memcpy(dump + fed, p, static_cast<size_t>(k));
            fed += k;
            real_fed = fed;
          }
          p += k;
          continue;
        }
      }
      // Byte-at-a-time path: stuffing, markers, stream end.
      uint8_t b;
      bool real_b = false;
      if (saw_marker || p >= end) {
        b = 0;  // zero-fill past the end / at a marker
      } else {
        b = *p++;
        real_b = true;
        if (b == 0xFF) {
          uint8_t b2 = (p < end) ? *p : 0xD9;
          if (b2 == 0x00) {
            ++p;  // stuffed byte
          } else {
            saw_marker = true;
            marker = b2;
            b = 0;
            real_b = false;
          }
        }
      }
      if (dump != nullptr) {
        if (fed < dump_cap) dump[fed] = b;
        ++fed;
        if (real_b) real_fed = fed;
      }
      acc |= static_cast<uint64_t>(b) << (56 - nbits);
      nbits += 8;
    }
  }

  void consume(int n) {
    acc <<= n;
    nbits -= n;
  }

  int get_bits(int n) {  // RECEIVE
    if (n == 0) return 0;
    fill();
    int v = static_cast<int>(acc >> (64 - n));
    consume(n);
    return v;
  }

  // RECEIVE without a refill: callers guarantee >= n bits remain
  // (huff_decode leaves >= 41 after consuming a <=16-bit code).
  int get_bits_nofill(int n) {
    if (n == 0) return 0;
    int v = static_cast<int>(acc >> (64 - n));
    consume(n);
    return v;
  }

  void align_and_clear_marker() {  // after RSTn
    acc = 0;
    nbits = 0;
    saw_marker = false;
  }
};

// Decode one Huffman symbol; the caller guarantees >= 26 bits are
// buffered (max code 16 bits; the paired value bits are consumed with
// get_bits_nofill, so one refill check covers a whole coefficient).
inline int huff_decode(BitReader& br, const HuffTable& t) {
  const int look = static_cast<int>(br.acc >> 56);
  const int16_t f = t.fast[look];
  if (f >= 0) {
    br.consume(f >> 8);
    return f & 0xFF;
  }
  // slow path: the 8-bit LUT holds every code of length <= 8, so a miss
  // means the code is 9..16 bits (or invalid).
  int code = 0, l;
  for (l = 9; l <= 16; ++l) {
    code = static_cast<int>(br.acc >> (64 - l));
    if (code <= t.maxcode[l]) break;
  }
  if (l > 16) return -1;
  br.consume(l);
  return t.values[t.valptr[l] + (code - t.mincode[l])];
}

struct Component {
  int id = 0;
  int h = 1, v = 1;
  int tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int16_t* out = nullptr;
  int bw = 0;  // blocks per row in the OUTPUT plane (MCU-aligned)
  int pred = 0;
  // zigzag index k -> strided offset inside an output block
  // ((z>>3)*stride + (z&7)); lets decode_block scatter non-zero
  // coefficients straight into the caller's pre-zeroed plane with no
  // per-block staging buffer, memset, or row copies.
  int32_t zigoff[64];

  void build_zigoff() {
    const int stride = bw * 8;
    for (int k = 0; k < 64; ++k) {
      const int z = kZigzag[k];
      zigoff[k] = (z >> 3) * stride + (z & 7);
    }
  }
};

// One SOS header's parameters (progressive files carry many scans).
struct ScanInfo {
  int ncomps = 0;
  int idx[3] = {0, 0, 0};  // indices into Decoder::comp
  int ss = 0, se = 63, ah = 0, al = 0;
};

struct Decoder {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1;
  int restart_interval = 0;
  bool progressive = false;
  unsigned int eobrun = 0;  // EOB-run state, persists across blocks
  ScanInfo scan;
  Component comp[3];
  HuffTable dc[4], ac[4];
  uint16_t qtab[4][64] = {};   // natural order
  // Optional per-restart-segment end recording (_rst entry point):
  // seg k's last MCU ends at rec_seg[k] bits (before byte-align
  // padding); the final segment's end is rec_mcu[nmcus].
  int64_t* rec_seg = nullptr;
  // Optional splice-support recording (ip_jpeg_scan_coefs_offsets):
  // per-MCU bit offsets into a destuffed copy of the entropy stream.
  int64_t* rec_mcu = nullptr;   // nmcus + 1 entries
  uint8_t* rec_dump = nullptr;  // destuffed stream sink
  int64_t rec_cap = 0;
  int64_t rec_real_bits = 0;    // real destuffed bits written

  int u16() {
    if (pos + 2 > len) return -1;
    int v = (data[pos] << 8) | data[pos + 1];
    pos += 2;
    return v;
  }

  // Parse headers up to (and including) SOS. Returns 0 ok.
  int parse_headers() {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return 10;
    pos = 2;
    while (pos + 4 <= len) {
      if (data[pos] != 0xFF) return 11;
      uint8_t m = data[pos + 1];
      if (m == 0xFF) {  // fill byte before a marker (T.81 B.1.1.2)
        ++pos;
        continue;
      }
      pos += 2;
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (m == 0x01) continue;
      int seglen = u16();
      if (seglen < 2) return 12;
      size_t seg_end = pos + static_cast<size_t>(seglen) - 2;
      if (seg_end > len) return 13;
      switch (m) {
        case 0xC2:  // SOF2 progressive DCT (same SOF layout)
          progressive = true;
          [[fallthrough]];
        case 0xC0:  // SOF0 baseline
        case 0xC1: {  // extended sequential (same coding model)
          if (seg_end - pos < 6) return 23;  // truncated SOF
          if (data[pos] != 8) return 14;  // precision
          height = (data[pos + 1] << 8) | data[pos + 2];
          width = (data[pos + 3] << 8) | data[pos + 4];
          ncomp = data[pos + 5];
          if (ncomp != 1 && ncomp != 3) return 15;
          if (width <= 0 || height <= 0 || width > 65500
              || height > 65500)
            return 26;
          if (seg_end - pos < 6 + 3 * static_cast<size_t>(ncomp))
            return 23;
          for (int c = 0; c < ncomp; ++c) {
            const uint8_t* q = data + pos + 6 + 3 * c;
            comp[c].id = q[0];
            comp[c].h = q[1] >> 4;
            comp[c].v = q[1] & 15;
            comp[c].tq = q[2];
            if (comp[c].tq > 3) return 27;
            if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1
                || comp[c].v > 4)
              return 16;
            if (comp[c].h > hmax) hmax = comp[c].h;
            if (comp[c].v > vmax) vmax = comp[c].v;
          }
          if (ncomp == 1) {
            // A single-component scan is non-interleaved (B.2.3): the
            // MCU is one data unit and sampling factors are ignored
            // (PIL writes h=v=2 for grayscale; libjpeg ignores it too).
            comp[0].h = comp[0].v = hmax = vmax = 1;
          }
          break;
        }
        case 0xC3: case 0xC5: case 0xC6: case 0xC7:
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          return 20;  // arithmetic/lossless: caller falls back
        case 0xC4: {  // DHT
          int rc = parse_dht(seg_end);
          if (rc != 0) return rc;
          break;
        }
        case 0xDD:  // DRI
          if (seg_end - pos < 2) return 23;
          restart_interval = (data[pos] << 8) | data[pos + 1];
          break;
        case 0xDA:  // SOS — entropy data starts at seg_end
          return parse_sos(seg_end);
        case 0xDB: {  // DQT
          int rc = parse_dqt(seg_end);
          if (rc != 0) return rc;
          break;
        }
        default:
          break;  // APPn/COM
      }
      pos = seg_end;
    }
    return 21;
  }

  int parse_dht(size_t seg_end) {  // may hold several tables
    size_t q = pos;
    while (q + 17 <= seg_end) {
      int tc = data[q] >> 4, th = data[q] & 15;
      if (tc > 1 || th > 3) return 17;
      const uint8_t* bits = data + q + 1;
      int nv = 0;
      for (int i = 0; i < 16; ++i) nv += bits[i];
      if (q + 17 + static_cast<size_t>(nv) > seg_end || nv > 256)
        return 18;
      if (!(tc == 0 ? dc[th] : ac[th]).build(bits, data + q + 17, nv,
                                             tc == 0))
        return 18;  // non-canonical code counts
      q += 17 + static_cast<size_t>(nv);
    }
    return 0;
  }

  int parse_dqt(size_t seg_end) {  // values stored zigzag in the stream
    size_t q = pos;
    while (q < seg_end) {
      int pq = data[q] >> 4, tq = data[q] & 15;
      ++q;
      if (tq > 3 || pq > 1) return 22;
      if (seg_end - q < (pq ? 128u : 64u)) return 23;  // truncated
      for (int i = 0; i < 64; ++i) {
        int val;
        if (pq) {
          val = (data[q] << 8) | data[q + 1];
          q += 2;
        } else {
          val = data[q++];
        }
        qtab[tq][kZigzag[i]] = static_cast<uint16_t>(val);
      }
    }
    return 0;
  }

  int parse_sos(size_t seg_end) {
    if (seg_end - pos < 1) return 23;
    int ns = data[pos];
    if (ns < 1 || ns > 3) return 19;
    // Baseline keeps the single-interleaved-scan restriction; progressive
    // scans may cover any subset (AC scans MUST be one component).
    if (!progressive && ns != ncomp) return 19;
    if (seg_end - pos < 1 + 2 * static_cast<size_t>(ns) + 3) return 23;
    scan.ncomps = ns;
    for (int s = 0; s < ns; ++s) {
      int cid = data[pos + 1 + 2 * s];
      int tbls = data[pos + 2 + 2 * s];
      if ((tbls >> 4) > 3 || (tbls & 15) > 3) return 28;
      int found = -1;
      for (int c = 0; c < ncomp; ++c) {
        if (comp[c].id == cid) found = c;
      }
      if (found < 0) return 19;
      comp[found].dc_tbl = tbls >> 4;
      comp[found].ac_tbl = tbls & 15;
      scan.idx[s] = found;
    }
    const uint8_t* q = data + pos + 1 + 2 * static_cast<size_t>(ns);
    scan.ss = q[0];
    scan.se = q[1];
    scan.ah = q[2] >> 4;
    scan.al = q[2] & 15;
    if (scan.ss > 63 || scan.se > 63 || scan.se < scan.ss) return 29;
    if (progressive) {
      if (scan.ss > 0 && ns != 1) return 29;  // AC scans: one component
      if (scan.ss == 0 && scan.se != 0) return 29;  // DC scan: Se == 0
      if (scan.ah > 13 || scan.al > 13) return 29;
      if (scan.ah != 0 && scan.ah != scan.al + 1) return 29;
    }
    pos = seg_end;  // entropy data starts here
    return 0;
  }

  // Raw-scan past a scan's entropy data to the next real marker
  // (stuffed 0xFF00 and RSTn are part of the entropy stream).
  size_t find_scan_end(size_t start) const {
    size_t i = start;
    while (i + 1 < len) {
      if (data[i] == 0xFF) {
        const uint8_t m = data[i + 1];
        if (m == 0x00 || (m >= 0xD0 && m <= 0xD7)) {
          i += 2;
          continue;
        }
        if (m == 0xFF) {  // fill byte
          i += 1;
          continue;
        }
        return i;
      }
      ++i;
    }
    return len;
  }

  // Parse inter-scan segments until the next SOS (progressive files
  // interleave DHT/DRI with scans). Returns 0 = scan ready, 1 = EOI /
  // end of stream, else an error code.
  int parse_next_scan() {
    while (pos + 2 <= len) {
      if (data[pos] != 0xFF) return 11;
      uint8_t m = data[pos + 1];
      if (m == 0xFF) {  // fill byte
        ++pos;
        continue;
      }
      pos += 2;
      if (m == 0xD9) return 1;  // EOI
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      int seglen = u16();
      if (seglen < 2) return 12;
      size_t seg_end = pos + static_cast<size_t>(seglen) - 2;
      if (seg_end > len) return 13;
      switch (m) {
        case 0xC4: {
          int rc = parse_dht(seg_end);
          if (rc != 0) return rc;
          break;
        }
        case 0xDD:
          if (seg_end - pos < 2) return 23;
          restart_interval = (data[pos] << 8) | data[pos + 1];
          break;
        case 0xDB: {
          int rc = parse_dqt(seg_end);
          if (rc != 0) return rc;
          break;
        }
        case 0xDA:
          return parse_sos(seg_end);
        default:
          break;
      }
      pos = seg_end;
    }
    return 1;  // tolerate a missing EOI
  }

  // Writes ONLY the non-zero coefficients; the caller's plane must be
  // pre-zeroed (np.zeros / calloc on the Python side).
  //
  // Hot path: one 12-bit LUT load resolves (len, run, size, value) per
  // coefficient — no canonical walk for 9..12-bit codes, no extend
  // branch, and usually no separate value read. The slow path (codes
  // 13..16 bits, invalid prefixes, forbidden categories) keeps the
  // original canonical decode + validation.
  int decode_block(BitReader& br, Component& c, int16_t* blk_out) {
    const HuffTable& dct = dc[c.dc_tbl];
    const HuffTable& act = ac[c.ac_tbl];
    if (!dct.present || !act.present) return 30;
    br.fill();  // >= 57 bits: covers the DC code (<=16) + diff (<=11)
    int diff;
    {
      const uint32_t e = dct.lut[br.acc >> 52];
      if (e & (1u << 9)) {  // combined: code + extended diff, one step
        br.consume(static_cast<int>(e & 31));
        diff = static_cast<int16_t>(e >> 16);
      } else if (e != 0) {  // code <=12 bits, diff bits past the window
        br.consume(static_cast<int>(e & 31));
        const int s = static_cast<int>((e >> 10) & 15);
        diff = extend_nb(br.get_bits_nofill(s), s);
      } else {
        // Baseline DC magnitude categories are 0..11 (ITU T.81
        // F.1.2.1.1); a malicious DHT can encode larger symbols, which
        // would shift by a negative count in get_bits_nofill /
        // overflow extend — reject first.
        int s = huff_decode(br, dct);
        if (s < 0 || s > 11) return 31;
        diff = s ? extend(br.get_bits_nofill(s), s) : 0;
      }
    }
    c.pred += diff;
    blk_out[0] = static_cast<int16_t>(c.pred);
    const int32_t* zig = c.zigoff;
    for (int k = 1; k < 64;) {
      if (br.nbits < 26) br.fill();  // AC code (<=16) + value (<=10)
      const uint32_t e = act.lut[br.acc >> 52];
      if (e & (1u << 9)) {  // combined (run, value): s >= 1 always
        br.consume(static_cast<int>(e & 31));
        k += static_cast<int>((e >> 5) & 15);
        if (k > 63) return 33;
        blk_out[zig[k]] = static_cast<int16_t>(e >> 16);
        ++k;
        continue;
      }
      if (e != 0) {
        br.consume(static_cast<int>(e & 31));
        const int s = static_cast<int>((e >> 10) & 15);
        if (s == 0) {
          if (((e >> 5) & 15) == 15) {
            k += 16;  // ZRL
            continue;
          }
          break;  // EOB
        }
        k += static_cast<int>((e >> 5) & 15);
        if (k > 63) return 33;
        blk_out[zig[k]] =
            static_cast<int16_t>(extend_nb(br.get_bits_nofill(s), s));
        ++k;
        continue;
      }
      // slow path: code 13..16 bits, invalid prefix, or s > 10
      int rs = huff_decode(br, act);
      if (rs < 0) return 32;
      int r = rs >> 4;
      int s = rs & 15;
      if (s == 0) {
        if (r == 15) {
          k += 16;
          continue;
        }
        break;  // EOB
      }
      // Baseline AC magnitude categories are 1..10 (T.81 F.1.2.2.1).
      if (s > 10) return 34;
      k += r;
      if (k > 63) return 33;
      blk_out[zig[k]] =
          static_cast<int16_t>(extend(br.get_bits_nofill(s), s));
      ++k;
    }
    return 0;
  }

  // Decode MCUs [mcu_begin, mcu_end) from a BitReader positioned at the
  // segment start (no restart markers inside the range). Predictors
  // must already be reset by the caller.
  int decode_mcu_range(BitReader& br, int mcu_begin, int mcu_end) {
    const int mcus_x = (width + hmax * 8 - 1) / (hmax * 8);
    for (int m = mcu_begin; m < mcu_end; ++m) {
      const int my = m / mcus_x;
      const int mx = m % mcus_x;
      for (int c = 0; c < ncomp; ++c) {
        Component& cc = comp[c];
        for (int v = 0; v < cc.v; ++v) {
          for (int h = 0; h < cc.h; ++h) {
            const int bx = mx * cc.h + h;
            const int by = my * cc.v + v;
            const int stride = cc.bw * 8;
            int16_t* out = cc.out
                + static_cast<size_t>(by) * 8 * stride
                + static_cast<size_t>(bx) * 8;
            int rc = decode_block(br, cc, out);
            if (rc != 0) return rc;
          }
        }
      }
    }
    return 0;
  }

  // Round-5 probe: per-block round-robin interleaved decode of W
  // restart segments on ONE core (the decode-side analog of round 4's
  // ip_jpeg_emit_strided_ilp). MEASURED THROUGHPUT-NEGATIVE on the dev
  // Xeon: 0.80-0.82x sequential at W=2..4 on a 12 MP q85 DRI=8 stream
  // (PERF.md round-5 scan-probe section) — the scan loop is
  // issue-bound like the emitter, and lane switching adds state
  // save/restore + predictor aliasing. Kept opt-in for wider cores.
  struct IlpLane {
    BitReader br;
    int preds[3];
    int m, m_end;
    int k;
    int c, bv, bh;
    bool active;
  };

  int decode_scan_ilp(int W, const std::vector<size_t>& seg_off,
                      int ri, int total) {
    const int mcus_x = (width + hmax * 8 - 1) / (hmax * 8);
    const int nseg = static_cast<int>(seg_off.size());
    std::vector<IlpLane> lanes(static_cast<size_t>(W));
    for (int wl = 0; wl < W; ++wl) {
      IlpLane& L = lanes[static_cast<size_t>(wl)];
      L.k = wl;
      L.active = L.k < nseg;
      if (L.active) {
        L.br = BitReader{data + seg_off[static_cast<size_t>(L.k)],
                         data + len};
        L.m = L.k * ri;
        L.m_end = L.m + ri < total ? L.m + ri : total;
        L.preds[0] = L.preds[1] = L.preds[2] = 0;
        L.c = L.bv = L.bh = 0;
      }
    }
    int live = 0;
    for (auto& L : lanes) live += L.active ? 1 : 0;
    while (live > 0) {
      for (int wl = 0; wl < W; ++wl) {
        IlpLane& L = lanes[static_cast<size_t>(wl)];
        if (!L.active) continue;
        Component& cc = comp[L.c];
        const int mx = L.m % mcus_x;
        const int my = L.m / mcus_x;
        const int bx = mx * cc.h + L.bh;
        const int by = my * cc.v + L.bv;
        const int stride = cc.bw * 8;
        int16_t* out = cc.out + static_cast<size_t>(by) * 8 * stride
                       + static_cast<size_t>(bx) * 8;
        cc.pred = L.preds[L.c];
        int rc = decode_block(L.br, cc, out);
        if (rc != 0) return rc;
        L.preds[L.c] = cc.pred;
        // advance the block cursor (h fastest, then v, then comp)
        if (++L.bh == cc.h) {
          L.bh = 0;
          if (++L.bv == cc.v) {
            L.bv = 0;
            if (++L.c == ncomp) {
              L.c = 0;
              if (++L.m == L.m_end) {
                L.k += W;
                if (L.k >= nseg) {
                  L.active = false;
                  --live;
                } else {
                  L.br = BitReader{
                      data + seg_off[static_cast<size_t>(L.k)],
                      data + len};
                  L.m = L.k * ri;
                  L.m_end = L.m + ri < total ? L.m + ri : total;
                  L.preds[0] = L.preds[1] = L.preds[2] = 0;
                }
              }
            }
          }
        }
      }
    }
    return 0;
  }

  int decode_scan() {
    const int mcus_x = (width + hmax * 8 - 1) / (hmax * 8);
    const int mcus_y = (height + vmax * 8 - 1) / (vmax * 8);
    BitReader br{data + pos, data + len};
    if (rec_mcu != nullptr) {
      br.dump = rec_dump;
      br.dump_cap = rec_cap;
    }
    int mcus_until_restart =
        restart_interval ? restart_interval : mcus_x * mcus_y + 1;
    int64_t seg_idx = 0;
    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx) {
        if (rec_mcu != nullptr)
          rec_mcu[static_cast<size_t>(my) * mcus_x + mx] = br.bit_pos();
        for (int c = 0; c < ncomp; ++c) {
          Component& cc = comp[c];
          for (int v = 0; v < cc.v; ++v) {
            for (int h = 0; h < cc.h; ++h) {
              const int bx = mx * cc.h + h;
              const int by = my * cc.v + v;
              const int stride = cc.bw * 8;
              int16_t* out = cc.out
                  + static_cast<size_t>(by) * 8 * stride
                  + static_cast<size_t>(bx) * 8;
              int rc = decode_block(br, cc, out);
              if (rc != 0) return rc;
            }
          }
        }
        if (--mcus_until_restart == 0 && !(my == mcus_y - 1
                                           && mx == mcus_x - 1)) {
          // bit_pos() is invariant under fill() (fed and nbits advance
          // together), so this is the true end of the segment's last
          // MCU code, before padding/alignment.
          if (rec_seg != nullptr) rec_seg[seg_idx++] = br.bit_pos();
          // Expect RSTn: byte-align, reset predictors.
          if (!br.saw_marker) {
            // marker not yet hit: skip remaining bits to it
            br.fill();
          }
          if (br.saw_marker && br.marker >= 0xD0 && br.marker <= 0xD7) {
            // advance the raw pointer past the marker
            // (p currently points just after 0xFF marker byte)
            br.p += 1;
            br.align_and_clear_marker();
          } else {
            return 34;
          }
          for (int c = 0; c < ncomp; ++c) comp[c].pred = 0;
          mcus_until_restart = restart_interval;
        }
      }
    }
    if (rec_mcu != nullptr) {
      rec_mcu[static_cast<size_t>(mcus_x) * mcus_y] = br.bit_pos();
      rec_real_bits = br.real_fed * 8;
      // Bytes past dump_cap were dropped by the BitReader; offsets
      // would then index lost data (restart boundaries can append a
      // few synthetic bytes each — callers size the buffer for that).
      if (br.fed > br.dump_cap) return 35;
    }
    return 0;
  }

  // ---------------------------------------------------- progressive scans
  // ITU T.81 G.1.2 / libjpeg jdphuff semantics: DC first/refine, AC
  // first/refine with EOB runs. Coefficients accumulate across scans in
  // the same output planes the baseline path writes.

  int decode_prog_dc_block(BitReader& br, Component& c, int16_t* blk) {
    if (scan.ah == 0) {  // first DC scan: diff-coded, scaled by 2^Al
      const HuffTable& dct = dc[c.dc_tbl];
      if (!dct.present) return 30;
      br.fill();
      int s = huff_decode(br, dct);
      if (s < 0 || s > 11) return 31;
      int diff = s ? extend(br.get_bits_nofill(s), s) : 0;
      c.pred += diff;
      blk[0] = static_cast<int16_t>(
          static_cast<unsigned>(c.pred) << scan.al);
    } else {  // refinement: one bit per block at position Al
      if (br.get_bits(1))
        blk[0] = static_cast<int16_t>(blk[0] | (1 << scan.al));
    }
    return 0;
  }

  int decode_ac_first_block(BitReader& br, Component& c, int16_t* blk) {
    if (eobrun > 0) {  // block is inside an EOB run: all-zero band
      --eobrun;
      return 0;
    }
    const HuffTable& act = ac[c.ac_tbl];
    if (!act.present) return 30;
    const int32_t* zig = c.zigoff;
    for (int k = scan.ss; k <= scan.se; ++k) {
      if (br.nbits < 26) br.fill();
      int rs = huff_decode(br, act);
      if (rs < 0) return 32;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        if (s > 10) return 34;
        k += r;
        if (k > scan.se) return 33;
        int v = extend(br.get_bits_nofill(s), s);
        blk[zig[k]] = static_cast<int16_t>(
            static_cast<unsigned>(v) << scan.al);
      } else {
        if (r != 15) {  // EOBr: run of 2^r + appended bits blocks
          eobrun = 1u << r;
          if (r) eobrun += static_cast<unsigned>(br.get_bits(r));
          --eobrun;  // this block is a member of the run
          break;
        }
        k += 15;  // ZRL
      }
    }
    return 0;
  }

  int decode_ac_refine_block(BitReader& br, Component& c, int16_t* blk) {
    const HuffTable& act = ac[c.ac_tbl];
    if (!act.present) return 30;
    const int p1 = 1 << scan.al;
    const int m1 = -(1 << scan.al);
    const int32_t* zig = c.zigoff;
    int k = scan.ss;
    if (eobrun == 0) {
      for (; k <= scan.se; ++k) {
        if (br.nbits < 26) br.fill();
        int rs = huff_decode(br, act);
        if (rs < 0) return 32;
        int r = rs >> 4, s = rs & 15;
        int val = 0;
        if (s) {
          if (s != 1) return 34;  // a newly-nonzero coef is always +-1
          val = br.get_bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1u << r;
          if (r) eobrun += static_cast<unsigned>(br.get_bits(r));
          break;  // rest of the band handled by the EOB logic below
        }
        // Advance over already-nonzero coefs (appending correction
        // bits) and r still-zero coefs, to the target zero position.
        while (k <= scan.se) {
          int16_t* coefp = blk + zig[k];
          if (*coefp != 0) {
            if (br.get_bits(1)) {
              if ((*coefp & p1) == 0)
                *coefp = static_cast<int16_t>(
                    *coefp + (*coefp >= 0 ? p1 : m1));
            }
          } else {
            if (--r < 0) break;
          }
          ++k;
        }
        if (val) {
          if (k > scan.se) return 33;
          blk[zig[k]] = static_cast<int16_t>(val);
        }
      }
    }
    if (eobrun > 0) {
      // Append correction bits to the remaining nonzero coefs of a
      // block inside the EOB run.
      for (; k <= scan.se; ++k) {
        int16_t* coefp = blk + zig[k];
        if (*coefp != 0) {
          if (br.get_bits(1)) {
            if ((*coefp & p1) == 0)
              *coefp = static_cast<int16_t>(
                  *coefp + (*coefp >= 0 ? p1 : m1));
          }
        }
      }
      --eobrun;
    }
    return 0;
  }

  int decode_progressive_scan() {
    BitReader br{data + pos, data + len};
    eobrun = 0;
    for (int c = 0; c < ncomp; ++c) comp[c].pred = 0;
    const int mcus_x = (width + hmax * 8 - 1) / (hmax * 8);
    const int mcus_y = (height + vmax * 8 - 1) / (vmax * 8);
    const bool interleaved = scan.ncomps > 1;
    Component& sc = comp[scan.idx[0]];
    int units, ux;
    if (interleaved) {
      units = mcus_x * mcus_y;
      ux = mcus_x;
    } else {
      // Non-interleaved geometry: the component's OWN block grid
      // (T.81 A.2.2), which can be smaller than the MCU-aligned
      // output plane; writes use the plane stride.
      const int sw = (width * sc.h + hmax - 1) / hmax;
      const int sh = (height * sc.v + vmax - 1) / vmax;
      ux = (sw + 7) / 8;
      units = ux * ((sh + 7) / 8);
    }
    int until_rst = restart_interval ? restart_interval : units + 1;
    for (int u = 0; u < units; ++u) {
      if (interleaved) {  // interleaved scans are DC scans (ss == 0)
        const int my = u / ux, mx = u % ux;
        for (int s = 0; s < scan.ncomps; ++s) {
          Component& cc = comp[scan.idx[s]];
          const int stride = cc.bw * 8;
          for (int v = 0; v < cc.v; ++v) {
            for (int h = 0; h < cc.h; ++h) {
              const int bx = mx * cc.h + h;
              const int by = my * cc.v + v;
              int16_t* blk = cc.out
                  + static_cast<size_t>(by) * 8 * stride
                  + static_cast<size_t>(bx) * 8;
              int rc = decode_prog_dc_block(br, cc, blk);
              if (rc != 0) return rc;
            }
          }
        }
      } else {
        const int by = u / ux, bx = u % ux;
        const int stride = sc.bw * 8;
        int16_t* blk = sc.out
            + static_cast<size_t>(by) * 8 * stride
            + static_cast<size_t>(bx) * 8;
        int rc = (scan.ss == 0)
            ? decode_prog_dc_block(br, sc, blk)
            : (scan.ah == 0 ? decode_ac_first_block(br, sc, blk)
                            : decode_ac_refine_block(br, sc, blk));
        if (rc != 0) return rc;
      }
      if (--until_rst == 0 && u != units - 1) {
        if (!br.saw_marker) br.fill();
        if (br.saw_marker && br.marker >= 0xD0 && br.marker <= 0xD7) {
          br.p += 1;
          br.align_and_clear_marker();
        } else {
          return 34;
        }
        for (int c = 0; c < ncomp; ++c) comp[c].pred = 0;
        eobrun = 0;
        until_rst = restart_interval;
      }
    }
    return 0;
  }

  // Decode the whole file: one scan for baseline, the full scan script
  // for progressive (headers already parsed to the first SOS).
  int decode_all() {
    if (!progressive) return decode_scan();
    while (true) {
      int rc = decode_progressive_scan();
      if (rc != 0) return rc;
      pos = find_scan_end(pos);
      rc = parse_next_scan();
      if (rc == 1) return 0;
      if (rc != 0) return rc;
    }
  }
};

}  // namespace

extern "C" {

// MCU-aligned plane dims (blocks) for the streaming decoder's output.
int ip_jpeg_scan_dims(const uint8_t* data, size_t len, int* ncomp,
                      int* img_w, int* img_h,
                      int* comp_bw, int* comp_bh,
                      int* h_samp, int* v_samp) {
  Decoder d{data, len};
  int rc = d.parse_headers();
  if (rc != 0) return rc;
  *ncomp = d.ncomp;
  *img_w = d.width;
  *img_h = d.height;
  const int mcus_x = (d.width + d.hmax * 8 - 1) / (d.hmax * 8);
  const int mcus_y = (d.height + d.vmax * 8 - 1) / (d.vmax * 8);
  for (int c = 0; c < d.ncomp; ++c) {
    comp_bw[c] = mcus_x * d.comp[c].h;
    comp_bh[c] = mcus_y * d.comp[c].v;
    h_samp[c] = d.comp[c].h;
    v_samp[c] = d.comp[c].v;
  }
  return 0;
}

// Quant tables per component (natural order), header parse only.
int ip_jpeg_scan_qtabs(const uint8_t* data, size_t len,
                       uint16_t* qt /* 3*64 */) {
  Decoder d{data, len};
  int rc = d.parse_headers();
  if (rc != 0) return rc;
  for (int c = 0; c < d.ncomp; ++c)
    memcpy(qt + c * 64, d.qtab[d.comp[c].tq], 64 * sizeof(uint16_t));
  return 0;
}

// Streaming entropy decode into caller planes (natural order, spatial
// block layout, MCU-aligned dims from ip_jpeg_scan_dims). Planes MUST be
// zero-initialized: only non-zero coefficients are written.
int ip_jpeg_scan_coefs(const uint8_t* data, size_t len,
                       int16_t* coef0, int16_t* coef1, int16_t* coef2) {
  Decoder d{data, len};
  int rc = d.parse_headers();
  if (rc != 0) return rc;
  const int mcus_x = (d.width + d.hmax * 8 - 1) / (d.hmax * 8);
  int16_t* outs[3] = {coef0, coef1, coef2};
  for (int c = 0; c < d.ncomp; ++c) {
    d.comp[c].out = outs[c];
    d.comp[c].bw = mcus_x * d.comp[c].h;
    d.comp[c].build_zigoff();
    if (outs[c] == nullptr) return 40;
  }
  return d.decode_all();
}

// Streaming entropy decode + splice-support recording: per-MCU bit
// offsets into a destuffed copy of the scan's entropy data — the
// inputs ip_jpeg_emit_transcode needs to copy untouched MCUs
// bit-for-bit. Gated to single-scan baseline streams WITHOUT restart
// markers (restarts byte-align and reset predictors, which the splice
// emitter does not model; progressive scans interleave coefficients
// across the file). Returns 50 for progressive, 51 for restart-marked
// streams — callers fall back to the plain scan + full re-encode.
//
// destuff must hold >= len + 8 bytes (the splice emitter bulk-reads
// 8-byte windows; destuffed data is <= len). mcu_bits must hold
// nmcus + 1 int64 entries: the bit offset of each MCU's first code
// plus the total consumed bit count. *destuff_bits receives the real
// destuffed bit count; a well-formed stream has
// mcu_bits[nmcus] <= *destuff_bits (callers must verify — a truncated
// stream decodes against synthetic zero-fill past that point).
int ip_jpeg_scan_coefs_offsets(const uint8_t* data, size_t len,
                               int16_t* coef0, int16_t* coef1,
                               int16_t* coef2,
                               uint8_t* destuff, size_t destuff_cap,
                               int64_t* mcu_bits, int64_t* destuff_bits) {
  Decoder d{data, len};
  int rc = d.parse_headers();
  if (rc != 0) return rc;
  if (d.progressive) return 50;
  if (d.restart_interval > 0) return 51;
  if (destuff == nullptr || mcu_bits == nullptr || destuff_bits == nullptr)
    return 40;
  const int mcus_x = (d.width + d.hmax * 8 - 1) / (d.hmax * 8);
  int16_t* outs[3] = {coef0, coef1, coef2};
  for (int c = 0; c < d.ncomp; ++c) {
    d.comp[c].out = outs[c];
    d.comp[c].bw = mcus_x * d.comp[c].h;
    d.comp[c].build_zigoff();
    if (outs[c] == nullptr) return 40;
  }
  d.rec_mcu = mcu_bits;
  d.rec_dump = destuff;
  d.rec_cap = static_cast<int64_t>(destuff_cap);
  rc = d.decode_scan();
  *destuff_bits = d.rec_real_bits;
  return rc;
}

// Restart-capable variant: additionally records each restart segment's
// true end bit (before byte-align padding) into seg_end_bits, which
// must hold ceil(nmcus / DRI) - 1 entries when the stream declares a
// restart interval (the FINAL segment's end is mcu_bits[nmcus]); pass
// nullptr for streams without one. The destuff buffer needs extra
// headroom with restarts: each boundary can append up to 8 synthetic
// zero bytes to the dump (size for len + 8 * nsegments + 64). Returns
// 35 when the dump overflowed destuff_cap.
int ip_jpeg_scan_coefs_offsets_rst(const uint8_t* data, size_t len,
                                   int16_t* coef0, int16_t* coef1,
                                   int16_t* coef2,
                                   uint8_t* destuff, size_t destuff_cap,
                                   int64_t* mcu_bits,
                                   int64_t* destuff_bits,
                                   int64_t* seg_end_bits) {
  Decoder d{data, len};
  int rc = d.parse_headers();
  if (rc != 0) return rc;
  if (d.progressive) return 50;
  if (d.restart_interval > 0 && seg_end_bits == nullptr) return 51;
  if (destuff == nullptr || mcu_bits == nullptr || destuff_bits == nullptr)
    return 40;
  const int mcus_x = (d.width + d.hmax * 8 - 1) / (d.hmax * 8);
  int16_t* outs[3] = {coef0, coef1, coef2};
  for (int c = 0; c < d.ncomp; ++c) {
    d.comp[c].out = outs[c];
    d.comp[c].bw = mcus_x * d.comp[c].h;
    d.comp[c].build_zigoff();
    if (outs[c] == nullptr) return 40;
  }
  d.rec_mcu = mcu_bits;
  d.rec_dump = destuff;
  d.rec_cap = static_cast<int64_t>(destuff_cap);
  d.rec_seg = seg_end_bits;
  rc = d.decode_scan();
  *destuff_bits = d.rec_real_bits;
  return rc;
}

// Entropy-coding headers for the splice emitter: per-component ids /
// quant-table slots / DC+AC table ids, the raw DHT specs (8 tables:
// dc0..3 then ac0..3; bits[0] unused), quant tables per SLOT in
// natural order, DRI and the progressive flag. Header parse only.
int ip_jpeg_scan_tables(const uint8_t* data, size_t len,
                        int* ncomp_out,
                        uint8_t* comp_id /*3*/, uint8_t* comp_tq /*3*/,
                        uint8_t* comp_dc /*3*/, uint8_t* comp_ac /*3*/,
                        uint8_t* dht_bits /*8*17*/,
                        uint8_t* dht_vals /*8*256*/,
                        uint8_t* dht_present /*8*/,
                        uint16_t* qt /*4*64 natural*/,
                        int* restart_interval_out, int* progressive_out) {
  Decoder d{data, len};
  int rc = d.parse_headers();
  if (rc != 0) return rc;
  *ncomp_out = d.ncomp;
  *restart_interval_out = d.restart_interval;
  *progressive_out = d.progressive ? 1 : 0;
  for (int c = 0; c < d.ncomp; ++c) {
    comp_id[c] = static_cast<uint8_t>(d.comp[c].id);
    comp_tq[c] = static_cast<uint8_t>(d.comp[c].tq);
    comp_dc[c] = static_cast<uint8_t>(d.comp[c].dc_tbl);
    comp_ac[c] = static_cast<uint8_t>(d.comp[c].ac_tbl);
  }
  for (int t = 0; t < 8; ++t) {
    const HuffTable& h = (t < 4) ? d.dc[t] : d.ac[t - 4];
    dht_present[t] = h.present ? 1 : 0;
    memcpy(dht_bits + t * 17, h.spec_bits, 17);
    memset(dht_vals + t * 256, 0, 256);
    if (h.present)
      memcpy(dht_vals + t * 256, h.values,
             static_cast<size_t>(h.spec_nvals));
  }
  memcpy(qt, d.qtab, sizeof(d.qtab));
  return 0;
}

// Multithreaded streaming entropy decode. The stream must carry restart
// markers (DRI > 0) — each restart segment's entropy data is fully
// independent (byte-aligned start, predictors reset), so segments decode
// in parallel with no synchronization beyond the join; every segment
// writes a disjoint set of output blocks. Falls back to the sequential
// path when the stream has no restarts or nthreads <= 1.
int ip_jpeg_scan_coefs_mt(const uint8_t* data, size_t len, int nthreads,
                          int16_t* coef0, int16_t* coef1, int16_t* coef2) {
  Decoder d{data, len};
  int rc = d.parse_headers();
  if (rc != 0) return rc;
  const int mcus_x = (d.width + d.hmax * 8 - 1) / (d.hmax * 8);
  const int mcus_y = (d.height + d.vmax * 8 - 1) / (d.vmax * 8);
  const int total = mcus_x * mcus_y;
  int16_t* outs[3] = {coef0, coef1, coef2};
  for (int c = 0; c < d.ncomp; ++c) {
    d.comp[c].out = outs[c];
    d.comp[c].bw = mcus_x * d.comp[c].h;
    d.comp[c].build_zigoff();
    if (outs[c] == nullptr) return 40;
  }
  const int ri = d.restart_interval;
  // Progressive files run the sequential multi-scan path: the restart-
  // segment parallelism below assumes one scan covering all MCUs.
  if (d.progressive || ri <= 0 || nthreads <= 1) return d.decode_all();

  // Segment k starts at offset[k] and covers MCUs [k*ri, ...). Offsets
  // come from a raw byte scan for RSTn markers: inside entropy data a
  // 0xFF is either stuffed (0x00 follows) or starts a marker, so the
  // scan cannot false-positive.
  const int nseg = (total + ri - 1) / ri;
  std::vector<size_t> seg_off;
  seg_off.reserve(static_cast<size_t>(nseg));
  seg_off.push_back(d.pos);
  for (size_t i = d.pos; i + 1 < len
       && seg_off.size() < static_cast<size_t>(nseg); ++i) {
    if (data[i] == 0xFF) {
      const uint8_t m = data[i + 1];
      if (m >= 0xD0 && m <= 0xD7) {
        seg_off.push_back(i + 2);
        ++i;
      } else if (m != 0x00 && m != 0xFF) {
        break;  // EOI or another marker: no more segments
      }
    }
  }
  if (seg_off.size() != static_cast<size_t>(nseg)) return d.decode_scan();

  int T = nthreads;
  const int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw > 0 && T > hw) T = hw;
  if (T > nseg) T = nseg;
  if (T <= 1) return d.decode_scan();

  std::vector<int> rcs(static_cast<size_t>(T), 0);
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(T));
  for (int t = 0; t < T; ++t) {
    threads.emplace_back([&, t]() {
      // Each worker gets its own Decoder copy (tables are a few KB) so
      // per-component DC predictors are thread-local.
      Decoder local = d;
      for (int k = t; k < nseg; k += T) {
        for (int c = 0; c < local.ncomp; ++c) local.comp[c].pred = 0;
        BitReader br{data + seg_off[static_cast<size_t>(k)], data + len};
        const int begin = k * ri;
        const int end = begin + ri < total ? begin + ri : total;
        int r = local.decode_mcu_range(br, begin, end);
        if (r != 0) {
          rcs[static_cast<size_t>(t)] = r;
          return;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < T; ++t)
    if (rcs[static_cast<size_t>(t)] != 0) return rcs[static_cast<size_t>(t)];
  return 0;
}


// Round-5 probe entry (see Decoder::decode_scan_ilp): single-core
// interleaved-lane decode over restart segments. Throughput-NEGATIVE
// on the dev host (0.80x at W=2) — committed so the measurement is
// reproducible and wider production cores can re-A/B it. Falls back
// to the sequential scan for non-restart/progressive streams or
// nlanes <= 1.
int ip_jpeg_scan_coefs_ilp(const uint8_t* data, size_t len, int nlanes,
                           int16_t* coef0, int16_t* coef1, int16_t* coef2) {
  Decoder d{data, len};
  int rc = d.parse_headers();
  if (rc != 0) return rc;
  const int mcus_x = (d.width + d.hmax * 8 - 1) / (d.hmax * 8);
  const int mcus_y = (d.height + d.vmax * 8 - 1) / (d.vmax * 8);
  const int total = mcus_x * mcus_y;
  int16_t* outs[3] = {coef0, coef1, coef2};
  for (int c = 0; c < d.ncomp; ++c) {
    d.comp[c].out = outs[c];
    d.comp[c].bw = mcus_x * d.comp[c].h;
    d.comp[c].build_zigoff();
    if (outs[c] == nullptr) return 40;
  }
  const int ri = d.restart_interval;
  if (d.progressive || ri <= 0 || nlanes <= 1) return d.decode_scan();
  const int nseg = (total + ri - 1) / ri;
  std::vector<size_t> seg_off;
  seg_off.reserve(static_cast<size_t>(nseg));
  seg_off.push_back(d.pos);
  for (size_t i = d.pos; i + 1 < len
       && seg_off.size() < static_cast<size_t>(nseg); ++i) {
    if (data[i] == 0xFF) {
      const uint8_t m = data[i + 1];
      if (m >= 0xD0 && m <= 0xD7) {
        seg_off.push_back(i + 2);
        ++i;
      } else if (m != 0x00 && m != 0xFF) {
        break;
      }
    }
  }
  if (seg_off.size() != static_cast<size_t>(nseg)) return d.decode_scan();
  return d.decode_scan_ilp(nlanes, seg_off, ri, total);
}

}  // extern "C"
