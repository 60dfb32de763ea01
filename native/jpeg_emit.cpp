// jpeg_emit — streaming baseline-JPEG entropy ENCODER.
//
// Mirror of jpeg_scan.cpp: takes quantized DCT coefficient planes
// (natural order, spatial block layout, MCU-aligned dims — exactly what
// the device-side FDCT+quantize in ops/jpeg_encode.py produces) and
// emits a complete JFIF stream with the Annex K Huffman tables (the
// same defaults libjpeg and Go's image/jpeg use; reference behavior:
// internal/usecase/image_processor.go encodes via image/jpeg at q85).
// With this, the host-side cost of JPEG encode is the entropy pass
// alone; all dense math (color convert, downsample, FDCT, quantize)
// runs on the device.
//
// Round-trip property (tested): ip_jpeg_scan_coefs(ip_jpeg_emit(P)) == P
// bit-exactly, for any coefficient planes in range.

#include <cstdint>
#include <cstring>

#include <algorithm>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif
#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K (K.3.3) Huffman table specs: BITS + HUFFVAL.
constexpr uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1,
                                    0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kDcLumVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kDcChrVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5,
                                    5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
    0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
    0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24,
    0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53,
    0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66,
    0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93,
    0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7,
    0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7,
                                    5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
    0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
    0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15,
    0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17,
    0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a,
    0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65,
    0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a,
    0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5,
    0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9,
    0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  // (size << 20) | code per symbol: one load serves both fields.
  uint32_t e[256];

  uint32_t code(int sym) const { return e[sym] & 0xFFFFF; }
  int size(int sym) const { return static_cast<int>(e[sym] >> 20); }

  void build(const uint8_t* bits, const uint8_t* vals, int nvals) {
    memset(e, 0, sizeof(e));
    int k = 0;
    uint32_t c = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k, ++c)
        e[vals[k]] = (static_cast<uint32_t>(l) << 20) | c;
      c <<= 1;
    }
    (void)nvals;
  }
};

struct BitWriter {
  // __restrict: uint8_t may legally alias anything, so without it every
  // out[] store forces acc/nbits/pos reloads in the hot bit loop.
  uint8_t* __restrict out;
  size_t cap;
  size_t pos = 0;
#if defined(__SIZEOF_INT128__)
  // 128-bit accumulator: a fused code+value write is <=27 bits, so a
  // 64-bit acc must flush 32 bits as soon as 32 are pending (pre-add
  // headroom), i.e. every ~5 symbols. With 128 bits of headroom the
  // flush runs half as often and stores 8 bytes per branch-free check.
  unsigned __int128 acc = 0;  // pending bits in the TOP `nbits` bits
#else
  uint64_t acc64 = 0;
#endif
  int nbits = 0;
  bool overflow = false;

  void put_byte(uint8_t b) {
    if (pos >= cap) {
      overflow = true;
      return;
    }
    out[pos++] = b;
  }

#if defined(__SIZEOF_INT128__)
  // Up-to-63-bit write: encode_block batches several fused code+value
  // symbols into one local 64-bit accumulator and hands them over in
  // one call — one 128-bit shift + one flush check per ~2.5 symbols
  // instead of per symbol.
  void put_bits64(uint64_t v, int n) {
    acc |= static_cast<unsigned __int128>(v) << (128 - nbits - n);
    nbits += n;
    if (nbits >= 64) flush64();
  }

  void flush64() {  // emit the top 64 buffered bits
    const uint64_t top = static_cast<uint64_t>(acc >> 64);
    const uint64_t inv = ~top;  // 0xFF byte <=> zero byte in ~top
    if (((inv - 0x0101010101010101ull) & ~inv
         & 0x8080808080808080ull) == 0
        && pos + 8 <= cap) {
      // no stuffing needed: one big-endian word store
      const uint64_t be = __builtin_bswap64(top);
      memcpy(out + pos, &be, 8);
      pos += 8;
    } else {
      for (int i = 56; i >= 0; i -= 8) {
        const uint8_t b = static_cast<uint8_t>(top >> i);
        put_byte(b);
        if (b == 0xFF) put_byte(0x00);
      }
    }
    acc <<= 64;
    nbits -= 64;
  }

  // v holds the code in its low n bits; n <= 31 (a fused Huffman code +
  // value pair is at most 16 + 11 bits).
  void put_bits(uint32_t v, int n) {
    acc |= static_cast<unsigned __int128>(v) << (128 - nbits - n);
    nbits += n;
    if (nbits >= 64) flush64();
  }

  void flush_scan() {  // pad final partial byte with 1s (spec F.1.2.3)
    if (nbits & 7) put_bits((1u << (8 - (nbits & 7))) - 1, 8 - (nbits & 7));
    while (nbits >= 64) flush64();
    while (nbits >= 8) {
      const uint8_t b = static_cast<uint8_t>(acc >> 120);
      put_byte(b);
      if (b == 0xFF) put_byte(0x00);
      acc <<= 8;
      nbits -= 8;
    }
  }
#else
  void flush32() {  // emit the top 32 buffered bits
    const uint32_t top = static_cast<uint32_t>(acc64 >> 32);
    const uint32_t inv = ~top;  // 0xFF byte <=> zero byte in ~top
    if (((inv - 0x01010101u) & ~inv & 0x80808080u) == 0
        && pos + 4 <= cap) {
      // no stuffing needed: one big-endian word store
      const uint32_t be = __builtin_bswap32(top);
      memcpy(out + pos, &be, 4);
      pos += 4;
    } else {
      for (int i = 24; i >= 0; i -= 8) {
        const uint8_t b = static_cast<uint8_t>(top >> i);
        put_byte(b);
        if (b == 0xFF) put_byte(0x00);
      }
    }
    acc64 <<= 32;
    nbits -= 32;
  }

  void put_bits(uint32_t v, int n) {
    acc64 |= static_cast<uint64_t>(v) << (64 - nbits - n);
    nbits += n;
    if (nbits >= 32) flush32();
  }

  void put_bits64(uint64_t v, int n) {  // <= 63 bits, split writes
    if (n > 31) {
      put_bits(static_cast<uint32_t>(v >> 31), n - 31);
      n = 31;
      v &= 0x7FFFFFFFull;
    }
    put_bits(static_cast<uint32_t>(v), n);
  }

  void flush_scan() {
    if (nbits & 7) put_bits((1u << (8 - (nbits & 7))) - 1, 8 - (nbits & 7));
    while (nbits >= 32) flush32();
    while (nbits >= 8) {
      const uint8_t b = static_cast<uint8_t>(acc64 >> 56);
      put_byte(b);
      if (b == 0xFF) put_byte(0x00);
      acc64 <<= 8;
      nbits -= 8;
    }
  }
#endif
};

inline int bit_length(int v) {  // category of |v| (v >= 0)
  return v ? 32 - __builtin_clz(static_cast<unsigned>(v)) : 0;
}

// Row-byte -> zigzag-position-mask tables: row r's non-zero byte mask b
// contributes RowZig[r][b] to the block's zigzag non-zero bitmask. Eight
// cache-resident lookups replace a 64-iteration gather+mask loop.
struct RowZigTables {
  uint64_t t[8][256];

  RowZigTables() {
    int nat2zig[64];
    for (int k = 0; k < 64; ++k) nat2zig[kZigzag[k]] = k;
    for (int r = 0; r < 8; ++r) {
      for (int b = 0; b < 256; ++b) {
        uint64_t m = 0;
        for (int i = 0; i < 8; ++i)
          if (b & (1 << i)) m |= 1ull << nat2zig[r * 8 + i];
        t[r][b] = m;
      }
    }
  }
};
const RowZigTables kRowZig;

struct CompSpec {
  const int16_t* coef;
  int bw;  // plane width in blocks (MCU-aligned)
  long stride;  // row stride in elements (>= bw * 8)
  int h, v;
  int dc_tbl, ac_tbl;  // 0 = luma tables, 1 = chroma tables
  int pred;
};

void encode_block(BitWriter& bw, const int16_t* blk, int stride,
                  const EncTable& dct, const EncTable& act, int& pred) {
  // Stage the block contiguously and build the zigzag-order non-zero
  // bitmask: SIMD zero-compare per row + the RowZig lookup tables. The
  // emit loop then visits only set bits instead of scanning all 63 AC
  // slots (typical blocks have ~10 non-zeros).
  int16_t nat[64];
  uint64_t nzmask = 0;
#if defined(__AVX2__) && defined(__BMI2__)
  // Two rows per 256-bit op; PEXT compacts the 32-bit epi8 movemask's
  // even bits into the two per-row non-zero bytes in one instruction.
  const __m256i zero256 = _mm256_setzero_si256();
  const __m256i lo256 = _mm256_set1_epi16(-1023);
  const __m256i hi256 = _mm256_set1_epi16(1023);
  for (int r = 0; r < 8; r += 2) {
    __m256i v = _mm256_inserti128_si256(
        _mm256_castsi128_si256(_mm_loadu_si128(
            reinterpret_cast<const __m128i*>(
                blk + static_cast<size_t>(r) * stride))),
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(
            blk + static_cast<size_t>(r + 1) * stride)),
        1);
    // Clamp to the baseline-representable range (see the SSE2 path).
    v = _mm256_max_epi16(_mm256_min_epi16(v, hi256), lo256);
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(nat + r * 8), v);
    const uint32_t mm = ~static_cast<uint32_t>(
        _mm256_movemask_epi8(_mm256_cmpeq_epi16(v, zero256)));
    const uint32_t rows = _pext_u32(mm, 0x55555555u);
    nzmask |= kRowZig.t[r][rows & 0xFF] | kRowZig.t[r + 1][rows >> 8];
  }
#elif defined(__SSE2__)
  const __m128i zero = _mm_setzero_si128();
  for (int r = 0; r < 8; ++r) {
    __m128i v = _mm_loadu_si128(reinterpret_cast<const __m128i*>(
        blk + static_cast<size_t>(r) * stride));
    // Clamp to the baseline-representable range: an out-of-range
    // coefficient (|v| > 1023; possible only from invalid caller
    // input) would index Huffman categories the tables don't
    // populate, emitting orphan bits and a silently corrupt stream.
    // Post-clamp, AC magnitudes stay <= 1023 (category <= 10) and DC
    // diffs <= 2046 (category <= 11) — always encodable.
    v = _mm_max_epi16(_mm_min_epi16(v, _mm_set1_epi16(1023)),
                      _mm_set1_epi16(-1023));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(nat + r * 8), v);
    // movemask gives 2 bits per int16 lane (set where the lane is 0);
    // invert and compact the even bits into a per-row non-zero byte.
    uint32_t mm = ~static_cast<uint32_t>(
        _mm_movemask_epi8(_mm_cmpeq_epi16(v, zero))) & 0xFFFFu;
    mm &= 0x5555u;
    mm = (mm | (mm >> 1)) & 0x3333u;
    mm = (mm | (mm >> 2)) & 0x0F0Fu;
    mm = (mm | (mm >> 4)) & 0x00FFu;
    nzmask |= kRowZig.t[r][mm];
  }
#else
  for (int r = 0; r < 8; ++r) {
    memcpy(nat + r * 8, blk + static_cast<size_t>(r) * stride,
           8 * sizeof(int16_t));
    uint32_t mm = 0;
    for (int i = 0; i < 8; ++i) {
      int16_t& c = nat[r * 8 + i];
      // see the SSE path: clamp keeps every symbol table-encodable
      if (c > 1023) c = 1023;
      if (c < -1023) c = -1023;
      mm |= static_cast<uint32_t>(c != 0) << i;
    }
    nzmask |= kRowZig.t[r][mm];
  }
#endif
  // Symbols accumulate into a local 64-bit buffer first (a fused
  // code+value pair is <= 27 bits, so ~2.5 symbols fit) and reach the
  // BitWriter via one put_bits64 per flush — one 128-bit shift + one
  // flush check per batch instead of per symbol.
  uint64_t pv = 0;
  int pn = 0;
  const auto push = [&](uint32_t v, int n) {
    if (pn + n > 63) {
      bw.put_bits64(pv, pn);
      pv = 0;
      pn = 0;
    }
    pv = (pv << n) | v;
    pn += n;
  };
  // DC: category code + extend bits of the prediction difference,
  // fused into one bit write.
  // Branchless sign handling (F.1.2.1): for negative v the appended
  // bits are (v - 1) mod 2^s; (v + sign) ^ sign is |v|, (v + sign) is
  // the bits field for both signs.
  const int diff = nat[0] - pred;
  pred = nat[0];
  const int dsign = diff >> 31;
  int s = bit_length((diff + dsign) ^ dsign);
  uint32_t bits = static_cast<uint32_t>(diff + dsign) & ((1u << s) - 1);
  {
    const uint32_t de = dct.e[s];
    push(((de & 0xFFFFF) << s) | bits, static_cast<int>(de >> 20) + s);
  }
  // AC: iterate set bits; runs of zeros come from bit-position gaps.
  uint64_t m = nzmask & ~1ull;
  int prev = 0;
  while (m) {
    const int k = __builtin_ctzll(m);
    m &= m - 1;
    int run = k - prev - 1;
    prev = k;
    while (run > 15) {
      push(act.code(0xF0), act.size(0xF0));  // ZRL
      run -= 16;
    }
    const int v = nat[kZigzag[k]];
    const int vsign = v >> 31;
    s = bit_length((v + vsign) ^ vsign);
    const int rs = (run << 4) | s;
    bits = static_cast<uint32_t>(v + vsign) & ((1u << s) - 1);
    const uint32_t ae = act.e[rs];
    push(((ae & 0xFFFFF) << s) | bits, static_cast<int>(ae >> 20) + s);
  }
  if (prev != 63) push(act.code(0x00), act.size(0x00));  // EOB
  if (pn) bw.put_bits64(pv, pn);
}

// Checked block encoder for the splice path (ip_jpeg_emit_transcode):
// the INPUT stream's Huffman tables may be optimized (holding only the
// symbols the original image used), so a re-encoded watermark block can
// produce a (run, size) combination the tables cannot express — and the
// boundary blocks it re-symbolizes are ORIGINAL data that must round-trip
// exactly, so the fast path's ±1023 clamp is wrong here. This variant
// validates every symbol against the table (absent => false, caller
// falls back to a full re-encode) and never clamps; coefficient
// magnitudes are validated instead (AC category <= 10, DC diff
// category <= 11 — the baseline-representable ranges).
bool encode_block_checked(BitWriter& bw, const int16_t* blk, long stride,
                          const EncTable& dct, const EncTable& act,
                          int& pred) {
  int16_t nat[64];
  uint64_t nzmask = 0;
  for (int r = 0; r < 8; ++r) {
    memcpy(nat + r * 8, blk + static_cast<size_t>(r) * stride,
           8 * sizeof(int16_t));
    uint32_t mm = 0;
    for (int i = 0; i < 8; ++i)
      mm |= static_cast<uint32_t>(nat[r * 8 + i] != 0) << i;
    nzmask |= kRowZig.t[r][mm];
  }
  const int diff = nat[0] - pred;
  pred = nat[0];
  const int dsign = diff >> 31;
  int s = bit_length((diff + dsign) ^ dsign);
  if (s > 11 || dct.e[s] == 0) return false;
  uint32_t bits = static_cast<uint32_t>(diff + dsign) & ((1u << s) - 1);
  bw.put_bits(((dct.e[s] & 0xFFFFF) << s) | bits,
              static_cast<int>(dct.e[s] >> 20) + s);
  uint64_t m = nzmask & ~1ull;
  int prev = 0;
  while (m) {
    const int k = __builtin_ctzll(m);
    m &= m - 1;
    int run = k - prev - 1;
    prev = k;
    while (run > 15) {
      if (act.e[0xF0] == 0) return false;
      bw.put_bits(act.code(0xF0), act.size(0xF0));  // ZRL
      run -= 16;
    }
    const int v = nat[kZigzag[k]];
    const int vsign = v >> 31;
    s = bit_length((v + vsign) ^ vsign);
    if (s > 10) return false;
    const int rs = (run << 4) | s;
    if (act.e[rs] == 0) return false;
    bits = static_cast<uint32_t>(v + vsign) & ((1u << s) - 1);
    bw.put_bits(((act.e[rs] & 0xFFFFF) << s) | bits,
                static_cast<int>(act.e[rs] >> 20) + s);
  }
  if (prev != 63) {
    if (act.e[0x00] == 0) return false;
    bw.put_bits(act.code(0x00), act.size(0x00));  // EOB
  }
  return true;
}

// Append destuffed-source bits [b0, b1) to the writer. The source must
// be readable through byte (b1 - 1) / 8 + 8 (bulk 8-byte windows; the
// scanner's offsets API requires callers to over-allocate by 8).
void copy_bits(BitWriter& bw, const uint8_t* src, int64_t b0, int64_t b1) {
  int64_t bit = b0;
  int64_t n = b1 - b0;
  while (n > 0) {
    const int take = n > 48 ? 48 : static_cast<int>(n);
    uint64_t w;
    memcpy(&w, src + (bit >> 3), 8);
    w = __builtin_bswap64(w);
    const uint64_t v = (w << (bit & 7)) >> (64 - take);
    bw.put_bits64(v, take);
    bit += take;
    n -= take;
  }
}

// One interleave lane: an independent restart segment mid-encode.
// Restart segments are byte-aligned and reset DC predictors, so W
// segments can encode concurrently on ONE core — each lane's serial
// dependency chain (Huffman table load -> bit-accumulator shift ->
// next symbol) is independent, and the out-of-order window overlaps
// them where a single stream leaves most issue slots idle. Lanes write
// private scratch buffers that are spliced (already byte-stuffed)
// into the main stream in segment order, so the output is
// byte-identical to the sequential restart-interval path.
struct EmitLane {
  BitWriter bw;
  int preds[3];
  int m;      // next MCU index
  int m_end;  // one past the segment's last MCU
  int mx, my;
};

void emit_marker_segment(BitWriter& bw, uint8_t marker, const uint8_t* body,
                         int body_len) {
  bw.put_byte(0xFF);
  bw.put_byte(marker);
  const int seglen = body_len + 2;
  bw.put_byte(static_cast<uint8_t>(seglen >> 8));
  bw.put_byte(static_cast<uint8_t>(seglen & 0xFF));
  for (int i = 0; i < body_len; ++i) bw.put_byte(body[i]);
}

void emit_dht(BitWriter& bw, int tc, int th, const uint8_t* bits,
              const uint8_t* vals) {
  int nv = 0;
  for (int l = 1; l <= 16; ++l) nv += bits[l];
  uint8_t body[1 + 16 + 256];
  body[0] = static_cast<uint8_t>((tc << 4) | th);
  memcpy(body + 1, bits + 1, 16);
  memcpy(body + 17, vals, static_cast<size_t>(nv));
  emit_marker_segment(bw, 0xC4, body, 17 + nv);
}

// Emit a complete baseline JFIF stream from quantized coefficient
// planes (natural order, spatial block layout, MCU-aligned dims) and
// per-component quant tables (natural order). ncomp is 1 (grayscale)
// or 3 (YCbCr, sampling given per component; chroma must be 1x1 and
// share qtab[1]). Returns the byte count written, or a negative error.
// strideN: row stride of plane N in int16 ELEMENTS (0 = tight, i.e.
// the component's MCU-aligned grid width) — lets callers emit directly
// from per-image views into larger batch canvases without copies.
// interleave > 1 (requires restart_interval > 0) encodes that many
// restart segments concurrently on this core (see EmitLane); output is
// byte-identical to the sequential path at the same restart interval.
long emit_impl(const int16_t* coef0, const int16_t* coef1,
               const int16_t* coef2,
               const uint16_t* qtab /* 2*64 */,
               int img_w, int img_h, int ncomp, int h0, int v0,
               int restart_interval,
               long stride0, long stride1, long stride2,
               uint8_t* out, size_t out_cap, int interleave) {
  if (img_w <= 0 || img_h <= 0) return -1;
  if (ncomp != 1 && ncomp != 3) return -2;
  if (h0 < 1 || h0 > 2 || v0 < 1 || v0 > 2) return -3;
  if (restart_interval < 0 || restart_interval > 65535) return -6;
  const int hmax = (ncomp == 1) ? 1 : h0;
  const int vmax = (ncomp == 1) ? 1 : v0;
  const int mcus_x = (img_w + hmax * 8 - 1) / (hmax * 8);
  const int mcus_y = (img_h + vmax * 8 - 1) / (vmax * 8);

  BitWriter bw{out, out_cap};
  // SOI + JFIF APP0
  bw.put_byte(0xFF);
  bw.put_byte(0xD8);
  const uint8_t app0[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  emit_marker_segment(bw, 0xE0, app0, sizeof(app0));

  // DQT (zigzag order in the stream)
  const int ntab = (ncomp == 1) ? 1 : 2;
  for (int t = 0; t < ntab; ++t) {
    uint8_t body[65];
    body[0] = static_cast<uint8_t>(t);
    for (int k = 0; k < 64; ++k) {
      const int q = qtab[t * 64 + kZigzag[k]];
      body[1 + k] = static_cast<uint8_t>(q > 255 ? 255 : (q < 1 ? 1 : q));
    }
    emit_marker_segment(bw, 0xDB, body, 65);
  }

  // DRI
  if (restart_interval > 0) {
    const uint8_t dri[2] = {
        static_cast<uint8_t>(restart_interval >> 8),
        static_cast<uint8_t>(restart_interval & 0xFF)};
    emit_marker_segment(bw, 0xDD, dri, 2);
  }

  // SOF0
  {
    uint8_t body[2 + 1 + 4 + 3 * 3];
    int o = 0;
    body[o++] = 8;  // precision
    body[o++] = static_cast<uint8_t>(img_h >> 8);
    body[o++] = static_cast<uint8_t>(img_h & 0xFF);
    body[o++] = static_cast<uint8_t>(img_w >> 8);
    body[o++] = static_cast<uint8_t>(img_w & 0xFF);
    body[o++] = static_cast<uint8_t>(ncomp);
    for (int c = 0; c < ncomp; ++c) {
      body[o++] = static_cast<uint8_t>(c + 1);
      const int hh = (c == 0) ? h0 : 1;
      const int vv = (c == 0) ? v0 : 1;
      body[o++] = static_cast<uint8_t>((hh << 4) | vv);
      body[o++] = static_cast<uint8_t>(c == 0 ? 0 : 1);
    }
    emit_marker_segment(bw, 0xC0, body, o);
  }

  // DHT: luma DC/AC always; chroma DC/AC for color.
  emit_dht(bw, 0, 0, kDcLumBits, kDcLumVals);
  emit_dht(bw, 1, 0, kAcLumBits, kAcLumVals);
  if (ncomp == 3) {
    emit_dht(bw, 0, 1, kDcChrBits, kDcChrVals);
    emit_dht(bw, 1, 1, kAcChrBits, kAcChrVals);
  }

  // SOS
  {
    uint8_t body[1 + 3 * 2 + 3];
    int o = 0;
    body[o++] = static_cast<uint8_t>(ncomp);
    for (int c = 0; c < ncomp; ++c) {
      body[o++] = static_cast<uint8_t>(c + 1);
      body[o++] = static_cast<uint8_t>(c == 0 ? 0x00 : 0x11);
    }
    body[o++] = 0;     // Ss
    body[o++] = 63;    // Se
    body[o++] = 0;     // Ah/Al
    emit_marker_segment(bw, 0xDA, body, o);
  }

  EncTable dc_l, ac_l, dc_c, ac_c;
  dc_l.build(kDcLumBits, kDcLumVals, 12);
  ac_l.build(kAcLumBits, kAcLumVals, 162);
  dc_c.build(kDcChrBits, kDcChrVals, 12);
  ac_c.build(kAcChrBits, kAcChrVals, 162);

  CompSpec comp[3];
  const int16_t* planes[3] = {coef0, coef1, coef2};
  const long strides[3] = {stride0, stride1, stride2};
  for (int c = 0; c < ncomp; ++c) {
    comp[c].coef = planes[c];
    if (planes[c] == nullptr) return -4;
    comp[c].h = (c == 0) ? h0 : 1;
    comp[c].v = (c == 0) ? v0 : 1;
    comp[c].bw = mcus_x * comp[c].h;
    comp[c].stride = strides[c] > 0 ? strides[c] : comp[c].bw * 8;
    if (comp[c].stride < comp[c].bw * 8) return -7;
    comp[c].pred = 0;
  }
  if (ncomp == 1) {
    comp[0].h = comp[0].v = 1;
    comp[0].bw = mcus_x;
    comp[0].stride = stride0 > 0 ? stride0 : mcus_x * 8;
    if (comp[0].stride < mcus_x * 8) return -7;
  }

  const int total_mcus = mcus_x * mcus_y;
  if (restart_interval > 0 && interleave > 1) {
    const int ri = restart_interval;
    const int nseg = (total_mcus + ri - 1) / ri;
    int W = interleave;
    if (W > nseg) W = nseg;
    if (W > 8) W = 8;
    if (W > 1) {
      // Scratch capacity: one segment's worst case. A block emits at
      // most (16+11) DC + 63×(16+10) AC + EOB bits ≈ 209 bytes, ≤ 2×
      // with stuffing — 512 bytes/block is a safe ceiling.
      int bpm = 0;  // blocks per MCU
      for (int c = 0; c < ncomp; ++c) bpm += comp[c].h * comp[c].v;
      const size_t lane_cap =
          static_cast<size_t>(ri) * static_cast<size_t>(bpm) * 512 + 4096;
      std::vector<std::vector<uint8_t>> scratch(static_cast<size_t>(W));
      for (auto& s : scratch) s.resize(lane_cap);
      std::vector<EmitLane> lanes(static_cast<size_t>(W));
      int next_rst = 0;
      for (int seg0 = 0; seg0 < nseg; seg0 += W) {
        const int nl = std::min(W, nseg - seg0);
        for (int l = 0; l < nl; ++l) {
          EmitLane& L = lanes[static_cast<size_t>(l)];
          L.bw = BitWriter{scratch[static_cast<size_t>(l)].data(), lane_cap};
          L.preds[0] = L.preds[1] = L.preds[2] = 0;
          L.m = (seg0 + l) * ri;
          L.m_end = std::min(L.m + ri, total_mcus);
        }
        for (;;) {
          // Lanes with MCUs left this step (only the window's last
          // segment can run short).
          int idx[8];
          int live = 0;
          for (int l = 0; l < nl; ++l)
            if (lanes[static_cast<size_t>(l)].m
                < lanes[static_cast<size_t>(l)].m_end)
              idx[live++] = l;
          if (live == 0) break;
          for (int j = 0; j < live; ++j) {
            EmitLane& L = lanes[static_cast<size_t>(idx[j])];
            L.mx = L.m % mcus_x;
            L.my = L.m / mcus_x;
          }
          // Block-level round robin: geometry is uniform across lanes,
          // so adjacent encode_block calls run on independent bit
          // chains — the ILP the single-stream loop can't expose.
          for (int c = 0; c < ncomp; ++c) {
            CompSpec& cc = comp[c];
            const EncTable& dct = (c == 0) ? dc_l : dc_c;
            const EncTable& act = (c == 0) ? ac_l : ac_c;
            const long stride = cc.stride;
            for (int v = 0; v < cc.v; ++v) {
              for (int h = 0; h < cc.h; ++h) {
                for (int j = 0; j < live; ++j) {
                  EmitLane& L = lanes[static_cast<size_t>(idx[j])];
                  const int bx = L.mx * cc.h + h;
                  const int by = L.my * cc.v + v;
                  const int16_t* blk = cc.coef
                      + static_cast<size_t>(by) * 8 * stride
                      + static_cast<size_t>(bx) * 8;
                  encode_block(L.bw, blk, static_cast<int>(stride), dct,
                               act, L.preds[c]);
                }
              }
            }
          }
          for (int j = 0; j < live; ++j)
            ++lanes[static_cast<size_t>(idx[j])].m;
        }
        // Splice in segment order: lane bytes are already stuffed and
        // flush_scan byte-aligns with 1-padding, exactly like the
        // sequential path does before each RSTn.
        for (int l = 0; l < nl; ++l) {
          EmitLane& L = lanes[static_cast<size_t>(l)];
          L.bw.flush_scan();
          if (L.bw.overflow) return -5;
          if (bw.pos + L.bw.pos > out_cap) return -5;
          memcpy(out + bw.pos, scratch[static_cast<size_t>(l)].data(),
                 L.bw.pos);
          bw.pos += L.bw.pos;
          if (seg0 + l != nseg - 1) {
            bw.put_byte(0xFF);
            bw.put_byte(static_cast<uint8_t>(0xD0 + next_rst));
            next_rst = (next_rst + 1) & 7;
          }
        }
      }
      bw.put_byte(0xFF);
      bw.put_byte(0xD9);  // EOI
      if (bw.overflow) return -5;
      return static_cast<long>(bw.pos);
    }
  }

  int mcus_until_restart =
      restart_interval ? restart_interval : total_mcus + 1;
  int next_rst = 0;
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      for (int c = 0; c < ncomp; ++c) {
        CompSpec& cc = comp[c];
        const EncTable& dct = (c == 0) ? dc_l : dc_c;
        const EncTable& act = (c == 0) ? ac_l : ac_c;
        const long stride = cc.stride;
        for (int v = 0; v < cc.v; ++v) {
          for (int h = 0; h < cc.h; ++h) {
            const int bx = mx * cc.h + h;
            const int by = my * cc.v + v;
            const int16_t* blk = cc.coef
                + static_cast<size_t>(by) * 8 * stride
                + static_cast<size_t>(bx) * 8;
            encode_block(bw, blk, static_cast<int>(stride), dct, act,
                         cc.pred);
          }
        }
      }
      if (--mcus_until_restart == 0
          && !(my == mcus_y - 1 && mx == mcus_x - 1)) {
        bw.flush_scan();  // byte-align with 1-padding
        bw.put_byte(0xFF);
        bw.put_byte(static_cast<uint8_t>(0xD0 + next_rst));
        next_rst = (next_rst + 1) & 7;
        for (int c = 0; c < ncomp; ++c) comp[c].pred = 0;
        mcus_until_restart = restart_interval;
      }
    }
  }
  bw.flush_scan();
  bw.put_byte(0xFF);
  bw.put_byte(0xD9);  // EOI
  if (bw.overflow) return -5;
  return static_cast<long>(bw.pos);
}

// Splice emitter: rebuild a baseline JPEG from (possibly modified)
// coefficient planes, COPYING the original entropy stream's bit spans
// for untouched MCUs instead of re-symbolizing them. Huffman coding is
// bit-serial, but with the input's own Huffman + quant tables
// re-declared in the output headers, an untouched MCU's coded bits are
// identical except for byte alignment (handled by the shifting copy)
// and the DC prediction chain (handled by re-symbolizing the first MCU
// after every re-encoded region — all later DC diffs difference two
// unchanged values). This turns the ~23 ms full-image entropy emit
// into a ~1-2 ms memcpy-with-bit-shift plus the edited region, the
// jpegtran-style lossless-region edit applied to watermarking.
//
// Inputs come from ip_jpeg_scan_coefs_offsets / ip_jpeg_scan_tables:
// coefficient planes (natural order, spatial block layout, MCU-aligned
// dims), the destuffed entropy stream + per-MCU bit offsets, the raw
// DHT specs and table/quant-slot assignments, and a per-MCU reenc flag
// (1 = the caller changed this MCU's coefficients; its bits are
// re-symbolized from the planes).
//
// Errors (negative): -5 output overflow, -8 a referenced Huffman/quant
// table is absent, -9 a re-encoded block needs a symbol the input's
// (possibly optimized) tables cannot express or is out of baseline
// range, -10 inconsistent offsets, -11 bad geometry/params. Callers
// fall back to the full re-encode path on any error.
long emit_transcode_impl(
    const int16_t* const* planes, const long* strides,
    const uint16_t* qt, const uint8_t* comp_tq, const uint8_t* comp_id,
    const uint8_t* comp_dc, const uint8_t* comp_ac,
    const uint8_t* dht_bits, const uint8_t* dht_vals,
    const uint8_t* dht_present,
    int img_w, int img_h, int ncomp,
    const uint8_t* samp_h, const uint8_t* samp_v,
    const uint8_t* destuff, int64_t destuff_bits,
    const int64_t* mcu_bits, const uint8_t* reenc,
    uint8_t* out, size_t out_cap,
    int restart_interval, const int64_t* seg_end_bits) {
  if (img_w <= 0 || img_h <= 0) return -11;
  if (ncomp != 1 && ncomp != 3) return -11;
  if (restart_interval < 0 || restart_interval > 65535) return -11;
  if (restart_interval > 0 && seg_end_bits == nullptr) return -11;
  int hmax = 1, vmax = 1;
  int h[3], v[3];
  for (int c = 0; c < ncomp; ++c) {
    h[c] = samp_h[c];
    v[c] = samp_v[c];
    if (h[c] < 1 || h[c] > 4 || v[c] < 1 || v[c] > 4) return -11;
    if (h[c] > hmax) hmax = h[c];
    if (v[c] > vmax) vmax = v[c];
  }
  if (ncomp == 1) h[0] = v[0] = hmax = vmax = 1;  // scanner convention
  const int mcus_x = (img_w + hmax * 8 - 1) / (hmax * 8);
  const int mcus_y = (img_h + vmax * 8 - 1) / (vmax * 8);
  const int64_t nmcus = static_cast<int64_t>(mcus_x) * mcus_y;

  // Offsets must be monotone and inside the destuffed stream; a
  // truncated scan (decoded against zero-fill) fails here.
  for (int64_t i = 0; i < nmcus; ++i)
    if (mcu_bits[i] > mcu_bits[i + 1]) return -10;
  if (mcu_bits[0] < 0 || mcu_bits[nmcus] > destuff_bits) return -10;

  EncTable enc[8];  // dc0..3, ac0..3
  bool built[8] = {};
  for (int c = 0; c < ncomp; ++c) {
    const int td = comp_dc[c], ta = comp_ac[c];
    if (td > 3 || ta > 3 || comp_tq[c] > 3) return -11;
    for (int t : {td, ta + 4}) {
      if (!dht_present[t]) return -8;
      if (!built[t]) {
        int nv = 0;
        for (int l = 1; l <= 16; ++l) nv += dht_bits[t * 17 + l];
        enc[t].build(dht_bits + t * 17, dht_vals + t * 256, nv);
        built[t] = true;
      }
    }
  }

  BitWriter bw{out, out_cap};
  bw.put_byte(0xFF);
  bw.put_byte(0xD8);  // SOI
  const uint8_t app0[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  emit_marker_segment(bw, 0xE0, app0, sizeof(app0));

  // DQT: each distinct slot, 16-bit entries when any value > 255.
  bool qdone[4] = {};
  for (int c = 0; c < ncomp; ++c) {
    const int tq = comp_tq[c];
    if (qdone[tq]) continue;
    qdone[tq] = true;
    bool wide = false;
    for (int k = 0; k < 64; ++k)
      if (qt[tq * 64 + k] > 255) wide = true;
    uint8_t body[1 + 128];
    body[0] = static_cast<uint8_t>((wide ? 0x10 : 0x00) | tq);
    int o = 1;
    for (int k = 0; k < 64; ++k) {
      const int q = qt[tq * 64 + kZigzag[k]];
      if (q < 1) return -8;
      if (wide) {
        body[o++] = static_cast<uint8_t>(q >> 8);
        body[o++] = static_cast<uint8_t>(q & 0xFF);
      } else {
        body[o++] = static_cast<uint8_t>(q);
      }
    }
    emit_marker_segment(bw, 0xDB, body, o);
  }

  // SOF0 with the input's component ids / sampling / quant slots.
  {
    uint8_t body[6 + 3 * 3];
    int o = 0;
    body[o++] = 8;
    body[o++] = static_cast<uint8_t>(img_h >> 8);
    body[o++] = static_cast<uint8_t>(img_h & 0xFF);
    body[o++] = static_cast<uint8_t>(img_w >> 8);
    body[o++] = static_cast<uint8_t>(img_w & 0xFF);
    body[o++] = static_cast<uint8_t>(ncomp);
    for (int c = 0; c < ncomp; ++c) {
      body[o++] = comp_id[c];
      body[o++] = static_cast<uint8_t>((h[c] << 4) | v[c]);
      body[o++] = comp_tq[c];
    }
    emit_marker_segment(bw, 0xC0, body, o);
  }

  // DHT: each distinct referenced table, input spec verbatim.
  bool hdone[8] = {};
  for (int c = 0; c < ncomp; ++c) {
    for (int t : {static_cast<int>(comp_dc[c]),
                  static_cast<int>(comp_ac[c]) + 4}) {
      if (hdone[t]) continue;
      hdone[t] = true;
      emit_dht(bw, t < 4 ? 0 : 1, t & 3, dht_bits + t * 17,
               dht_vals + t * 256);
    }
  }

  // DRI: re-declare the input's restart interval (segment boundaries
  // are preserved 1:1 so offsets/predictor resets line up).
  if (restart_interval > 0) {
    const uint8_t dri[] = {
        static_cast<uint8_t>(restart_interval >> 8),
        static_cast<uint8_t>(restart_interval & 0xFF)};
    emit_marker_segment(bw, 0xDD, dri, 2);
  }

  // SOS
  {
    uint8_t body[1 + 3 * 2 + 3];
    int o = 0;
    body[o++] = static_cast<uint8_t>(ncomp);
    for (int c = 0; c < ncomp; ++c) {
      body[o++] = comp_id[c];
      body[o++] = static_cast<uint8_t>((comp_dc[c] << 4) | comp_ac[c]);
    }
    body[o++] = 0;
    body[o++] = 63;
    body[o++] = 0;
    emit_marker_segment(bw, 0xDA, body, o);
  }

  CompSpec comp[3];
  for (int c = 0; c < ncomp; ++c) {
    comp[c].coef = planes[c];
    if (planes[c] == nullptr) return -4;
    comp[c].h = h[c];
    comp[c].v = v[c];
    comp[c].bw = mcus_x * h[c];
    comp[c].stride = strides[c] > 0 ? strides[c] : comp[c].bw * 8;
    if (comp[c].stride < comp[c].bw * 8) return -7;
    comp[c].pred = 0;
  }

  // Re-symbolize one MCU from the planes (checked, exact).
  const auto resym_mcu = [&](int64_t m) -> bool {
    const int mx = static_cast<int>(m % mcus_x);
    const int my = static_cast<int>(m / mcus_x);
    for (int c = 0; c < ncomp; ++c) {
      CompSpec& cc = comp[c];
      const EncTable& dct = enc[comp_dc[c]];
      const EncTable& act = enc[comp_ac[c] + 4];
      for (int bv = 0; bv < cc.v; ++bv) {
        for (int bh = 0; bh < cc.h; ++bh) {
          const int bx = mx * cc.h + bh;
          const int by = my * cc.v + bv;
          const int16_t* blk = cc.coef
              + static_cast<size_t>(by) * 8 * cc.stride
              + static_cast<size_t>(bx) * 8;
          if (!encode_block_checked(bw, blk, cc.stride, dct, act,
                                    cc.pred))
            return false;
        }
      }
    }
    return true;
  };

  // Restart segments are byte-aligned with predictors reset, so each
  // splices independently: copy runs clip at segment boundaries, the
  // output re-aligns + emits RSTn exactly where the input did, and the
  // first MCU of a segment never needs the DC fix-up (its diff is
  // against the reset predictor, unchanged by edits elsewhere).
  const int64_t ri = restart_interval > 0 ? restart_interval : nmcus;
  const int64_t nseg = (nmcus + ri - 1) / ri;
  int next_rst = 0;
  for (int64_t seg = 0; seg < nseg; ++seg) {
    const int64_t s0 = seg * ri;
    const int64_t s1 = s0 + ri < nmcus ? s0 + ri : nmcus;
    const int64_t seg_end =
        (seg == nseg - 1) ? mcu_bits[nmcus] : seg_end_bits[seg];
    if (seg_end < mcu_bits[s1 - 1] || seg_end > destuff_bits) return -10;
    if (seg > 0) {
      bw.flush_scan();  // byte-align with 1-padding, like the input
      bw.put_byte(0xFF);
      bw.put_byte(static_cast<uint8_t>(0xD0 + next_rst));
      next_rst = (next_rst + 1) & 7;
      for (int c = 0; c < ncomp; ++c) comp[c].pred = 0;
    }
    int64_t m = s0;
    while (m < s1) {
      if (reenc[m]) {
        if (!resym_mcu(m)) return -9;
        ++m;
        continue;
      }
      int64_t e = m;
      while (e < s1 && !reenc[e]) ++e;
      // First MCU after a re-encoded region: its DC diffs reference
      // changed predecessors, so re-symbolize it (bit-identical to the
      // original except the DC fields). Every later MCU in the run
      // differences two unchanged DC values — straight copy.
      if (m > s0 && reenc[m - 1]) {
        if (!resym_mcu(m)) return -9;
        ++m;
      }
      if (m < e) {
        copy_bits(bw, destuff, mcu_bits[m],
                  e == s1 ? seg_end : mcu_bits[e]);
        // Restore per-component DC predictors from the planes: the last
        // block (in scan order) of the run's final MCU.
        const int mx = static_cast<int>((e - 1) % mcus_x);
        const int my = static_cast<int>((e - 1) / mcus_x);
        for (int c = 0; c < ncomp; ++c) {
          CompSpec& cc = comp[c];
          const int bx = mx * cc.h + (cc.h - 1);
          const int by = my * cc.v + (cc.v - 1);
          cc.pred = cc.coef[static_cast<size_t>(by) * 8 * cc.stride
                            + static_cast<size_t>(bx) * 8];
        }
        m = e;
      }
    }
  }

  bw.flush_scan();
  bw.put_byte(0xFF);
  bw.put_byte(0xD9);  // EOI
  if (bw.overflow) return -5;
  return static_cast<long>(bw.pos);
}

}  // namespace

extern "C" {

long ip_jpeg_emit_strided(const int16_t* coef0, const int16_t* coef1,
                          const int16_t* coef2, const uint16_t* qtab,
                          int img_w, int img_h, int ncomp, int h0, int v0,
                          int restart_interval,
                          long stride0, long stride1, long stride2,
                          uint8_t* out, size_t out_cap) {
  return emit_impl(coef0, coef1, coef2, qtab, img_w, img_h, ncomp, h0, v0,
                   restart_interval, stride0, stride1, stride2, out,
                   out_cap, 1);
}

// Interleaved variant: encode `interleave` restart segments
// concurrently on one core (independent bit chains fill the OoO issue
// slots a single serial Huffman stream leaves idle). Byte-identical
// output to ip_jpeg_emit_strided at the same restart_interval.
long ip_jpeg_emit_strided_ilp(const int16_t* coef0, const int16_t* coef1,
                              const int16_t* coef2, const uint16_t* qtab,
                              int img_w, int img_h, int ncomp, int h0,
                              int v0, int restart_interval,
                              long stride0, long stride1, long stride2,
                              uint8_t* out, size_t out_cap,
                              int interleave) {
  return emit_impl(coef0, coef1, coef2, qtab, img_w, img_h, ncomp, h0, v0,
                   restart_interval, stride0, stride1, stride2, out,
                   out_cap, interleave);
}

// Splice emitter (see emit_transcode_impl above): copy untouched MCUs'
// bit spans from the original destuffed entropy stream, re-symbolize
// only reenc-flagged MCUs (plus the DC-chain boundary MCU after each
// edited region) with the input's own Huffman/quant tables.
long ip_jpeg_emit_transcode(
    const int16_t* coef0, const int16_t* coef1, const int16_t* coef2,
    long stride0, long stride1, long stride2,
    const uint16_t* qt /*4*64 natural*/,
    const uint8_t* comp_tq, const uint8_t* comp_id,
    const uint8_t* comp_dc, const uint8_t* comp_ac,
    const uint8_t* dht_bits /*8*17*/, const uint8_t* dht_vals /*8*256*/,
    const uint8_t* dht_present /*8*/,
    int img_w, int img_h, int ncomp,
    const uint8_t* samp_h, const uint8_t* samp_v,
    const uint8_t* destuff, int64_t destuff_bits,
    const int64_t* mcu_bits, const uint8_t* reenc,
    uint8_t* out, size_t out_cap) {
  const int16_t* planes[3] = {coef0, coef1, coef2};
  const long strides[3] = {stride0, stride1, stride2};
  return emit_transcode_impl(planes, strides, qt, comp_tq, comp_id,
                             comp_dc, comp_ac, dht_bits, dht_vals,
                             dht_present, img_w, img_h, ncomp, samp_h,
                             samp_v, destuff, destuff_bits, mcu_bits,
                             reenc, out, out_cap, 0, nullptr);
}

// Restart-capable splice emitter: preserves the input's restart
// interval 1:1 (DRI re-declared; byte-align + RSTn + predictor reset
// at every boundary; copy runs clip at boundaries). seg_end_bits comes
// from ip_jpeg_scan_coefs_offsets_rst: each non-final segment's true
// end bit in the destuffed stream. Pass restart_interval=0 +
// seg_end_bits=nullptr for streams without restarts (identical to
// ip_jpeg_emit_transcode).
long ip_jpeg_emit_transcode_rst(
    const int16_t* coef0, const int16_t* coef1, const int16_t* coef2,
    long stride0, long stride1, long stride2,
    const uint16_t* qt /*4*64 natural*/,
    const uint8_t* comp_tq, const uint8_t* comp_id,
    const uint8_t* comp_dc, const uint8_t* comp_ac,
    const uint8_t* dht_bits /*8*17*/, const uint8_t* dht_vals /*8*256*/,
    const uint8_t* dht_present /*8*/,
    int img_w, int img_h, int ncomp,
    const uint8_t* samp_h, const uint8_t* samp_v,
    const uint8_t* destuff, int64_t destuff_bits,
    const int64_t* mcu_bits, const uint8_t* reenc,
    uint8_t* out, size_t out_cap,
    int restart_interval, const int64_t* seg_end_bits) {
  const int16_t* planes[3] = {coef0, coef1, coef2};
  const long strides[3] = {stride0, stride1, stride2};
  return emit_transcode_impl(planes, strides, qt, comp_tq, comp_id,
                             comp_dc, comp_ac, dht_bits, dht_vals,
                             dht_present, img_w, img_h, ncomp, samp_h,
                             samp_v, destuff, destuff_bits, mcu_bits,
                             reenc, out, out_cap, restart_interval,
                             seg_end_bits);
}

long ip_jpeg_emit(const int16_t* coef0, const int16_t* coef1,
                  const int16_t* coef2, const uint16_t* qtab,
                  int img_w, int img_h, int ncomp, int h0,
                  int v0, int restart_interval, uint8_t* out,
                  size_t out_cap) {
  return emit_impl(coef0, coef1, coef2, qtab, img_w, img_h,
                   ncomp, h0, v0, restart_interval, 0, 0, 0,
                   out, out_cap, 1);
}

}  // extern "C"
