// iputil — libjpeg-free helpers shared by every native build.
//
// ip_free releases buffers the encoders allocate; ip_crc32c and
// ip_coef_rot_i16 need no codec library. They live apart from
// ipcodec.cpp so that a host without libjpeg's headers still builds
// the entropy scanner/emitter (jpeg_scan.cpp, jpeg_emit.cpp), the GIF
// quantizer and these helpers (runtime/nativecodec.py _build).

#include <cstdint>
#include <cstdlib>
#include <cstring>

#if defined(__SSE4_2__)
#include <nmmintrin.h>  // SSE4.2 CRC-32C intrinsics (ip_crc32c below)
#endif

extern "C" {

void ip_free(void* p) { free(p); }

// CRC-32C (Castagnoli) — the checksum Kafka RecordBatch v2 mandates.
// Hardware SSE4.2 path when the build arch has it (-march=native /
// x86-64-v2 both do), byte-table fallback otherwise. Exposed so the
// pure-Python Kafka client can validate megabyte fetch payloads at
// native speed instead of ~5 MB/s Python-loop speed.
uint32_t ip_crc32c(const uint8_t* data, size_t len, uint32_t crc) {
  crc ^= 0xFFFFFFFFu;
#if defined(__SSE4_2__)
  uint64_t c = crc;
  while (len >= 8) {
    uint64_t chunk;
    memcpy(&chunk, data, 8);
    c = _mm_crc32_u64(c, chunk);
    data += 8;
    len -= 8;
  }
  crc = static_cast<uint32_t>(c);
  while (len--) crc = _mm_crc32_u8(crc, *data++);
#else
  // C++11 magic static: thread-safe one-time table build.
  static const struct Table {
    uint32_t t[256];
    Table() {
      for (uint32_t i = 0; i < 256; ++i) {
        uint32_t r = i;
        for (int k = 0; k < 8; ++k)
          r = (r >> 1) ^ (0x82F63B78u & (0u - (r & 1u)));
        t[i] = r;
      }
    }
  } tbl;
  while (len--) crc = tbl.t[(crc ^ *data++) & 0xFFu] ^ (crc >> 8);
#endif
  return crc ^ 0xFFFFFFFFu;
}

// Blocked coefficient-plane rotation for the lossless JPEG transforms
// (runtime/coeftx.py). The plane is an (hb*8, wb*8) int16 grid of 8x8
// DCT blocks; a 90-degree image rotation is a transpose of the block
// GRID combined with a transpose of EACH block plus a frequency sign
// flip inherited from the mirror half of the decomposition:
//   mode 0: pure transpose          out_blk(I,J) = T(src_blk(J,I))
//   mode 1: rot90 ccw               out_blk(I,J) = T(src_blk(J,wb-1-I)),
//           out[u][v] *= (u&1) ? -1 : 1   (flip_h's (-1)^v pre-transpose)
//   mode 2: rot270 ccw              out_blk(I,J) = T(src_blk(hb-1-J,I)),
//           out[u][v] *= (v&1) ? -1 : 1   (flip_v's (-1)^u pre-transpose)
// dst dims are (wb*8, hb*8). Output blocks are written sequentially
// (row-major) so the pass runs at copy bandwidth instead of the
// cache-hostile element-wise transpose numpy performs (~6x measured).
// Returns 0 on success, nonzero on bad arguments.
int ip_coef_rot_i16(const int16_t* src, int64_t hb, int64_t wb,
                    int16_t* dst, int mode) {
  if (!src || !dst || hb <= 0 || wb <= 0 || mode < 0 || mode > 2)
    return 1;
  const int64_t sstride = wb * 8;   // src row stride (elements)
  const int64_t dstride = hb * 8;   // dst row stride
  for (int64_t I = 0; I < wb; ++I) {
    for (int64_t J = 0; J < hb; ++J) {
      int64_t sr = J, sc = I;
      if (mode == 1) sc = wb - 1 - I;
      else if (mode == 2) sr = hb - 1 - J;
      const int16_t* s = src + (sr * 8) * sstride + sc * 8;
      int16_t* d = dst + (I * 8) * dstride + J * 8;
      if (mode == 1) {
        for (int u = 0; u < 8; ++u) {
          int16_t* drow = d + u * dstride;
          const int16_t sign = (u & 1) ? -1 : 1;
          for (int v = 0; v < 8; ++v)
            drow[v] = static_cast<int16_t>(s[v * sstride + u] * sign);
        }
      } else if (mode == 2) {
        for (int u = 0; u < 8; ++u) {
          int16_t* drow = d + u * dstride;
          for (int v = 0; v < 8; ++v)
            drow[v] = static_cast<int16_t>(
                s[v * sstride + u] * ((v & 1) ? -1 : 1));
        }
      } else {
        for (int u = 0; u < 8; ++u) {
          int16_t* drow = d + u * dstride;
          for (int v = 0; v < 8; ++v)
            drow[v] = s[v * sstride + u];
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
