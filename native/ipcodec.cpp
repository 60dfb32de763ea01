// ipcodec — native host codec for imageprocessor_tpu.
//
// Thin C ABI over libjpeg(-turbo) exposed to Python via ctypes
// (no pybind11 in this environment). Two capabilities beyond what the
// OpenCV wrapper offers:
//   * DCT-domain scaled decode (scale_num/8): decoding a 12 MP JPEG
//     directly at 1/2, 1/4 or 1/8 size costs a fraction of a full decode —
//     the right host-side move when a task only requests a thumbnail;
//   * header-only probe (dimensions + components) without entropy decode,
//     used by the batcher to pick resolution buckets before full decode.
//
// All functions are thread-safe (no shared state); libjpeg releases no
// GIL concerns since calls happen outside Python.
//
// Build: make native (links -ljpeg; without libjpeg the library is built
// from the other native sources alone, see runtime/nativecodec.py _build).

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
  char message[JMSG_LENGTH_MAX];
};

void error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, err->message);
  longjmp(err->setjmp_buffer, 1);
}

void silence_output(j_common_ptr, int) {}

}  // namespace

extern "C" {

// Returns 0 on success. Fills w/h/components from the JPEG header only.
int ip_jpeg_probe(const uint8_t* data, size_t len, int* w, int* h,
                  int* components) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = silence_output;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  *components = cinfo.num_components;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode to RGB888 with DCT-domain scaling scale_num/8 (scale_num in 1..8).
// `out` must hold out_w*out_h*3 bytes where out_w/out_h are the scaled
// dims previously obtained from ip_jpeg_scaled_dims. Returns 0 on success.
int ip_jpeg_decode(const uint8_t* data, size_t len, int scale_num,
                   uint8_t* out, int out_stride) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = silence_output;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = scale_num;
  cinfo.scale_denom = 8;
  cinfo.dct_method = JDCT_ISLOW;  // libjpeg-turbo SIMD path
  jpeg_start_decompress(&cinfo);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline)
                             * static_cast<size_t>(out_stride);
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Scaled output dimensions for scale_num/8 without decoding.
int ip_jpeg_scaled_dims(const uint8_t* data, size_t len, int scale_num,
                        int* out_w, int* out_h) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = silence_output;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.scale_num = scale_num;
  cinfo.scale_denom = 8;
  jpeg_calc_output_dimensions(&cinfo);
  *out_w = static_cast<int>(cinfo.output_width);
  *out_h = static_cast<int>(cinfo.output_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Encode RGB888 -> JPEG at `quality`. The shim allocates *out via malloc;
// caller frees with ip_free. Returns 0 on success.
int ip_jpeg_encode(const uint8_t* rgb, int w, int h, int stride, int quality,
                   uint8_t** out, size_t* out_len) {
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = silence_output;
  // volatile: buf is reassigned by jpeg_mem_dest between setjmp and
  // longjmp, so it must be reloaded from memory after a longjmp.
  unsigned char* volatile buf = nullptr;
  unsigned long buflen = 0;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_compress(&cinfo);
    if (buf != nullptr) free(buf);
    return 1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, const_cast<unsigned char**>(&buf), &buflen);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(
        rgb + static_cast<size_t>(cinfo.next_scanline)
                  * static_cast<size_t>(stride));
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out = buf;
  *out_len = buflen;
  return 0;
}


// --- DCT-coefficient access (device-side decode support) -------------------
//
// The expensive parts of JPEG decode (dequant + iDCT + upsample + color
// convert) are dense math that belongs on the device; only the sequential
// Huffman decode stays on host. ip_jpeg_read_coefs extracts the quantized
// coefficient planes + quant tables; the device turns them into pixels.

// Phase 1: dimensions. comp_w/comp_h are in 8x8 BLOCKS per component.
int ip_jpeg_coef_dims(const uint8_t* data, size_t len, int* ncomp,
                      int* img_w, int* img_h,
                      int* comp_bw, int* comp_bh,   // [4] each
                      int* h_samp, int* v_samp) {   // [4] each
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = silence_output;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  *ncomp = cinfo.num_components;
  *img_w = static_cast<int>(cinfo.image_width);
  *img_h = static_cast<int>(cinfo.image_height);
  for (int c = 0; c < cinfo.num_components && c < 4; ++c) {
    jpeg_component_info* ci = &cinfo.comp_info[c];
    // width_in_blocks is only valid after start; compute from sampling.
    long cw = (static_cast<long>(cinfo.image_width) * ci->h_samp_factor
               + cinfo.max_h_samp_factor * 8L - 1)
              / (cinfo.max_h_samp_factor * 8L);
    long ch = (static_cast<long>(cinfo.image_height) * ci->v_samp_factor
               + cinfo.max_v_samp_factor * 8L - 1)
              / (cinfo.max_v_samp_factor * 8L);
    comp_bw[c] = static_cast<int>(cw);
    comp_bh[c] = static_cast<int>(ch);
    h_samp[c] = ci->h_samp_factor;
    v_samp[c] = ci->v_samp_factor;
  }
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Phase 2: fill caller buffers. For component c:
//   coefs[c]: int16 array of shape (comp_bh*8, comp_bw*8) — each 8x8 block
//             stored at its spatial position, natural (row-major) order;
//   qtab[c]:  64 uint16, natural order.
int ip_jpeg_read_coefs(const uint8_t* data, size_t len,
                       int16_t* coef0, int16_t* coef1, int16_t* coef2,
                       uint16_t* qtab /* 3*64 */) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = silence_output;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  jvirt_barray_ptr* arrays = jpeg_read_coefficients(&cinfo);
  if (arrays == nullptr) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  int16_t* outs[3] = {coef0, coef1, coef2};
  // (libjpeg already returns coefficients in natural order; no zigzag
  // reordering happens here.)
  for (int c = 0; c < cinfo.num_components && c < 3; ++c) {
    jpeg_component_info* ci = &cinfo.comp_info[c];
    const JDIMENSION bw = ci->width_in_blocks;
    const JDIMENSION bh = ci->height_in_blocks;
    const size_t row_px = static_cast<size_t>(bw) * 8;
    int16_t* out = outs[c];
    if (out == nullptr) continue;
    // quant table: libjpeg keeps quantval in natural order.
    if (ci->quant_table != nullptr) {
      for (int k = 0; k < 64; ++k)
        qtab[c * 64 + k] = ci->quant_table->quantval[k];
    } else if (cinfo.quant_tbl_ptrs[ci->quant_tbl_no] != nullptr) {
      for (int k = 0; k < 64; ++k)
        qtab[c * 64 + k] =
            cinfo.quant_tbl_ptrs[ci->quant_tbl_no]->quantval[k];
    }
    for (JDIMENSION by = 0; by < bh; ++by) {
      JBLOCKARRAY rows = (*cinfo.mem->access_virt_barray)(
          reinterpret_cast<j_common_ptr>(&cinfo), arrays[c], by, 1, FALSE);
      for (JDIMENSION bx = 0; bx < bw; ++bx) {
        const JCOEF* blk = rows[0][bx];  // natural order, quantized
        int16_t* base = out + static_cast<size_t>(by) * 8 * row_px
                        + static_cast<size_t>(bx) * 8;
        for (int r = 0; r < 8; ++r) {
          memcpy(base + static_cast<size_t>(r) * row_px, blk + r * 8,
                 8 * sizeof(int16_t));
        }
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
