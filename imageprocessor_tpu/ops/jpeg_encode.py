"""Device-side JPEG encode: color convert + downsample + FDCT + quantize.

Mirror of ops/jpeg_decode.py. The host keeps only the sequential
Huffman pass (nativecodec.emit_jpeg_from_coefficients, Annex K tables);
everything dense runs on device:

* RGB -> YCbCr (BT.601/JFIF matrix, the one image/jpeg and libjpeg use;
  reference encode: internal/usecase/image_processor.go writes q85 JPEG
  via Go's image/jpeg);
* 4:2:0 chroma downsampling — 2x2 box mean;
* forward 8x8 DCT — two 8-point contractions per block batched over all
  blocks, at Precision.HIGHEST (see ops/jpeg_decode.py);
* quantization — elementwise divide + round against the quality-scaled
  Annex K tables, clamped to the baseline coefficient range.

Validation: emit(scan(x)) transcodes bit-exactly, and full encodes
decode within ~0.5 dB of a libjpeg encode at the same quality
(tests/test_jpeg_encode_tpu.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from imageprocessor_tpu.ops.jpeg_decode import _clamp_extent, _idct_basis

# Annex K (K.1/K.2) base quantization tables, natural (row-major) order.
_BASE_QT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], dtype=np.int32).reshape(8, 8)
_BASE_QT_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], dtype=np.int32).reshape(8, 8)


@functools.lru_cache(maxsize=32)
def quality_qtables(quality: int) -> np.ndarray:
    """(2, 8, 8) uint16 quant tables for an IJG-style quality in [1, 100]
    (the scaling libjpeg and Go's image/jpeg both apply to Annex K)."""
    q = min(100, max(1, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    out = np.empty((2, 8, 8), dtype=np.uint16)
    for i, base in enumerate((_BASE_QT_LUMA, _BASE_QT_CHROMA)):
        t = (base * scale + 50) // 100
        out[i] = np.clip(t, 1, 255).astype(np.uint16)
    return out


@functools.partial(jax.jit, static_argnames=("bh", "bw"))
def _fdct_quantize(plane_f32, qtab_f32, bh: int, bw: int):
    """(bh*8, bw*8) float32 samples -> int16 quantized coefficients.

    coef = D @ (x - 128) @ D^T with the orthonormal DCT basis shared
    with the decoder (jpeg_decode._idct_basis), divided by the quant
    table with round-to-nearest, clamped to the baseline range.
    """
    d = jnp.asarray(_idct_basis())
    x = plane_f32.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
    x = x.reshape(bh * bw, 8, 8) - 128.0
    c = jnp.einsum("ki,bij->bkj", d, x, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    c = jnp.einsum("bkj,lj->bkl", c, d, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    c = c / qtab_f32[None, :, :]
    c = jnp.clip(jnp.round(c), -1023, 1023).astype(jnp.int16)
    return c.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
        bh * 8, bw * 8)


def _pad_edge(plane, out_h: int, out_w: int):
    """Edge-replicate to the MCU-aligned canvas (libjpeg pads the same
    way, which keeps edge blocks cheap to code and ringing-free)."""
    h, w = plane.shape[-2], plane.shape[-1]
    return jnp.pad(plane, ((0, out_h - h), (0, out_w - w)), mode="edge")


@functools.partial(jax.jit, static_argnames=("mcu_h", "mcu_w",
                                             "subsample"))
def _rgb_to_coef_planes(rgb_u8, qt_f32, mcu_h: int, mcu_w: int,
                        subsample: bool):
    """Planar (3, H, W) uint8 RGB -> (Y, Cb, Cr) quantized coefficient
    planes (luma (mcu_h*16, mcu_w*16) for 4:2:0, chroma half that; at
    4:4:4 all planes are (mcu_h*8, mcu_w*8))."""
    x = rgb_u8.astype(jnp.float32)
    r, g, b = x[0], x[1], x[2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    if subsample:
        ly_h, ly_w = mcu_h * 16, mcu_w * 16
        y = _pad_edge(y, ly_h, ly_w)
        cb = _pad_edge(cb, ly_h, ly_w)
        cr = _pad_edge(cr, ly_h, ly_w)
        # 2x2 box mean (libjpeg's non-fancy h2v2 downsample)
        def down2(p):
            p = p.reshape(ly_h // 2, 2, ly_w // 2, 2)
            return p.mean(axis=(1, 3))
        cb, cr = down2(cb), down2(cr)
        yc = _fdct_quantize(y, qt_f32[0], mcu_h * 2, mcu_w * 2)
        cbc = _fdct_quantize(cb, qt_f32[1], mcu_h, mcu_w)
        crc = _fdct_quantize(cr, qt_f32[1], mcu_h, mcu_w)
    else:
        ly_h, ly_w = mcu_h * 8, mcu_w * 8
        y = _pad_edge(y, ly_h, ly_w)
        cb = _pad_edge(cb, ly_h, ly_w)
        cr = _pad_edge(cr, ly_h, ly_w)
        yc = _fdct_quantize(y, qt_f32[0], mcu_h, mcu_w)
        cbc = _fdct_quantize(cb, qt_f32[1], mcu_h, mcu_w)
        crc = _fdct_quantize(cr, qt_f32[1], mcu_h, mcu_w)
    return yc, cbc, crc


@jax.jit
def _fdct_quantize_batched(planes_f32, qtab_f32):
    """(B, bh*8, bw*8) float32 samples + (8, 8) quant table ->
    (B, bh*8, bw*8) int16 quantized coefficients.

    Layout-preserving formulation (see jpeg_decode._idct_planes_batched):
    both 8-point transforms contract an in-place axis, never gathering
    8x8 blocks."""
    b, hh, ww = planes_f32.shape
    bh, bw = hh // 8, ww // 8
    d = jnp.asarray(_idct_basis())
    # vertical: coef_k = sum_i D[k, i] * x[i, .]
    x = jnp.einsum("ki,bhiw->bhkw", d, planes_f32.reshape(b, bh, 8, ww)
                   - 128.0, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    # horizontal: coef_l = sum_j x[., j] * D[l, j]
    x = jnp.einsum("bhwj,lj->bhwl", x.reshape(b, hh, bw, 8), d,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    c = x.reshape(b, bh, 8, bw, 8) / qtab_f32[None, None, :, None, :]
    c = jnp.clip(jnp.round(c), -1023, 1023).astype(jnp.int16)
    return c.reshape(b, hh, ww)


# Replicate each image's last valid row/col across the batch canvas
# (libjpeg pads to the MCU grid the same way, so edge blocks encode
# identically and zero-padding never rings into the image). Same clamp
# the decode side uses — one implementation, not two drifting copies.
_replicate_edges = _clamp_extent


@jax.jit
def batched_encode_420(rgb_u8, valid_hw, qt_f32):
    """Batched device-side 4:2:0 JPEG encode front half.

    rgb_u8: (B, H, W, 3) uint8 bucket canvases (H, W multiples of 16);
    valid_hw: (B, 2) per-image valid dims (edges replicate from
    there); qt_f32: (2, 8, 8) luma/chroma quant tables. Returns int16
    coefficient canvases (yc (B,H,W), cbc (B,H/2,W/2), crc) ready for
    the host entropy emitter — the engine's full-size JPEG outputs keep
    only the Huffman pass on host.
    """
    x = rgb_u8.astype(jnp.float32)
    r = _replicate_edges(x[..., 0], valid_hw)
    g = _replicate_edges(x[..., 1], valid_hw)
    b = _replicate_edges(x[..., 2], valid_hw)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    bsz, hh, ww = y.shape

    def down2(p):
        return p.reshape(bsz, hh // 2, 2, ww // 2, 2).mean(axis=(2, 4))

    yc = _fdct_quantize_batched(y, qt_f32[0])
    cbc = _fdct_quantize_batched(down2(cb), qt_f32[1])
    crc = _fdct_quantize_batched(down2(cr), qt_f32[1])
    return yc, cbc, crc


def encode_jpeg_device(rgb_planar_u8, quality: int = 85,
                       subsampling: str = "420") -> bytes:
    """Full device-side encode of one baseline JPEG: device math + host
    entropy pass. Input is planar (3, H, W) uint8 RGB."""
    from imageprocessor_tpu.runtime import nativecodec

    rgb_planar_u8 = jnp.asarray(rgb_planar_u8)
    if rgb_planar_u8.ndim != 3 or rgb_planar_u8.shape[0] != 3:
        raise ValueError("expected planar (3, H, W) uint8")
    h, w = int(rgb_planar_u8.shape[1]), int(rgb_planar_u8.shape[2])
    sub = subsampling == "420"
    mcu = 16 if sub else 8
    mcu_h = -(-h // mcu)
    mcu_w = -(-w // mcu)
    qt = quality_qtables(quality)
    yc, cbc, crc = _rgb_to_coef_planes(
        rgb_planar_u8, jnp.asarray(qt, dtype=jnp.float32), mcu_h, mcu_w,
        sub)
    planes = [np.asarray(yc), np.asarray(cbc), np.asarray(crc)]
    return nativecodec.emit_jpeg_from_coefficients(
        planes, qt, w, h, (2, 2) if sub else (1, 1))


__all__ = ["encode_jpeg_device", "quality_qtables"]
