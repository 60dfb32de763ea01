"""Device-side JPEG decode: dequant + iDCT + upsample + color convert.

The host keeps only the sequential Huffman pass
(nativecodec.read_jpeg_coefficients, ~1/3 of a full libjpeg decode);
everything dense runs here:

* dequantization — elementwise multiply by the quant table;
* 8x8 inverse DCT — two 8-point contractions per block, batched over all
  blocks; each einsum runs at Precision.HIGHEST, because a default f32
  matmul may run in reduced precision (TF32 on the GPU) and the decode
  has no room for that at coefficient magnitudes (PERF.md: writing the
  contractions as fused scaled adds instead measured no faster);
* chroma upsampling — libjpeg's "fancy" triangular filter for 2x factors
  (matching the host-side native decoder this path substitutes for, and
  libjpeg-turbo in production; Go's image/jpeg replicates instead, so
  chroma-edge pixels may differ from a Go decode by a few LSBs — the
  PSNR contract vs the oracle is over the RESAMPLE ops, which decode via
  the same path on both sides);
* YCbCr -> RGB (BT.601, the JFIF matrix both libjpeg and Go use).

Fidelity: float iDCT vs libjpeg's integer islow differs by <=1 LSB in
practice (PSNR > 50 dB on full decodes, tested).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=1)
def _idct_basis() -> np.ndarray:
    """D[k, n] such that spatial = D^T @ coef @ D (type-III DCT)."""
    d = np.zeros((8, 8), dtype=np.float64)
    for k in range(8):
        ck = np.sqrt(0.25) if k else np.sqrt(0.125)
        for n in range(8):
            d[k, n] = ck * np.cos((2 * n + 1) * k * np.pi / 16.0)
    return d.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("bh", "bw"))
def _idct_plane(coefs_i16, qtab_f32, bh: int, bw: int):
    """(bh*8, bw*8) int16 quantized coefs -> float32 samples (level +128)."""
    d = jnp.asarray(_idct_basis())
    x = coefs_i16.astype(jnp.float32).reshape(bh, 8, bw, 8)
    x = x * qtab_f32[None, :, None, :].reshape(1, 8, 1, 8)
    # Pixel-sourced streams keep |dequantized coef| <= 255*8 + q/2 ~
    # 2168; the clamp only bites adversarial synthetic canvases, and the
    # host decode in runtime/splice.py applies the same one, so the two
    # decodes agree on any input.
    x = jnp.clip(x, -4096.0, 4096.0)
    x = x.transpose(0, 2, 1, 3).reshape(bh * bw, 8, 8)
    # spatial = D^T @ X @ D
    x = jnp.einsum("ki,bkl->bil", d, x, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    x = jnp.einsum("bil,lj->bij", x, d, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    x = x.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
    return x + 128.0


def _fancy_up2_axis(plane, axis: int):
    """libjpeg "fancy" (triangular) 2x upsample along one axis:
    out[2i]   = (3*in[i] + in[i-1]) / 4
    out[2i+1] = (3*in[i] + in[i+1]) / 4   (edges clamp)."""
    prev = jnp.concatenate([jax.lax.slice_in_dim(plane, 0, 1, axis=axis),
                            jax.lax.slice_in_dim(plane, 0, -1, axis=axis)],
                           axis=axis)
    nxt = jnp.concatenate([jax.lax.slice_in_dim(plane, 1, None, axis=axis),
                           jax.lax.slice_in_dim(plane, -1, None, axis=axis)],
                          axis=axis)
    even = (3.0 * plane + prev) * 0.25
    odd = (3.0 * plane + nxt) * 0.25
    stacked = jnp.stack([even, odd], axis=axis + 1)
    shape = list(plane.shape)
    shape[axis] *= 2
    return stacked.reshape(shape)


def _upsample(plane, factor_h: int, factor_w: int):
    """Chroma upsampling matching libjpeg's fancy mode for 2x factors
    (triangular filter); other factors use replication."""
    if factor_h == 2:
        plane = _fancy_up2_axis(plane, 0)
    elif factor_h > 1:
        plane = jnp.repeat(plane, factor_h, axis=0)
    if factor_w == 2:
        plane = _fancy_up2_axis(plane, 1)
    elif factor_w > 1:
        plane = jnp.repeat(plane, factor_w, axis=1)
    return plane


@functools.partial(jax.jit, static_argnames=("shapes", "sampling",
                                             "out_h", "out_w"))
def _decode_ycbcr(y_c, cb_c, cr_c, qt, shapes, sampling, out_h: int,
                  out_w: int):
    (ybh, ybw), (cbh_, cbw_), (crh, crw) = shapes
    (hy, vy), (hc, vc), (hr, vr) = sampling
    y = _idct_plane(y_c, qt[0], ybh, ybw)
    cb = _idct_plane(cb_c, qt[1], cbh_, cbw_)
    cr = _idct_plane(cr_c, qt[2], crh, crw)
    # libjpeg range-limits IDCT samples to [0, 255] BEFORE upsampling
    # (jidctint's range_limit table); matching it here bounds the
    # upsample operands — real (pixel-sourced) streams are unaffected.
    # Applied only when an upsample runs, like the batched program.
    if (vy, hy) != (vc, hc):
        cb = jnp.clip(cb, 0.0, 255.0)
    if (vy, hy) != (vr, hr):
        cr = jnp.clip(cr, 0.0, 255.0)
    cb = _upsample(cb, vy // vc, hy // hc)
    cr = _upsample(cr, vy // vr, hy // hr)
    y = y[:out_h, :out_w]
    cb = cb[:out_h, :out_w] - 128.0
    cr = cr[:out_h, :out_w] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    rgb = jnp.stack([r, g, b], axis=0)  # planar (3, H, W)
    return jnp.clip(jnp.round(rgb), 0, 255).astype(jnp.uint8)


@jax.jit
def _idct_planes_batched(coefs_i16, qtabs_f32):
    """(B, bh*8, bw*8) int16 quantized coefs + (B, 8, 8) per-image quant
    tables -> float32 samples (level-shifted +128). Zero-padded blocks
    decode to flat 128-gray, which stays inside the cropped region.

    Layout-preserving: both 8-point transforms contract an axis carved
    out of the plane in place ((B, bh, 8, W) then (B, H, bw, 8)) — no
    per-block gather/transpose ever materializes."""
    b, hh, ww = coefs_i16.shape
    bh, bw = hh // 8, ww // 8
    d = jnp.asarray(_idct_basis())
    x = coefs_i16.astype(jnp.float32).reshape(b, bh, 8, bw, 8)
    x = x * qtabs_f32[:, None, :, None, :]
    x = jnp.clip(x, -4096.0, 4096.0)  # see _idct_plane
    # vertical: spatial_i = sum_k D[k, i] * coef[k, .]
    x = jnp.einsum("ki,bhkw->bhiw", d, x.reshape(b, bh, 8, ww),
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    # horizontal: spatial_j = sum_l coef[., l] * D[l, j]
    x = jnp.einsum("bhwl,lj->bhwj", x.reshape(b, hh, bw, 8), d,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    return x.reshape(b, hh, ww) + 128.0


def _clamp_extent(plane, valid_hw):
    """Replicate each image's last valid row/col across the canvas
    padding, batched — matches the plane-edge clamp the single-image
    path gets for free (without it the triangular upsample's `next` tap
    reads a zero-padded block at the image's chroma grid boundary)."""
    bsz, h, w = plane.shape
    iy = jnp.minimum(jnp.arange(h, dtype=jnp.int32)[None],
                     valid_hw[:, :1] - 1)
    plane = jnp.take_along_axis(plane, iy[:, :, None], axis=1,
                                mode="promise_in_bounds")
    ix = jnp.minimum(jnp.arange(w, dtype=jnp.int32)[None],
                     valid_hw[:, 1:2] - 1)
    return jnp.take_along_axis(plane, ix[:, None, :], axis=2,
                               mode="promise_in_bounds")


@functools.partial(jax.jit, static_argnames=("fh", "fw", "out_h", "out_w"))
def batched_decode_ycbcr(yc, cbc, crc, qtabs, chroma_valid,
                         fh: int = 2, fw: int = 2,
                         out_h: int | None = None, out_w: int | None = None):
    """Batched device-side baseline YCbCr decode into an RGB bucket.

    fh/fw: chroma upsample factors (luma/chroma sampling ratio) —
    (2, 2) = 4:2:0, (1, 2) = 4:2:2, (2, 1) = 4:4:0, (1, 1) = 4:4:4.
    out_h/out_w: crop the decoded canvas back to the resolution bucket
    (the coefficient canvas is MCU-padded past it) inside this program.

    yc: (B, Hb, Wb) int16 luma coefficient canvases (bucket-sized, zero
    padded); cbc/crc: (B, Hb/fh, Wb/fw); qtabs: (B, 3, 8, 8) float32;
    chroma_valid: (B, 2) int32 — each image's own chroma plane dims
    (its MCU grid / factor), the clamp boundary for the upsample taps.
    Returns (B, Hb, Wb, 3) uint8 — the canvas the engine's pipeline
    consumes, so the dense half of every JPEG decode (IDCT, fancy chroma
    upsample, color convert) runs on the device and the host keeps only
    the streaming entropy scan.
    """
    y = _idct_planes_batched(yc, qtabs[:, 0])
    cb = _idct_planes_batched(cbc, qtabs[:, 1])
    cr = _idct_planes_batched(crc, qtabs[:, 2])
    if fh > 1 or fw > 1:
        # The triangular filter's `next` tap must not read a zero-padded
        # block at the image's chroma grid boundary.
        cb = _clamp_extent(cb, chroma_valid)
        cr = _clamp_extent(cr, chroma_valid)
        # libjpeg range-limits IDCT samples before upsampling; see
        # _decode_ycbcr.
        cb = jnp.clip(cb, 0.0, 255.0)
        cr = jnp.clip(cr, 0.0, 255.0)
    # libjpeg fancy (triangular) 2x upsample; batched planes use
    # axes (1, 2) of (B, h, w).
    if fh == 2:
        cb = _fancy_up2_axis(cb, 1)
        cr = _fancy_up2_axis(cr, 1)
    if fw == 2:
        cb = _fancy_up2_axis(cb, 2)
        cr = _fancy_up2_axis(cr, 2)
    cb = cb - 128.0
    cr = cr - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    bch = y + 1.772 * cb
    rgb = jnp.stack([r, g, bch], axis=-1)  # (B, H, W, 3)
    if out_h is not None or out_w is not None:
        rgb = rgb[:, :out_h, :out_w]
    return jnp.clip(jnp.round(rgb), 0, 255).astype(jnp.uint8)


def batched_decode_ycbcr420(yc, cbc, crc, qtabs, chroma_valid):
    """Back-compat wrapper: batched 4:2:0 decode (fh=fw=2)."""
    return batched_decode_ycbcr(yc, cbc, crc, qtabs, chroma_valid,
                                fh=2, fw=2)


def decode_jpeg_device(data: bytes, pad_hw: tuple[int, int] | None = None):
    """Full device-side decode of one baseline JPEG: host entropy pass +
    device math. Returns planar (3, H, W) uint8 (padded if pad_hw given).

    Grayscale JPEGs replicate luma across channels.
    """
    from imageprocessor_tpu.runtime import nativecodec

    try:
        # Preferred: the streaming one-pass entropy decoder
        # (native/jpeg_scan.cpp) — faster than even a full SIMD libjpeg
        # decode, and with no virtual-array buffering. Plane dims are
        # MCU-aligned, which the block math below handles transparently.
        planes, qtabs, (img_w, img_h), sampling = \
            nativecodec.scan_jpeg_coefficients(data)
    except nativecodec.NativeCodecError:
        # Progressive / arithmetic / exotic streams: libjpeg's
        # coefficient API handles everything baseline doesn't cover.
        planes, qtabs, (img_w, img_h), sampling = \
            nativecodec.read_jpeg_coefficients(data)
    if len(planes) == 1:
        y = _idct_plane(jnp.asarray(planes[0]), jnp.asarray(qtabs[0]),
                        planes[0].shape[0] // 8, planes[0].shape[1] // 8)
        y = jnp.clip(jnp.round(y[:img_h, :img_w]), 0, 255).astype(jnp.uint8)
        out = jnp.broadcast_to(y[None], (3, img_h, img_w))
    else:
        # The YCbCr device math assumes luma carries the max sampling
        # factors and chroma divides them evenly (4:4:4/4:2:2/4:4:0/
        # 4:2:0). Spec-legal oddities (Y 1x1 + Cb 2x2, 3:2 ratios — the
        # scanner accepts h,v in 1..4) would integer-divide to factor 0
        # and crash with a shape error; reject them as NativeCodecError
        # so callers fall back to the generic decoder.
        (hy, vy), (hc, vc), (hr, vr) = (tuple(s) for s in sampling)
        if not ((hc, vc) == (hr, vr) and hc and vc
                and hy % hc == 0 and vy % vc == 0
                and hy // hc in (1, 2) and vy // vc in (1, 2)):
            raise nativecodec.NativeCodecError(
                f"unsupported sampling layout {sampling}")
        shapes = tuple((p.shape[0] // 8, p.shape[1] // 8) for p in planes)
        out = _decode_ycbcr(
            jnp.asarray(planes[0]), jnp.asarray(planes[1]),
            jnp.asarray(planes[2]), jnp.asarray(qtabs),
            shapes, tuple(sampling), img_h, img_w)
    if pad_hw is not None:
        ph, pw = pad_hw
        out = jnp.pad(out, ((0, 0), (0, ph - img_h), (0, pw - img_w)))
    return out
