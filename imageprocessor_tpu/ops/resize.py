"""Bilinear resize — the hot op.

Semantics match the reference's `xdraw.BiLinear.Scale` into a fresh RGBA
canvas with `Over` compositing (reference: operations/resize.go:121-125):
half-pixel source mapping, edge clamping, 16-bit premultiplied quantization.

Device design: a separable two-pass gather+lerp. A downscale reads only
the source rows/cols that contribute (2 taps per output), so the pass is
memory-bandwidth bound rather than compute bound — for 12 MP -> 1024x768
that is ~20 MB of traffic per image instead of the ~74 GFLOP a dense
weight-matrix formulation would burn.

The batched variant vectorizes over images with *per-image* scale factors
(mixed resolutions inside one padded bucket) using `jnp.take_along_axis`
with batched index arrays — one compiled program per (bucket, out-shape).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from imageprocessor_tpu.ops.coords import bilinear_coords, keep_aspect_dims, quantize_go_xdraw


def _lerp_axis_rows(img_f32, idx0, idx1, frac):
    """Vertical pass over axis 0 of (H, W, C)."""
    top = jnp.take(img_f32, idx0, axis=0)
    bot = jnp.take(img_f32, idx1, axis=0)
    return top + (bot - top) * frac[:, None, None]


def _lerp_axis_cols(img_f32, idx0, idx1, frac):
    """Horizontal pass over axis 1 of (H, W, C)."""
    left = jnp.take(img_f32, idx0, axis=1)
    right = jnp.take(img_f32, idx1, axis=1)
    return left + (right - left) * frac[None, :, None]


@functools.partial(jax.jit, static_argnames=("out_h", "out_w"))
def resize_bilinear_u8(img_u8, out_h: int, out_w: int):
    """uint8 (H, W, C) -> uint8 (out_h, out_w, C), Go-xdraw-equivalent."""
    src_h, src_w = img_u8.shape[0], img_u8.shape[1]
    x = img_u8.astype(jnp.float32)
    ri0, ri1, rf = bilinear_coords(out_h, src_h)
    x = _lerp_axis_rows(x, ri0, ri1, rf)
    ci0, ci1, cf = bilinear_coords(out_w, src_w)
    x = _lerp_axis_cols(x, ci0, ci1, cf)
    return quantize_go_xdraw(x)


def resize_image(img_u8, width: int, height: int, keep_aspect: bool = False):
    """Reference `Resizer.Process` core semantics (operations/resize.go:26-91).

    `width`/`height` must be positive (validated by the caller, matching
    resize.go:54-56). With keep_aspect, the min-ratio rule picks the target
    (resize.go:63-72). Returns a uint8 array of the target size.
    """
    if keep_aspect:
        out_w, out_h = keep_aspect_dims(img_u8.shape[1], img_u8.shape[0], width, height)
        out_w, out_h = max(out_w, 1), max(out_h, 1)
    else:
        out_w, out_h = width, height
    return resize_bilinear_u8(img_u8, out_h, out_w)


# ---------------------------------------------------------------------------
# Batched bucketed path
# ---------------------------------------------------------------------------

def _batched_coords(out_size: int, valid_src, out_valid, src_cap: int):
    """Per-image gather indices for a padded batch.

    valid_src: (B,) int32 — true source extent per image.
    out_valid: (B,) int32 — true output extent per image (canvas is padded
      to `out_size`; rows/cols beyond out_valid are don't-care).
    Returns idx0, idx1 (B, out_size) int32 and frac (B, out_size) f32.
    """
    dst = jnp.arange(out_size, dtype=jnp.float32)[None, :]          # (1, O)
    scale = valid_src.astype(jnp.float32) / jnp.maximum(
        out_valid.astype(jnp.float32), 1.0)                          # (B,)
    src = (dst + 0.5) * scale[:, None] - 0.5                         # (B, O)
    hi = valid_src.astype(jnp.float32)[:, None] - 1.0
    src = jnp.clip(src, 0.0, jnp.maximum(hi, 0.0))
    idx0 = jnp.floor(src).astype(jnp.int32)
    idx1 = jnp.minimum(idx0 + 1, jnp.maximum(valid_src[:, None] - 1, 0))
    idx0 = jnp.minimum(idx0, src_cap - 1)
    idx1 = jnp.minimum(idx1, src_cap - 1)
    frac = src - idx0.astype(jnp.float32)
    return idx0, idx1, frac


def gather_lerp(x, idx0, idx1, frac, axis: int):
    """Two-tap gather + lerp along `axis` of a batched image.

    idx0/idx1: (B, O) int32 source indices, frac: (B, O) f32 weights.
    Gathers run on the input dtype (uint8 moves 4x fewer bytes than f32);
    the cast follows the gather."""
    shape = [1] * x.ndim
    shape[0], shape[axis] = idx0.shape
    a = jnp.take_along_axis(x, idx0.reshape(shape), axis=axis,
                            mode="promise_in_bounds").astype(jnp.float32)
    b = jnp.take_along_axis(x, idx1.reshape(shape), axis=axis,
                            mode="promise_in_bounds").astype(jnp.float32)
    return a + (b - a) * frac.reshape(shape)


@functools.partial(jax.jit, static_argnames=("out_h", "out_w"))
def batched_resize_bilinear(imgs_u8, src_hw, out_hw, out_h: int, out_w: int):
    """Per-image-scale bilinear over a padded bucket.

    imgs_u8: (B, Hp, Wp, C) uint8, each image valid in [0:h_i, 0:w_i].
    src_hw:  (B, 2) int32 valid source (h, w) per image.
    out_hw:  (B, 2) int32 valid output (h, w) per image (<= (out_h, out_w)).
    Returns (B, out_h, out_w, C) uint8; pixels beyond each image's valid
    output extent are unspecified (the host crops to out_hw before encode).
    """
    ri0, ri1, rf = _batched_coords(out_h, src_hw[:, 0], out_hw[:, 0],
                                   imgs_u8.shape[1])
    x = gather_lerp(imgs_u8, ri0, ri1, rf, 1)
    ci0, ci1, cf = _batched_coords(out_w, src_hw[:, 1], out_hw[:, 1],
                                   imgs_u8.shape[2])
    x = gather_lerp(x, ci0, ci1, cf, 2)
    return quantize_go_xdraw(x)
