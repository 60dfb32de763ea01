"""Thumbnail op: aspect-fit or center-crop-to-square.

Reference semantics (operations/thumbnail.go:25-132):
* crop_to_fit: center square crop (an identity-scale blit in the reference,
  thumbnail.go:114-132) then bilinear to size x size;
* otherwise: shorter side scaled to `size`, longer side proportional with
  int truncation (thumbnail.go:53-64).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from imageprocessor_tpu.ops.coords import (
    bilinear_coords,
    center_crop_rect,
    quantize_go_xdraw,
    thumbnail_dims,
)
from imageprocessor_tpu.ops.resize import (
    _lerp_axis_cols,
    _lerp_axis_rows,
    gather_lerp,
    resize_bilinear_u8,
)


@functools.partial(jax.jit, static_argnames=("size", "crop_x", "crop_y", "crop_side"))
def _crop_resize_u8(img_u8, size: int, crop_x: int, crop_y: int, crop_side: int):
    # Coordinates are computed inside the crop window [0, side) and only then
    # shifted by the crop origin, so edge clamping clamps to the crop, not
    # to the full image (matches the reference's crop-then-resize two-pass).
    x = img_u8.astype(jnp.float32)
    ri0, ri1, rf = bilinear_coords(size, crop_side)
    x = _lerp_axis_rows(x, ri0 + crop_y, ri1 + crop_y, rf)
    ci0, ci1, cf = bilinear_coords(size, crop_side)
    x = _lerp_axis_cols(x, ci0 + crop_x, ci1 + crop_x, cf)
    return quantize_go_xdraw(x)


def thumbnail_image(img_u8, size: int, crop_to_fit: bool = False):
    """Reference `Thumbnailer.Process` core (thumbnail.go:25-132)."""
    h, w = int(img_u8.shape[0]), int(img_u8.shape[1])
    if crop_to_fit:
        cx, cy, side = center_crop_rect(w, h)
        # Reference does crop (identity blit) then a separate bilinear pass;
        # a single offset bilinear over the crop window is arithmetically
        # identical because the blit is an exact pixel copy.
        return _crop_resize_u8(img_u8, size, cx, cy, side)
    out_w, out_h = thumbnail_dims(w, h, size)
    return resize_bilinear_u8(img_u8, max(out_h, 1), max(out_w, 1))


def _crop_coords(size: int, side, origin, cap: int):
    """Gather indices for one axis of a centered square crop resampled to
    `size`: src = (d + .5) * side/size - .5 + origin, clamped to the crop
    window (not the image), then to the canvas."""
    dst = jnp.arange(size, dtype=jnp.float32)[None, :]
    scale = side.astype(jnp.float32)[:, None] / float(size)
    src = (dst + 0.5) * scale - 0.5
    src = jnp.clip(src, 0.0, side.astype(jnp.float32)[:, None] - 1.0)
    src = src + origin.astype(jnp.float32)[:, None]
    i0 = jnp.floor(src).astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, (origin + side - 1)[:, None])
    i0 = jnp.minimum(i0, cap - 1)
    i1 = jnp.minimum(i1, cap - 1)
    return i0, i1, src - i0.astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("size",))
def batched_thumbnail(imgs_u8, src_hw, size: int):
    """Batched crop-to-fit thumbnails over a padded bucket.

    imgs_u8: (B, Hp, Wp, C) uint8; src_hw: (B, 2) valid (h, w). Always
    produces a (B, size, size, C) canvas. For crop-to-fit (the service
    default, handler/image/image.go:224-231) the full canvas is valid.
    Aspect-mode images are produced by `batched_resize_bilinear` with
    out_hw=thumbnail dims instead (engine dispatches there), so this
    kernel only implements the square crop path.
    """
    h = src_hw[:, 0]
    w = src_hw[:, 1]
    side = jnp.minimum(h, w)                                     # (B,)
    crop_x = jnp.where(w > h, (w - h) // 2, 0)
    crop_y = jnp.where(w > h, 0, (h - w) // 2)
    ri0, ri1, rf = _crop_coords(size, side, crop_y, imgs_u8.shape[1])
    x = gather_lerp(imgs_u8, ri0, ri1, rf, 1)
    ci0, ci1, cf = _crop_coords(size, side, crop_x, imgs_u8.shape[2])
    x = gather_lerp(x, ci0, ci1, cf, 2)
    return quantize_go_xdraw(x)
