"""Operations the reference's domain enumerates but never implemented.

The reference declares crop / rotate / flip / grayscale operation types
(reference: internal/domain/image.go:42-50) and rejects them at dispatch
("unsupported operation type", image_processor.go:118-120). This framework
implements all four on-device, so the full declared surface works.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from imageprocessor_tpu.ops.coords import quantize_go_xdraw


def crop_image(img_u8, x: int, y: int, width: int, height: int):
    """Rectangular crop, clamped to image bounds."""
    h, w = int(img_u8.shape[0]), int(img_u8.shape[1])
    x = max(0, min(x, w - 1))
    y = max(0, min(y, h - 1))
    width = max(1, min(width, w - x))
    height = max(1, min(height, h - y))
    return jax.lax.slice(img_u8, (y, x, 0), (y + height, x + width, img_u8.shape[2]))


@functools.partial(jax.jit, static_argnames=("angle_deg",))
def _rotate_arbitrary(img_u8, angle_deg: float):
    """Rotate by an arbitrary angle about the center (bilinear, same canvas).

    Out-of-source pixels are black, matching the zero-filled RGBA canvas a
    Go implementation drawing into a fresh image would produce.
    """
    h, w = img_u8.shape[0], img_u8.shape[1]
    theta = jnp.deg2rad(jnp.float32(angle_deg))
    cos_t, sin_t = jnp.cos(theta), jnp.sin(theta)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = jnp.arange(h, dtype=jnp.float32)[:, None] - cy
    xx = jnp.arange(w, dtype=jnp.float32)[None, :] - cx
    # Inverse map: destination -> source, for a visually COUNTER-
    # clockwise forward rotation (screen y points down) — matching the
    # rot90 branches; the previous sign convention rotated arbitrary
    # angles clockwise, a ~180 degree discontinuity against rotate(90).
    src_x = cos_t * xx - sin_t * yy + cx
    src_y = sin_t * xx + cos_t * yy + cy
    x0 = jnp.floor(src_x).astype(jnp.int32)
    y0 = jnp.floor(src_y).astype(jnp.int32)
    fx = src_x - x0
    fy = src_y - y0
    valid = ((src_x >= -0.5) & (src_x <= w - 0.5) &
             (src_y >= -0.5) & (src_y <= h - 0.5))

    def gather(yi, xi):
        yi = jnp.clip(yi, 0, h - 1)
        xi = jnp.clip(xi, 0, w - 1)
        return img_u8.astype(jnp.float32)[yi, xi]

    p00 = gather(y0, x0)
    p01 = gather(y0, x0 + 1)
    p10 = gather(y0 + 1, x0)
    p11 = gather(y0 + 1, x0 + 1)
    top = p00 + (p01 - p00) * fx[..., None]
    bot = p10 + (p11 - p10) * fx[..., None]
    out = top + (bot - top) * fy[..., None]
    out = jnp.where(valid[..., None], out, 0.0)
    return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)


def rotate_image(img_u8, angle: float):
    """Rotate counter-clockwise. Multiples of 90° are exact pixel shuffles
    (lane/sublane transposes XLA handles natively); other angles use an
    inverse-mapped bilinear sample on the same canvas."""
    a = float(angle) % 360.0
    if a == 0.0:
        return img_u8
    if a == 90.0:
        return jnp.rot90(img_u8, k=1, axes=(0, 1))
    if a == 180.0:
        return jnp.rot90(img_u8, k=2, axes=(0, 1))
    if a == 270.0:
        return jnp.rot90(img_u8, k=3, axes=(0, 1))
    return _rotate_arbitrary(img_u8, a)


def flip_image(img_u8, direction: str = "horizontal"):
    """Mirror horizontally (default) or vertically."""
    if direction == "vertical":
        return jnp.flip(img_u8, axis=0)
    return jnp.flip(img_u8, axis=1)


@jax.jit
def grayscale_image(img_u8):
    """Luma grayscale with Go stdlib arithmetic.

    Go color.GrayModel: y = (299 r + 587 g + 114 b + 500) / 1000 computed
    on 16-bit channels; replicated across RGB so output stays 3-channel.
    """
    x = img_u8[..., :3].astype(jnp.float32) * 257.0  # 8 -> 16 bit (v * 0x101)
    y16 = (299.0 * x[..., 0] + 587.0 * x[..., 1] + 114.0 * x[..., 2] + 500.0) / 1000.0
    y8 = jnp.clip(jnp.floor(y16) // 256, 0, 255)
    out = jnp.repeat(y8[..., None], 3, axis=-1)
    if img_u8.shape[-1] == 4:
        out = jnp.concatenate([out, img_u8[..., 3:].astype(jnp.float32)], axis=-1)
    return out.astype(jnp.uint8)


# --- batched bucket variants -------------------------------------------------

@jax.jit
def batched_grayscale(imgs_u8):
    """Elementwise luma over a full bucket; padding is harmless."""
    return grayscale_image(imgs_u8)


@functools.partial(jax.jit, static_argnames=("direction",))
def batched_flip(imgs_u8, src_hw, direction: str = "horizontal"):
    """Per-image mirror inside a padded bucket.

    A plain jnp.flip would mirror the padding into view; instead gather
    with per-image reversed indices clamped to each image's valid extent.
    """
    if direction == "vertical":
        n = imgs_u8.shape[1]
        extent = src_hw[:, 0]
        idx = extent[:, None] - 1 - jnp.arange(n, dtype=jnp.int32)[None, :]
        idx = jnp.clip(idx, 0, n - 1)
        return jnp.take_along_axis(imgs_u8, idx[:, :, None, None], axis=1, mode='promise_in_bounds')
    n = imgs_u8.shape[2]
    extent = src_hw[:, 1]
    idx = extent[:, None] - 1 - jnp.arange(n, dtype=jnp.int32)[None, :]
    idx = jnp.clip(idx, 0, n - 1)
    return jnp.take_along_axis(imgs_u8, idx[:, None, :, None], axis=2, mode='promise_in_bounds')


@functools.partial(jax.jit, static_argnames=("x", "y", "width", "height"))
def batched_crop(imgs_u8, src_hw, x: int, y: int, width: int, height: int):
    """Plan-static crop rect, clamped per image like the single-image op.

    Output canvas (B, height, width, C); each image's valid extent is
    (min(height, h_i - y_i), min(width, w_i - x_i)) with the same origin
    clamping as crop_image — the engine computes those dims host-side.
    """
    h_i = src_hw[:, 0]
    w_i = src_hw[:, 1]
    cx = jnp.clip(jnp.int32(x), 0, jnp.maximum(w_i - 1, 0))
    cy = jnp.clip(jnp.int32(y), 0, jnp.maximum(h_i - 1, 0))
    # Clamped index gather, NOT dynamic_slice: dynamic_slice clamps the
    # START to bucket_dim - slice_size, silently shifting the crop
    # origin whenever the rect extends past the bucket edge (e.g.
    # y=200 h=900 in a 1024 bucket slid up by 76 rows). Per-row clamped
    # indices keep the origin exact; rows/cols past the image's valid
    # extent clamp to the edge and are cropped off by finish_item.
    bh, bw = imgs_u8.shape[1], imgs_u8.shape[2]
    ry = jnp.clip(cy[:, None] + jnp.arange(height, dtype=jnp.int32)[None],
                  0, bh - 1)
    rx = jnp.clip(cx[:, None] + jnp.arange(width, dtype=jnp.int32)[None],
                  0, bw - 1)
    out = jnp.take_along_axis(imgs_u8, ry[:, :, None, None], axis=1,
                              mode="promise_in_bounds")
    return jnp.take_along_axis(out, rx[:, None, :, None], axis=2,
                               mode="promise_in_bounds")


def batched_rotate(imgs_u8, src_hw, angle: float):
    """Per-image rotate inside a padded bucket.

    90° multiples are exact shuffles composed from transpose + the
    extent-aware batched flip (output valid dims swap for 90/270; the
    output canvas is the transposed bucket). Other angles inverse-map
    about each image's own center; out-of-source pixels are black.
    """
    a = float(angle) % 360.0
    if a == 0.0:
        return imgs_u8
    if a in (90.0, 270.0):
        tr = jnp.transpose(imgs_u8, (0, 2, 1, 3))     # (B, Wb, Hb, C)
        hw_t = src_hw[:, ::-1]                         # valid (w_i, h_i)
        if a == 90.0:   # out[y, x] = in[x, w_i - 1 - y]
            return batched_flip(tr, hw_t, direction="vertical")
        return batched_flip(tr, hw_t, direction="horizontal")
    if a == 180.0:
        out = batched_flip(imgs_u8, src_hw, direction="horizontal")
        return batched_flip(out, src_hw, direction="vertical")
    return _batched_rotate_arbitrary(imgs_u8, src_hw, a)


@functools.partial(jax.jit, static_argnames=("angle_deg",))
def _batched_rotate_arbitrary(imgs_u8, src_hw, angle_deg: float):
    hb, wb = imgs_u8.shape[1], imgs_u8.shape[2]
    theta = jnp.deg2rad(jnp.float32(angle_deg))
    cos_t, sin_t = jnp.cos(theta), jnp.sin(theta)
    yy = jnp.arange(hb, dtype=jnp.float32)[:, None]
    xx = jnp.arange(wb, dtype=jnp.float32)[None, :]

    def one(img, hw):
        h = hw[0].astype(jnp.float32)
        w = hw[1].astype(jnp.float32)
        cy, cx = (h - 1.0) / 2.0, (w - 1.0) / 2.0
        dy = yy - cy
        dx = xx - cx
        # CCW inverse map — keep in sign-lockstep with _rotate_arbitrary
        src_x = cos_t * dx - sin_t * dy + cx
        src_y = sin_t * dx + cos_t * dy + cy
        x0 = jnp.floor(src_x).astype(jnp.int32)
        y0 = jnp.floor(src_y).astype(jnp.int32)
        fx = src_x - x0
        fy = src_y - y0
        valid = ((src_x >= -0.5) & (src_x <= w - 0.5)
                 & (src_y >= -0.5) & (src_y <= h - 0.5))

        def g(yi, xi):
            # Clamp to the image's own extent (not the bucket) so edge
            # samples replicate border pixels exactly like the
            # single-image op, never the zero padding.
            yi = jnp.clip(yi, 0, hw[0] - 1)
            xi = jnp.clip(xi, 0, hw[1] - 1)
            return img[yi, xi].astype(jnp.float32)

        top = g(y0, x0) + (g(y0, x0 + 1) - g(y0, x0)) * fx[..., None]
        bot = (g(y0 + 1, x0)
               + (g(y0 + 1, x0 + 1) - g(y0 + 1, x0)) * fx[..., None])
        out = top + (bot - top) * fy[..., None]
        out = jnp.where(valid[..., None], out, 0.0)
        return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)

    return jax.vmap(one)(imgs_u8, src_hw.astype(jnp.int32))


__all__ = ["crop_image", "rotate_image", "flip_image", "grayscale_image",
           "batched_grayscale", "batched_flip",
           "batched_crop", "batched_rotate", "quantize_go_xdraw"]
