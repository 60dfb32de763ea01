"""Text watermark: host-rasterized glyph tile + on-device alpha composite.

Reference behavior (operations/watermark.go:40-155): freetype renders the
text string directly onto an RGBA copy of the image at one of seven anchor
positions with a 20 px margin, color (R,G,B) at alpha = opacity*255,
DPI 72, default font size 36, text box height = fontSize*1.2.

Device design: rasterizing vector glyphs is branchy scalar work that belongs
on the host — but it only depends on (text, font, size), NOT on the image.
So the coverage mask is rendered once per distinct watermark spec, cached,
and shipped to the device as a small uint8 tile; the per-image work on
device is a pure alpha blend over a Th x Tw window — bandwidth-trivial and
batchable. Anchor arithmetic reproduces watermark.go:121-148 exactly
(baseline-anchored points, margin 20), with proper edge clipping (the
reference clips overhanging text; we shift the window and shift the tile
read by the same amount, which is equivalent).
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from imageprocessor_tpu.domain.task import (
    DEFAULT_WATERMARK_OPACITY,
    DEFAULT_WATERMARK_TEXT,
    WatermarkPosition,
)

_MARGIN = 20  # px, reference watermark.go:121


@dataclass(frozen=True)
class WatermarkTile:
    """Host-rasterized coverage mask plus the metrics the anchor math needs.

    coverage: (Th, Tw) float32 in [0, 1] — glyph coverage, baseline at row
    `ascent`. width_px/height_px mirror the reference's text-box metrics
    (watermark.go:109-116): advance-sum width, fontSize*1.2 height.
    """

    coverage: np.ndarray
    width_px: int
    height_px: int
    ascent: int
    descent: int


_FONT_LOCK = threading.Lock()
# Bounded like PipelineModel's arg caches: the key is user-controlled
# (watermark_text form field), so an unbounded dict is a slow memory
# leak on a long-lived worker. FIFO eviction via dict insertion order.
_TILE_CACHE: dict[tuple, WatermarkTile] = {}
_TILE_CACHE_MAX = 128
_DEFAULT_FONT_PATH: str | None = None

# Widest tile the rasterizer will allocate. The blend window clips to
# the image and no bucket exceeds 6144 px, so glyphs past this are
# never visible; without the cap a 64 KiB watermark_text rasterizes a
# multi-GB coverage buffer (the Go reference draws clipped into the
# image and never allocates text-proportional memory,
# watermark.go:96-151). Anchor math uses the CLIPPED width for
# right/center positions — a documented divergence for absurd texts.
_MAX_TILE_W = 8192


def _default_font_path() -> str:
    """Bundled-font lookup, in priority order:

    1. IMAGEPROCESSOR_FONT env var,
    2. a Go-Regular TTF dropped into assets/fonts/ (the reference embeds
       Go-Regular, watermark.go:29-38; the repository ships no copy —
       deployments wanting glyph-exact parity with Go outputs copy
       Go-Regular.ttf there and every render picks it up),
    3. DejaVu Sans (metrically similar humanist sans), shipped in
       assets/fonts/ with its license, as fallback.
    """
    global _DEFAULT_FONT_PATH
    if _DEFAULT_FONT_PATH is None:
        import os
        env = os.environ.get("IMAGEPROCESSOR_FONT")
        if env:
            _DEFAULT_FONT_PATH = env
        else:
            here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            fonts = os.path.join(here, "assets", "fonts")
            for name in ("Go-Regular.ttf", "GoRegular.ttf", "goregular.ttf",
                         "DejaVuSans.ttf"):
                cand = os.path.join(fonts, name)
                if os.path.exists(cand):
                    _DEFAULT_FONT_PATH = cand
                    break
    return _DEFAULT_FONT_PATH


def rasterize_text(text: str, font_size: float = 36.0,
                   font_path: str | None = None) -> WatermarkTile:
    """Render `text` to a coverage tile (cached per (text, size, font)).

    Uses FreeType via PIL at DPI 72 (1 pt == 1 px), matching the
    reference's freetype context setup (watermark.go:96-104).
    """
    font_path = font_path or _default_font_path()
    key = (text, float(font_size), font_path)
    tile = _TILE_CACHE.get(key)
    if tile is not None:
        return tile
    with _FONT_LOCK:
        tile = _TILE_CACHE.get(key)
        if tile is not None:
            return tile
        from PIL import Image, ImageDraw, ImageFont

        font = ImageFont.truetype(font_path, int(round(font_size)))
        ascent, descent = font.getmetrics()
        # Reference width = ceil(sum of glyph advances) (watermark.go:109-115)
        width_px = min(int(np.ceil(font.getlength(text))), _MAX_TILE_W - 8)
        height_px = int(np.ceil(font_size * 1.2))  # watermark.go:116
        th = ascent + descent
        tw = max(width_px + 8, 1)  # small slack for right-side overhang
        img = Image.new("L", (tw, th), 0)
        draw = ImageDraw.Draw(img)
        draw.text((0, 0), text, fill=255, font=font)
        coverage = np.asarray(img, dtype=np.float32) / 255.0
        tile = WatermarkTile(coverage=coverage, width_px=width_px,
                             height_px=height_px, ascent=ascent,
                             descent=descent)
        while len(_TILE_CACHE) >= _TILE_CACHE_MAX:
            _TILE_CACHE.pop(next(iter(_TILE_CACHE)))
        _TILE_CACHE[key] = tile
        return tile


def anchor_baseline(position: str, img_w, img_h, tile: WatermarkTile):
    """Baseline origin (x, y) for the text, reference watermark.go:121-148.

    Works with Python ints (static path) or traced int32 scalars/arrays
    (batched path). Unknown positions fall through to bottom-right, like
    the reference's default case. One implementation for both entry
    points: delegates to _anchor_traced (same arithmetic, runtime
    width/height inputs) so the single-image and batched paths cannot
    drift."""
    return _anchor_traced(position, img_w, img_h,
                          tile.width_px, tile.height_px)


def parse_color(color_str: str, opacity: float) -> tuple[int, int, int, int]:
    """"R,G,B[,A]" -> RGBA, reference parseColor (watermark.go:159-186).

    Invalid strings fall back to white at opacity alpha — but note the
    reference then *uses black* when parse errors (watermark.go:92-94);
    callers pass the parsed flag accordingly.
    """
    s = color_str.replace(" ", "")
    parts = s.split(",")
    default_a = int(255 * opacity)
    if len(parts) not in (3, 4):
        raise ValueError("invalid color format")
    try:
        r, g, b = int(parts[0]), int(parts[1]), int(parts[2])
    except ValueError as exc:
        raise ValueError("invalid color values") from exc
    clamp = lambda v: max(0, min(255, v))  # noqa: E731
    a = default_a
    if len(parts) == 4:
        try:
            a = clamp(int(parts[3]))
        except ValueError:
            a = default_a
    return clamp(r), clamp(g), clamp(b), a


def resolve_color(color_str: str, opacity: float) -> tuple[int, int, int, int]:
    """Reference error path: parse failure -> black at opacity
    (watermark.go:92-94)."""
    try:
        return parse_color(color_str, opacity)
    except ValueError:
        return 0, 0, 0, int(255 * opacity)


@functools.partial(jax.jit, static_argnames=("tile_h", "tile_w"))
def _blend_at(img_u8, padded_tile, color_rgb, alpha, x0, y0,
              valid_w, valid_h, tile_h: int, tile_w: int):
    """Blend one tile into one uint8 image at (x0, y0) with clipping.

    Only the Th x Tw window round-trips through float32 — the rest of the
    image is untouched uint8, so a 12 MP watermark costs a ~tile-sized
    blend plus (at worst) one uint8 copy, never a full f32 materialization.

    padded_tile: (3*tile_h, 3*tile_w) f32 — coverage tile centered in a zero
    canvas so a shifted window read stays in bounds in both directions.
    Negative/overflowing origins are handled by clamping the destination
    window and shifting the tile read by the same amount (equivalent to the
    reference's freetype clip, watermark.go:100).
    """
    h, w = img_u8.shape[0], img_u8.shape[1]
    win_h, win_w = min(tile_h, h), min(tile_w, w)  # text may exceed the image
    dx = jnp.clip(x0, 0, w - win_w)
    dy = jnp.clip(y0, 0, h - win_h)
    # The tile sits at [tile_h:2*tile_h, tile_w:2*tile_w] inside a 3x zero
    # canvas, so a window clamped in either direction reads the correctly
    # shifted coverage (zeros where the text falls outside the window).
    tx = jnp.clip(dx - x0 + tile_w, 0, 3 * tile_w - win_w)
    ty = jnp.clip(dy - y0 + tile_h, 0, 3 * tile_h - win_h)

    cov = jax.lax.dynamic_slice(padded_tile, (ty, tx), (win_h, win_w))
    # Mask out pixels beyond the image's valid extent (bucket padding) and
    # beyond the intended (unclamped) draw rect.
    rows = dy + jnp.arange(win_h, dtype=jnp.int32)[:, None]
    cols = dx + jnp.arange(win_w, dtype=jnp.int32)[None, :]
    inside = ((rows < valid_h) & (cols < valid_w)).astype(jnp.float32)
    m = (cov * inside * alpha)[:, :, None]

    region = jax.lax.dynamic_slice(img_u8, (dy, dx, 0),
                                   (win_h, win_w, img_u8.shape[2]))
    blended = (region.astype(jnp.float32) * (1.0 - m)
               + color_rgb[None, None, :] * m)
    blended_u8 = jnp.clip(jnp.round(blended), 0, 255).astype(jnp.uint8)
    return jax.lax.dynamic_update_slice(img_u8, blended_u8, (dy, dx, 0))


def _pad_tile(tile: WatermarkTile) -> np.ndarray:
    th, tw = tile.coverage.shape
    out = np.zeros((3 * th, 3 * tw), dtype=np.float32)
    out[th:2 * th, tw:2 * tw] = tile.coverage
    return out


def watermark_image(img_u8, text: str = DEFAULT_WATERMARK_TEXT,
                    position: str = "bottom-right",
                    opacity: float = DEFAULT_WATERMARK_OPACITY,
                    font_size: float = 36.0,
                    font_color: str = "255,255,255",
                    font_path: str | None = None):
    """Reference `Watermarker.Process` core (watermark.go:40-155).

    Single-image path: full-resolution alpha composite of the rasterized
    text at the anchor position. Returns uint8 (H, W, C).
    """
    tile = rasterize_text(text, font_size, font_path)
    r, g, b, a = resolve_color(font_color, opacity)
    h, w = int(img_u8.shape[0]), int(img_u8.shape[1])
    bx, by = anchor_baseline(position, w, h, tile)
    x0 = int(bx)
    y0 = int(by) - tile.ascent  # baseline -> tile top row
    th, tw = tile.coverage.shape
    return _blend_at(
        jnp.asarray(img_u8),
        jnp.asarray(_pad_tile(tile)),
        jnp.asarray([r, g, b], dtype=jnp.float32),
        jnp.float32(a / 255.0),
        jnp.int32(x0), jnp.int32(y0),
        jnp.int32(w), jnp.int32(h),
        tile_h=th, tile_w=tw,
    )


def quantize_tile(tile: WatermarkTile, h_mult: int = 16,
                  w_mult: int = 64) -> WatermarkTile:
    """Zero-pad coverage to quantized dims so different watermark texts
    share one compiled program (shape stability; content stays dynamic)."""
    th, tw = tile.coverage.shape
    qh = -(-th // h_mult) * h_mult
    qw = -(-tw // w_mult) * w_mult
    if (qh, qw) == (th, tw):
        return tile
    cov = np.zeros((qh, qw), dtype=np.float32)
    cov[:th, :tw] = tile.coverage
    return WatermarkTile(coverage=cov, width_px=tile.width_px,
                         height_px=tile.height_px, ascent=tile.ascent,
                         descent=tile.descent)


def _anchor_traced(position: str, img_w, img_h, width_px, height_px):
    """Anchor arithmetic (watermark.go:121-148) over traced scalars —
    width_px/height_px are runtime inputs so text changes don't recompile."""
    try:
        pos = WatermarkPosition(position)
    except ValueError:
        pos = WatermarkPosition.BOTTOM_RIGHT
    m = _MARGIN
    if pos is WatermarkPosition.TOP_LEFT:
        return m + 0 * img_w, m + height_px + 0 * img_h
    if pos is WatermarkPosition.TOP_RIGHT:
        return img_w - width_px - m, m + height_px + 0 * img_h
    if pos is WatermarkPosition.TOP_CENTER:
        return (img_w - width_px) // 2, m + height_px + 0 * img_h
    if pos is WatermarkPosition.BOTTOM_LEFT:
        return m + 0 * img_w, img_h - m
    if pos is WatermarkPosition.BOTTOM_CENTER:
        return (img_w - width_px) // 2, img_h - m
    if pos is WatermarkPosition.CENTER:
        return (img_w - width_px) // 2, (img_h + height_px) // 2
    return img_w - width_px - m, img_h - m


def batched_watermark_core(imgs_u8, src_hw, padded_tile, color_rgb, alpha,
                           width_px, height_px, ascent, *, position: str,
                           tile_h: int, tile_w: int):
    """Jit-composable core: all image/text content is traced; only the
    anchor position and (quantized) tile shape are static. uint8 in/out —
    only the blend window touches float32, so the full-resolution frame
    never materializes as f32 in HBM."""
    w = src_hw[:, 1].astype(jnp.int32)
    h = src_hw[:, 0].astype(jnp.int32)
    bx, by = _anchor_traced(position, w, h,
                            jnp.int32(width_px), jnp.int32(height_px))
    x0 = bx.astype(jnp.int32)
    y0 = (by - ascent).astype(jnp.int32)

    def one(img, x, y, h_w):
        return _blend_at(img, padded_tile, color_rgb, alpha, x, y,
                         h_w[1], h_w[0], tile_h, tile_w)

    return jax.vmap(one)(imgs_u8, x0, y0, src_hw.astype(jnp.int32))


def batched_watermark(imgs_u8, src_hw, tile: WatermarkTile,
                      position: str = "bottom-right",
                      opacity: float = DEFAULT_WATERMARK_OPACITY,
                      font_color: str = "255,255,255"):
    """Watermark a padded bucket in place; positions follow each image's
    valid (h, w) so the text lands relative to the true image, not the pad.

    Returns (B, Hp, Wp, C) uint8 — valid region watermarked, padding
    unspecified; the host crops to src_hw before encode.
    """
    r, g, b, a = resolve_color(font_color, opacity)
    th, tw = tile.coverage.shape
    return batched_watermark_core(
        jnp.asarray(imgs_u8), jnp.asarray(src_hw, dtype=jnp.int32),
        jnp.asarray(_pad_tile(tile)),
        jnp.asarray([r, g, b], dtype=jnp.float32),
        jnp.float32(a / 255.0),
        jnp.int32(tile.width_px), jnp.int32(tile.height_px),
        jnp.int32(tile.ascent),
        position=position, tile_h=th, tile_w=tw,
    )
