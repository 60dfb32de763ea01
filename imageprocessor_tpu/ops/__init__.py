"""On-device image operations (JAX/XLA/Pallas).

This package is the device replacement for the reference's pure-Go pixel layer
(reference: internal/usecase/processor/operations/{resize,thumbnail,watermark}.go).
Every op is a pure function over arrays; shapes are static per call so XLA
compiles one program per (bucket, plan) pair. Two API levels:

* single-image ops (`resize_image`, `thumbnail_image`, `watermark_image`, ...)
  — exact reference semantics, the correctness anchor;
* batched bucketed ops (`batched_*`) — operate on padded (B, H, W, C) buckets
  with per-image valid dims and per-image scale factors; the production path.
"""

from imageprocessor_tpu.ops.coords import keep_aspect_dims, thumbnail_dims
from imageprocessor_tpu.ops.resize import (
    batched_resize_bilinear,
    resize_bilinear_u8,
    resize_image,
)
from imageprocessor_tpu.ops.thumbnail import batched_thumbnail, thumbnail_image
from imageprocessor_tpu.ops.watermark import (
    WatermarkTile,
    batched_watermark,
    rasterize_text,
    watermark_image,
)
from imageprocessor_tpu.ops.extra import (
    crop_image,
    flip_image,
    grayscale_image,
    rotate_image,
)

__all__ = [
    "keep_aspect_dims",
    "thumbnail_dims",
    "resize_image",
    "resize_bilinear_u8",
    "batched_resize_bilinear",
    "thumbnail_image",
    "batched_thumbnail",
    "watermark_image",
    "batched_watermark",
    "rasterize_text",
    "WatermarkTile",
    "crop_image",
    "rotate_image",
    "flip_image",
    "grayscale_image",
]
