"""Host-side runtime: codecs, bucketing/batching, and the device engine.

This is the accelerator-side replacement for the reference's worker internals
(reference: internal/worker/worker.go, internal/usecase/processor/): decode
and encode stay on the host (libjpeg-turbo via OpenCV, GIL-released, thread
pooled); everything between them runs as batched XLA programs.
"""

from imageprocessor_tpu.runtime.codecs import (
    decode_image,
    detect_content_type,
    encode_image,
    format_from_content_type,
    mime_from_path,
    negotiate_format,
)

__all__ = [
    "decode_image",
    "encode_image",
    "detect_content_type",
    "format_from_content_type",
    "mime_from_path",
    "negotiate_format",
]
