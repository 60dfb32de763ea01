"""imageprocessor_tpu — a batch image-processing framework for JAX
accelerators (an NVIDIA GPU in production, the CPU in tests).

A from-scratch rebuild of the capabilities of sj-shoff/ImageProcessor
(an async Go microservice: HTTP upload -> queue -> worker -> object store)
re-designed accelerator-first:

* the per-image, per-goroutine CPU pixel loop of the reference
  (reference: internal/worker/worker.go:112-148,
  internal/usecase/processor/image_processor.go:39-102) becomes a batched,
  resolution-bucketed JAX/XLA device pipeline;
* host work (JPEG/PNG codec, queue/storage I/O) is pipelined around the
  device step with thread pools and double buffering;
* multi-card scale-out is expressed with `jax.sharding.Mesh` + `shard_map`
  over the batch (data) axis — no collectives are semantically required
  because images are independent.

Public surface (mirrors the reference's external contracts):

* HTTP API: POST /api/images/upload, GET /api/images/{id}[?operation=..],
  GET /api/images/{id}/status, DELETE /api/images/{id}, GET /api/images,
  GET /api/health (reference: internal/http-server/router/router.go:41-50).
* Queue topics "image-processing" / "image-processed" with the reference's
  JSON payload shapes (reference: internal/domain/task.go:3-23,38-40).
* Object-store path scheme processed/{op}/{id}/... (reference:
  internal/usecase/processor/image_processor.go:129-162).
"""

from imageprocessor_tpu.version import __version__

__all__ = ["__version__"]
