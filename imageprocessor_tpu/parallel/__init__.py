"""Multi-card scale-out via jax.sharding.

The workload is embarrassingly parallel over images (SURVEY.md §2
parallelism table), so the primary axis is `data` (batch). A secondary
`space` axis shards the image width for very large frames — the spatial
analogue of sequence parallelism: the vertical resample pass is local,
the horizontal pass gathers across width shards (XLA inserts the
all-gather automatically from the sharding annotations).

Cross-host distribution stays on the queue (one consumer-group member per
worker host), exactly like the reference scales workers horizontally over
Kafka partitions (consumer.go:23, Makefile:24) — no DCN collectives are
semantically required.
"""

from imageprocessor_tpu.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch_arrays,
)

__all__ = ["make_mesh", "batch_sharding", "replicated", "shard_batch_arrays"]
