"""Pipelined worker tests: streaming stages, deadline flush, failure paths."""

import io
import threading
import time

import numpy as np
import pytest
from PIL import Image as PILImage

from imageprocessor_tpu.broker.memory import MemoryBroker
from imageprocessor_tpu.config import load as load_config
from imageprocessor_tpu.domain import (
    ImageStatus,
    OperationParams,
    OperationType,
)
from imageprocessor_tpu.service.pipelined import PipelinedWorker
from imageprocessor_tpu.service.usecase import ImageUsecase
from imageprocessor_tpu.storage import LocalFSObjectStore, SQLiteMetadataStore
from imageprocessor_tpu.utils import RetryStrategy

RNG = np.random.default_rng(61)

OPS = [OperationParams(OperationType.THUMBNAIL,
                       {"size": 32, "crop_to_fit": True})]


def png_bytes(h=64, w=80):
    arr = RNG.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    bio = io.BytesIO()
    PILImage.fromarray(arr).save(bio, format="PNG")
    return bio.getvalue()


@pytest.fixture()
def harness(tmp_path):
    cfg = load_config({})
    cfg.worker.batch_size = 4
    cfg.worker.batch_deadline_ms = 30
    cfg.retries_attempts = 1
    meta = SQLiteMetadataStore(":memory:")
    store = LocalFSObjectStore(str(tmp_path / "objects"))
    broker = MemoryBroker()
    uc = ImageUsecase(meta, store, broker,
                      retries=RetryStrategy(attempts=1, delay_ms=1))
    worker = PipelinedWorker(cfg, meta=meta, store=store, broker=broker)
    worker._idle_sleep = 0.01
    thread = threading.Thread(target=worker.run, daemon=True)
    thread.start()
    yield uc, meta, broker, worker
    worker.stop()
    thread.join(timeout=20)
    worker.engine.close()


def wait_for(fn, timeout=180, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def test_single_upload_flows_through(harness):
    uc, meta, broker, _w = harness
    img = uc.upload_image(png_bytes(), "a.png", "image/png", OPS)
    assert wait_for(lambda: meta.get_image(img.id).status
                    is ImageStatus.COMPLETED), "never completed"
    rows = meta.list_processed(img.id)
    assert len(rows) == 1
    # acked: nothing left for the group
    assert broker.depth("image-processing",
                        _w.cfg.broker.group_id) == 0


def test_burst_of_mixed_sizes(harness):
    uc, meta, _broker, _w = harness
    ids = []
    for i in range(10):
        h, w = 40 + 7 * i, 90 - 3 * i
        img = uc.upload_image(png_bytes(h, w), f"b{i}.png", "image/png", OPS)
        ids.append(img.id)
    assert wait_for(lambda: all(
        meta.get_image(i).status is ImageStatus.COMPLETED for i in ids))


def test_poison_and_good_interleaved(harness):
    uc, meta, broker, w = harness
    broker.produce("image-processing", b"x", b"{not json")
    good = uc.upload_image(png_bytes(), "g.png", "image/png", OPS)
    assert wait_for(lambda: meta.get_image(good.id).status
                    is ImageStatus.COMPLETED)
    # malformed message was acked away, not looping
    assert wait_for(lambda: broker.depth(
        "image-processing", w.cfg.broker.group_id) == 0)


def test_nonbatchable_plan_single_path(harness):
    uc, meta, _broker, _w = harness
    img = uc.upload_image(
        png_bytes(), "c.png", "image/png",
        [OperationParams(OperationType.CROP,
                         {"x": 2, "y": 2, "width": 20, "height": 20})])
    assert wait_for(lambda: meta.get_image(img.id).status
                    is ImageStatus.COMPLETED)
    rows = meta.list_processed(img.id)
    assert rows[0].operation is OperationType.CROP


def test_device_stage_failure_is_transient(harness):
    """A device/transport/compile hiccup must nack the micro-batch for
    redelivery — never permanently fail it (ADVICE r1 #2)."""
    uc, meta, broker, w = harness

    def boom(group):
        raise RuntimeError("device transport reset by peer")

    w.engine.device_group = boom
    img = uc.upload_image(png_bytes(), "d.png", "image/png", OPS)
    assert wait_for(lambda: meta.get_image(img.id).status
                    is ImageStatus.FAILED)
    w.stop()
    # still deliverable: nacked, not acked away
    assert broker.depth("image-processing", w.cfg.broker.group_id) >= 1


def test_pipelined_with_device_jpeg(tmp_path):
    """JPEG uploads flow through the pipelined worker with the device
    decode path on (coef batch layout end to end)."""
    cfg = load_config({})
    cfg.worker.batch_size = 4
    cfg.worker.batch_deadline_ms = 30
    meta = SQLiteMetadataStore(":memory:")
    store = LocalFSObjectStore(str(tmp_path / "objects"))
    broker = MemoryBroker()
    uc = ImageUsecase(meta, store, broker,
                      retries=RetryStrategy(attempts=1, delay_ms=1))
    worker = PipelinedWorker(cfg, meta=meta, store=store, broker=broker)
    worker.engine.device_jpeg = True
    worker._idle_sleep = 0.01
    thread = threading.Thread(target=worker.run, daemon=True)
    thread.start()
    try:
        # 120x220 buckets to (128, 256): MCU-aligned, so the coef
        # layout engages (the 200 rung would fall back to pixels).
        arr = RNG.integers(0, 256, size=(120, 220, 3), dtype=np.uint8)
        bio = io.BytesIO()
        PILImage.fromarray(arr).save(bio, format="JPEG", quality=90)
        from imageprocessor_tpu.models.plan import normalize_operations
        dec = worker.engine.decode_for_plan(
            bio.getvalue(), normalize_operations(OPS))
        assert dec[2].startswith("coef"), dec[2]
        img = uc.upload_image(bio.getvalue(), "a.jpg", "image/jpeg", OPS)
        assert wait_for(lambda: meta.get_image(img.id).status.value
                        in ("completed", "failed"))
        rec = meta.get_image(img.id)
        assert rec.status.value == "completed", getattr(rec, "error", None)
        rows = meta.list_processed(img.id)
        ops = {r.operation: r.path for r in rows}
        assert "thumbnail" in ops
        data = store.get_object(ops["thumbnail"])
        assert len(data) > 0
    finally:
        worker.stop()
        thread.join(timeout=20)
        worker.engine.close()


def test_deadline_bounds_batcher_wait(tmp_path):
    """With batch_size far above the offered load, a lone item must flush
    on the deadline — queue-to-flush is bounded at batch_deadline_ms plus
    one poll-loop iteration (BASELINE p99 contract's latency lever)."""
    from imageprocessor_tpu.utils.metrics import METRICS

    deadline_ms = 120.0
    cfg = load_config({})
    cfg.worker.batch_size = 64           # a full batch can never form
    cfg.worker.batch_deadline_ms = deadline_ms
    meta = SQLiteMetadataStore(":memory:")
    store = LocalFSObjectStore(str(tmp_path / "objects"))
    broker = MemoryBroker()
    uc = ImageUsecase(meta, store, broker,
                      retries=RetryStrategy(attempts=1, delay_ms=1))
    worker = PipelinedWorker(cfg, meta=meta, store=store, broker=broker)
    worker._idle_sleep = 0.01
    thread = threading.Thread(target=worker.run, daemon=True)
    thread.start()
    try:
        # warm the compiled program so compile time never pollutes timing
        warm = uc.upload_image(png_bytes(), "w.png", "image/png", OPS)
        assert wait_for(lambda: meta.get_image(warm.id).status
                        is ImageStatus.COMPLETED)
        METRICS.reset()
        img = uc.upload_image(png_bytes(), "d.png", "image/png", OPS)
        assert wait_for(lambda: meta.get_image(img.id).status
                        is ImageStatus.COMPLETED)
    finally:
        worker.stop()
        thread.join(timeout=20)
        worker.engine.close()

    snap = METRICS.snapshot()["timings"]
    assert "batcher_wait_ms" in snap, snap.keys()
    wait = snap["batcher_wait_ms"]["max"]
    # flushed BY the deadline (+poll granularity & 1-core scheduling slack),
    # not held for the 64-item batch...
    assert wait <= deadline_ms + 1500.0, wait
    # ...and actually deadline-triggered, not size-triggered
    assert wait >= deadline_ms * 0.9, wait
    assert "queue_wait_ms" in snap, snap.keys()


def test_permit_exhaustion_by_distinct_buckets_does_not_deadlock(tmp_path):
    """Regression: items parked in the DeadlineBatcher each hold an
    inflight permit and only the decode thread can flush them. With a
    tiny queue depth and every image in a DIFFERENT bucket (so no group
    reaches batch_size), an unconditional permit acquire deadlocked the
    whole pipeline; the timed acquire + flush loop must keep it moving."""
    cfg = load_config({})
    cfg.worker.batch_size = 32           # never reached by any one bucket
    cfg.worker.batch_deadline_ms = 40
    cfg.worker.max_queue_depth = 8       # clamp floor: 8 permits
    meta = SQLiteMetadataStore(":memory:")
    store = LocalFSObjectStore(str(tmp_path / "objects"))
    broker = MemoryBroker()
    uc = ImageUsecase(meta, store, broker,
                      retries=RetryStrategy(attempts=1, delay_ms=1))
    worker = PipelinedWorker(cfg, meta=meta, store=store, broker=broker)
    worker._idle_sleep = 0.01
    thread = threading.Thread(target=worker.run, daemon=True)
    thread.start()
    try:
        # 12 images in 12 distinct buckets > the 8-permit depth
        imgs = []
        for k in range(12):
            h, w = 64 + 64 * (k % 6), 80 + 128 * (k // 6)
            imgs.append(uc.upload_image(png_bytes(h, w),
                                        f"b{k}.png", "image/png", OPS))
        assert wait_for(lambda: all(
            meta.get_image(im.id).status is ImageStatus.COMPLETED
            for im in imgs), timeout=240), "pipeline deadlocked"
        assert broker.depth("image-processing",
                            worker.cfg.broker.group_id) == 0
    finally:
        worker.stop()
        thread.join(timeout=20)
        worker.engine.close()


def test_bad_format_field_fails_without_permit_leak(harness):
    """A wire payload with a non-string Format (from_json passes it
    through) used to raise AttributeError AFTER the decode try-block:
    the message was neither acked nor nacked and the caller's _inflight
    permit leaked — each lease-expiry redelivery leaked another until
    the pipeline wedged. It must classify as a permanent failure."""
    import json

    uc, meta, broker, worker = harness
    img = uc.upload_image(png_bytes(), "bad.png", "image/png", OPS)
    # Doctor the queued task: replay it with Format as an int.
    raw = {
        "ID": "t-badfmt", "ImageID": img.id,
        "OriginalPath": img.original_path, "Bucket": "images",
        "Operations": [{"Type": "thumbnail", "Parameters": {"size": 32}}],
        "Format": 5,
    }
    broker.produce(worker.cfg.broker.processing_topic,
                   img.id.encode(), json.dumps(raw).encode())

    assert wait_for(lambda: meta.get_image(img.id).status
                    in (ImageStatus.FAILED, ImageStatus.COMPLETED))
    # The doctored replay must not wedge the pipeline: all permits come
    # back once the queue drains (the good original task may also run).
    depth = max(worker.cfg.worker.max_queue_depth, 8)

    def permits_restored():
        n = 0
        while worker._inflight.acquire(blocking=False):
            n += 1
        for _ in range(n):
            worker._inflight.release()
        return n == depth

    assert wait_for(permits_restored, timeout=60)


def test_watermark_only_jpeg_splices_through_pipeline(harness):
    """The streaming worker threads the splice context through its own
    staging (BatchItem splice=..., 'splice' layout grouping): a
    watermark-only JPEG upload completes by splice transcode — untouched
    rows byte-identical to the source."""
    uc, meta, _broker, w = harness
    yy = np.linspace(0, 170, 320)[:, None, None]
    arr = np.clip(yy + RNG.integers(0, 40, (320, 448, 3)), 0,
                  255).astype(np.uint8)
    bio = io.BytesIO()
    PILImage.fromarray(arr).save(bio, format="JPEG", quality=90)
    blob = bio.getvalue()
    ops = [OperationParams(OperationType.WATERMARK,
                           {"text": "pipelined", "opacity": 0.5,
                            "position": "bottom-right"})]
    img = uc.upload_image(blob, "w.jpg", "image/jpeg", ops)
    assert wait_for(lambda: meta.get_image(img.id).status
                    is ImageStatus.COMPLETED), "never completed"
    rows = meta.list_processed(img.id)
    assert len(rows) == 1
    out = w.store.get_object(rows[0].path)
    src = np.asarray(PILImage.open(io.BytesIO(blob)))
    got = np.asarray(PILImage.open(io.BytesIO(out)))
    assert got.shape == src.shape
    assert np.array_equal(src[:256], got[:256])
    assert (src[288:] != got[288:]).any()
