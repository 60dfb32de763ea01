"""Multi-chip serving through the ENGINE entry point (process_tasks).

VERDICT r2 lead item: the validated run_sharded path must be reachable
from production — these tests drive ProcessingEngine.process_tasks (the
exact path service/worker.py calls) with a device mesh on the 8 virtual
CPU devices, asserting the sharded engine produces byte-identical
artifacts to the single-device engine. Reference analog: the goroutine
pool + consumer-group scale-out (worker.go:88-96, consumer.go:21-27)
mapped to intra-host chip fan-out per SURVEY §2's parallelism table.
"""

import io
import uuid

import numpy as np
import pytest
from PIL import Image as PILImage

import jax

from imageprocessor_tpu.config import load as load_config
from imageprocessor_tpu.domain import (
    ImageStatus,
    OperationParams,
    OperationType,
    ProcessingTask,
)
from imageprocessor_tpu.runtime.engine import ProcessingEngine

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

RNG = np.random.default_rng(31)


class CaptureStore:
    def __init__(self):
        self.blobs: dict[str, bytes] = {}

    def save_processed(self, path, data, mime=None):
        self.blobs[path] = data


def _blob(h, w, fmt="PNG", quality=92):
    arr = RNG.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    bio = io.BytesIO()
    kw = {"quality": quality} if fmt == "JPEG" else {}
    PILImage.fromarray(arr).save(bio, format=fmt, **kw)
    return bio.getvalue()


def _task(ops, fmt="png"):
    iid = str(uuid.uuid4())
    return ProcessingTask(id=iid, image_id=iid, original_path=f"o/{iid}",
                          bucket="b", operations=ops, format=fmt)


DEFAULT_OPS = [
    OperationParams(OperationType.THUMBNAIL, {"size": 64, "crop_to_fit": True}),
    OperationParams(OperationType.RESIZE,
                    {"width": 128, "height": 96, "keep_aspect": True}),
    OperationParams(OperationType.WATERMARK, {"text": "dp"}),
]


def _run_both(blobs, fmt, sharded_kw, single_kw=None):
    """Process the same tasks through a sharded and a single-device
    engine; return (sharded_results, single_results, stores)."""
    tasks = [( _task(DEFAULT_OPS, fmt), b) for b in blobs]
    st_s, st_1 = CaptureStore(), CaptureStore()
    eng_s = ProcessingEngine(st_s, **sharded_kw)
    eng_1 = ProcessingEngine(st_1, **(single_kw or {k: v for k, v in
                                      sharded_kw.items()
                                      if k not in ("data_axis",
                                                   "space_axis")}))
    try:
        res_s = eng_s.process_tasks(tasks)
        res_1 = eng_1.process_tasks(tasks)
    finally:
        eng_s.close()
        eng_1.close()
    return res_s, res_1, st_s, st_1


def test_engine_process_tasks_sharded_matches_single():
    """HWC path over a 4-way data mesh: mixed sizes landing in two
    buckets, batch padded to the data axis."""
    blobs = [_blob(100, 140), _blob(120, 150), _blob(60, 70),
             _blob(100, 140), _blob(90, 130)]
    res_s, res_1, st_s, st_1 = _run_both(
        blobs, "png",
        {"data_axis": 4})
    assert ProcessingEngine(CaptureStore(), data_axis=4)._mesh is not None
    for rs, r1 in zip(res_s, res_1):
        assert rs.result.status is ImageStatus.COMPLETED
        assert r1.result.status is ImageStatus.COMPLETED
        assert len(rs.artifacts) == 3
        for a_s, a_1 in zip(rs.artifacts, r1.artifacts):
            assert a_s.operation == a_1.operation
            assert st_s.blobs[a_s.path] == st_1.blobs[a_1.path]


def test_engine_sharded_pallas_planar_path():
    """JPEG inputs through the host codec over a 4-way data mesh match
    the single-device engine byte for byte."""
    blobs = [_blob(110, 150, "JPEG"), _blob(120, 140, "JPEG"),
             _blob(100, 150, "JPEG"), _blob(115, 145, "JPEG")]
    res_s, res_1, st_s, st_1 = _run_both(
        blobs, "jpeg",
        {"data_axis": 4, "device_jpeg": False})
    for rs, r1 in zip(res_s, res_1):
        assert rs.result.status is ImageStatus.COMPLETED
        assert r1.result.status is ImageStatus.COMPLETED
        for a_s, a_1 in zip(rs.artifacts, r1.artifacts):
            assert st_s.blobs[a_s.path] == st_1.blobs[a_1.path]


def test_engine_sharded_device_jpeg_coef_path():
    """The multi-GPU combination: device_jpeg plus the mesh — JPEG
    uploads take the coefficient layout (batched device IDCT decode)
    into run_sharded. Exercised explicitly here because on the CPU both
    defaults are off (auto policies)."""
    from imageprocessor_tpu.runtime import nativecodec as nc

    if not nc.available() or not hasattr(nc._load(), "ip_jpeg_scan_dims"):
        pytest.skip("native scanner unavailable")
    blobs = [_blob(110, 150, "JPEG"), _blob(120, 140, "JPEG"),
             _blob(100, 150, "JPEG"), _blob(115, 145, "JPEG")]
    tasks = [(_task(DEFAULT_OPS, "jpeg"), b) for b in blobs]
    st_s, st_1 = CaptureStore(), CaptureStore()
    eng_s = ProcessingEngine(st_s, data_axis=4, device_jpeg=True)
    eng_1 = ProcessingEngine(st_1, device_jpeg=True)
    try:
        # confirm the coef layout is actually selected
        from imageprocessor_tpu.models.plan import normalize_operations
        plan = normalize_operations(DEFAULT_OPS)
        dec = eng_s.decode_for_plan(blobs[0], plan)
        assert dec[2].startswith("coef"), dec[2]
        res_s = eng_s.process_tasks(tasks)
        res_1 = eng_1.process_tasks(
            [(_task(DEFAULT_OPS, "jpeg"), b) for b in blobs])
    finally:
        eng_s.close()
        eng_1.close()
    for rs, r1 in zip(res_s, res_1):
        assert rs.result.status is ImageStatus.COMPLETED, rs.result.error
        for a_s, a_1 in zip(rs.artifacts, r1.artifacts):
            assert st_s.blobs[a_s.path] == st_1.blobs[a_1.path]


def test_engine_sharded_pallas_codec_kernels(monkeypatch):
    """On a 4-way data mesh BOTH XLA codec programs (decode and the
    encode front half) run under shard_map (engine._codec_program),
    scaling the codec halves across local cards like the pixel
    pipeline — and match the single-device engine byte-for-byte.

    Splice transcode is disabled so the watermark rendition actually
    exercises the device encode (with it on, eligible watermark groups
    skip the encode front half entirely)."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    from imageprocessor_tpu.runtime import nativecodec as nc

    if not nc.available() or not hasattr(nc._load(), "ip_jpeg_scan_dims"):
        pytest.skip("native scanner unavailable")
    blobs = [_blob(250, 400, "JPEG"), _blob(240, 390, "JPEG"),
             _blob(230, 395, "JPEG"), _blob(245, 400, "JPEG")]
    tasks = [(_task(DEFAULT_OPS, "jpeg"), b) for b in blobs]
    st_s, st_1 = CaptureStore(), CaptureStore()
    eng_s = ProcessingEngine(st_s, data_axis=4, device_jpeg=True)
    eng_1 = ProcessingEngine(st_1, device_jpeg=True)
    try:
        res_s = eng_s.process_tasks(tasks)
        res_1 = eng_1.process_tasks(
            [(_task(DEFAULT_OPS, "jpeg"), b) for b in blobs])
        codec = [k[2] for k in eng_s.model._cache
                 if isinstance(k, tuple) and k[0] == "codec"]
        assert "decode" in codec and "encode" in codec, codec
        assert not any(isinstance(k, tuple) and k and k[0] == "codec"
                       for k in eng_1.model._cache)
    finally:
        eng_s.close()
        eng_1.close()
    for rs, r1 in zip(res_s, res_1):
        assert rs.result.status is ImageStatus.COMPLETED, rs.result.error
        assert r1.result.status is ImageStatus.COMPLETED, r1.result.error
        for a_s, a_1 in zip(rs.artifacts, r1.artifacts):
            assert st_s.blobs[a_s.path] == st_1.blobs[a_1.path]


def test_engine_spatial_mesh_matches_single():
    """DEVICE_SPACE_AXIS honored: a (2 data x 2 space) mesh routes the
    GSPMD jit path (XLA auto-partitions the width axis)."""
    blobs = [_blob(100, 140), _blob(120, 150), _blob(90, 130)]
    res_s, res_1, st_s, st_1 = _run_both(
        blobs, "png",
        {"data_axis": 2, "space_axis": 2}, {})
    for rs, r1 in zip(res_s, res_1):
        assert rs.result.status is ImageStatus.COMPLETED
        for a_s, a_1 in zip(rs.artifacts, r1.artifacts):
            assert st_s.blobs[a_s.path] == st_1.blobs[a_1.path]


def test_engine_sharded_per_image_failure_isolation():
    """A corrupt image in a sharded batch fails alone; batchmates
    complete — the per-image isolation contract is mesh-independent."""
    tasks = [(_task(DEFAULT_OPS), _blob(100, 140)),
             (_task(DEFAULT_OPS), b"not an image at all"),
             (_task(DEFAULT_OPS), _blob(90, 130))]
    store = CaptureStore()
    eng = ProcessingEngine(store, data_axis=4)
    try:
        res = eng.process_tasks(tasks)
    finally:
        eng.close()
    assert res[0].result.status is ImageStatus.COMPLETED
    assert res[1].result.status is ImageStatus.FAILED
    assert res[2].result.status is ImageStatus.COMPLETED


def test_worker_uses_engine_mesh(tmp_path):
    """End-to-end: a Worker built from config with DEVICE_DATA_AXIS=4
    serves through the sharded engine (the real serving path)."""
    from imageprocessor_tpu.broker.memory import MemoryBroker
    from imageprocessor_tpu.service.usecase import ImageUsecase
    from imageprocessor_tpu.service.worker import Worker
    from imageprocessor_tpu.storage import (
        LocalFSObjectStore,
        SQLiteMetadataStore,
    )
    from imageprocessor_tpu.utils import RetryStrategy

    cfg = load_config({"DEVICE_DATA_AXIS": "4"})
    cfg.worker.batch_size = 4
    meta = SQLiteMetadataStore(":memory:")
    store = LocalFSObjectStore(str(tmp_path / "objects"))
    broker = MemoryBroker()
    uc = ImageUsecase(meta, store, broker,
                      retries=RetryStrategy(attempts=2, delay_ms=1))
    worker = Worker(cfg, meta=meta, store=store, broker=broker)
    try:
        assert worker.engine._mesh is not None
        assert int(worker.engine._mesh.shape["data"]) == 4
        imgs = [uc.upload_image(_blob(80, 100), f"{i}.png", "image/png",
                                DEFAULT_OPS) for i in range(3)]
        assert worker.run_once() == 3
        for img in imgs:
            assert meta.get_image(img.id).status is ImageStatus.COMPLETED
            assert len(meta.list_processed(img.id)) == 3
    finally:
        worker.engine.close()
