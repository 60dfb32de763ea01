"""Engine device-JPEG path: entropy scan -> device decode -> pipeline
program, against the host-codec engine."""

import io
import uuid

import numpy as np
import pytest
from PIL import Image as PILImage

from imageprocessor_tpu.domain import (
    ImageStatus,
    OperationParams,
    OperationType,
    ProcessingTask,
)
from imageprocessor_tpu.runtime import nativecodec
from imageprocessor_tpu.runtime.codecs import decode_image
from imageprocessor_tpu.runtime.engine import ProcessingEngine
from imageprocessor_tpu.storage import LocalFSObjectStore
from tests.oracle import psnr

pytestmark = pytest.mark.skipif(not nativecodec.available(),
                                reason="native codec not buildable")

RNG = np.random.default_rng(71)


def jpeg_task(h, w, ops):
    yy = np.linspace(0, 255, h)[:, None]
    xx = np.linspace(0, 255, w)[None, :]
    arr = np.stack([yy + 0 * xx, 0 * yy + xx, (yy + xx) / 2],
                   axis=-1).astype(np.uint8)
    bio = io.BytesIO()
    PILImage.fromarray(arr).save(bio, format="JPEG", quality=95)
    task = ProcessingTask(id=str(uuid.uuid4()), image_id=str(uuid.uuid4()),
                          original_path="x", bucket="images",
                          operations=ops, format="jpeg")
    return task, bio.getvalue(), arr


@pytest.fixture()
def planar_engine(tmp_path):
    store = LocalFSObjectStore(str(tmp_path / "objects"))
    # The device codec feeds the program; forced on for the CPU.
    eng = ProcessingEngine(store, codec_threads=2, batch_size=8,
                           device_jpeg=True)
    yield eng, store
    eng.close()


def test_planar_jpeg_flow_matches_reference_path(planar_engine):
    eng, store = planar_engine
    ops = [
        OperationParams(OperationType.THUMBNAIL,
                        {"size": 64, "crop_to_fit": True}),
        OperationParams(OperationType.RESIZE,
                        {"width": 128, "height": 96, "keep_aspect": True}),
        OperationParams(OperationType.WATERMARK, {"text": "P"}),
    ]
    task, data, _src = jpeg_task(200, 256, ops)
    res = eng.process_tasks([(task, data)])[0]
    assert res.result.status is ImageStatus.COMPLETED, res.result.error
    assert set(res.result.processed_paths) == {"thumbnail", "resize",
                                               "watermark"}

    # Reference: HWC engine on the same inputs
    ref_store_eng = ProcessingEngine(store, codec_threads=1,
                                     device_jpeg=False)
    task2 = ProcessingTask(id=task.id, image_id=str(uuid.uuid4()),
                           original_path="x", bucket="images",
                           operations=ops, format="jpeg")
    ref = ref_store_eng.process_tasks([(task2, data)])[0]
    assert ref.result.status is ImageStatus.COMPLETED

    for op_name in ("thumbnail", "resize", "watermark"):
        got, _ = decode_image(store.get_object(
            res.result.processed_paths[op_name]))
        want, _ = decode_image(store.get_object(
            ref.result.processed_paths[op_name]))
        assert got.shape == want.shape, op_name
        assert psnr(got, want) > 40.0, f"{op_name} diverged"  # JPEG recode
    ref_store_eng.close()


def test_planar_mixed_with_png_falls_back(planar_engine):
    eng, _store = planar_engine
    ops = [OperationParams(OperationType.GRAYSCALE, {})]
    t_jpeg, d_jpeg, _ = jpeg_task(100, 150, ops)
    arr = RNG.integers(0, 256, size=(100, 150, 3), dtype=np.uint8)
    bio = io.BytesIO()
    PILImage.fromarray(arr).save(bio, format="PNG")
    t_png = ProcessingTask(id=str(uuid.uuid4()), image_id=str(uuid.uuid4()),
                           original_path="x", bucket="images",
                           operations=ops, format="png")
    results = eng.process_tasks([(t_jpeg, d_jpeg), (t_png, bio.getvalue())])
    for r in results:
        assert r.result.status is ImageStatus.COMPLETED, r.result.error


def test_steep_downscale_routed_off_planar_path(planar_engine):
    """A >32x downscale (1400px -> 40px) stays on the device-decode path
    — the XLA resample has no band limit — and matches the host-codec
    engine."""
    eng, store = planar_engine
    ops = [
        OperationParams(OperationType.RESIZE,
                        {"width": 40, "height": 40, "keep_aspect": False}),
        OperationParams(OperationType.THUMBNAIL,
                        {"size": 40, "crop_to_fit": True}),
    ]
    task, data, _src = jpeg_task(1400, 1344, ops)

    plan = __import__("imageprocessor_tpu.models.plan",
                      fromlist=["normalize_operations"]
                      ).normalize_operations(ops)
    _arr, _fmt, layout, _hw = eng.decode_for_plan(data, plan)
    assert layout.startswith("coef")

    res = eng.process_tasks([(task, data)])[0]
    assert res.result.status is ImageStatus.COMPLETED, res.result.error

    ref_eng = ProcessingEngine(store, codec_threads=1, device_jpeg=False)
    task2 = ProcessingTask(id=task.id, image_id=str(uuid.uuid4()),
                           original_path="x", bucket="images",
                           operations=ops, format="jpeg")
    ref = ref_eng.process_tasks([(task2, data)])[0]
    assert ref.result.status is ImageStatus.COMPLETED

    for op_name in ("resize", "thumbnail"):
        got, _ = decode_image(store.get_object(
            res.result.processed_paths[op_name]))
        want, _ = decode_image(store.get_object(
            ref.result.processed_paths[op_name]))
        assert got.shape == want.shape
        assert psnr(got, want) > 40.0   # device vs host JPEG decode
    ref_eng.close()


def test_padded_batch_keeps_planar_path(planar_engine):
    """A non-power-of-two group is batch-padded (pad rows mirror the
    last real image) and still decodes on the device."""
    from imageprocessor_tpu.runtime.batcher import BatchItem, group_items

    eng, store = planar_engine
    ops = [
        OperationParams(OperationType.THUMBNAIL,
                        {"size": 64, "crop_to_fit": True}),
        OperationParams(OperationType.RESIZE,
                        {"width": 128, "height": 96, "keep_aspect": True}),
    ]
    from imageprocessor_tpu.models.plan import normalize_operations
    plan = normalize_operations(ops)
    items = []
    for i in range(3):   # 3 pads to 4 in quantize_batch
        task, data, _src = jpeg_task(200, 256, ops)
        arr, detected, layout, valid_hw = eng.decode_for_plan(data, plan)
        assert layout.startswith("coef")
        items.append(BatchItem(item_id=str(i), image=arr,
                               plan_key=plan.group_key(),
                               payload=(i, task, "jpeg", plan),
                               layout=layout, valid_hw=valid_hw))
    groups = list(group_items(items, max_batch=8))
    assert len(groups) == 1
    assert groups[0].layout.startswith("coef")
    _plan, outs, out_hws = eng.device_group(groups[0])
    assert outs[0].shape[0] == 4      # 3 items padded to 4
    assert out_hws[1].shape == (4, 2)
