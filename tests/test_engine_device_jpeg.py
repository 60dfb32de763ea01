"""Engine integration of device-side JPEG decode (device_jpeg=True).

With the flag on, baseline 4:2:0 JPEG inputs skip the host pixel
decoder entirely: the streaming scanner extracts coefficient planes and
the batched device program (ops/jpeg_decode.batched_decode_ycbcr420)
runs IDCT + fancy chroma upsample + color convert into the
bucket. Outputs must match the host-decoded path within the float-vs-
integer-IDCT tolerance (~1-2 LSB).
"""

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
from imageprocessor_tpu.runtime import nativecodec as nc
from imageprocessor_tpu.runtime.codecs import decode_image
from imageprocessor_tpu.runtime.engine import ProcessingEngine
from imageprocessor_tpu.storage import LocalFSObjectStore

pytestmark = pytest.mark.skipif(
    nc._load() is None or not hasattr(nc._load(), "ip_jpeg_scan_dims"),
    reason="native codec library unavailable")

RNG = np.random.default_rng(55)


def jpeg_bytes(h, w, quality=90, subsampling=2, mode="RGB"):
    if mode == "L":
        arr = RNG.integers(0, 256, size=(h, w), dtype=np.uint8)
    else:
        yy = np.linspace(0, 170, h)[:, None, None]
        arr = np.clip(yy + RNG.integers(0, 40, (h, w, 3)), 0,
                      255).astype(np.uint8)
    bio = io.BytesIO()
    PILImage.fromarray(arr, mode=mode).save(bio, format="JPEG",
                                            quality=quality,
                                            subsampling=subsampling)
    return bio.getvalue()


def make_task(fmt="png"):
    return ProcessingTask(
        id=str(uuid.uuid4()), image_id=str(uuid.uuid4()),
        original_path="original/x.jpg", bucket="images",
        operations=[
            OperationParams(OperationType.THUMBNAIL,
                            {"size": 100, "crop_to_fit": True}),
            OperationParams(OperationType.RESIZE,
                            {"width": 128, "height": 96,
                             "keep_aspect": True}),
        ], format=fmt)


@pytest.fixture()
def engines(tmp_path):
    s1 = LocalFSObjectStore(str(tmp_path / "dev"))
    s2 = LocalFSObjectStore(str(tmp_path / "host"))
    e1 = ProcessingEngine(s1, device_jpeg=True, codec_threads=2)
    e2 = ProcessingEngine(s2, device_jpeg=False, codec_threads=2)
    yield (e1, s1), (e2, s2)
    e1.close()
    e2.close()


def test_coef_layout_selected_for_baseline_420(engines):
    (e1, _), _ = engines
    from imageprocessor_tpu.models.plan import normalize_operations
    plan = normalize_operations(make_task().operations)
    out = e1.decode_for_plan(jpeg_bytes(300, 400), plan)
    assert out[2] == "coef:22"
    assert out[3] == (300, 400)
    y, cb, cr, qt = out[0]
    assert y.shape == (304, 400)  # MCU-aligned (16) luma grid
    assert cb.shape == (152, 200)
    assert qt.shape == (3, 8, 8)


@pytest.mark.parametrize("subsampling,layout", [
    (0, "coef:11"),   # 4:4:4
    (1, "coef:12"),   # 4:2:2 (chroma half width)
    (2, "coef:22"),   # 4:2:0
])
def test_coef_layout_covers_all_subsampling_modes(engines, subsampling,
                                                  layout):
    (e1, s1), (e2, s2) = engines
    from imageprocessor_tpu.models.plan import normalize_operations
    plan = normalize_operations(make_task().operations)
    blob = jpeg_bytes(300, 400, subsampling=subsampling)
    out = e1.decode_for_plan(blob, plan)
    assert out[2] == layout
    r1 = e1.process_tasks([(make_task(), blob)])[0]
    r2 = e2.process_tasks([(make_task(), blob)])[0]
    assert r1.result.status is ImageStatus.COMPLETED, r1.result.error
    for op in ("thumbnail", "resize"):
        x, _ = decode_image(s1.get_object(r1.result.processed_paths[op]))
        y, _ = decode_image(s2.get_object(r2.result.processed_paths[op]))
        diff = np.abs(x.astype(int) - y.astype(int))
        mse = (diff.astype(float) ** 2).mean()
        assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-9)) > 45.0
        assert diff.max() <= 4


def test_coef_path_covers_non_mcu_aligned_bucket(engines):
    """The 200 ladder rung (200 % 16 != 0) joins the coefficient path:
    the canvas MCU-pads to 208 and the device decode crops back."""
    (e1, s1), (e2, s2) = engines
    from imageprocessor_tpu.models.plan import normalize_operations
    plan = normalize_operations(make_task().operations)
    blob = jpeg_bytes(190, 196)  # bucket (200, 200)
    out = e1.decode_for_plan(blob, plan)
    assert out[2] == "coef:22"
    r1 = e1.process_tasks([(make_task(), blob)])[0]
    r2 = e2.process_tasks([(make_task(), blob)])[0]
    assert r1.result.status is ImageStatus.COMPLETED, r1.result.error
    for op in ("thumbnail", "resize"):
        x, _ = decode_image(s1.get_object(r1.result.processed_paths[op]))
        y, _ = decode_image(s2.get_object(r2.result.processed_paths[op]))
        diff = np.abs(x.astype(int) - y.astype(int))
        mse = (diff.astype(float) ** 2).mean()
        assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-9)) > 45.0


def test_device_jpeg_matches_host_decode(engines):
    (e1, s1), (e2, s2) = engines
    blobs = [jpeg_bytes(300, 400), jpeg_bytes(250, 330)]
    r1 = e1.process_tasks([(make_task(), b) for b in blobs])
    r2 = e2.process_tasks([(make_task(), b) for b in blobs])
    for a, b in zip(r1, r2):
        assert a.result.status is ImageStatus.COMPLETED, a.result.error
        assert b.result.status is ImageStatus.COMPLETED, b.result.error
        for op in ("thumbnail", "resize"):
            x, _ = decode_image(s1.get_object(a.result.processed_paths[op]))
            y, _ = decode_image(s2.get_object(b.result.processed_paths[op]))
            assert x.shape == y.shape
            diff = np.abs(x.astype(int) - y.astype(int))
            mse = (diff.astype(float) ** 2).mean()
            psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-9))
            assert psnr > 45.0, (op, psnr)
            assert diff.max() <= 4


def test_grayscale_falls_back_and_completes(engines):
    (e1, _), _ = engines
    blob = jpeg_bytes(200, 260, mode="L")  # single component
    from imageprocessor_tpu.models.plan import normalize_operations
    plan = normalize_operations(make_task().operations)
    out = e1.decode_for_plan(blob, plan)
    assert not out[2].startswith("coef")  # fell through to a pixel decode
    res = e1.process_tasks([(make_task(), blob)])[0]
    assert res.result.status is ImageStatus.COMPLETED, res.result.error


def test_progressive_joins_device_decode_path(engines):
    """Progressive uploads now flow through the streaming scanner into
    the coefficient path (round-3: native progressive scan passes) and
    must match the host-decoded engine."""
    (e1, s1), (e2, s2) = engines
    arr = RNG.integers(0, 256, (150, 180, 3), dtype=np.uint8)
    bio = io.BytesIO()
    PILImage.fromarray(arr).save(bio, format="JPEG", quality=90,
                                 progressive=True)
    blob = bio.getvalue()
    from imageprocessor_tpu.models.plan import normalize_operations
    plan = normalize_operations(make_task().operations)
    out = e1.decode_for_plan(blob, plan)
    assert out[2].startswith("coef"), out[2]
    r1 = e1.process_tasks([(make_task(), blob)])[0]
    r2 = e2.process_tasks([(make_task(), blob)])[0]
    assert r1.result.status is ImageStatus.COMPLETED, r1.result.error
    for op in ("thumbnail", "resize"):
        x, _ = decode_image(s1.get_object(r1.result.processed_paths[op]))
        y, _ = decode_image(s2.get_object(r2.result.processed_paths[op]))
        diff = np.abs(x.astype(int) - y.astype(int))
        mse = (diff.astype(float) ** 2).mean()
        assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-9)) > 45.0


def test_device_encode_watermark_output(engines, monkeypatch):
    """Full-bucket JPEG outputs (watermark) run the encode front half on
    device; host keeps only the entropy emit. Output must decode within
    encoder-variation tolerance of the host-encoded engine's output.

    Splice transcode is disabled here on purpose: it intentionally
    preserves the SOURCE quantization (strictly closer to the ideal
    than either re-encode, see test_engine_splice.py), which would turn
    this same-pixels/two-encoders comparison into a q90-vs-q85 one.
    With it off, the device coef encode + full entropy emit path this
    test pins stays exercised (it remains the fallback for mixed groups
    and non-splice-editable streams)."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    (e1, s1), (e2, s2) = engines
    blob = jpeg_bytes(300, 400)
    wm = [OperationParams(OperationType.WATERMARK,
                          {"text": "hi", "opacity": 0.5,
                           "position": "bottom-right"})]
    t1 = ProcessingTask(id=str(uuid.uuid4()), image_id=str(uuid.uuid4()),
                        original_path="o.jpg", bucket="b",
                        operations=wm, format="jpeg")
    t2 = ProcessingTask(id=str(uuid.uuid4()), image_id=str(uuid.uuid4()),
                        original_path="o.jpg", bucket="b",
                        operations=wm, format="jpeg")
    r1 = e1.process_tasks([(t1, blob)])[0]
    r2 = e2.process_tasks([(t2, blob)])[0]
    assert r1.result.status is ImageStatus.COMPLETED, r1.result.error
    p1 = r1.result.processed_paths["watermark"]
    assert p1.endswith(".jpeg")
    x, _ = decode_image(s1.get_object(p1))
    y, _ = decode_image(s2.get_object(r2.result.processed_paths["watermark"]))
    assert x.shape == y.shape == (300, 400, 3)
    mse = ((x.astype(float) - y.astype(float)) ** 2).mean()
    assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-9)) > 38.0


def test_device_encode_skipped_for_png_output(engines):
    (e1, _), _ = engines
    t = ProcessingTask(id=str(uuid.uuid4()), image_id=str(uuid.uuid4()),
                       original_path="o.jpg", bucket="b",
                       operations=[OperationParams(
                           OperationType.WATERMARK, {"text": "x"})],
                       format="png")
    res = e1.process_tasks([(t, jpeg_bytes(200, 260))])[0]
    assert res.result.status is ImageStatus.COMPLETED, res.result.error
    assert res.result.processed_paths["watermark"].endswith(".png")


def test_device_jpeg_default_policy(tmp_path, monkeypatch):
    """Unset env -> auto: on only on a GPU, with the native scanner, on
    a core-starved host (runtime/device.py). Tests run on the CPU, so
    auto is off here; explicit 1/0 forces."""
    monkeypatch.delenv("IMAGEPROCESSOR_DEVICE_JPEG", raising=False)
    eng = ProcessingEngine(LocalFSObjectStore(str(tmp_path)))
    assert eng.caps.backend == "cpu"
    assert eng.device_jpeg is False
    eng.close()
    monkeypatch.setenv("IMAGEPROCESSOR_DEVICE_JPEG", "1")
    eng = ProcessingEngine(LocalFSObjectStore(str(tmp_path)))
    assert eng.device_jpeg is True
    eng.close()
    monkeypatch.setenv("IMAGEPROCESSOR_DEVICE_JPEG", "0")
    eng = ProcessingEngine(LocalFSObjectStore(str(tmp_path)))
    assert eng.device_jpeg is False
    eng.close()
