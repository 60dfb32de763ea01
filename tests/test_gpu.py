"""Checks that need an NVIDIA GPU; they skip elsewhere (the `gpu`
fixture decides when the test runs). On a GPU host:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""

import numpy as np
import pytest

from test_codec_reference import decode_reference, random_planes

pytestmark = pytest.mark.gpu


def test_decode_program_keeps_float32_on_the_card(gpu):
    """The IDCT contractions ask for Precision.HIGHEST; a TF32 matmul
    would miss the float64 reference by several LSB at coefficient
    magnitudes."""
    from imageprocessor_tpu.ops.jpeg_decode import batched_decode_ycbcr
    from imageprocessor_tpu.ops.jpeg_encode import quality_qtables

    rng = np.random.default_rng(0)
    q = quality_qtables(95).astype(np.float64)
    qts = np.stack([q[0], q[1], q[1]])
    y, cb, cr = random_planes(rng, 256, 384, 2, 2)
    out = np.asarray(batched_decode_ycbcr(
        y[None], cb[None], cr[None], qts[None].astype(np.float32),
        np.asarray([cb.shape], np.int32), fh=2, fw=2))
    want = decode_reference(y, cb, cr, qts, 2, 2, 256, 384)
    assert np.abs(out[0].astype(np.int16) - want).max() <= 1


def test_engine_serves_a_jpeg_on_the_card(gpu, tmp_path):
    """Both JPEG routes complete on the GPU."""
    import io
    import uuid

    from PIL import Image

    from imageprocessor_tpu.domain import (
        ImageStatus,
        OperationParams,
        OperationType,
        ProcessingTask,
    )
    from imageprocessor_tpu.runtime.engine import ProcessingEngine
    from imageprocessor_tpu.storage import LocalFSObjectStore

    bio = io.BytesIO()
    Image.fromarray(np.full((480, 640, 3), 90, np.uint8)).save(
        bio, format="JPEG", quality=85)
    ops = [OperationParams(OperationType.THUMBNAIL,
                           {"size": 200, "crop_to_fit": True}),
           OperationParams(OperationType.WATERMARK, {})]
    for device_jpeg in (False, True):
        eng = ProcessingEngine(LocalFSObjectStore(str(tmp_path)),
                               device_jpeg=device_jpeg)
        task = ProcessingTask(id=str(uuid.uuid4()),
                              image_id=str(uuid.uuid4()), original_path="o",
                              bucket="b", operations=ops, format="jpeg")
        try:
            (res,) = eng.process_tasks([(task, bio.getvalue())])
        finally:
            eng.close()
        assert res.result.status is ImageStatus.COMPLETED, res.result.error
