"""Device-side JPEG decode (host Huffman + device iDCT) fidelity tests."""

import io
import math

import numpy as np
import pytest
from PIL import Image

from imageprocessor_tpu.runtime import nativecodec

pytestmark = pytest.mark.skipif(not nativecodec.available(),
                                reason="native codec not buildable")

from imageprocessor_tpu.ops.jpeg_decode import decode_jpeg_device  # noqa: E402

RNG = np.random.default_rng(29)


def _psnr(a, b):
    mse = ((a.astype(float) - b.astype(float)) ** 2).mean()
    return 10 * math.log10(255 ** 2 / max(mse, 1e-9))


def _jpeg(arr, quality=90, **save_kw):
    bio = io.BytesIO()
    Image.fromarray(arr).save(bio, format="JPEG", quality=quality, **save_kw)
    return bio.getvalue()


@pytest.mark.parametrize("shape,quality", [
    ((120, 168), 85), ((200, 304), 90), ((250, 330), 95), ((97, 131), 75)])
def test_device_decode_matches_libjpeg(shape, quality):
    arr = np.clip(RNG.normal(128, 50, (*shape, 3)), 0, 255).astype(np.uint8)
    data = _jpeg(arr, quality)
    ref = nativecodec.decode_jpeg(data)
    out = np.transpose(np.asarray(decode_jpeg_device(data)), (1, 2, 0))
    assert out.shape == ref.shape
    assert _psnr(out, ref) > 45.0


def test_device_decode_444_sampling():
    arr = np.clip(RNG.normal(128, 50, (96, 136, 3)), 0, 255).astype(np.uint8)
    data = _jpeg(arr, 92, subsampling=0)  # 4:4:4
    ref = nativecodec.decode_jpeg(data)
    out = np.transpose(np.asarray(decode_jpeg_device(data)), (1, 2, 0))
    assert _psnr(out, ref) > 45.0


def test_device_decode_grayscale():
    arr = np.clip(RNG.normal(128, 50, (80, 104)), 0, 255).astype(np.uint8)
    bio = io.BytesIO()
    Image.fromarray(arr, "L").save(bio, format="JPEG", quality=90)
    ref = nativecodec.decode_jpeg(bio.getvalue())
    out = np.transpose(np.asarray(decode_jpeg_device(bio.getvalue())),
                       (1, 2, 0))
    assert out.shape == ref.shape
    assert _psnr(out, ref) > 45.0


def test_device_decode_padded_bucket():
    arr = np.clip(RNG.normal(100, 30, (100, 140, 3)), 0, 255).astype(np.uint8)
    data = _jpeg(arr)
    out = np.asarray(decode_jpeg_device(data, pad_hw=(128, 256)))
    assert out.shape == (3, 128, 256)
    assert out[:, 100:, :].max() == 0  # padding is zero
    ref = nativecodec.decode_jpeg(data)
    assert _psnr(np.transpose(out[:, :100, :140], (1, 2, 0)), ref) > 45.0


def test_coefficient_reader_shapes():
    arr = np.zeros((64, 80, 3), dtype=np.uint8)
    data = _jpeg(arr)
    planes, qtabs, (w, h), sampling = \
        nativecodec.read_jpeg_coefficients(data)
    assert (w, h) == (80, 64)
    assert planes[0].shape[0] % 8 == 0 and planes[0].shape[1] % 8 == 0
    assert qtabs.shape == (3, 8, 8)
    assert sampling[0][0] >= sampling[1][0]
