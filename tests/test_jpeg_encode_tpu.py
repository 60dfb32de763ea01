"""Device-side JPEG encode (ops/jpeg_encode.py + native/jpeg_emit.cpp).

Two validation angles:
* transcode identity — scan(emit(P)) must reproduce the coefficient
  planes bit-exactly and the emitted stream must decode pixel-identically
  to the source JPEG (same coefficients => same pixels);
* full device encode — RGB -> JFIF through the device FDCT path must
  decode within a fraction of a dB of a libjpeg encode at the same
  quality, for every supported subsampling mode.
"""

import io

import numpy as np
import pytest
from PIL import Image as PILImage

from imageprocessor_tpu.runtime import nativecodec as nc

pytestmark = pytest.mark.skipif(
    nc._load() is None or not hasattr(nc._load(), "ip_jpeg_emit"),
    reason="native codec library unavailable")

RNG = np.random.default_rng(31)


def photo(h, w):
    yy = np.linspace(0, 170, h)[:, None, None]
    xx = np.linspace(0, 70, w)[None, :, None]
    return np.clip(yy + xx + RNG.integers(0, 36, (h, w, 3)), 0,
                   255).astype(np.uint8)


def pil_jpeg(arr, **kw):
    bio = io.BytesIO()
    PILImage.fromarray(arr).save(bio, format="JPEG", **kw)
    return bio.getvalue()


def psnr(a, b):
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / mse) if mse else np.inf


@pytest.mark.parametrize("subsampling,quality", [(2, 85), (1, 90), (0, 75)],
                         ids=["420q85", "422q90", "444q75"])
def test_transcode_identity(subsampling, quality):
    jpeg = pil_jpeg(photo(121, 165), quality=quality,
                    subsampling=subsampling)
    planes, qt, dims, samp = nc.scan_jpeg_coefficients(jpeg)
    out = nc.emit_jpeg_from_coefficients(planes, qt, dims[0], dims[1],
                                         samp[0])
    p2, q2, d2, s2 = nc.scan_jpeg_coefficients(out)
    assert d2 == dims and s2 == samp
    np.testing.assert_array_equal(qt, q2)
    for c in range(3):
        np.testing.assert_array_equal(planes[c], p2[c])
    # Same coefficients => pixel-identical decode.
    a = np.asarray(PILImage.open(io.BytesIO(jpeg)).convert("RGB"))
    b = np.asarray(PILImage.open(io.BytesIO(out)).convert("RGB"))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ri", [1, 3, 11, 64])
@pytest.mark.parametrize("ilv", [2, 4, 8])
def test_interleaved_emit_byte_identical(ri, ilv):
    """The interleaved-lane emitter (ip_jpeg_emit_strided_ilp) must be
    byte-identical to the sequential path at the same restart interval:
    restart segments are byte-aligned with reset predictors, so lane
    order cannot leak into the stream. Covers short final segments
    (ri that doesn't divide the MCU count) and W > segment count."""
    if not hasattr(nc._load(), "ip_jpeg_emit_strided_ilp"):
        pytest.skip("stale native library without the ilp entry point")
    jpeg = pil_jpeg(photo(137, 181), quality=85, subsampling=2)
    planes, qt, dims, samp = nc.scan_jpeg_coefficients(jpeg)
    seq = nc.emit_jpeg_from_coefficients(planes, qt, dims[0], dims[1],
                                         samp[0], restart_interval=ri)
    par = nc.emit_jpeg_from_coefficients(planes, qt, dims[0], dims[1],
                                         samp[0], restart_interval=ri,
                                         interleave=ilv)
    assert par == seq


def test_interleaved_emit_byte_identical_grayscale():
    if not hasattr(nc._load(), "ip_jpeg_emit_strided_ilp"):
        pytest.skip("stale native library without the ilp entry point")
    arr = RNG.integers(0, 256, (90, 130), dtype=np.uint8)
    jpeg = pil_jpeg(arr, quality=85)
    planes, qt, dims, samp = nc.scan_jpeg_coefficients(jpeg)
    seq = nc.emit_jpeg_from_coefficients(planes, qt, dims[0], dims[1],
                                         restart_interval=5)
    par = nc.emit_jpeg_from_coefficients(planes, qt, dims[0], dims[1],
                                         restart_interval=5, interleave=3)
    assert par == seq


def test_transcode_identity_grayscale():
    arr = RNG.integers(0, 256, (90, 130), dtype=np.uint8)
    jpeg = pil_jpeg(arr, quality=85)
    planes, qt, dims, samp = nc.scan_jpeg_coefficients(jpeg)
    out = nc.emit_jpeg_from_coefficients(planes, qt, dims[0], dims[1])
    p2, _, d2, _ = nc.scan_jpeg_coefficients(out)
    assert d2 == dims
    np.testing.assert_array_equal(planes[0], p2[0])


@pytest.mark.parametrize("quality", [75, 85, 95])
def test_device_encode_matches_libjpeg_quality(quality):
    from imageprocessor_tpu.ops.jpeg_encode import encode_jpeg_device

    arr = photo(121, 165)
    ours = encode_jpeg_device(arr.transpose(2, 0, 1), quality=quality)
    ref = pil_jpeg(arr, quality=quality)  # PIL => libjpeg, 4:2:0 default
    dec_ours = np.asarray(PILImage.open(io.BytesIO(ours)).convert("RGB"))
    dec_ref = np.asarray(PILImage.open(io.BytesIO(ref)).convert("RGB"))
    p_ours = psnr(dec_ours, arr)
    p_ref = psnr(dec_ref, arr)
    assert p_ours > p_ref - 0.5, (p_ours, p_ref)
    # File sizes in the same ballpark (same tables, same entropy model)
    assert len(ours) < len(ref) * 1.15


def test_device_encode_444():
    from imageprocessor_tpu.ops.jpeg_encode import encode_jpeg_device

    arr = photo(96, 120)
    ours = encode_jpeg_device(arr.transpose(2, 0, 1), quality=90,
                              subsampling="444")
    dec = np.asarray(PILImage.open(io.BytesIO(ours)).convert("RGB"))
    ref = pil_jpeg(arr, quality=90, subsampling=0)
    dec_ref = np.asarray(PILImage.open(io.BytesIO(ref)).convert("RGB"))
    assert psnr(dec, arr) > psnr(dec_ref, arr) - 0.5


def test_device_encode_odd_dims():
    from imageprocessor_tpu.ops.jpeg_encode import encode_jpeg_device

    arr = photo(77, 51)
    out = encode_jpeg_device(arr.transpose(2, 0, 1), quality=85)
    img = PILImage.open(io.BytesIO(out))
    assert img.size == (51, 77)
    assert psnr(np.asarray(img.convert("RGB")), arr) > 25.0


def test_device_encode_roundtrips_through_own_decoder():
    from imageprocessor_tpu.ops.jpeg_decode import decode_jpeg_device
    from imageprocessor_tpu.ops.jpeg_encode import encode_jpeg_device

    arr = photo(64, 80)
    out = encode_jpeg_device(arr.transpose(2, 0, 1), quality=95)
    dec = np.asarray(decode_jpeg_device(out)).transpose(1, 2, 0)
    assert dec.shape == arr.shape
    # Device decode agrees with libjpeg's decode of the same stream far
    # more tightly than either agrees with the (4:2:0-lossy) source.
    pil = np.asarray(PILImage.open(io.BytesIO(out)).convert("RGB"))
    assert psnr(dec, pil) > 45.0
    assert psnr(dec, arr) > 27.0


def test_quality_qtables_match_ijg_scaling():
    from imageprocessor_tpu.ops.jpeg_encode import quality_qtables

    # q50 is the unscaled Annex K base table.
    qt50 = quality_qtables(50)
    assert qt50[0, 0, 0] == 16 and qt50[1, 0, 0] == 17
    # q100 is all ones.
    assert (quality_qtables(100) == 1).all()
    # Higher quality => finer (element-wise <=) tables.
    assert (quality_qtables(90) <= quality_qtables(60)).all()


@pytest.mark.parametrize("interval", [1, 7, 64])
def test_emit_restart_intervals_roundtrip(interval):
    """DRI/RSTn emission: scan round-trips bit-exactly and external
    decoders accept the stream."""
    jpeg = pil_jpeg(photo(121, 165), quality=85)
    planes, qt, dims, samp = nc.scan_jpeg_coefficients(jpeg)
    out = nc.emit_jpeg_from_coefficients(planes, qt, dims[0], dims[1],
                                         samp[0], restart_interval=interval)
    assert b"\xff\xdd" in out[:2048]  # DRI present
    p2, _, d2, _ = nc.scan_jpeg_coefficients(out)
    assert d2 == dims
    for c in range(3):
        np.testing.assert_array_equal(planes[c], p2[c])
    a = np.asarray(PILImage.open(io.BytesIO(jpeg)).convert("RGB"))
    b = np.asarray(PILImage.open(io.BytesIO(out)).convert("RGB"))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("threads", [2, 4])
def test_parallel_scan_of_restart_stream(threads):
    """Restart segments decode independently across threads."""
    jpeg = pil_jpeg(photo(200, 260), quality=88)
    planes, qt, dims, samp = nc.scan_jpeg_coefficients(jpeg)
    rst = nc.emit_jpeg_from_coefficients(planes, qt, dims[0], dims[1],
                                         samp[0], restart_interval=3)
    pmt, _, dmt, _ = nc.scan_jpeg_coefficients(rst, threads=threads)
    assert dmt == dims
    for c in range(3):
        np.testing.assert_array_equal(planes[c], pmt[c])


def test_parallel_scan_falls_back_without_restarts():
    jpeg = pil_jpeg(photo(100, 140), quality=85)
    seq = nc.scan_jpeg_coefficients(jpeg)
    mt = nc.scan_jpeg_coefficients(jpeg, threads=8)
    for a, b in zip(seq[0], mt[0]):
        np.testing.assert_array_equal(a, b)


def test_emit_rejects_bad_inputs():
    with pytest.raises(nc.NativeCodecError):
        nc.emit_jpeg_from_coefficients(
            [np.zeros((8, 8), np.int16)] * 2,  # 2 components invalid
            np.ones((2, 8, 8), np.uint16), 8, 8)
