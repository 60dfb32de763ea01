"""Host codec tests: sniffing, decode/encode roundtrips, format rules."""

import io

import numpy as np
import pytest
from PIL import Image

from imageprocessor_tpu.errors import DecodeError
from imageprocessor_tpu.runtime import (
    decode_image,
    detect_content_type,
    encode_image,
    format_from_content_type,
    mime_from_path,
    negotiate_format,
)

RNG = np.random.default_rng(11)


def make_bytes(fmt, size=(64, 48), mode="RGB", smooth=False):
    if smooth:  # JPEG is lossy; use a gradient so roundtrip error is small
        yy = np.linspace(0, 255, size[1])[:, None]
        xx = np.linspace(0, 255, size[0])[None, :]
        arr = np.stack([yy + 0 * xx, 0 * yy + xx, (yy + xx) / 2],
                       axis=-1).astype(np.uint8)
    else:
        arr = RNG.integers(0, 256, size=(size[1], size[0], 3), dtype=np.uint8)
    im = Image.fromarray(arr, "RGB").convert(mode)
    bio = io.BytesIO()
    im.save(bio, format=fmt)
    return bio.getvalue(), np.asarray(im.convert("RGB"))


def test_detect_content_type_magic_numbers():
    jpeg, _ = make_bytes("JPEG")
    png, _ = make_bytes("PNG")
    gif, _ = make_bytes("GIF", mode="P")
    bmp, _ = make_bytes("BMP")
    webp, _ = make_bytes("WEBP")
    assert detect_content_type(jpeg[:512]) == "image/jpeg"
    assert detect_content_type(png[:512]) == "image/png"
    assert detect_content_type(gif[:512]) == "image/gif"
    assert detect_content_type(bmp[:512]) == "image/bmp"
    assert detect_content_type(webp[:512]) == "image/webp"
    assert detect_content_type(b"not an image") == "application/octet-stream"


@pytest.mark.parametrize("fmt,expected", [
    ("JPEG", "jpeg"), ("PNG", "png"), ("BMP", "bmp"), ("WEBP", "webp")])
def test_decode_roundtrip(fmt, expected):
    data, rgb = make_bytes(fmt, smooth=(fmt in ("JPEG", "WEBP")))
    arr, detected = decode_image(data)
    assert detected == expected
    assert arr.shape == rgb.shape
    if fmt in ("PNG", "BMP"):  # lossless
        np.testing.assert_array_equal(arr, rgb)
    else:  # JPEG/WEBP are lossy; smooth input keeps error small
        assert np.abs(arr.astype(int) - rgb.astype(int)).mean() < 10


def test_decode_gif_first_frame():
    data, rgb = make_bytes("GIF", mode="P")
    arr, detected = decode_image(data)
    assert detected == "gif"
    assert arr.shape == rgb.shape


def test_decode_rgba_premultiplies_onto_black():
    arr = np.zeros((10, 10, 4), dtype=np.uint8)
    arr[..., 0] = 200  # red
    arr[..., 3] = 128  # half alpha
    bio = io.BytesIO()
    Image.fromarray(arr, "RGBA").save(bio, format="PNG")
    out, _ = decode_image(bio.getvalue())
    # premultiplied: 200 * 128/255 ~= 100
    assert abs(int(out[5, 5, 0]) - 100) <= 2
    assert out[5, 5, 1] == 0


def test_decode_garbage_raises():
    with pytest.raises(DecodeError):
        decode_image(b"\x00\x01\x02 this is not an image at all" * 20)


def test_encode_jpeg_decodes_back():
    arr = RNG.integers(0, 256, size=(48, 64, 3), dtype=np.uint8)
    data = encode_image(arr, "jpeg", quality=85)
    assert data[:3] == b"\xff\xd8\xff"
    back, fmt = decode_image(data)
    assert fmt == "jpeg"
    assert back.shape == arr.shape


def test_encode_png_lossless():
    arr = RNG.integers(0, 256, size=(32, 32, 3), dtype=np.uint8)
    back, _ = decode_image(encode_image(arr, "png"))
    np.testing.assert_array_equal(back, arr)


def test_encode_gif():
    arr = np.zeros((32, 32, 3), dtype=np.uint8)
    arr[:16] = [255, 0, 0]
    data = encode_image(arr, "gif")
    assert data[:6] in (b"GIF87a", b"GIF89a")


def test_negotiate_format_reference_rules():
    assert negotiate_format("jpg") == "jpeg"
    assert negotiate_format("jpeg") == "jpeg"
    assert negotiate_format("png") == "png"
    assert negotiate_format("gif") == "gif"
    assert negotiate_format("tiff") == "jpeg"   # unknown -> jpeg
    assert negotiate_format("") == "jpeg"
    # watermark re-encodes gif as jpeg (watermark.go:73-74)
    assert negotiate_format("gif", watermark=True) == "jpeg"
    assert negotiate_format("png", watermark=True) == "png"


def test_format_from_content_type():
    assert format_from_content_type("image/jpeg") == "jpeg"
    assert format_from_content_type("image/svg+xml") == "jpeg"  # default
    assert format_from_content_type("image/webp") == "webp"


def test_mime_from_path():
    assert mime_from_path("processed/resize/x/1024x768.jpeg") == "image/jpeg"
    assert mime_from_path("a/b.png") == "image/png"
    assert mime_from_path("a/b.tif") == "image/tiff"
    assert mime_from_path("noext") == "image/jpeg"


def test_16bit_rgba_png_decodes_sanely():
    """Bit depth must normalize BEFORE alpha flattening: a 16-bit RGBA
    PNG's alpha (up to 65535) fed into the /255 premultiply scaled rgb by
    ~257x and saturated the whole image white."""
    import cv2

    rgba16 = np.zeros((8, 8, 4), dtype=np.uint16)
    rgba16[..., 0] = 100 * 257   # R = 100 in 8-bit terms (RGBA order)
    rgba16[..., 3] = 65535       # fully opaque
    bgra16 = cv2.cvtColor(rgba16, cv2.COLOR_RGBA2BGRA)
    ok, png = cv2.imencode(".png", bgra16)
    assert ok
    arr, fmt = decode_image(png.tobytes())
    assert fmt == "png"
    assert abs(int(arr[0, 0, 0]) - 100) <= 1   # not 255 (saturated)
    assert int(arr[0, 0, 1]) <= 1


def test_transparent_gif_pixels_render_black():
    """P-mode GIFs with a transparency index must composite transparent
    pixels to black (Go's image/gif yields {0,0,0,0} and the
    premultiplied encode renders black), not the palette entry's color."""
    import io as _io

    from PIL import Image as PILImage

    # palette: index 0 = bright red, used as the TRANSPARENT index
    im = PILImage.new("P", (4, 4), 0)
    im.putpalette([255, 0, 0] + [0, 255, 0] + [0] * (254 * 3))
    im.info["transparency"] = 0
    buf = _io.BytesIO()
    im.save(buf, "GIF", transparency=0)
    arr, fmt = decode_image(buf.getvalue())
    assert fmt == "gif"
    assert arr.max() == 0   # transparent red -> black, not (255,0,0)


def test_png_compression_knob(monkeypatch):
    """IMAGEPROCESSOR_PNG_COMPRESSION: default 6 (Go png.Encode size
    parity, reference resize.go:83-85), validated range, fail-safe
    fallback to 6, and a real size effect between levels."""
    import importlib

    import numpy as np

    import imageprocessor_tpu.runtime.codecs as codecs

    # graphics-like content — where the level matters
    img = np.zeros((256, 256, 3), np.uint8)
    img[:128, :128] = (200, 10, 10)
    img[::7, :] = 255

    monkeypatch.delenv("IMAGEPROCESSOR_PNG_COMPRESSION", raising=False)
    importlib.reload(codecs)
    assert codecs.PNG_COMPRESSION == 6
    size6 = len(codecs.encode_image(img, "png"))

    monkeypatch.setenv("IMAGEPROCESSOR_PNG_COMPRESSION", "1")
    importlib.reload(codecs)
    assert codecs.PNG_COMPRESSION == 1
    size1 = len(codecs.encode_image(img, "png"))
    assert size6 < size1  # level 6 compresses graphics harder

    # invalid values fall back to the size-parity default, warning
    monkeypatch.setenv("IMAGEPROCESSOR_PNG_COMPRESSION", "fast")
    with pytest.warns(UserWarning, match="PNG_COMPRESSION"):
        importlib.reload(codecs)
    assert codecs.PNG_COMPRESSION == 6
    monkeypatch.setenv("IMAGEPROCESSOR_PNG_COMPRESSION", "11")
    with pytest.warns(UserWarning):
        importlib.reload(codecs)
    assert codecs.PNG_COMPRESSION == 6

    # restore the module for the rest of the suite
    monkeypatch.delenv("IMAGEPROCESSOR_PNG_COMPRESSION", raising=False)
    importlib.reload(codecs)
    assert codecs.PNG_COMPRESSION == 6

    # decoded pixels are identical at any level (PNG is lossless)
    a1, _ = codecs.decode_image(codecs.encode_image(img, "png"))
    assert np.array_equal(a1, img)


def test_jpeg_stream_complete_walks_past_embedded_thumbnail_eoi():
    """A `\\xff\\xd9 in tail` heuristic false-positives when a stream
    truncated mid-entropy still shows an embedded EXIF *thumbnail's*
    EOI in the search window; jpeg_stream_complete must skip APPn
    payloads and only accept the real EOI after SOS (truncated uploads
    must FAIL like Go image.Decode, image_processor.go:47 — never
    gray-fill into a COMPLETED rendition)."""
    from imageprocessor_tpu.runtime.codecs import jpeg_stream_complete

    base, _ = make_bytes("jpeg", size=(96, 64))
    assert jpeg_stream_complete(base)

    # Embed a fake EXIF thumbnail (own SOI..EOI) in an APP1 after SOI.
    payload = (b"Exif\x00\x00" + b"A" * 80 + b"\xff\xd8" + b"B" * 60
               + b"\xff\xd9" + b"C" * 20)
    app1 = b"\xff\xe1" + (len(payload) + 2).to_bytes(2, "big") + payload
    doctored = base[:2] + app1 + base[2:]
    assert jpeg_stream_complete(doctored)  # intact: still complete

    # Truncate inside the entropy data, shallow enough that the
    # thumbnail EOI sits inside any tail search window.
    trunc = doctored[: len(app1) + 2 + 256]
    assert b"\xff\xd9" in trunc  # the naive check would pass...
    assert not jpeg_stream_complete(trunc)  # ...this one must not
    with pytest.raises(DecodeError):
        decode_image(trunc)

    # Cut points everywhere: mid-APP1, mid-SOS header, mid-entropy,
    # before the final EOI byte — all incomplete; the full stream and
    # one with trailing padding after EOI are complete.
    for frac in (0.02, 0.1, 0.3, 0.6, 0.9):
        cut = doctored[: max(4, int(len(doctored) * frac))]
        assert not jpeg_stream_complete(cut), frac
    assert not jpeg_stream_complete(doctored[:-1])
    assert jpeg_stream_complete(doctored + b"\x00" * 32)  # trailing pad
    assert not jpeg_stream_complete(b"\xff\xd8\xff")
    assert not jpeg_stream_complete(b"not a jpeg")


def test_engine_rejects_truncated_jpeg_with_thumbnail_eoi_in_tail():
    """End-to-end: the engine's native-path gate must not be fooled by
    an embedded thumbnail EOI either — the task fails with a decode
    error instead of serving a zero-filled splice/scan rendition."""
    import tempfile

    from imageprocessor_tpu.domain import (
        ImageStatus,
        OperationParams,
        OperationType,
        ProcessingTask,
    )
    from imageprocessor_tpu.runtime.engine import ProcessingEngine
    from imageprocessor_tpu.storage import LocalFSObjectStore

    base, _ = make_bytes("jpeg", size=(96, 64))
    payload = (b"Exif\x00\x00" + b"A" * 80 + b"\xff\xd8" + b"B" * 60
               + b"\xff\xd9" + b"C" * 20)
    app1 = b"\xff\xe1" + (len(payload) + 2).to_bytes(2, "big") + payload
    doctored = base[:2] + app1 + base[2:]
    trunc = doctored[: len(app1) + 2 + 256]

    with tempfile.TemporaryDirectory() as td:
        store = LocalFSObjectStore(td)
        eng = ProcessingEngine(store, device_jpeg=False)
        try:
            task = ProcessingTask(
                id="t-trunc", image_id="i-trunc",
                original_path="o.jpg", bucket="b", format="jpeg",
                operations=[OperationParams(OperationType.WATERMARK, {})])
            res = eng.process_tasks([(task, trunc)])[0]
            assert res.result.status is ImageStatus.FAILED
            assert "decode" in (res.result.error or "").lower()
        finally:
            eng.close()


def test_jpeg_stream_complete_prefix_and_mutation_fuzz():
    """Every strict prefix of a real stream (baseline and progressive)
    is incomplete; arbitrary mutations never raise. The gate is pure
    header-walking Python, so this doubles as its structural fuzz."""
    from imageprocessor_tpu.runtime.codecs import jpeg_stream_complete

    rng = np.random.default_rng(42)
    base, _ = make_bytes("JPEG", size=(64, 48))
    bio = io.BytesIO()
    Image.fromarray(
        rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)).save(
        bio, "JPEG", quality=80, progressive=True)
    prog = bio.getvalue()
    assert jpeg_stream_complete(base) and jpeg_stream_complete(prog)
    for src in (base, prog):
        for cut in range(len(src)):
            assert not jpeg_stream_complete(src[:cut]), cut
    for trial in range(500):
        buf = bytearray(base)
        kind = trial % 4
        if kind == 0:
            for _ in range(int(rng.integers(1, 8))):
                buf[int(rng.integers(0, len(buf)))] = int(
                    rng.integers(0, 256))
        elif kind == 1:
            buf = buf[: int(rng.integers(0, len(buf)))] + bytes(
                rng.integers(0, 256, int(rng.integers(0, 64)),
                             dtype=np.uint8))
        elif kind == 2:
            a = int(rng.integers(0, len(base)))
            b = int(rng.integers(0, len(prog)))
            buf = bytearray(base[:a] + prog[b:])
        else:
            buf = bytearray(rng.integers(
                0, 256, int(rng.integers(0, 512)),
                dtype=np.uint8).tobytes())
        jpeg_stream_complete(bytes(buf))  # must not raise
