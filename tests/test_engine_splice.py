"""Engine-level watermark splice transcode (runtime/splice.py).

The device-JPEG engine's watermark renditions on splice-editable
streams must be emitted by region transcode: coefficients outside the
text band BIT-EXACT to the source stream (zero generation loss — a
property no decode+re-encode path has; decoded pixels are identical
except a <=1-px boundary row/column adjacent to the band on
subsampled-chroma sources, where fancy-upsample taps cross into edited
chroma blocks), the band itself within the PSNR contract of the
full-pipeline blend, and every non-eligible input falling back to the
round-3 re-encode path unchanged.

Reference behavior being replaced: watermark.go:40-155 decodes, blends,
and re-encodes the WHOLE image; the splice path produces the same
visible rendition at a fraction of the host entropy cost (PERF.md
whole-system model) with strictly higher fidelity outside the band.
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
from imageprocessor_tpu.runtime import nativecodec, splice
from imageprocessor_tpu.runtime.codecs import decode_image
from imageprocessor_tpu.runtime.engine import ProcessingEngine
from imageprocessor_tpu.storage import LocalFSObjectStore

RNG = np.random.default_rng(11)

pytestmark = pytest.mark.skipif(not nativecodec.available(),
                                reason="native codec unavailable")


def jpeg_bytes(h, w, quality=90, subsampling=2):
    yy = np.linspace(0, 170, h)[:, None, None]
    arr = np.clip(yy + RNG.integers(0, 40, (h, w, 3)), 0,
                  255).astype(np.uint8)
    bio = io.BytesIO()
    PILImage.fromarray(arr).save(bio, format="JPEG", quality=quality,
                                 subsampling=subsampling)
    return bio.getvalue()


def wm_task(fmt="jpeg", extra_ops=(), **params):
    p = {"text": "hi mark", "opacity": 0.5, "position": "bottom-right"}
    p.update(params)
    ops = [OperationParams(OperationType.WATERMARK, p), *extra_ops]
    return ProcessingTask(id=str(uuid.uuid4()), image_id=str(uuid.uuid4()),
                          original_path="o.jpg", bucket="b",
                          operations=ops, format=fmt)


@pytest.fixture()
def engine(tmp_path):
    store = LocalFSObjectStore(str(tmp_path / "objects"))
    eng = ProcessingEngine(store, device_jpeg=True, codec_threads=2)
    yield eng, store
    eng.close()


def psnr(a, b):
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def test_watermark_rendition_is_spliced(engine):
    """Untouched rows decode byte-identically to the source; the band
    carries the blend; metrics record the splice emit."""
    eng, store = engine
    blob = jpeg_bytes(320, 448)
    task = wm_task()
    res = eng.process_tasks([(task, blob)])[0]
    assert res.result.status is ImageStatus.COMPLETED, res.result.error
    out = store.get_object(res.result.processed_paths["watermark"])
    src = np.asarray(PILImage.open(io.BytesIO(blob)))
    got = np.asarray(PILImage.open(io.BytesIO(out)))
    assert got.shape == src.shape
    # bottom-right text box: everything above the last few MCU rows is
    # a verbatim bit copy -> decodes identically
    assert np.array_equal(src[:256], got[:256])
    assert (src[288:] != got[288:]).any()
    # and the band matches the full-pipeline blend reference
    from imageprocessor_tpu.ops.watermark import watermark_image
    ref = np.asarray(watermark_image(src, text="hi mark", opacity=0.5,
                                     position="bottom-right"))
    assert psnr(got, ref) > 45.0


def test_splice_composes_with_resize_thumbnail(engine):
    """The default 3-op plan: resize/thumbnail still come off the device
    pipeline while the watermark rendition splices."""
    eng, store = engine
    blob = jpeg_bytes(304, 400)
    task = wm_task(extra_ops=[
        OperationParams(OperationType.RESIZE,
                        {"width": 200, "height": 150}),
        OperationParams(OperationType.THUMBNAIL, {"size": 96})])
    res = eng.process_tasks([(task, blob)])[0]
    assert res.result.status is ImageStatus.COMPLETED, res.result.error
    src = np.asarray(PILImage.open(io.BytesIO(blob)))
    wm = np.asarray(PILImage.open(io.BytesIO(
        store.get_object(res.result.processed_paths["watermark"]))))
    assert np.array_equal(src[:240], wm[:240])
    rz, _ = decode_image(store.get_object(res.result.processed_paths["resize"]))
    assert rz.shape == (150, 200, 3)
    from imageprocessor_tpu.ops import thumbnail_dims
    th, _ = decode_image(
        store.get_object(res.result.processed_paths["thumbnail"]))
    tw, thh = thumbnail_dims(400, 304, 96)
    assert th.shape[:2] == (thh, tw)


def test_mixed_group_splices_eligible_item(engine, tmp_path):
    """A batch mixing a splice-eligible JPEG with a PNG upload (never
    splice-eligible: splice only serves JPEG sources): the JPEG item
    splices in its own 'splice'-layout group, the PNG decodes to pixels
    in a separate group and takes the blend+encode path — both
    complete, neither corrupts the other (guards the placeholder image
    against ever reaching Group.pack)."""
    eng, store = engine
    base = jpeg_bytes(320, 448)
    arr = np.asarray(PILImage.open(io.BytesIO(base)))
    bio = io.BytesIO()
    PILImage.fromarray(arr).save(bio, format="PNG")
    png = bio.getvalue()
    t1, t2 = wm_task(), wm_task()
    results = eng.process_tasks([(t1, base), (t2, png)])
    for res in results:
        assert res.result.status is ImageStatus.COMPLETED, res.result.error
    out1 = np.asarray(PILImage.open(io.BytesIO(
        store.get_object(results[0].result.processed_paths["watermark"]))))
    src = np.asarray(PILImage.open(io.BytesIO(base)))
    assert np.array_equal(src[:256], out1[:256])  # spliced
    out2 = np.asarray(PILImage.open(io.BytesIO(
        store.get_object(results[1].result.processed_paths["watermark"]))))
    assert out2.shape[:2] == (320, 448)
    from imageprocessor_tpu.ops.watermark import watermark_image
    ref = np.asarray(watermark_image(arr, text="hi mark", opacity=0.5,
                                     position="bottom-right"))
    assert psnr(out2, ref) > 33.0  # pixel path: q85 re-encode of noise


def test_progressive_watermark_coef_reencode(engine):
    """Progressive sources have no bit offsets to copy, but the plain
    scan's coefficients support the coefficient-domain rendition: band
    edit + baseline re-symbolization with the SOURCE's quantization.
    Pixels outside the band must be IDENTICAL to PIL's decode of the
    progressive source (same coefficients, same tables, same decoder)."""
    eng, store = engine
    base = jpeg_bytes(320, 448)
    arr = np.asarray(PILImage.open(io.BytesIO(base)))
    bio = io.BytesIO()
    PILImage.fromarray(arr).save(bio, format="JPEG", quality=90,
                                 progressive=True)
    prog = bio.getvalue()
    res = eng.process_tasks([(wm_task(), prog)])[0]
    assert res.result.status is ImageStatus.COMPLETED, res.result.error
    out = store.get_object(res.result.processed_paths["watermark"])
    assert b"\xff\xc0" in out  # SOF0: baseline output, like Go's encoder
    src = np.asarray(PILImage.open(io.BytesIO(prog)))
    got = np.asarray(PILImage.open(io.BytesIO(out)))
    assert got.shape == src.shape
    assert np.array_equal(src[:256], got[:256])  # zero-loss region
    assert (src[288:] != got[288:]).any()        # band carries the blend
    from imageprocessor_tpu.ops.watermark import watermark_image
    ref = np.asarray(watermark_image(src, text="hi mark", opacity=0.5,
                                     position="bottom-right"))
    assert psnr(got, ref) > 45.0


def test_restart_marked_source_splices(engine):
    """A restart-marked baseline upload (DRI > 0) takes the splice path:
    untouched rows decode byte-identically, the output re-declares DRI,
    and the band carries the blend."""
    eng, store = engine
    base = jpeg_bytes(320, 448)
    planes, qt, (w, h), samp = nativecodec.scan_jpeg_coefficients(base)
    blob = nativecodec.emit_jpeg_from_coefficients(
        planes, qt, w, h, samp[0], restart_interval=6)
    res = eng.process_tasks([(wm_task(), blob)])[0]
    assert res.result.status is ImageStatus.COMPLETED, res.result.error
    out = store.get_object(res.result.processed_paths["watermark"])
    assert out.count(b"\xff\xdd") >= 1  # restart interval preserved
    src = np.asarray(PILImage.open(io.BytesIO(blob)))
    got = np.asarray(PILImage.open(io.BytesIO(out)))
    assert got.shape == src.shape
    assert np.array_equal(src[:256], got[:256])
    assert (src[288:] != got[288:]).any()
    from imageprocessor_tpu.ops.watermark import watermark_image
    ref = np.asarray(watermark_image(src, text="hi mark", opacity=0.5,
                                     position="bottom-right"))
    assert psnr(got, ref) > 45.0


def test_splice_disabled_restores_reencode(engine, monkeypatch):
    """IMAGEPROCESSOR_JPEG_SPLICE=0: the watermark rendition is a full
    re-encode again (no byte-identical prefix at q85 vs a q90 source)."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    eng, store = engine
    blob = jpeg_bytes(320, 448)
    res = eng.process_tasks([(wm_task(), blob)])[0]
    assert res.result.status is ImageStatus.COMPLETED, res.result.error
    src = np.asarray(PILImage.open(io.BytesIO(blob)))
    got = np.asarray(PILImage.open(io.BytesIO(
        store.get_object(res.result.processed_paths["watermark"]))))
    assert got.shape == src.shape
    assert not np.array_equal(src[:256], got[:256])


def test_png_output_never_splices(engine):
    """format=png forces the PNG encoder; splice only serves JPEG
    renditions."""
    eng, store = engine
    res = eng.process_tasks([(wm_task(fmt="png"),
                              jpeg_bytes(200, 264))])[0]
    assert res.result.status is ImageStatus.COMPLETED, res.result.error
    assert res.result.processed_paths["watermark"].endswith(".png")


def test_grayscale_watermark_promotes_in_coefficient_domain(engine):
    """Grayscale watermark-only tasks promote to color in the
    coefficient domain (round 5): Y coefficients stay bit-exact outside
    the band, synthesized neutral chroma reproduces the gray→color
    promotion, output is a 3-component baseline stream (reference:
    watermark.go promotes to RGBA before jpeg.Encode). Decoded pixels
    outside the band are IDENTICAL to the grayscale source's decode."""
    eng, store = engine
    arr = RNG.integers(0, 256, (200, 264), dtype=np.uint8)
    bio = io.BytesIO()
    PILImage.fromarray(arr, mode="L").save(bio, format="JPEG", quality=88)
    blob = bio.getvalue()
    res = eng.process_tasks([(wm_task(), blob)])[0]
    assert res.result.status is ImageStatus.COMPLETED, res.result.error
    out = store.get_object(res.result.processed_paths["watermark"])
    got = np.asarray(PILImage.open(io.BytesIO(out)).convert("RGB"))
    assert got.shape == (200, 264, 3)
    src = np.asarray(PILImage.open(io.BytesIO(blob)))  # (H, W) gray
    # outside the bottom-right band: exact gray promotion
    np.testing.assert_array_equal(got[:136],
                                  np.repeat(src[:136, :, None], 3, axis=2))
    assert (got[168:] != src[168:, :, None]).any()  # band carries blend
    # grayscale PROGRESSIVE promotes the same way (via the plain scan)
    bio = io.BytesIO()
    PILImage.fromarray(arr, mode="L").save(bio, format="JPEG", quality=88,
                                           progressive=True)
    pblob = bio.getvalue()
    res2 = eng.process_tasks([(wm_task(), pblob)])[0]
    assert res2.result.status is ImageStatus.COMPLETED, res2.result.error
    got2 = np.asarray(PILImage.open(io.BytesIO(store.get_object(
        res2.result.processed_paths["watermark"]))).convert("RGB"))
    psrc = np.asarray(PILImage.open(io.BytesIO(pblob)))
    np.testing.assert_array_equal(
        got2[:136], np.repeat(psrc[:136, :, None], 3, axis=2))


def test_splice_preserves_source_quality(engine):
    """The headline fidelity property: vs the ideal (decoded source +
    float blend), the spliced rendition beats the re-encode path."""
    eng, store = engine
    blob = jpeg_bytes(320, 448, quality=95)
    res = eng.process_tasks([(wm_task(), blob)])[0]
    assert res.result.status is ImageStatus.COMPLETED, res.result.error
    spliced = np.asarray(PILImage.open(io.BytesIO(
        store.get_object(res.result.processed_paths["watermark"]))))

    src = np.asarray(PILImage.open(io.BytesIO(blob)))
    from imageprocessor_tpu.ops.watermark import watermark_image
    ideal = np.asarray(watermark_image(src, text="hi mark", opacity=0.5,
                                       position="bottom-right"))
    # re-encode comparison: the ideal pixels through a q85 JPEG cycle
    bio = io.BytesIO()
    PILImage.fromarray(ideal).save(bio, format="JPEG", quality=85)
    reenc = np.asarray(PILImage.open(bio))
    assert psnr(spliced, ideal) > psnr(reenc, ideal) + 3.0


def test_two_watermark_ops_no_dc_corruption(engine):
    """A plan with TWO watermark ops: plan ops are INDEPENDENT
    renditions of one source, and watermark_splice restores the context
    after each emit, so the second op splices on pristine planes — it
    must carry ONLY its own text, with every MCU outside its band
    bit-copied from the source (no DC-shift corruption, no first-op
    leakage)."""
    eng, store = engine
    blob = jpeg_bytes(320, 448)
    task = wm_task(text="first")
    task.operations.append(OperationParams(
        OperationType.WATERMARK,
        {"text": "second", "opacity": 0.5, "position": "top-left"}))
    res = eng.process_tasks([(task, blob)])[0]
    assert res.result.status is ImageStatus.COMPLETED, res.result.error
    # one shared output path (reference layout: watermarked.{fmt});
    # the surviving artifact is the SECOND op's write
    got = np.asarray(PILImage.open(io.BytesIO(
        store.get_object(res.result.processed_paths["watermark"]))))
    src = np.asarray(PILImage.open(io.BytesIO(blob)))
    assert got.shape == src.shape
    # the second op's text landed top-left...
    assert (got[:64] != src[:64]).any()
    # ...and everything below its band is BIT-EXACT to the source:
    # no first-op text (bottom-right stayed pristine) and no DC-shift
    # corruption anywhere
    assert np.array_equal(got[96:], src[96:])


def test_splice_restores_context_between_renditions():
    """watermark_splice restores the band edit in a finally: the context
    is pristine after each call (edited=False), a repeat call emits
    byte-identical output, and the defense-in-depth guard still rejects
    a context that is already dirty at entry."""
    from types import SimpleNamespace

    blob = jpeg_bytes(168, 232)
    ctx = nativecodec.scan_jpeg_for_transcode(blob)
    pristine = [p.copy() for p in ctx.planes]
    op = SimpleNamespace(text="x", opacity=0.5, position="bottom-right",
                         font_size=None, font_color="")
    out1 = splice.watermark_splice(ctx, op)
    assert out1[:2] == b"\xff\xd8"
    assert not ctx.edited
    for a, b in zip(ctx.planes, pristine):
        assert np.array_equal(a, b)
    assert splice.watermark_splice(ctx, op) == out1
    # guard: a context dirty at entry cannot be spliced
    ctx.edited = True
    with pytest.raises(nativecodec.NativeCodecError):
        splice.watermark_splice(ctx, op)


def test_watermark_only_splices_without_device_jpeg(tmp_path):
    """Backend-independent shortcut (round 5): a watermark-ONLY plan on
    a splice-eligible JPEG needs no pixel decode and no device program
    — it splices even with device_jpeg OFF (the host-codec path CPU
    scale-out workers run). The rendition keeps the byte-identical
    untouched region."""
    store = LocalFSObjectStore(str(tmp_path / "objects"))
    eng = ProcessingEngine(store, device_jpeg=False)
    try:
        blob = jpeg_bytes(320, 448)
        res = eng.process_tasks([(wm_task(), blob)])[0]
        assert res.result.status is ImageStatus.COMPLETED, res.result.error
        src = np.asarray(PILImage.open(io.BytesIO(blob)))
        got = np.asarray(PILImage.open(io.BytesIO(
            store.get_object(res.result.processed_paths["watermark"]))))
        assert got.shape == src.shape
        assert np.array_equal(src[:256], got[:256])
        assert (src[288:] != got[288:]).any()
    finally:
        eng.close()


def test_watermark_only_mixed_eligibility_without_device_jpeg(tmp_path):
    """Shortcut grouping: splice-served items (baseline bit-splice,
    progressive coef re-encode, grayscale promotion) ride the 'splice'
    layout group; a PNG batchmate decodes to pixels in its own group —
    all complete, none corrupts another, and a TRUNCATED baseline JPEG
    fails with a decode error instead of being zero-filled into a
    COMPLETED garbage rendition."""
    store = LocalFSObjectStore(str(tmp_path / "objects"))
    eng = ProcessingEngine(store, device_jpeg=False)
    try:
        base = jpeg_bytes(320, 448)
        arr = np.asarray(PILImage.open(io.BytesIO(base)))
        bio = io.BytesIO()
        PILImage.fromarray(arr).save(bio, format="PNG")
        png = bio.getvalue()
        bio = io.BytesIO()
        PILImage.fromarray(arr).save(bio, format="JPEG", quality=90,
                                     progressive=True)
        prog = bio.getvalue()
        truncated = base[:len(base) // 2]
        results = eng.process_tasks([
            (wm_task(), base), (wm_task(), png), (wm_task(), prog),
            (wm_task(), truncated)])
        for res in results[:3]:
            assert res.result.status is ImageStatus.COMPLETED, \
                res.result.error
        src = np.asarray(PILImage.open(io.BytesIO(base)))
        out1 = np.asarray(PILImage.open(io.BytesIO(store.get_object(
            results[0].result.processed_paths["watermark"]))))
        assert np.array_equal(src[:256], out1[:256])  # spliced
        out2 = np.asarray(PILImage.open(io.BytesIO(store.get_object(
            results[1].result.processed_paths["watermark"]))))
        assert out2.shape[:2] == (320, 448)  # pixel path (PNG source)
        prog_px = np.asarray(PILImage.open(io.BytesIO(prog)))
        out3 = np.asarray(PILImage.open(io.BytesIO(store.get_object(
            results[2].result.processed_paths["watermark"]))))
        assert np.array_equal(prog_px[:256], out3[:256])  # coef-spliced
        # truncated: decode-error semantics, never a zero-filled splice
        assert results[3].result.status is ImageStatus.FAILED
        assert "decode" in (results[3].result.error or "").lower()
    finally:
        eng.close()


def test_decode_rgb_fallback_matches_decoder():
    """splice.decode_rgb (the defensive full-image fallback) matches
    the production decode path within the codec contract."""
    blob = jpeg_bytes(168, 232)
    ctx = nativecodec.scan_jpeg_for_transcode(blob)
    got = splice.decode_rgb(ctx)
    from imageprocessor_tpu.ops.jpeg_decode import decode_jpeg_device
    want = np.transpose(np.asarray(decode_jpeg_device(blob)), (1, 2, 0))
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert psnr(got, want) > 55.0


@pytest.mark.parametrize("hw,pos,subsampling", [
    ((33, 47), "bottom-right", 2),   # partial MCU row+col, 4:2:0
    ((33, 47), "top-left", 0),       # 4:4:4 keeps chroma the pixel
    ((17, 129), "center", 0),        # path's 4:2:0 re-encode drops
    ((17, 129), "bottom-center", 2),
    ((15, 15), "bottom-right", 2),   # image smaller than one band
    ((15, 15), "top-center", 1),     # 4:2:2 partial MCUs
    ((128, 16), "bottom-left", 2),   # single-MCU-wide canvas
    ((40, 24), "top-right", 1),
])
def test_splice_partial_mcu_geometry(tmp_path, hw, pos, subsampling):
    """Geometry sweep distilled from a 147-combo probe: sizes with
    partial bottom/right MCUs across anchors and subsamplings must
    splice to COMPLETED, and the splice rendition must be at least as
    close to the decoded source as the splice-off pixel path's q85
    re-encode is (on 4:4:4 sources it is ~70 dB closer — the re-encode
    subsamples chroma to 4:2:0, splice keeps the source's sampling)."""
    h, w = hw
    store = LocalFSObjectStore(str(tmp_path / "objects"))
    eng = ProcessingEngine(store, device_jpeg=False)
    try:
        yy = np.linspace(0, 170, h)[:, None, None]
        arr = np.clip(yy + RNG.integers(0, 40, (h, w, 3)), 0,
                      255).astype(np.uint8)
        bio = io.BytesIO()
        PILImage.fromarray(arr).save(bio, format="JPEG", quality=88,
                                     subsampling=subsampling)
        src = bio.getvalue()
        srcpx = np.asarray(PILImage.open(io.BytesIO(src)).convert("RGB"))
        res = eng.process_tasks([
            (wm_task(position=pos, opacity=0.35), src)])[0]
        assert res.result.status is ImageStatus.COMPLETED, res.result.error
        out = store.get_object(res.result.processed_paths["watermark"])
        a = np.asarray(PILImage.open(io.BytesIO(out)).convert("RGB"))
        assert a.shape == srcpx.shape
        import os
        os.environ["IMAGEPROCESSOR_JPEG_SPLICE"] = "0"
        try:
            res2 = eng.process_tasks([
                (wm_task(position=pos, opacity=0.35), src)])[0]
        finally:
            os.environ["IMAGEPROCESSOR_JPEG_SPLICE"] = "1"
        assert res2.result.status is ImageStatus.COMPLETED
        b = np.asarray(PILImage.open(io.BytesIO(store.get_object(
            res2.result.processed_paths["watermark"]))).convert("RGB"))
        # The fidelity ordering IS the property: splice must never be
        # farther from the source than the q85 re-encode (no absolute
        # floor — on tiny canvases the watermark band legitimately
        # covers most pixels, so both paths sit far from the
        # unwatermarked source).
        assert psnr(a, srcpx) >= psnr(b, srcpx) - 0.5
    finally:
        eng.close()
