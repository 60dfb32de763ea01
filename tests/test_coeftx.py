"""Lossless coefficient-domain flip/rotate/crop (runtime/coeftx.py).

Correctness criteria, strongest first:
1. BIT-EXACT coefficients: emit + rescan of a transformed context
   returns exactly the transformed planes (the transform is lossless in
   the coefficient domain — zero generation loss, jpegtran's property).
2. BIT-EXACT pixels under the float64 symmetric oracle decoder
   (splice.decode_rgb) for mirrors and 90-degree rotations; crop is
   pixel-exact except the <=1-px strip adjacent to a subsampled-chroma
   crop edge, where the decoder's upsample taps clamp at the new plane
   boundary instead of reading the cropped-away neighbors (same caveat
   family as the splice band edge, PARITY.md). Integer decoders
   (libjpeg/PIL) add their own <=3 LSB IDCT/upsample rounding asymmetry
   on top — inherent to any jpegtran-style output, not a transform
   property.
3. Geometry gates follow jpegtran's perfect-transform rules; anything
   inexpressible falls back to the pixel path.
"""

import io
import tempfile
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
from imageprocessor_tpu.models.plan import NormalizedOp
from imageprocessor_tpu.runtime import coeftx, nativecodec, splice
from imageprocessor_tpu.runtime.engine import ProcessingEngine
from imageprocessor_tpu.storage import LocalFSObjectStore

pytestmark = pytest.mark.skipif(not nativecodec.available(),
                                reason="native codec unavailable")

RNG = np.random.default_rng(23)


def jpeg_bytes(h, w, subsampling=2, quality=88, progressive=False,
               gray=False):
    yy = np.linspace(0, 170, h)[:, None, None]
    arr = np.clip(yy + RNG.integers(0, 60, (h, w, 3)), 0,
                  255).astype(np.uint8)
    im = PILImage.fromarray(arr)
    if gray:
        im = im.convert("L")
    bio = io.BytesIO()
    kw = {"quality": quality}
    if not gray:
        kw["subsampling"] = subsampling
    if progressive:
        kw["progressive"] = True
    im.save(bio, format="JPEG", **kw)
    return bio.getvalue()


OPS = [
    ("flip_h", NormalizedOp(type=OperationType.FLIP,
                            direction="horizontal"),
     lambda a: a[:, ::-1]),
    ("flip_v", NormalizedOp(type=OperationType.FLIP,
                            direction="vertical"),
     lambda a: a[::-1]),
    ("rot90", NormalizedOp(type=OperationType.ROTATE, angle=90.0),
     lambda a: np.rot90(a, 1, (0, 1))),
    ("rot180", NormalizedOp(type=OperationType.ROTATE, angle=180.0),
     lambda a: np.rot90(a, 2, (0, 1))),
    ("rot270", NormalizedOp(type=OperationType.ROTATE, angle=270.0),
     lambda a: np.rot90(a, 3, (0, 1))),
    ("crop", NormalizedOp(type=OperationType.CROP, x=16, y=16,
                          width=33, height=23),
     lambda a: a[16:39, 16:49]),
]


@pytest.mark.parametrize("subsampling,hw", [
    (0, (56, 72)), (1, (56, 80)), (2, (64, 80))])
def test_transforms_bit_exact_and_oracle_pixels(subsampling, hw):
    h, w = hw
    src = jpeg_bytes(h, w, subsampling)
    ctx = nativecodec.scan_jpeg_for_transcode(src)
    srcpx = splice.decode_rgb(ctx)
    pristine = [p.copy() for p in ctx.planes]
    for label, op, fn in OPS:
        prims = coeftx.eligible_prims(op, ctx.size, ctx.sampling)
        assert prims is not None, label
        out = coeftx.apply(ctx, prims)
        # apply() is pure: the source context is untouched
        for a, b in zip(ctx.planes, pristine):
            assert np.array_equal(a, b), label
        data = splice.reencode(out)
        # 1. coefficient bit-exactness through a real emit + rescan
        p2, qt2, (w2, h2), samp2 = \
            nativecodec.scan_jpeg_coefficients(data)
        assert (w2, h2) == out.size, label
        assert [tuple(s) for s in samp2] == \
            [tuple(s) for s in out.sampling], label
        for a, b in zip(p2, out.planes):
            assert np.array_equal(a, b), label
        # 2. pixel exactness under the float64 symmetric oracle
        got = splice.decode_rgb(out)
        want = fn(srcpx)
        assert got.shape == want.shape, label
        if label == "crop":
            d = np.abs(got.astype(int) - want.astype(int))
            assert d[2:-2, 2:-2].max() == 0, label  # interior exact
            # edge strip: bounded chroma-upsample clamp (content-
            # dependent; a wrong permutation would blow far past this)
            assert d.max() <= 32, label
        else:
            assert np.array_equal(got, want), label


def test_eligibility_gates():
    """Mirror gates: axes where every component's extent is
    block-aligned take the exact block mirror; any axis where the fold
    is an exact per-component banded linear map — a sample SELECTION
    when each component's lattice divides the dim (1080-class %16==8,
    even %8!=0 like 1366, any dim on unsubsampled axes) or the
    subsample-area two-tap mirror when it does not (odd dims at
    4:2:0) — takes the `_rs` variant (aligned components exact,
    shifted ones one requant). Crops need an MCU-aligned origin,
    rotations a multiple of 90 degrees."""
    s420 = [(2, 2), (1, 1), (1, 1)]
    flip_h = NormalizedOp(type=OperationType.FLIP, direction="horizontal")
    flip_v = NormalizedOp(type=OperationType.FLIP, direction="vertical")
    # 72 % 16 == 8 but % 8 == 0: chroma-resample mirror
    assert coeftx.eligible_prims(flip_h, (72, 64), s420) == ["flip_h_rs"]
    assert coeftx.eligible_prims(flip_h, (80, 64), s420) == ["flip_h"]
    # 68 % 8 == 4 but even: luma shifts too (1366-class)
    assert coeftx.eligible_prims(flip_h, (68, 64), s420) == ["flip_h_rs"]
    # odd width at 4:2:0: two-tap chroma mirror — still eligible
    assert coeftx.eligible_prims(flip_h, (67, 64), s420) == ["flip_h_rs"]
    assert coeftx.eligible_prims(flip_v, (64, 67), s420) == ["flip_v_rs"]
    assert coeftx.eligible_prims(flip_v, (80, 56), s420) == ["flip_v_rs"]
    assert coeftx.eligible_prims(flip_v, (80, 64), s420) == ["flip_v"]
    assert coeftx.eligible_prims(flip_v, (80, 1080), s420) == \
        ["flip_v_rs"]  # the 1920x1080 case
    assert coeftx.eligible_prims(flip_h, (1366, 768), s420) == \
        ["flip_h_rs"]  # the 1366x768 case (luma+chroma shift)
    # 4:2:2 only needs width % 16 for flip_h, height % 8 for flip_v
    s422 = [(2, 1), (1, 1), (1, 1)]
    assert coeftx.eligible_prims(flip_v, (80, 56), s422) == ["flip_v"]
    # ... and vertically nothing is subsampled: ANY height is a
    # selection (odd included)
    assert coeftx.eligible_prims(flip_v, (80, 55), s422) == ["flip_v_rs"]
    # 4:4:4 / grayscale: any dim on any axis
    s444 = [(1, 1), (1, 1), (1, 1)]
    assert coeftx.eligible_prims(flip_h, (53, 64), s444) == ["flip_h_rs"]
    assert coeftx.eligible_prims(flip_h, (53, 64), [(1, 1)]) == \
        ["flip_h_rs"]
    rot = lambda a: NormalizedOp(type=OperationType.ROTATE, angle=a)
    assert coeftx.eligible_prims(rot(45.0), (80, 64), s420) is None
    assert coeftx.eligible_prims(rot(0.0), (80, 64), s420) == []
    assert coeftx.eligible_prims(rot(90.0), (72, 64), s420) == \
        ["flip_h_rs", "transpose"]
    assert coeftx.eligible_prims(rot(90.0), (67, 64), s420) == \
        ["flip_h_rs", "transpose"]
    assert coeftx.eligible_prims(rot(270.0), (72, 64), s420) == \
        ["flip_v", "transpose"]
    crop = NormalizedOp(type=OperationType.CROP, x=8, y=0,
                        width=32, height=32)
    # unaligned origin (x % 16): eligible through the rs shift path
    assert coeftx.eligible_prims(crop, (80, 64), s420) == \
        [("crop", 8, 0, 32, 32)]
    crop2 = NormalizedOp(type=OperationType.CROP, x=16, y=32,
                         width=32, height=32)
    assert coeftx.eligible_prims(crop2, (80, 64), s420) == \
        [("crop", 16, 32, 32, 32)]
    # clamping mirrors ops/extra.crop_image: oversize rect shrinks
    big = NormalizedOp(type=OperationType.CROP, x=0, y=0,
                       width=999, height=999)
    assert coeftx.eligible_prims(big, (80, 64), s420) == \
        [("crop", 0, 0, 80, 64)]


def _task(ops, fmt="jpeg"):
    return ProcessingTask(
        id=str(uuid.uuid4()), image_id=str(uuid.uuid4()),
        original_path="o.jpg", bucket="b", format=fmt,
        operations=[OperationParams(t, p) for t, p in ops])


def test_engine_serves_transform_plans_without_pixel_decode(tmp_path):
    """All-coefficient plans (transforms, optionally with a watermark)
    take the no-pixel-decode shortcut on any backend; ineligible
    geometry falls back to the pixel path and still completes."""
    from imageprocessor_tpu.utils.metrics import METRICS

    store = LocalFSObjectStore(str(tmp_path / "objects"))
    eng = ProcessingEngine(store, device_jpeg=False)
    try:
        src = jpeg_bytes(64, 80)
        srcpx = np.asarray(PILImage.open(io.BytesIO(src)).convert("RGB"))
        before = METRICS.snapshot().get(
            "counters", {}).get("engine_coeftx_images", 0)

        res = eng.process_tasks([
            (_task([(OperationType.ROTATE, {"angle": 90})]), src)])[0]
        assert res.result.status is ImageStatus.COMPLETED, res.result.error
        out = np.asarray(PILImage.open(io.BytesIO(store.get_object(
            res.result.processed_paths["rotate"]))).convert("RGB"))
        want = np.rot90(srcpx, 1, (0, 1))
        assert out.shape == want.shape
        # integer-decoder rounding asymmetry only (PIL decodes both)
        assert np.abs(out.astype(int) - want.astype(int)).max() <= 3

        # mixed transform + watermark plan: both renditions coef-served
        res = eng.process_tasks([
            (_task([(OperationType.FLIP, {"direction": "vertical"}),
                    (OperationType.WATERMARK,
                     {"text": "hi", "opacity": 0.5})]), src)])[0]
        assert res.result.status is ImageStatus.COMPLETED, res.result.error
        out = np.asarray(PILImage.open(io.BytesIO(store.get_object(
            res.result.processed_paths["flip"]))).convert("RGB"))
        assert np.array_equal(out, srcpx[::-1])  # flip_v is PIL-exact

        after = METRICS.snapshot().get(
            "counters", {}).get("engine_coeftx_images", 0)
        assert after - before >= 2

        # ineligible: arbitrary angle falls back to the pixel path
        res = eng.process_tasks([
            (_task([(OperationType.ROTATE, {"angle": 45})]), src)])[0]
        assert res.result.status is ImageStatus.COMPLETED, res.result.error
        out = np.asarray(PILImage.open(io.BytesIO(store.get_object(
            res.result.processed_paths["rotate"]))).convert("RGB"))
        assert out.shape == srcpx.shape

        # png-format tasks never shortcut (output must be png)
        res = eng.process_tasks([
            (_task([(OperationType.FLIP, {"direction": "vertical"})],
                   fmt="png"), src)])[0]
        assert res.result.status is ImageStatus.COMPLETED, res.result.error
        blob = store.get_object(res.result.processed_paths["flip"])
        assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        eng.close()


def test_engine_transforms_progressive_and_grayscale_sources(tmp_path):
    """Progressive sources re-symbolize from the plain scan; grayscale
    sources promote to color in the coefficient domain (the same
    promotion the pixel pipeline performs)."""
    store = LocalFSObjectStore(str(tmp_path / "objects"))
    eng = ProcessingEngine(store, device_jpeg=False)
    try:
        for blob in (jpeg_bytes(64, 80, progressive=True),
                     jpeg_bytes(64, 80, gray=True)):
            px = np.asarray(PILImage.open(io.BytesIO(blob)).convert("RGB"))
            res = eng.process_tasks([
                (_task([(OperationType.FLIP,
                         {"direction": "horizontal"})]), blob)])[0]
            assert res.result.status is ImageStatus.COMPLETED, \
                res.result.error
            out = np.asarray(PILImage.open(io.BytesIO(store.get_object(
                res.result.processed_paths["flip"]))).convert("RGB"))
            assert out.shape == px.shape
            d = np.abs(out.astype(int) - px[:, ::-1].astype(int))
            assert d.max() <= 3  # integer-decoder rounding only
    finally:
        eng.close()


def test_native_rot_kernel_matches_numpy_path(monkeypatch):
    """The fused native blocked-rotation kernel and the pure numpy
    decomposition must produce byte-identical streams (the numpy path
    is the behavioral reference and the fallback when the library
    lacks ip_coef_rot_i16)."""
    src = jpeg_bytes(64, 80)
    ctx = nativecodec.scan_jpeg_for_transcode(src)
    for angle in (90.0, 270.0):
        op = NormalizedOp(type=OperationType.ROTATE, angle=angle)
        prims = coeftx.eligible_prims(op, ctx.size, ctx.sampling)
        native_out = splice.reencode(coeftx.apply(ctx, prims))

        def boom(plane, mode):
            raise nativecodec.NativeCodecError("forced numpy path")

        monkeypatch.setattr(nativecodec, "coef_rot_i16", boom)
        numpy_out = splice.reencode(coeftx.apply(ctx, prims))
        monkeypatch.undo()
        assert native_out == numpy_out, angle


@pytest.mark.parametrize("direction,hw,axis", [
    ("vertical", (56, 80), 0),    # 56 % 16 == 8: chroma shift on rows
    ("horizontal", (64, 72), 1),  # 72 % 16 == 8: chroma shift on cols
])
def test_rs_mirror_luma_exact_chroma_single_requant(direction, hw, axis):
    """The `_rs` mirrors (runtime/coeftx._shift_mirror): LUMA plane is
    a bit-exact extent-mirror; decoded pixels beat the pixel path's
    q85 re-encode (which requantizes luma AND chroma) on every source —
    the chroma pays exactly one requantization with its own table."""
    h, w = hw
    src = jpeg_bytes(h, w, subsampling=2)
    ctx = nativecodec.scan_jpeg_for_transcode(src)
    op = NormalizedOp(type=OperationType.FLIP, direction=direction)
    prims = coeftx.eligible_prims(op, ctx.size, ctx.sampling)
    assert prims == ["flip_v_rs" if axis == 0 else "flip_h_rs"]
    out = coeftx.apply(ctx, prims)
    # luma: bit-exact extent-aware block mirror
    ext = h if axis == 0 else w
    want_luma = coeftx._mirror_blocks(ctx.planes[0], ext, axis)
    assert np.array_equal(out.planes[0], want_luma)
    # pixels: closer to the ideal than the pixel path's q85 re-encode
    ideal = splice.decode_rgb(ctx)
    ideal = ideal[::-1] if axis == 0 else ideal[:, ::-1]
    got = splice.decode_rgb(out)
    a = nativecodec.decode_jpeg(src)
    a = a[::-1] if axis == 0 else a[:, ::-1]
    pix = nativecodec.decode_jpeg(nativecodec.encode_jpeg(
        np.ascontiguousarray(a), quality=85))

    def psnr(x, y):
        mse = ((x.astype(np.float64) - y.astype(np.float64)) ** 2).mean()
        return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))

    assert psnr(got, ideal) > psnr(pix, ideal)
    # the emitted stream round-trips bit-exact (coefficients final)
    p2, _qt, (w2, h2), _s = nativecodec.scan_jpeg_coefficients(
        splice.reencode(out))
    assert (w2, h2) == out.size
    for x, y in zip(p2, out.planes):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("subsampling,direction,hw", [
    (2, "horizontal", (64, 70)),   # 4:2:0, 70 % 8 == 6 even: the
    (2, "vertical", (70, 64)),     # 1366-class (luma + chroma shift)
    (1, "vertical", (55, 64)),     # 4:2:2: vertical factors all 1 —
                                   # odd heights are selections too
    (0, "horizontal", (64, 53)),   # 4:4:4: any dim, 3 shifted comps
    (2, "horizontal", (64, 67)),   # 4:2:0 odd width: two-tap chroma
    (2, "vertical", (67, 64)),     # 4:2:0 odd height
    (1, "horizontal", (64, 67)),   # 4:2:2 odd width: two-tap chroma
])
def test_generalized_rs_mirror(subsampling, direction, hw):
    """Generalized `_rs` mirrors: components whose extent stays
    8-aligned mirror bit-exact; lattice-dividing misaligned ones take
    the exact selection shift; odd dims on a subsampled axis take the
    subsample-area two-tap mirror — each pays exactly one source-table
    requant. Decoded pixels beat the pixel path's q85 re-encode on
    every shape (measured up to +10 dB on chroma edges, PERF.md), and
    the emitted stream round-trips the coefficients bit-exact."""
    h, w = hw
    src = jpeg_bytes(h, w, subsampling=subsampling)
    ctx = nativecodec.scan_jpeg_for_transcode(src)
    op = NormalizedOp(type=OperationType.FLIP, direction=direction)
    prims = coeftx.eligible_prims(op, ctx.size, ctx.sampling)
    axis = 0 if direction == "vertical" else 1
    assert prims == ["flip_v_rs" if axis == 0 else "flip_h_rs"]
    out = coeftx.apply(ctx, prims)
    ideal = splice.decode_rgb(ctx)
    ideal = ideal[::-1] if axis == 0 else ideal[:, ::-1]
    got = splice.decode_rgb(out)
    a = nativecodec.decode_jpeg(src)
    a = a[::-1] if axis == 0 else a[:, ::-1]
    pix = nativecodec.decode_jpeg(nativecodec.encode_jpeg(
        np.ascontiguousarray(a), quality=85))

    def psnr(x, y):
        mse = ((x.astype(np.float64) - y.astype(np.float64)) ** 2).mean()
        return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))

    assert psnr(got, ideal) > psnr(pix, ideal)
    p2, _qt, (w2, h2), _s = nativecodec.scan_jpeg_coefficients(
        splice.reencode(out))
    assert (w2, h2) == out.size
    for x, y in zip(p2, out.planes):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("subsampling", [2, 1, 0])
@pytest.mark.parametrize("rect", [
    (8, 8, 33, 23),     # luma block-aligned, chroma shifts (4:2:0)
    (5, 3, 33, 23),     # fully unaligned, odd offsets (two-tap chroma)
    (13, 7, 40, 32),
    (21, 11, 99, 85),   # crop reaching the right/bottom image edge
                        # (exercises the source-padding tap clamp)
])
def test_unaligned_origin_crop(subsampling, rect):
    """Crops with a non-MCU-aligned origin run through the banded
    shift machinery: both axes composed on the dequantized planes, one
    source-table requant per shifted component (components whose own
    offset stays block-aligned keep the lossless integer slice).
    Interior pixels beat the pixel path's q85 re-encode on every
    shape; the emitted stream round-trips the coefficients bit-exact
    and matches the pixel op's output dims exactly."""
    x, y, cw, ch = rect
    h, w = 96, 120
    src = jpeg_bytes(h, w, subsampling=subsampling)
    ctx = nativecodec.scan_jpeg_for_transcode(src)
    op = NormalizedOp(type=OperationType.CROP, x=x, y=y,
                      width=cw, height=ch)
    prims = coeftx.eligible_prims(op, ctx.size, ctx.sampling)
    assert prims == [("crop", x, y, cw, ch)]
    out = coeftx.apply(ctx, prims)
    assert out.size == (cw, ch)
    p2, _qt, (w2, h2), _s = nativecodec.scan_jpeg_coefficients(
        splice.reencode(out))
    assert (w2, h2) == (cw, ch)
    for a, b in zip(p2, out.planes):
        assert np.array_equal(a, b)
    ideal = splice.decode_rgb(ctx)[y:y + ch, x:x + cw]
    got = splice.decode_rgb(out)
    a0 = nativecodec.decode_jpeg(src)[y:y + ch, x:x + cw]
    pix = nativecodec.decode_jpeg(nativecodec.encode_jpeg(
        np.ascontiguousarray(a0), quality=85))

    def psnr(q, r):
        mse = ((q.astype(np.float64) - r.astype(np.float64)) ** 2).mean()
        return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))

    # interior comparison: edge strips carry the documented <=1-px
    # chroma-upsample clamp caveat on BOTH paths
    assert psnr(got[2:-2, 2:-2], ideal[2:-2, 2:-2]) > \
        psnr(pix[2:-2, 2:-2], ideal[2:-2, 2:-2])


def test_rs_mirror_through_engine_1080p_shape(tmp_path):
    """1920x1080-class sources (h % 16 == 8 at 4:2:0) flip vertically
    through the engine via the rs path — previously pixel-path-only."""
    store = LocalFSObjectStore(str(tmp_path / "objects"))
    eng = ProcessingEngine(store, device_jpeg=False)
    try:
        src = jpeg_bytes(120, 160)  # 120 % 16 == 8, same class as 1080
        srcpx = np.asarray(PILImage.open(io.BytesIO(src)).convert("RGB"))
        res = eng.process_tasks([
            (_task([(OperationType.FLIP, {"direction": "vertical"}),
                    (OperationType.ROTATE, {"angle": 180})]), src)])[0]
        assert res.result.status is ImageStatus.COMPLETED, res.result.error
        for key, fn in [("flip", lambda a: a[::-1]),
                        ("rotate", lambda a: np.rot90(a, 2, (0, 1)))]:
            out = np.asarray(PILImage.open(io.BytesIO(store.get_object(
                res.result.processed_paths[key]))).convert("RGB"))
            want = fn(srcpx)
            assert out.shape == want.shape

            def psnr(x, y):
                mse = ((x.astype(np.float64)
                        - y.astype(np.float64)) ** 2).mean()
                return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))

            assert psnr(out, want) > 33.0, key  # chroma requant only
    finally:
        eng.close()


def test_rs_knob_reverts_to_pixel_path(monkeypatch):
    """IMAGEPROCESSOR_COEF_RS=0: half-MCU mirror shapes fall back to
    the pixel path (the measured host-cost tradeoff, PERF.md); exact
    mirrors are unaffected."""
    s420 = [(2, 2), (1, 1), (1, 1)]
    flip_v = NormalizedOp(type=OperationType.FLIP, direction="vertical")
    crop = NormalizedOp(type=OperationType.CROP, x=5, y=3,
                        width=32, height=32)
    monkeypatch.setenv("IMAGEPROCESSOR_COEF_RS", "0")
    assert coeftx.eligible_prims(flip_v, (80, 56), s420) is None
    assert coeftx.eligible_prims(flip_v, (80, 64), s420) == ["flip_v"]
    assert coeftx.eligible_prims(crop, (80, 64), s420) is None
    monkeypatch.delenv("IMAGEPROCESSOR_COEF_RS", raising=False)
    assert coeftx.eligible_prims(flip_v, (80, 56), s420) == ["flip_v_rs"]
    assert coeftx.eligible_prims(crop, (80, 64), s420) == \
        [("crop", 5, 3, 32, 32)]
