"""The fused pipeline program against the float64 oracle (tests/oracle.py)
and the single-image ops, across plans and geometries: mixed sizes in one
bucket, upscales, aspect thumbnails, extreme aspect ratios and steep
downscales."""

import numpy as np
import pytest

from imageprocessor_tpu.domain import OperationParams, OperationType
from imageprocessor_tpu.models.pipeline import PipelineModel, plan_output_specs
from imageprocessor_tpu.models.plan import normalize_operations
from imageprocessor_tpu.ops import flip_image, grayscale_image, watermark_image
from imageprocessor_tpu.ops.coords import keep_aspect_dims, thumbnail_dims
from tests.oracle import psnr, resize_go, thumbnail_go

RNG = np.random.default_rng(91)


def _batch(shapes, bucket, rng=RNG):
    imgs = np.zeros((len(shapes), *bucket, 3), dtype=np.uint8)
    src_hw = np.asarray(shapes, dtype=np.int32)
    srcs = []
    for i, (h, w) in enumerate(shapes):
        srcs.append(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8))
        imgs[i, :h, :w] = srcs[i]
    return imgs, src_hw, srcs


def _keep_aspect_hw(shapes, width, height):
    return np.asarray([keep_aspect_dims(w, h, width, height)[::-1]
                       for h, w in shapes], dtype=np.int32)


def test_default_plan_matches_oracle_mixed_sizes():
    """Thumbnail + resize + watermark + grayscale over two image sizes
    sharing one bucket: resamples match the oracle, the blend and the
    luma match the single-image ops exactly."""
    plan = normalize_operations([
        OperationParams(OperationType.THUMBNAIL,
                        {"size": 64, "crop_to_fit": True}),
        OperationParams(OperationType.RESIZE,
                        {"width": 128, "height": 96, "keep_aspect": True}),
        OperationParams(OperationType.WATERMARK, {"text": "wm"}),
        OperationParams(OperationType.GRAYSCALE, {}),
    ])
    shapes = [(200, 256), (160, 220)]
    bucket = (200, 256)
    imgs, src_hw, srcs = _batch(shapes, bucket)
    out_hws = {1: _keep_aspect_hw(shapes, 128, 96)}
    outs = [np.asarray(o) for o in PipelineModel().run(
        plan, imgs, src_hw, out_hws, plan_output_specs(plan, bucket))]
    for i, (h, w) in enumerate(shapes):
        assert psnr(outs[0][i], thumbnail_go(srcs[i], 64,
                                             crop_to_fit=True)) > 45.0
        th, tw = out_hws[1][i]
        assert psnr(outs[1][i, :th, :tw],
                    resize_go(srcs[i], 128, 96, keep_aspect=True)) > 45.0
        np.testing.assert_array_equal(
            outs[2][i, :h, :w], np.asarray(watermark_image(srcs[i],
                                                           text="wm")))
        np.testing.assert_array_equal(
            outs[3][i, :h, :w], np.asarray(grayscale_image(srcs[i])))


def test_geometry_ops_share_the_program():
    """Flip and grayscale in one program agree with the single-image ops
    on every image of a mixed-size batch."""
    plan = normalize_operations([
        OperationParams(OperationType.FLIP, {"direction": "horizontal"}),
        OperationParams(OperationType.GRAYSCALE, {}),
    ])
    shapes = [(64, 96), (50, 80)]
    bucket = (64, 128)
    imgs, src_hw, srcs = _batch(shapes, bucket)
    outs = [np.asarray(o) for o in PipelineModel().run(
        plan, imgs, src_hw, {}, plan_output_specs(plan, bucket))]
    for i, (h, w) in enumerate(shapes):
        np.testing.assert_array_equal(
            outs[0][i, :h, :w], np.asarray(flip_image(srcs[i],
                                                      "horizontal")))
        np.testing.assert_array_equal(
            outs[1][i, :h, :w], np.asarray(grayscale_image(srcs[i])))


def test_upscale_matches_oracle():
    plan = normalize_operations([
        OperationParams(OperationType.THUMBNAIL,
                        {"size": 64, "crop_to_fit": True}),
        OperationParams(OperationType.RESIZE,
                        {"width": 512, "height": 384, "keep_aspect": True}),
    ])
    shapes = [(120, 160)]
    bucket = (128, 160)
    imgs, src_hw, srcs = _batch(shapes, bucket)
    out_hws = {1: _keep_aspect_hw(shapes, 512, 384)}
    outs = [np.asarray(o) for o in PipelineModel().run(
        plan, imgs, src_hw, out_hws, plan_output_specs(plan, bucket))]
    th, tw = out_hws[1][0]
    assert psnr(outs[0][0], thumbnail_go(srcs[0], 64,
                                         crop_to_fit=True)) > 45.0
    assert psnr(outs[1][0, :th, :tw],
                resize_go(srcs[0], 512, 384, keep_aspect=True)) > 45.0


def test_aspect_thumbnail_matches_oracle():
    """Aspect-mode thumbnails (crop_to_fit=False) run as a second
    keep-aspect resize on a per-group canvas."""
    plan = normalize_operations([
        OperationParams(OperationType.THUMBNAIL,
                        {"size": 64, "crop_to_fit": False}),
        OperationParams(OperationType.RESIZE,
                        {"width": 96, "height": 64, "keep_aspect": False}),
    ])
    shapes = [(200, 300), (256, 384)]
    bucket = (256, 384)
    imgs, src_hw, srcs = _batch(shapes, bucket, np.random.default_rng(17))
    t_hw = np.asarray([thumbnail_dims(w, h, 64)[::-1] for h, w in shapes],
                      dtype=np.int32)
    out_hws = {0: t_hw, 1: np.asarray([(64, 96)] * 2, dtype=np.int32)}
    specs = plan_output_specs(plan, bucket, {0: int(t_hw.max())})
    outs = [np.asarray(o) for o in PipelineModel().run(
        plan, imgs, src_hw, out_hws, specs)]
    for i in range(2):
        th, tw = t_hw[i]
        assert psnr(outs[0][i, :th, :tw],
                    thumbnail_go(srcs[i], 64, crop_to_fit=False)) > 45.0
        assert psnr(outs[1][i, :64, :96],
                    resize_go(srcs[i], 96, 64, keep_aspect=False)) > 45.0


@pytest.mark.parametrize("h,w,bh,bw", [
    (96, 2048, 128, 2048),    # 21:1 panorama
    (2048, 96, 2048, 128),    # 1:21 tall strip
    (70, 70, 128, 128),       # barely above the thumbnail size
    (65, 130, 128, 256),
])
def test_extreme_aspect_geometries_stay_correct(h, w, bh, bw):
    """Adversarial aspect ratios: outputs match the oracle."""
    plan = normalize_operations([
        OperationParams(OperationType.THUMBNAIL,
                        {"size": 64, "crop_to_fit": True}),
        OperationParams(OperationType.RESIZE,
                        {"width": 128, "height": 96, "keep_aspect": True}),
    ])
    imgs, src_hw, srcs = _batch([(h, w)], (bh, bw),
                                np.random.default_rng(9))
    tw, th = keep_aspect_dims(w, h, 128, 96)
    out_hws = {1: np.asarray([[th, tw]], np.int32)}
    outs = [np.asarray(o) for o in PipelineModel().run(
        plan, imgs, src_hw, out_hws, plan_output_specs(plan, (bh, bw)))]
    assert psnr(outs[0][0, :64, :64],
                thumbnail_go(srcs[0], 64, crop_to_fit=True)) > 45.0
    assert psnr(outs[1][0, :th, :tw],
                resize_go(srcs[0], tw, th, keep_aspect=False)) > 45.0


def test_wm_args_cache_keyed_by_op_index():
    """[watermark] and [thumbnail, watermark] with identical watermark
    params must not share a cached wm_args dict — the dict is keyed by
    position in the plan (a shared entry crashed the second plan's step
    with KeyError, poisoning the worker for the process lifetime)."""
    model = PipelineModel()
    plan_a = normalize_operations([
        OperationParams(OperationType.WATERMARK, {"text": "cache"}),
    ])
    plan_b = normalize_operations([
        OperationParams(OperationType.THUMBNAIL, {"size": 32}),
        OperationParams(OperationType.WATERMARK, {"text": "cache"}),
    ])
    args_a = model.prepare_wm_args(plan_a)
    args_b = model.prepare_wm_args(plan_b)
    assert set(args_a) == {0}
    assert set(args_b) == {1}      # not the cached {0: ...}

    # and the full program runs (this crashed before the fix)
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (1, 64, 128, 3), dtype=np.uint8)
    src_hw = np.asarray([[64, 128]], np.int32)
    specs = plan_output_specs(plan_b, (64, 128))
    outs = model.run(plan_b, imgs, src_hw, {}, specs)
    assert len(outs) == 2


def test_two_resizes_and_thumbnail_match_oracle():
    """A rendition ladder (thumbnail + two resizes) in one program."""
    plan = normalize_operations([
        OperationParams(OperationType.THUMBNAIL,
                        {"size": 48, "crop_to_fit": True}),
        OperationParams(OperationType.RESIZE,
                        {"width": 128, "height": 96, "keep_aspect": True}),
        OperationParams(OperationType.RESIZE,
                        {"width": 80, "height": 60, "keep_aspect": True}),
    ])
    shapes = [(200, 256), (160, 220)]
    bucket = (200, 256)
    imgs, src_hw, srcs = _batch(shapes, bucket)
    out_hws = {1: _keep_aspect_hw(shapes, 128, 96),
               2: _keep_aspect_hw(shapes, 80, 60)}
    outs = [np.asarray(o) for o in PipelineModel().run(
        plan, imgs, src_hw, out_hws, plan_output_specs(plan, bucket))]
    for i in range(len(shapes)):
        assert psnr(outs[0][i], thumbnail_go(srcs[i], 48,
                                             crop_to_fit=True)) > 45.0
        for oi, (rw, rh) in ((1, (128, 96)), (2, (80, 60))):
            th, tw = out_hws[oi][i]
            assert psnr(outs[oi][i, :th, :tw],
                        resize_go(srcs[i], rw, rh, keep_aspect=True)) > 45.0


@pytest.mark.parametrize("h,w", [(1400, 1344), (1344, 1400)])
def test_steep_downscale_matches_oracle(h, w):
    """A 35x downscale (1400 px -> 40 px) and a crop-thumbnail of the
    same frame agree with the float64 oracle."""
    plan = normalize_operations([
        OperationParams(OperationType.RESIZE,
                        {"width": 40, "height": 40, "keep_aspect": False}),
        OperationParams(OperationType.THUMBNAIL,
                        {"size": 40, "crop_to_fit": True}),
    ])
    imgs, src_hw, srcs = _batch([(h, w)], (h, w))
    out_hws = {0: np.asarray([[40, 40]], np.int32)}
    outs = [np.asarray(o) for o in PipelineModel().run(
        plan, imgs, src_hw, out_hws, plan_output_specs(plan, (h, w)))]
    assert psnr(outs[0][0, :40, :40],
                resize_go(srcs[0], 40, 40, keep_aspect=False)) > 45.0
    assert psnr(outs[1][0], thumbnail_go(srcs[0], 40,
                                         crop_to_fit=True)) > 45.0
