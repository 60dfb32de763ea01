"""Data-parallel pipeline execution over a device mesh (8 virtual CPUs)."""

import numpy as np
import pytest

import jax

from imageprocessor_tpu.domain import OperationParams, OperationType
from imageprocessor_tpu.models.pipeline import PipelineModel, plan_output_specs
from imageprocessor_tpu.models.plan import normalize_operations
from imageprocessor_tpu.ops.coords import keep_aspect_dims
from imageprocessor_tpu.parallel.mesh import make_mesh
from tests.oracle import psnr

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

RNG = np.random.default_rng(47)


def test_run_sharded_matches_single_device():
    plan = normalize_operations([
        OperationParams(OperationType.THUMBNAIL,
                        {"size": 64, "crop_to_fit": True}),
        OperationParams(OperationType.RESIZE,
                        {"width": 128, "height": 96, "keep_aspect": True}),
        OperationParams(OperationType.WATERMARK, {"text": "dp"}),
    ])
    b = 8
    bucket = (256, 256)
    imgs = np.zeros((b, *bucket, 3), dtype=np.uint8)
    src_hw = np.zeros((b, 2), dtype=np.int32)
    for i in range(b):
        h, w = 200 + 4 * i, 240 - 6 * i
        imgs[i, :h, :w] = RNG.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        src_hw[i] = (h, w)
    out_hw = np.zeros((b, 2), dtype=np.int32)
    for i in range(b):
        tw, th = keep_aspect_dims(int(src_hw[i, 1]), int(src_hw[i, 0]),
                                  128, 96)
        out_hw[i] = (th, tw)
    out_hws = {1: out_hw}
    specs = plan_output_specs(plan, bucket)

    model = PipelineModel()
    single = [np.asarray(o) for o in
              model.run(plan, imgs, src_hw, out_hws, specs)]

    mesh = make_mesh(4, space=1)
    sharded = [np.asarray(o) for o in
               model.run_sharded(mesh, plan, imgs, src_hw, out_hws, specs)]

    for s, r in zip(sharded, single):
        assert s.shape == r.shape
    for i in range(b):
        assert psnr(sharded[0][i], single[0][i]) > 50.0       # thumbnail
        th, tw = out_hw[i]
        assert psnr(sharded[1][i, :th, :tw],
                    single[1][i, :th, :tw]) > 50.0            # resize
        h, w = src_hw[i]
        np.testing.assert_array_equal(sharded[2][i, :h, :w],
                                      single[2][i, :h, :w])   # watermark


def _default_plan():
    return normalize_operations([
        OperationParams(OperationType.THUMBNAIL,
                        {"size": 64, "crop_to_fit": True}),
        OperationParams(OperationType.RESIZE,
                        {"width": 128, "height": 96, "keep_aspect": True}),
        OperationParams(OperationType.WATERMARK, {"text": "dp"}),
    ])


def _inputs(b, bucket):
    """A batch of mixed per-image dims (B, H, W, 3) with keep-aspect
    resize targets."""
    imgs = np.zeros((b, *bucket, 3), dtype=np.uint8)
    src_hw = np.zeros((b, 2), dtype=np.int32)
    for i in range(b):
        h, w = 200 + 4 * (i % 3), 240 - 6 * (i % 4)
        imgs[i, :h, :w] = RNG.integers(0, 256, size=(h, w, 3),
                                       dtype=np.uint8)
        src_hw[i] = (h, w)
    out_hw = np.zeros((b, 2), dtype=np.int32)
    for i in range(b):
        tw, th = keep_aspect_dims(int(src_hw[i, 1]), int(src_hw[i, 0]),
                                  128, 96)
        out_hw[i] = (th, tw)
    return imgs, src_hw, {1: out_hw}


def test_run_sharded_hwc_matches_single():
    """The HWC program INSIDE shard_map: each card's slice of the batch
    and of the per-image geometry arrays line up (P('data'))."""
    plan = _default_plan()
    b, bucket = 8, (256, 256)
    imgs, src_hw, out_hws = _inputs(b, bucket)
    specs = plan_output_specs(plan, bucket)

    model = PipelineModel()
    single = [np.asarray(o) for o in
              model.run(plan, imgs, src_hw, out_hws, specs)]
    mesh = make_mesh(4, space=1)
    sharded = [np.asarray(o) for o in
               model.run_sharded(mesh, plan, imgs, src_hw, out_hws, specs)]

    out_hw = out_hws[1]
    for s, r in zip(sharded, single):
        assert s.shape == r.shape
    for i in range(b):
        np.testing.assert_array_equal(sharded[0][i, :64, :64],
                                      single[0][i, :64, :64])
        th, tw = out_hw[i]
        np.testing.assert_array_equal(sharded[1][i, :th, :tw],
                                      single[1][i, :th, :tw])
        h, w = src_hw[i]
        np.testing.assert_array_equal(sharded[2][i, :h, :w],
                                      single[2][i, :h, :w])


def test_run_sharded_device_resident_input_matches_single():
    """The multi-card device-decode hot path: the batch arrives as a
    device array (the device JPEG decode's output, committed to one
    card); run_sharded re-places it onto the mesh and matches the
    single-device run exactly, with every output split over 4 devices."""
    plan = _default_plan()
    b, bucket = 8, (256, 256)
    imgs, src_hw, out_hws = _inputs(b, bucket)
    specs = plan_output_specs(plan, bucket)

    model = PipelineModel()
    single = [np.asarray(o) for o in
              model.run(plan, imgs, src_hw, out_hws, specs)]
    mesh = make_mesh(4, space=1)
    on_device = jax.device_put(imgs, jax.devices()[0])
    outs = model.run_sharded(mesh, plan, on_device, src_hw, out_hws, specs)
    for o in outs:
        assert len({s.device for s in o.addressable_shards}) == 4
    sharded = [np.asarray(o) for o in outs]

    out_hw = out_hws[1]
    for s, r in zip(sharded, single):
        assert s.shape == r.shape
    for i in range(b):
        np.testing.assert_array_equal(sharded[0][i, :64, :64],
                                      single[0][i, :64, :64])
        th, tw = out_hw[i]
        np.testing.assert_array_equal(sharded[1][i, :th, :tw],
                                      single[1][i, :th, :tw])
        h, w = src_hw[i]
        np.testing.assert_array_equal(sharded[2][i, :h, :w],
                                      single[2][i, :h, :w])


def test_run_sharded_mixed_scale_quantization_matches_single():
    """Per-image scales differ across shards (the batch's steepest
    downscale lives in the LAST shard): every shard resamples with its
    own images' geometry."""
    plan = _default_plan()
    b, bucket = 8, (512, 512)
    imgs = np.zeros((b, *bucket, 3), dtype=np.uint8)
    src_hw = np.zeros((b, 2), dtype=np.int32)
    for i in range(b):
        # first shards: mild downscale; last shard: much larger scale
        h = w = 180 if i < 6 else 500
        imgs[i, :h, :w] = RNG.integers(0, 256, size=(h, w, 3),
                                       dtype=np.uint8)
        src_hw[i] = (h, w)
    out_hw = np.zeros((b, 2), dtype=np.int32)
    for i in range(b):
        tw, th = keep_aspect_dims(int(src_hw[i, 1]), int(src_hw[i, 0]),
                                  128, 96)
        out_hw[i] = (th, tw)
    out_hws = {1: out_hw}
    specs = plan_output_specs(plan, bucket)

    model = PipelineModel()
    single = [np.asarray(o) for o in
              model.run(plan, imgs, src_hw, out_hws, specs)]
    mesh = make_mesh(4, space=1)
    sharded = [np.asarray(o) for o in
               model.run_sharded(mesh, plan, imgs, src_hw, out_hws, specs)]
    for i in range(b):
        np.testing.assert_array_equal(sharded[0][i, :64, :64],
                                      single[0][i, :64, :64])
        th, tw = out_hw[i]
        np.testing.assert_array_equal(sharded[1][i, :th, :tw],
                                      single[1][i, :th, :tw])
