"""Buffer-donation gating regression (round-1 weak item #7).

The source batch is donated ONLY when the plan contains a watermark op —
the one output that shares the input's exact shape/dtype and is computed
as an in-place region blend. Donating on any other plan cannot alias and
makes XLA emit "Some donated buffers were not usable" on every step.
These tests fail on ANY such warning, for host and device-resident
inputs alike.
"""

import warnings

import numpy as np

from imageprocessor_tpu.domain import OperationParams, OperationType
from imageprocessor_tpu.models.pipeline import (
    PipelineModel,
    plan_output_specs,
)
from imageprocessor_tpu.models.plan import normalize_operations

RNG = np.random.default_rng(17)


def _run_plan(ops, device_input=False):
    plan = normalize_operations(ops)
    bucket = (96, 128)
    b = 2
    imgs = RNG.integers(0, 256, size=(b, *bucket, 3), dtype=np.uint8)
    src_hw = np.asarray([[96, 128], [64, 100]], np.int32)
    out_hws = {}
    for i, op in enumerate(plan.ops):
        if op.type is OperationType.RESIZE:
            out_hws[i] = np.asarray([[op.height, op.width]] * b, np.int32)
        elif op.type is OperationType.THUMBNAIL:
            out_hws[i] = np.asarray([[op.size, op.size]] * b, np.int32)
    specs = plan_output_specs(plan, bucket)
    model = PipelineModel()
    import jax

    if device_input:
        imgs = jax.device_put(imgs)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        outs = model.run(plan, imgs, src_hw, out_hws, specs)
        jax.block_until_ready(outs)
    donation_warnings = [w for w in caught
                         if "donated buffers" in str(w.message)]
    assert not donation_warnings, [str(w.message) for w in donation_warnings]
    return outs


def test_resample_only_plan_does_not_donate():
    _run_plan([
        OperationParams(OperationType.THUMBNAIL,
                        {"size": 48, "crop_to_fit": True}),
        OperationParams(OperationType.RESIZE,
                        {"width": 64, "height": 48, "keep_aspect": False}),
    ])


def test_flip_grayscale_plan_does_not_warn():
    _run_plan([
        OperationParams(OperationType.FLIP, {"direction": "horizontal"}),
        OperationParams(OperationType.GRAYSCALE, {}),
    ])


def test_watermark_plan_donates_without_warning():
    outs = _run_plan([
        OperationParams(OperationType.RESIZE,
                        {"width": 64, "height": 48, "keep_aspect": False}),
        OperationParams(OperationType.WATERMARK, {"text": "wm"}),
    ])
    assert outs[1].shape == (2, 96, 128, 3)


def test_device_resident_plans_do_not_warn():
    # Device-decoded batches arrive as device arrays: resample-only (no
    # donation) and +watermark (donated).
    _run_plan([
        OperationParams(OperationType.THUMBNAIL,
                        {"size": 48, "crop_to_fit": True}),
        OperationParams(OperationType.RESIZE,
                        {"width": 64, "height": 48, "keep_aspect": True}),
    ], device_input=True)
    _run_plan([
        OperationParams(OperationType.RESIZE,
                        {"width": 64, "height": 48, "keep_aspect": True}),
        OperationParams(OperationType.WATERMARK, {"text": "wm"}),
    ], device_input=True)
