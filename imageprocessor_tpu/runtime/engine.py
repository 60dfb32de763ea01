"""The processing engine: decode -> bucketed device batches -> encode/save.

Accelerator-side replacement for the reference's per-image worker hot loop
(reference: internal/worker/worker.go:112-148 + internal/usecase/processor/
image_processor.go:39-127). Differences that matter:

* N tasks are decoded on host threads (libjpeg-turbo releases the GIL),
  grouped into padded resolution buckets, and processed as fused batched
  XLA programs — one program run per (bucket, plan) group instead of one
  op call per image;
* per-image failure isolation: a bad JPEG fails that image only, the rest
  of the batch proceeds (SURVEY.md §2 parallelism table, row 3);
* fail-fast inside one image's op list, matching the reference
  (image_processor.go:64-95): an encode/save error marks the image failed
  and skips its remaining ops, but already-saved paths are reported.

Engine results carry artifact details (path, size, mime) so the worker can
write the same metadata rows the reference writes (worker.go:202-214).
"""

from __future__ import annotations

import functools
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from imageprocessor_tpu.domain import (
    DEFAULT_JPEG_QUALITY,
    ImageStatus,
    OperationType,
    ProcessingResult,
    ProcessingTask,
)
from imageprocessor_tpu.errors import DecodeError, UnsupportedOperationError
from imageprocessor_tpu.models.pipeline import (
    PipelineModel,
    plan_output_specs,
)
from imageprocessor_tpu.models.plan import (
    InvalidParamsError,
    NormalizedOp,
    OperationPlan,
    normalize_operations,
)
from imageprocessor_tpu.ops import (
    crop_image,
    flip_image,
    grayscale_image,
    keep_aspect_dims,
    resize_image,
    rotate_image,
    thumbnail_dims,
    thumbnail_image,
    watermark_image,
)
from imageprocessor_tpu.runtime.batcher import (
    BatchItem,
    group_items,
    quantize_batch,
)
from imageprocessor_tpu.runtime import coeftx, device, nativecodec, splice
from imageprocessor_tpu.runtime.batcher import (
    bucket_for,
    coef_canvas,
    coef_layout,
)
from imageprocessor_tpu.runtime.codecs import (
    decode_image,
    detect_content_type,
    encode_image,
    jpeg_stream_complete,
    mime_from_path,
    negotiate_format,
)
from imageprocessor_tpu.runtime.paths import generate_path
from imageprocessor_tpu.utils import get_logger
from imageprocessor_tpu.utils.metrics import METRICS

log = get_logger("engine")

# Every operation type normalize_operations admits has a batched kernel
# (models/pipeline.py builds programs for all 7); plans that reach the
# engine are batchable by construction — normalize_operations is the
# single gate, there is no per-op fallback to guard.

# Typed failure classification carried on EngineResult.error_kind so ack
# policy never depends on error-message wording: PERMANENT failures are
# acked with status=failed (bad input — redelivery cannot help);
# TRANSIENT ones are nacked for redelivery (infra hiccup — the
# reference's leave-uncommitted-for-retry behavior, worker.go:125-146).
PERMANENT = "permanent"
TRANSIENT = "transient"

def usable_cores() -> int:
    """Cores this PROCESS may use: cgroup/affinity-aware (a container
    pinned to 4 of 64 cores must count 4 — it is exactly the
    core-starved host the device-JPEG offload targets)."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):  # non-Linux
        return os.cpu_count() or 1


@dataclass
class Artifact:
    operation: str
    path: str
    size: int
    mime_type: str
    format: str


@dataclass
class EngineResult:
    """ProcessingResult plus the artifact metadata the DB rows need.

    error_kind: "" on success, else PERMANENT or TRANSIENT — the worker's
    ack decision reads this field, never the error string.
    """

    result: ProcessingResult
    artifacts: list[Artifact] = field(default_factory=list)
    error_kind: str = ""


class ProcessingEngine:
    def __init__(self, object_store, *, codec_threads: int = 3,
                 batch_size: int = 32, jpeg_quality: int = DEFAULT_JPEG_QUALITY,
                 device_jpeg: bool | None = None,
                 data_axis: int | None = None,
                 space_axis: int = 1):
        self.store = object_store
        # The one device decision (runtime/device.py): mesh size and the
        # device-JPEG policy follow from the backend JAX came up on.
        self.caps = device.detect()
        # Multi-card serving: ONE worker process drives every local card
        # (the analog of the reference's goroutine pool, worker.go:88-96 —
        # intra-host fan-out per SURVEY §2's parallelism table).
        # space_axis > 1 additionally shards image WIDTH — the GSPMD jit
        # path where XLA inserts the halo collectives — for buckets whose
        # frames strain device memory.
        space = max(1, int(space_axis or 1))
        n_data = self.caps.data_axis(int(data_axis or 0), space)
        self._mesh = None
        self._mesh_spatial = space > 1
        if n_data * space > 1:
            from imageprocessor_tpu.parallel.mesh import make_mesh
            self._mesh = make_mesh(n_data * space, space=space)
            log.info("Device mesh active", data=n_data, space=space)
        self.model = PipelineModel()
        # Clamp to the device-program cap: a WORKER_BATCH_SIZE above
        # MAX_BATCH would make group_items emit groups bigger than the
        # quantize_batch canvas -> IndexError in Group.pack for every
        # full batch.
        from imageprocessor_tpu.runtime.batcher import MAX_BATCH
        self.batch_size = max(1, min(batch_size, MAX_BATCH))
        # Device-side JPEG codec: the host keeps only the streaming
        # entropy scan and emit; IDCT + chroma upsample + color convert
        # and the encode front half (color convert, downsample, FDCT,
        # quantize) run batched on the card. It trades card time for
        # host CPU, so the auto policy turns it on where the host cannot
        # feed the card (device.DEVICE_JPEG_CORES_PER_CARD);
        # IMAGEPROCESSOR_DEVICE_JPEG=1/0 forces it.
        if device_jpeg is None:
            env_flag = os.environ.get("IMAGEPROCESSOR_DEVICE_JPEG", "")
            if env_flag in ("1", "true", "yes"):
                device_jpeg = True
            elif env_flag in ("0", "false", "no"):
                device_jpeg = False
            else:
                device_jpeg = self.caps.device_jpeg_auto(
                    nativecodec.available(), usable_cores(),
                    n_data * space)
        self.device_jpeg = device_jpeg
        self.jpeg_quality = jpeg_quality
        self._pool = ThreadPoolExecutor(max_workers=max(codec_threads, 1),
                                        thread_name_prefix="codec")

    # ------------------------------------------------------------------ utils

    def _failed(self, task: ProcessingTask, error: str,
                kind: str = PERMANENT) -> EngineResult:
        return EngineResult(result=ProcessingResult(
            id=task.id, image_id=task.image_id, status=ImageStatus.FAILED,
            error=error), error_kind=kind)

    def _encode_and_save(self, task: ProcessingTask, op: NormalizedOp,
                         arr: np.ndarray, fmt: str) -> Artifact:
        out_fmt = negotiate_format(fmt,
                                   watermark=op.type is OperationType.WATERMARK)
        data = encode_image(arr, out_fmt, quality=self.jpeg_quality)
        path = generate_path(task.image_id, op, out_fmt)
        mime = mime_from_path(path)
        self._save(path, data, mime)
        return Artifact(operation=op.type.value, path=path, size=len(data),
                        mime_type=mime, format=out_fmt)

    @staticmethod
    def _is_infra_failure(exc: Exception) -> bool:
        """Infra (retryable) vs compute/params (permanent): storage I/O,
        OS-level errors (sockets, device transport), and JAX/XLA runtime
        errors are transient — the same policy the batched device stage
        applies to a whole micro-batch (a device hiccup must nack for
        redelivery, not permanently fail the image)."""
        from imageprocessor_tpu.errors import StorageError
        if isinstance(exc, (StorageError, OSError, TimeoutError)):
            return True
        mod = type(exc).__module__ or ""
        return (isinstance(exc, RuntimeError)
                and mod.startswith(("jaxlib", "jax")))

    @classmethod
    def _classify_op_failure(cls, out: EngineResult, op: NormalizedOp,
                             exc: Exception) -> None:
        """Fail-fast bookkeeping for one op failure: infra errors are
        TRANSIENT, everything else (compute/encode/params) PERMANENT."""
        out.result.status = ImageStatus.FAILED
        out.result.error = f"Operation {op.type.value} failed: {exc}"
        out.error_kind = (TRANSIENT if cls._is_infra_failure(exc)
                          else PERMANENT)

    def _save(self, path: str, data: bytes, mime: str) -> None:
        """Object-store writes are infra I/O: wrap failures as StorageError
        so the op loops classify them TRANSIENT (nack/redeliver) instead of
        PERMANENT like compute/encode errors."""
        from imageprocessor_tpu.errors import StorageError
        try:
            self.store.save_processed(path, data, mime)
        except Exception as exc:
            raise StorageError(f"save {path}: {exc}") from exc

    def _emit_and_save(self, task: ProcessingTask, op: NormalizedOp,
                       coef, i: int, h: int, w: int) -> Artifact:
        """Save one device-encoded output: slice the image's MCU grid
        out of the batch coefficient canvases (strided views, no copy)
        and run the host entropy emitter."""
        _tag, yc, cbc, crc, qt = coef
        gh, gw = -(-h // 16) * 16, -(-w // 16) * 16
        data = nativecodec.emit_jpeg_from_coefficients(
            [yc[i, :gh, :gw], cbc[i, :gh // 2, :gw // 2],
             crc[i, :gh // 2, :gw // 2]],
            qt, w, h, (2, 2))
        path = generate_path(task.image_id, op, "jpeg")
        mime = mime_from_path(path)
        self._save(path, data, mime)
        return Artifact(operation=op.type.value, path=path, size=len(data),
                        mime_type=mime, format="jpeg")

    def _splice_and_save(self, task: ProcessingTask, op: NormalizedOp,
                         ctx) -> Artifact:
        """Watermark rendition by JPEG splice transcode: edit only the
        MCU band the text touches, copy every other MCU's bits verbatim
        (runtime/splice.py — replaces the full-image entropy emit, the
        host-side system bottleneck). Defensive fallback: decode the
        scanned coefficients on host, blend if the band edit never
        landed, and re-encode at the engine quality — same output the
        pre-splice path produced."""
        import time as _time

        t0 = _time.monotonic()
        try:
            data = splice.watermark_splice(ctx, op)
        except nativecodec.NativeCodecError:
            # watermark_splice restores the context in a finally, so
            # decode_rgb always sees pristine source coefficients here
            # and the blend must be applied in the pixel domain.
            arr = splice.decode_rgb(ctx)
            if not ctx.edited:
                arr = self._apply_single(arr, op)
            return self._encode_and_save(task, op, np.asarray(arr),
                                         "jpeg")
        METRICS.observe("engine_splice_emit_ms",
                        (_time.monotonic() - t0) * 1000.0)
        METRICS.inc("engine_splice_images", 1)
        path = generate_path(task.image_id, op, "jpeg")
        mime = mime_from_path(path)
        self._save(path, data, mime)
        return Artifact(operation=op.type.value, path=path,
                        size=len(data), mime_type=mime, format="jpeg")

    def _coef_tx_and_save(self, task: ProcessingTask, op: NormalizedOp,
                          ctx) -> Artifact:
        """Crop/rotate/flip rendition by lossless coefficient-domain
        transform (runtime/coeftx.py, jpegtran-style): permute the
        quantized blocks, re-symbolize with the source's own tables —
        no pixel decode, no re-encode generation loss. Defensive
        fallback mirrors _splice_and_save: decode the scanned
        coefficients on host, run the pixel op, re-encode at the
        engine quality."""
        import time as _time

        t0 = _time.monotonic()
        try:
            prims = coeftx.eligible_prims(op, ctx.size, ctx.sampling)
            if prims is None or not splice.coef_reencodable(ctx):
                raise nativecodec.NativeCodecError(
                    "transform not expressible in the coefficient domain")
            data = splice.reencode(coeftx.apply(ctx, prims))
        except nativecodec.NativeCodecError:
            arr = splice.decode_rgb(ctx)
            arr = self._apply_single(arr, op)
            return self._encode_and_save(task, op, np.asarray(arr), "jpeg")
        METRICS.observe("engine_coeftx_emit_ms",
                        (_time.monotonic() - t0) * 1000.0)
        METRICS.inc("engine_coeftx_images", 1)
        path = generate_path(task.image_id, op, "jpeg")
        mime = mime_from_path(path)
        self._save(path, data, mime)
        return Artifact(operation=op.type.value, path=path,
                        size=len(data), mime_type=mime, format="jpeg")

    # ------------------------------------------------------- single-image path

    def _apply_single(self, arr: np.ndarray, op: NormalizedOp) -> np.ndarray:
        t = op.type
        if t is OperationType.RESIZE:
            return np.asarray(resize_image(arr, op.width, op.height,
                                           op.keep_aspect))
        if t is OperationType.THUMBNAIL:
            return np.asarray(thumbnail_image(arr, op.size, op.crop_to_fit))
        if t is OperationType.WATERMARK:
            return np.asarray(watermark_image(
                arr, text=op.text, position=op.position, opacity=op.opacity,
                font_size=op.font_size, font_color=op.font_color))
        if t is OperationType.CROP:
            return np.asarray(crop_image(arr, op.x, op.y, op.width, op.height))
        if t is OperationType.ROTATE:
            return np.asarray(rotate_image(arr, op.angle))
        if t is OperationType.FLIP:
            return np.asarray(flip_image(arr, op.direction))
        if t is OperationType.GRAYSCALE:
            return np.asarray(grayscale_image(arr))
        raise UnsupportedOperationError(f"unsupported operation type: {t}")

    def process_single(self, task: ProcessingTask, data: bytes) -> EngineResult:
        """Reference-sequential path: used for plans without batched kernels
        and as the correctness baseline for the batched path."""
        try:
            arr, detected_fmt = decode_image(data)
        except DecodeError as exc:
            return self._failed(task, f"Failed to decode image: {exc}")
        fmt = (task.format or detected_fmt or "jpeg").lower()
        try:
            plan = normalize_operations(task.operations)
        except (InvalidParamsError, UnsupportedOperationError, ValueError) as exc:
            return self._failed(task, f"Operation failed: {exc}")
        # One op loop for both entry points (fail-fast + typed
        # classification live in _process_decoded_single only).
        return self._process_decoded_single(task, arr, fmt, plan)

    # ------------------------------------------------------------ batched path

    def decode_for_plan(self, data: bytes, plan: OperationPlan | None
                        ) -> tuple[np.ndarray, str, str, tuple | None]:
        """Back-compat 4-tuple wrapper over decode_for_plan_ex. The
        watermark-only splice shortcut returns a placeholder image whose
        meaning lives in the discarded 5th element, so this wrapper
        decodes real pixels instead — callers of the 4-tuple API get
        pixels, always."""
        arr, detected, layout, valid_hw, _sctx = \
            self.decode_for_plan_ex(data, plan)
        if layout == "splice":
            arr, detected = decode_image(data)
            return arr, detected, "hwc", None
        return arr, detected, layout, valid_hw

    def decode_for_plan_ex(self, data: bytes, plan: OperationPlan | None,
                           task_format: str | None = None
                           ) -> tuple[np.ndarray, str, str, tuple | None,
                                      object | None]:
        """Decode one blob, choosing the layout the device path wants.

        With the device codec on, JPEG tasks stop at the entropy scan:
        their coefficient canvases decode on the device, straight into
        the pipeline program. Everything else decodes on host. Returns
        (array, detected_format, layout, valid_hw_or_None,
        splice_ctx_or_None) — the splice context is produced when the
        plan wants a watermark rendition and the stream is splice-
        editable (runtime/splice.py), in which case the entropy scan
        additionally records per-MCU bit offsets (+~13% scan cost) so
        the finish stage can emit the watermark by region transcode.
        """
        # The completeness check keeps truncated streams off every
        # lenient native path (scan zero-fill, libjpeg gray-fill): they
        # fall to decode_image, which rejects them like the reference's
        # Go image.Decode does (worker marks the task failed).
        is_jpeg = (plan is not None and nativecodec.available()
                   and detect_content_type(data[:512]) == "image/jpeg"
                   and jpeg_stream_complete(data))
        # Coefficient-domain servable ops: watermark (band edit /
        # splice, runtime/splice.py) and the lossless geometry
        # transforms (flip / 90-degree rotate / MCU-aligned crop,
        # runtime/coeftx.py). Skip the scan when the task's requested
        # format can never negotiate to JPEG (e.g. format=png — the
        # context would be discarded at finish time). task_format=None
        # (unknown caller) keeps the scan: the source IS a JPEG here,
        # so the detected-format fallback negotiates to jpeg.
        fmt0 = task_format or "jpeg"
        has_wm = any(op.type is OperationType.WATERMARK
                     for op in plan.ops) if plan is not None else False
        tx_ops = ([op for op in plan.ops if op.type in coeftx.TX_TYPES]
                  if plan is not None else [])
        all_coef_types = (plan is not None and len(plan.ops) > 0 and all(
            op.type is OperationType.WATERMARK
            or op.type in coeftx.TX_TYPES for op in plan.ops))
        fmt_ok_all = (plan is not None and all(
            negotiate_format(
                fmt0, watermark=op.type is OperationType.WATERMARK)
            == "jpeg" for op in plan.ops))
        coef_only = all_coef_types and fmt_ok_all
        wants_splice = (is_jpeg and splice.enabled()
                        and ((has_wm and negotiate_format(
                            fmt0, watermark=True) == "jpeg")
                            or coef_only))
        # ONE scan, shared by the splice context and the device-JPEG
        # coefficient path (they consume the identical planes).
        sctx = None
        scanned = None  # (planes, qtabs, (w, h), sampling)
        if wants_splice and has_wm:
            try:
                c = nativecodec.scan_jpeg_for_transcode(data)
                scanned = (c.planes, c.qtabs, c.size, c.sampling)
                if splice.supports(c):
                    sctx = c
                elif len(c.planes) == 1:
                    # Grayscale: keep Y bit-exact, synthesize neutral
                    # chroma, re-encode 4:4:4 — the same color
                    # promotion the pixel pipeline performs, minus the
                    # pixel pipeline (splice.promote_grayscale).
                    sctx = splice.promote_grayscale(
                        c.planes, c.qtabs, c.size, c.sampling)
            except nativecodec.NativeCodecError:
                # The transcode scan refuses progressive AND truncated/
                # exotic streams. Only PROGRESSIVE — an exact header
                # signal — takes the coefficient-domain path
                # (splice.coef_context: band edit + baseline
                # re-symbolization with the SOURCE's quantization; zero
                # loss outside the band, no pixel decode, matching the
                # reference's baseline output). Truncated streams must
                # fall to the pixel decoders and their error semantics
                # instead of being zero-filled into a COMPLETED
                # rendition.
                try:
                    if nativecodec.is_progressive(data):
                        planes, qt, (w, h), samp = \
                            nativecodec.scan_jpeg_coefficients(data)
                        scanned = (planes, qt, (w, h), samp)
                        c = (splice.promote_grayscale(planes, qt,
                                                      (w, h), samp)
                             if len(planes) == 1
                             else splice.coef_context(planes, qt,
                                                      (w, h), samp))
                        if splice.coef_reencodable(c):
                            sctx = c
                except nativecodec.NativeCodecError:
                    pass  # unparseable/truncated: pixel decode below
        elif wants_splice:
            # Transform-only plans re-symbolize every MCU, so the
            # +~13% offset-recording transcode scan buys nothing —
            # take the plain coefficient scan directly (it also covers
            # progressive sources in one shot).
            try:
                planes, qt, (w, h), samp = \
                    nativecodec.scan_jpeg_coefficients(data)
                scanned = (planes, qt, (w, h), samp)
                c = (splice.promote_grayscale(planes, qt, (w, h), samp)
                     if len(planes) == 1
                     else splice.coef_context(planes, qt, (w, h), samp))
                if splice.coef_reencodable(c):
                    sctx = c
            except nativecodec.NativeCodecError:
                pass  # exotic stream: pixel decode below
        # Plans where EVERY op is coefficient-servable need NO pixel
        # decode and no device program on ANY backend: each rendition
        # is emitted straight from the scanned coefficients
        # (device_group has nothing to run; finish_item splices the
        # watermark ops and block-permutes the transform ops). The
        # placeholder image can never be packed: 'splice'-layout items
        # group separately, so a group is either all-splice (early
        # return before pack) or all-pixels. On the host-codec path
        # (CPU scale-out workers) this is ~2.6x over
        # decode+blend+re-encode for the watermark shape and more for
        # the transforms (zero DCT work).
        if coef_only and sctx is not None:
            tx_ok = all(
                coeftx.eligible_prims(op, sctx.size, sctx.sampling)
                is not None for op in tx_ops)
            if tx_ok and (not tx_ops or splice.coef_reencodable(sctx)):
                w, h = sctx.size
                return (np.empty((0, 0, 3), dtype=np.uint8), "jpeg",
                        "splice", (h, w), sctx)
        if is_jpeg and self.device_jpeg:
            try:
                if scanned is None:
                    scanned = nativecodec.scan_jpeg_coefficients(data)
                planes, qt, (w, h), samp = scanned
                if len(planes) == 3:
                    (hy, vy), (hc, vc), (hr, vr) = (tuple(s) for s in samp)
                    fh, fw = vy, hy
                    ch, cw = coef_canvas(bucket_for(h, w), fh, fw)
                    # Chroma must be unsubsampled relative to itself and
                    # the luma ratio one of the common modes: (2,2)=4:2:0,
                    # (1,2)=4:2:2, (2,1)=4:4:0, (1,1)=4:4:4. Canvases are
                    # MCU-padded past the bucket, so non-aligned ladder
                    # rungs (200) are eligible too.
                    if ((hc, vc) == (hr, vr) == (1, 1)
                            and fh in (1, 2) and fw in (1, 2)
                            and planes[0].shape[0] <= ch
                            and planes[0].shape[1] <= cw
                            and planes[1].shape == planes[2].shape
                            and planes[1].shape[0] * fh == planes[0].shape[0]
                            and planes[1].shape[1] * fw == planes[0].shape[1]):
                        return ((planes[0], planes[1], planes[2],
                                 np.asarray(qt, dtype=np.float32)),
                                "jpeg", coef_layout(fh, fw), (h, w), sctx)
            except nativecodec.NativeCodecError:
                pass  # exotic/truncated: fall through
        arr, detected = decode_image(data)
        return arr, detected, "hwc", None, sctx

    def process_tasks(self, tasks_with_data: list[tuple[ProcessingTask, bytes]],
                      device_section=None) -> list[EngineResult]:
        """Process many tasks: decode pool -> bucket groups -> fused programs
        -> encode pool. Returns results in input order.

        device_section: optional context-manager factory (e.g.
        Watchdog.armed) wrapped around EACH group's device dispatch —
        per group, not around the whole call, so a mixed-bucket batch
        paying several cold compiles gets one deadline per compiled
        program instead of one for the sum (a legitimate first batch
        would otherwise exceed the deadline and crash-loop)."""
        n = len(tasks_with_data)
        results: list[EngineResult | None] = [None] * n

        # Plans first: they decide how each blob decodes
        # (decode_for_plan_ex).
        import time as _time

        plans: dict[int, OperationPlan] = {}
        for i, (task, _data) in enumerate(tasks_with_data):
            try:
                plans[i] = normalize_operations(task.operations)
            except (InvalidParamsError, UnsupportedOperationError,
                    ValueError) as exc:
                results[i] = self._failed(task, f"Operation failed: {exc}")

        def _dec(i):
            fmt = tasks_with_data[i][0].format
            return self.decode_for_plan_ex(
                tasks_with_data[i][1], plans.get(i),
                task_format=fmt if isinstance(fmt, str) else None)

        pending = [i for i in range(n) if results[i] is None]
        t_dec = _time.monotonic()
        decoded = list(self._pool.map(_dec_safe(_dec), pending))
        METRICS.observe("engine_decode_ms",
                        (_time.monotonic() - t_dec) * 1000.0)
        METRICS.inc("engine_decoded_images", len(pending))

        items: list[BatchItem] = []
        for i, dec in zip(pending, decoded):
            task = tasks_with_data[i][0]
            if isinstance(dec, Exception):
                results[i] = self._failed(task,
                                          f"Failed to decode image: {dec}")
                continue
            arr, detected, layout, valid_hw, sctx = dec
            plan = plans[i]
            try:
                # e.g. a non-string Format in the wire payload: fail
                # THIS task, not the whole batch (the same guard the
                # pipelined worker's staging has — an escape here would
                # abort healthy batchmates and crash-loop on
                # redelivery).
                fmt = (task.format or detected or "jpeg").lower()
                items.append(BatchItem(item_id=str(i), image=arr,
                                       plan_key=plan.group_key(),
                                       payload=(i, task, fmt, plan),
                                       layout=layout, valid_hw=valid_hw,
                                       splice=sctx))
            except Exception as exc:
                results[i] = self._failed(task, f"Operation failed: {exc}")

        # 2. group + run fused programs — with PER-GROUP isolation: one
        # group's device failure must not abort batchmates in other
        # groups whose results are already computed (and must carry the
        # typed infra/permanent classification, not bypass it by
        # propagating out of process_tasks).
        for group in group_items(items, max_batch=self.batch_size):
            try:
                self._run_group(group, results,
                                device_section=device_section)
            except Exception as exc:
                kind = (TRANSIENT if self._is_infra_failure(exc)
                        else PERMANENT)
                log.error("Device group failed", error=str(exc),
                          kind=kind, size=len(group.items), exc_info=True)
                for it in group.items:
                    i, task = it.payload[0], it.payload[1]
                    if results[i] is None:
                        results[i] = self._failed(
                            task, f"device error: {exc}", kind=kind)

        return [r if r is not None else self._failed(
            tasks_with_data[i][0], "internal: no result produced",
            kind=TRANSIENT)
            for i, r in enumerate(results)]

    def _process_decoded_single(self, task, arr, fmt, plan) -> EngineResult:
        out = EngineResult(result=ProcessingResult(
            id=task.id, image_id=task.image_id, status=ImageStatus.COMPLETED))
        for op in plan:
            try:
                processed = self._apply_single(arr, op)
                artifact = self._encode_and_save(task, op, processed, fmt)
            except Exception as exc:
                self._classify_op_failure(out, op, exc)
                return out
            out.artifacts.append(artifact)
            out.result.processed_paths[op.type.value] = artifact.path
        return out

    def _place(self, x):
        """Host array -> device, batch-sharded over the data mesh when
        there is one (each card receives only its own slice)."""
        if self._mesh is None or self._mesh_spatial:
            return jnp.asarray(x)
        return jax.device_put(x, NamedSharding(self._mesh, P("data")))

    def _codec_program(self, key: tuple, fn, in_specs, out_specs):
        """An XLA codec program, data-parallel under the engine mesh:
        images are independent, so each card runs `fn` on its shard."""
        if self._mesh is None or self._mesh_spatial:
            return fn
        key = ("codec", self._mesh) + key
        prog = self.model.prog_cache_get(key)
        if prog is None:
            prog = jax.jit(jax.shard_map(fn, mesh=self._mesh,
                                         in_specs=in_specs,
                                         out_specs=out_specs))
            self.model.prog_cache_put(key, prog)
        return prog

    def _decode_coefs(self, yc, cbc, crc, qt, cv, fh: int, fw: int,
                      bucket: tuple[int, int]):
        """Coefficient canvases -> (B, H, W, 3) pixel canvas on device
        (ops/jpeg_decode.batched_decode_ycbcr), in any of the four common
        subsampling modes."""
        from imageprocessor_tpu.ops.jpeg_decode import batched_decode_ycbcr
        fn = functools.partial(batched_decode_ycbcr, fh=fh, fw=fw,
                               out_h=bucket[0], out_w=bucket[1])
        sh = P("data")
        prog = self._codec_program(("decode", fh, fw, bucket), fn,
                                   (sh,) * 5, sh)
        return prog(*(self._place(a) for a in (yc, cbc, crc, qt, cv)))

    def _encode_coefs(self, rgb, vh: np.ndarray, qt: np.ndarray):
        """Pixel canvas -> quantized 4:2:0 coefficient canvases on device
        (the encode front half; host keeps only entropy emit)."""
        from imageprocessor_tpu.ops.jpeg_encode import batched_encode_420
        sh = P("data")
        prog = self._codec_program(("encode",), batched_encode_420,
                                   (sh, sh, P()), (sh, sh, sh))
        return prog(rgb, self._place(np.asarray(vh, dtype=np.int32)),
                    jnp.asarray(qt, dtype=jnp.float32))

    def device_group(self, group):
        """Stage 2: run one packed group's fused program; returns the
        host-side outputs + geometry needed to finish each image.
        Reusable by both the batch worker and the pipelined worker."""
        plan: OperationPlan = group.items[0].payload[3]

        # Watermark renditions that EVERY item can produce by splice
        # transcode (runtime/splice.py): exclude the op from the device
        # program entirely — no device blend, no encode front half, no
        # D2H; the finish stage edits+emits from the scanned coefficient
        # stream on host. (_splice_and_save's fallback is a host
        # decode_rgb of the scanned coefficients + re-encode, so the
        # device output is never needed.) Mixed groups keep the device
        # blend: non-eligible batchmates consume it, and eligible items
        # still prefer splice per item in finish_item.
        splice_skip: set[int] = set()
        if group.layout == "splice":
            # decode_for_plan_ex only emits 'splice'-layout items when
            # EVERY op is coefficient-servable (watermark band edit or
            # coeftx transform) for that item's stream — the whole plan
            # is served at finish time from the scanned coefficients.
            splice_skip = set(range(len(plan.ops)))
        elif (group.items
                and all(it.splice is not None for it in group.items)
                and all(negotiate_format(it.payload[2],
                                         watermark=True) == "jpeg"
                        for it in group.items)):
            splice_skip = {oi for oi, op in enumerate(plan.ops)
                           if op.type is OperationType.WATERMARK}
        if splice_skip and len(splice_skip) == len(plan.ops):
            # Every op splices: the device has nothing to do. Keep the
            # device-stage counters continuous (a legitimately
            # zero-cost device stage, not a gap in the decomposition —
            # this is the PRIMARY production shape with splice on).
            METRICS.observe("engine_device_ms", 0.0)
            METRICS.inc("engine_device_images", len(group.items))
            return plan, [("splice", op) for op in plan.ops], {}

        b = quantize_batch(len(group.items))
        if self._mesh is not None:
            # shard_map needs the batch divisible by the data axis; both
            # sides are normally powers of two, and the ceil keeps odd
            # DEVICE_DATA_AXIS settings (e.g. 6) working too.
            n_data = int(self._mesh.shape["data"])
            if b % n_data:
                b = -(-b // n_data) * n_data
        imgs, src_hw = group.pack(pad_batch_to=b)

        # Per-op, per-image valid output dims (host arithmetic, Go-exact)
        out_hws: dict[int, np.ndarray] = {}
        aspect_long: dict[int, int] = {}
        for oi, op in enumerate(plan.ops):
            if op.type is OperationType.RESIZE:
                hw = np.zeros((b, 2), dtype=np.int32)
                for i, it in enumerate(group.items):
                    h, w = it.hw
                    if op.keep_aspect:
                        tw, th = keep_aspect_dims(w, h, op.width, op.height)
                        hw[i] = (max(th, 1), max(tw, 1))
                    else:
                        hw[i] = (op.height, op.width)
                # Pad rows mirror the LAST REAL image (pack duplicates
                # its pixels into pad rows too): out=(1,1) pads made the
                # pad rows look like a bogus >32x downscale, kicking
                # every non-power-of-two group off the Pallas path.
                hw[len(group.items):] = hw[max(len(group.items) - 1, 0)]
                out_hws[oi] = hw
            elif op.type is OperationType.THUMBNAIL and not op.crop_to_fit:
                hw = np.zeros((b, 2), dtype=np.int32)
                long_side = op.size
                for i, it in enumerate(group.items):
                    h, w = it.hw
                    tw, th = thumbnail_dims(w, h, op.size)
                    hw[i] = (th, tw)
                    long_side = max(long_side, th, tw)
                # see the resize branch: pad rows mirror the last real
                # image so padding never distorts the scale gates
                hw[len(group.items):] = hw[max(len(group.items) - 1, 0)]
                out_hws[oi] = hw
                aspect_long[oi] = long_side
            elif op.type is OperationType.CROP:
                # Same per-image clamping as the single-image op.
                hw = np.ones((b, 2), dtype=np.int32)
                for i, it in enumerate(group.items):
                    h, w = it.hw
                    cx = max(0, min(op.x, w - 1))
                    cy = max(0, min(op.y, h - 1))
                    hw[i] = (max(1, min(op.height, h - cy)),
                             max(1, min(op.width, w - cx)))
                out_hws[oi] = hw
            elif op.type is OperationType.ROTATE:
                hw = np.ones((b, 2), dtype=np.int32)
                swap = (op.angle % 180.0) == 90.0
                for i, it in enumerate(group.items):
                    h, w = it.hw
                    hw[i] = (w, h) if swap else (h, w)
                out_hws[oi] = hw

        import time as _time

        # Reduced device plan: splice-served watermark ops are excluded
        # from the compiled program (no blend canvas materialized).
        keep = [oi for oi in range(len(plan.ops)) if oi not in splice_skip]
        if splice_skip:
            run_plan = OperationPlan(ops=tuple(plan.ops[oi] for oi in keep))
            ridx = {oi: j for j, oi in enumerate(keep)}
            run_out_hws = {ridx[oi]: v for oi, v in out_hws.items()
                           if oi in ridx}
            run_aspect = {ridx[oi]: v for oi, v in aspect_long.items()
                          if oi in ridx}
        else:
            run_plan, ridx = plan, {oi: oi for oi in keep}
            run_out_hws, run_aspect = out_hws, aspect_long

        specs = plan_output_specs(run_plan, group.bucket, run_aspect)
        device_coded = group.layout.startswith("coef")
        if device_coded:
            # Batched device JPEG decode straight into the bucket; the
            # result is a device array, so the downstream program
            # consumes it with no host round trip. The coefficient canvas
            # is MCU-padded past the bucket; the decode crops back inside
            # the same program.
            from imageprocessor_tpu.runtime.batcher import coef_factors
            fh, fw = coef_factors(group.layout)
            yc, cbc, crc, qt, cv = imgs
            imgs = self._decode_coefs(yc, cbc, crc, qt, cv, fh, fw,
                                      group.bucket)
        t_dev = _time.monotonic()
        if self._mesh is not None and not self._mesh_spatial:
            # Data-parallel over the local mesh: one fused program under
            # shard_map, batch axis split across cards, no cross-card
            # collectives (images are independent).
            outs = self.model.run_sharded(self._mesh, run_plan, imgs,
                                          src_hw, run_out_hws, specs)
        elif self._mesh is not None:
            # (data x space) GSPMD path: place the batch on the mesh and
            # let XLA auto-partition the jitted program — the horizontal
            # resample's cross-shard gathers lower to collectives.
            from imageprocessor_tpu.parallel.mesh import batch_sharding
            imgs = jax.device_put(imgs, batch_sharding(self._mesh))
            outs = self.model.run(run_plan, imgs, src_hw, run_out_hws,
                                  specs)
        else:
            outs = self.model.run(run_plan, imgs, src_hw, run_out_hws,
                                  specs)
        # Crop device-side to the group's max valid extent before D2H —
        # canvases are padded well past the real outputs (e.g. a 480x640
        # upload's resize is valid 480x640 inside a 768x1024 canvas), so
        # this regularly cuts transfer bytes 2-3x. Crop dims quantize up
        # to /64 and the batch stays padded, so slice shapes (and their
        # compiled programs) are reused across groups.
        n_real = len(group.items)

        def _q64(n: int, cap: int) -> int:
            return min(-(-n // 64) * 64, cap)

        max_h = int(max(it.hw[0] for it in group.items))
        max_w = int(max(it.hw[1] for it in group.items))
        cropped = []
        for oi, op in enumerate(plan.ops):
            if oi in splice_skip:
                # Served by splice transcode on host; never ran on device.
                cropped.append(("splice", op))
                continue
            o = outs[ridx[oi]]
            cv_h, cv_w = o.shape[1], o.shape[2]
            if oi in out_hws:
                mh = _q64(int(out_hws[oi][:n_real, 0].max()), cv_h)
                mw = _q64(int(out_hws[oi][:n_real, 1].max()), cv_w)
            elif op.type is OperationType.THUMBNAIL:
                cropped.append(o)
                continue
            else:
                mh = _q64(max_h, cv_h)
                mw = _q64(max_w, cv_w)
                # Full-bucket ops (watermark/flip/grayscale) of
                # device-decoded groups whose output every item wants as
                # JPEG: run the encode front half (color convert + 4:2:0
                # downsample + FDCT + quantize) on device and pull
                # coefficient canvases instead of pixels; finish_item
                # keeps only the entropy emit.
                if (device_coded
                        and mh % 16 == 0 and mw % 16 == 0
                        and all(negotiate_format(
                                    it.payload[2],
                                    watermark=op.type
                                    is OperationType.WATERMARK) == "jpeg"
                                for it in group.items)):
                    from imageprocessor_tpu.ops.jpeg_encode import (
                        quality_qtables,
                    )
                    qt = quality_qtables(self.jpeg_quality)
                    vh = np.array([it.hw for it in group.items]
                                  + [(1, 1)] * (o.shape[0]
                                                - len(group.items)),
                                  dtype=np.int32)
                    yc, cbc, crc = self._encode_coefs(
                        o[:, :mh, :mw], vh, qt)
                    cropped.append(("coef420", yc, cbc, crc, qt))
                    continue
            cropped.append(o[:, :mh, :mw])
        outs_np = [
            o if (isinstance(o, tuple) and o[0] == "splice")
            else (o[0], np.asarray(o[1]), np.asarray(o[2]),
                  np.asarray(o[3]), o[4]) if isinstance(o, tuple)
            else np.asarray(o)
            for o in cropped]
        METRICS.observe("engine_device_ms",
                        (_time.monotonic() - t_dev) * 1000.0)
        METRICS.inc("engine_device_images", len(group.items))
        return plan, outs_np, out_hws

    def finish_item(self, group, i: int, plan, outs_np,
                    out_hws) -> EngineResult:
        """Stage 3 for one image: crop valid regions, encode, save.
        Fail-fast across the image's op list (reference semantics)."""
        it = group.items[i]
        _task_idx, task, fmt, _plan = it.payload
        out = EngineResult(result=ProcessingResult(
            id=task.id, image_id=task.image_id,
            status=ImageStatus.COMPLETED))
        h, w = it.hw
        for oi, op in enumerate(plan.ops):
            if oi in out_hws:   # per-image valid output dims known
                oh, ow = out_hws[oi][i]
                arr = outs_np[oi][i, :oh, :ow]
            elif op.type is OperationType.THUMBNAIL:
                arr = outs_np[oi][i]
            elif isinstance(outs_np[oi], tuple):  # device-encoded coefs
                arr = outs_np[oi]
            else:  # full-bucket canvas ops: crop to the valid extent
                arr = outs_np[oi][i, :h, :w]
            try:
                if isinstance(arr, tuple) and arr[0] == "splice":
                    artifact = (
                        self._splice_and_save(task, op, it.splice)
                        if op.type is OperationType.WATERMARK
                        else self._coef_tx_and_save(task, op, it.splice))
                elif (op.type is OperationType.WATERMARK
                        and it.splice is not None
                        and negotiate_format(fmt, watermark=True)
                        == "jpeg"):
                    # Mixed group (device coefs / pixels were computed
                    # for batchmates): this item still prefers the
                    # splice emit; _splice_and_save's own fallback
                    # chain covers failures.
                    artifact = self._splice_and_save(task, op, it.splice)
                elif isinstance(arr, tuple):
                    artifact = self._emit_and_save(task, op, arr, i, h, w)
                else:
                    artifact = self._encode_and_save(task, op, arr, fmt)
            except Exception as exc:
                self._classify_op_failure(out, op, exc)
                return out
            out.artifacts.append(artifact)
            out.result.processed_paths[op.type.value] = artifact.path
        return out

    def _run_group(self, group, results: list, device_section=None) -> None:
        import time as _time

        if device_section is not None:
            with device_section("device_group"):
                plan, outs_np, out_hws = self.device_group(group)
        else:
            plan, outs_np, out_hws = self.device_group(group)

        def _finish(i):
            task_idx = group.items[i].payload[0]
            return task_idx, self.finish_item(group, i, plan, outs_np,
                                              out_hws)

        t_enc = _time.monotonic()
        for task_idx, res in self._pool.map(_finish,
                                            range(len(group.items))):
            results[task_idx] = res
        METRICS.observe("engine_encode_ms",
                        (_time.monotonic() - t_enc) * 1000.0)

    def close(self) -> None:
        self._pool.shutdown(wait=True)


def _dec_safe(fn):
    def wrapper(i):
        try:
            return fn(i)
        except Exception as exc:  # noqa: BLE001 — isolated per image
            return exc
    return wrapper
