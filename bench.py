#!/usr/bin/env python
"""Benchmark: 12 MP images/sec through the device pipeline.

Measures the served path's device programs on the accelerator JAX runs
on, at the reference's default plan (thumbnail 200 crop + resize
1024x768 keep-aspect + watermark) on 8 x 12 MP (3000x4000) batches:

* the fused ops program alone (pixels resident on the device), and the
  same with a fresh H2D of each batch and D2H of the small outputs;
* the composed device-JPEG step: coefficient decode (IDCT + upsample +
  color) -> ops -> 4:2:0 encode front half (FDCT + quantize), and the
  splice-mode step the default watermark path runs (decode -> thumbnail
  + resize; the watermark rendition is spliced on host);
* the host codec's per-core rates (decode, encode, entropy scan/emit,
  splice stages, PNG).

Device times are wall times around work that ends in
`block_until_ready`, after warm-up; the best of the timed repetitions
is reported. Prints ONE JSON line; every result names the platform,
device kind and count, and the card's name and power limit
(`nvidia-smi`).

Usage: python bench.py [--smoke] [--batch B] [--iters N] [--latency]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_T0 = time.monotonic()


def _progress(msg: str) -> None:
    print(f"[bench +{time.monotonic() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def device_info() -> dict:
    """Where the numbers were taken: JAX's view plus nvidia-smi's."""
    from imageprocessor_tpu.runtime import device

    caps = device.detect()
    return {"platform": caps.backend, "device_kind": caps.kind,
            "device_count": caps.count, "card": device.card_report()}


def make_inputs(batch: int, src_h: int, src_w: int, bucket_h: int,
                bucket_w: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    # Photographic-ish content: smooth gradients + mild noise (compressible,
    # but the device path cost is content-independent).
    yy = np.linspace(0, 200, src_h, dtype=np.float32)[:, None, None]
    xx = np.linspace(0, 55, src_w, dtype=np.float32)[None, :, None]
    base = (yy + xx).astype(np.float32)
    imgs = np.zeros((batch, bucket_h, bucket_w, 3), dtype=np.uint8)
    for i in range(batch):
        noise = rng.integers(0, 24, size=(src_h, src_w, 3), dtype=np.uint8)
        imgs[i, :src_h, :src_w] = np.clip(base + noise, 0, 255).astype(np.uint8)
    src_hw = np.tile(np.asarray([[src_h, src_w]], np.int32), (batch, 1))
    return imgs, src_hw


def time_call(fn, iters: int) -> float:
    """Best wall seconds of `fn()` over `iters` calls, each ending in
    block_until_ready (JAX returns before the device finishes)."""
    import jax

    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def default_plan(resize_to=(768, 1024), thumb=200, watermark=True):
    from imageprocessor_tpu.domain import OperationParams, OperationType
    from imageprocessor_tpu.models.plan import normalize_operations

    ops = [
        OperationParams(OperationType.THUMBNAIL,
                        {"size": thumb, "crop_to_fit": True}),
        OperationParams(OperationType.RESIZE,
                        {"width": resize_to[1], "height": resize_to[0],
                         "keep_aspect": True}),
    ]
    if watermark:
        ops.append(OperationParams(OperationType.WATERMARK,
                                   {"text": "© ImageProcessor"}))
    return normalize_operations(ops)


def _geometry(plan, batch, src_hw_px, bucket, resize_to):
    from imageprocessor_tpu.models.pipeline import plan_output_specs
    from imageprocessor_tpu.ops.coords import keep_aspect_dims

    src_h, src_w = src_hw_px
    out_w, out_h = keep_aspect_dims(src_w, src_h, resize_to[1], resize_to[0])
    out_hws = {1: np.tile(np.asarray([[out_h, out_w]], np.int32),
                          (batch, 1))}
    return out_hws, plan_output_specs(plan, bucket)


def bench_device_pipeline(batch: int, iters: int, src_hw_px=(3000, 4000),
                          resize_to=(768, 1024), thumb=200):
    """Time the served fused ops program (PipelineModel.run: resample +
    watermark with input donation) on the device."""
    import jax

    from imageprocessor_tpu.models.pipeline import PipelineModel
    from imageprocessor_tpu.runtime.batcher import bucket_for

    src_h, src_w = src_hw_px
    bucket = bucket_for(src_h, src_w)
    imgs_np, src_hw_np = make_inputs(batch, src_h, src_w, *bucket)
    plan = default_plan(resize_to, thumb)
    out_hws, specs = _geometry(plan, batch, src_hw_px, bucket, resize_to)
    model = PipelineModel()

    _progress("fused ops: compile + first run")
    t0 = time.monotonic()
    jax.block_until_ready(model.run(plan, imgs_np, src_hw_np, out_hws,
                                    specs))
    compile_s = time.monotonic() - t0

    # Device-resident input: the watermark output is donated onto the
    # input buffer, so each call gets a fresh device copy (made outside
    # the timed region).
    dev_imgs = [jax.device_put(imgs_np) for _ in range(iters)]
    jax.block_until_ready(dev_imgs)
    it = iter(dev_imgs)
    step_s = time_call(lambda: model.run(plan, next(it), src_hw_np, out_hws,
                                         specs), iters)
    del dev_imgs

    # Streaming: fresh H2D of the batch, D2H of thumbnail + resize (the
    # small renditions the host encodes).
    def stream():
        outs = model.run(plan, imgs_np, src_hw_np, out_hws, specs)
        return np.asarray(outs[0]), np.asarray(outs[1])

    stream_s = time_call(stream, max(iters // 2, 2))

    probe = np.zeros((64 << 20,), dtype=np.uint8)
    h2d_s = time_call(lambda: jax.device_put(probe), 3)
    probe_dev = jax.device_put(probe)
    d2h_s = time_call(lambda: np.asarray(probe_dev + 0), 3)
    return {
        "fused_ops_ms_per_batch": step_s * 1000.0,
        "fused_ops_images_per_sec": batch / step_s,
        "stream_images_per_sec": batch / stream_s,
        "h2d_mb_per_s": 64.0 / h2d_s,
        "d2h_mb_per_s": 64.0 / d2h_s,
        "compile_s": compile_s,
        "batch": batch,
        "bucket": list(bucket),
    }


def coef_batch(batch: int, src_hw_px, bucket, quality: int = 85,
               seed: int = 0):
    """Host entropy scan of `batch` encoded q`quality` 4:2:0 JPEGs into
    bucket-sized coefficient canvases (the engine's coef420 layout)."""
    from imageprocessor_tpu.runtime import nativecodec as nc
    from imageprocessor_tpu.runtime.codecs import encode_image

    src_h, src_w = src_hw_px
    bh, bw = bucket
    imgs_np, _ = make_inputs(batch, src_h, src_w, src_h, src_w, seed)
    yc = np.zeros((batch, bh, bw), dtype=np.int16)
    cbc = np.zeros((batch, bh // 2, bw // 2), dtype=np.int16)
    crc = np.zeros((batch, bh // 2, bw // 2), dtype=np.int16)
    qt = np.zeros((batch, 3, 8, 8), dtype=np.float32)
    cv = np.ones((batch, 2), dtype=np.int32)
    for i in range(batch):
        jpeg = encode_image(imgs_np[i], "jpeg", quality)
        (y, cb, cr), qtabs, _dims, _samp = nc.scan_jpeg_coefficients(jpeg)
        yc[i, :y.shape[0], :y.shape[1]] = y
        cbc[i, :cb.shape[0], :cb.shape[1]] = cb
        crc[i, :cr.shape[0], :cr.shape[1]] = cr
        qt[i] = np.asarray(qtabs, dtype=np.float32)
        cv[i] = cb.shape
    return (yc, cbc, crc, qt, cv), imgs_np


def bench_device_jpeg_step(batch: int, iters: int, src_hw_px=(3000, 4000),
                           resize_to=(768, 1024), thumb=200,
                           splice_mode: bool = False):
    """Time the composed device-JPEG step as one jitted program.

    splice_mode=False (splice off, or splice-ineligible uploads):
    coefficient decode -> thumbnail + resize + watermark -> 4:2:0 encode
    front half of the watermark rendition.
    splice_mode=True (the default watermark path): the engine leaves the
    splice-served watermark out of the device program, so the device
    runs coefficient decode -> thumbnail + resize only."""
    import jax
    import jax.numpy as jnp

    from imageprocessor_tpu.models.pipeline import PipelineModel
    from imageprocessor_tpu.ops.jpeg_decode import batched_decode_ycbcr
    from imageprocessor_tpu.ops.jpeg_encode import (
        batched_encode_420,
        quality_qtables,
    )
    from imageprocessor_tpu.runtime import nativecodec as nc
    from imageprocessor_tpu.runtime.batcher import bucket_for

    bucket = bucket_for(*src_hw_px)
    if bucket[0] % 16 or bucket[1] % 16 or not nc.available():
        return None
    plan = default_plan(resize_to, thumb, watermark=not splice_mode)
    out_hws, specs = _geometry(plan, batch, src_hw_px, bucket, resize_to)
    model = PipelineModel()
    raw_step = model.get_raw_step(plan, specs)
    wm_args = model.prepare_wm_args(plan)
    src_hw = jnp.asarray(np.tile(np.asarray([src_hw_px], np.int32),
                                 (batch, 1)))
    hws = tuple(jnp.asarray(out_hws.get(i, np.zeros((batch, 2), np.int32)))
                for i in range(len(plan.ops)))
    eqt = jnp.asarray(quality_qtables(85), dtype=jnp.float32)

    _progress("device-jpeg step: scanning input coefficients")
    coefs, _ = coef_batch(batch, src_hw_px, bucket)
    coefs = [jnp.asarray(a) for a in coefs]

    @jax.jit
    def step(yc, cbc, crc, qt, cv):
        pix = batched_decode_ycbcr(yc, cbc, crc, qt, cv, fh=2, fw=2,
                                   out_h=bucket[0], out_w=bucket[1])
        outs = raw_step(pix, src_hw, hws, wm_args)
        if splice_mode:
            return outs
        return outs[:2] + batched_encode_420(outs[2], src_hw, eqt)

    _progress(f"device-jpeg step: compile (splice_mode={splice_mode})")
    jax.block_until_ready(step(*coefs))
    per_batch_s = time_call(lambda: step(*coefs), iters)
    key = ("device_splice_step" if splice_mode else "device_jpeg_step")
    return {f"{key}_images_per_sec": batch / per_batch_s,
            f"{key}_ms_per_batch": per_batch_s * 1000.0, "batch": batch}


def bench_host_codecs(src_hw_px=(3000, 4000), n: int = 4):
    """Single-core host codec rates (cv2/libjpeg-turbo)."""
    from imageprocessor_tpu.runtime.codecs import decode_image, encode_image

    src_h, src_w = src_hw_px
    imgs, _ = make_inputs(1, src_h, src_w, src_h, src_w)
    arr = imgs[0]
    jpeg = encode_image(arr, "jpeg", 85)

    def _best(fn, reps: int = n) -> float:
        """min-of-reps seconds: the floor is the codec's own cost; a mean
        would also measure whatever else shares the core."""
        best = float("inf")
        for _ in range(reps):
            t0 = time.monotonic()
            fn()
            best = min(best, time.monotonic() - t0)
        return best

    dec_s = _best(lambda: decode_image(jpeg))
    enc_s = _best(lambda: encode_image(arr, "jpeg", 85))

    out = {"host_decode_images_per_sec_per_core": 1.0 / dec_s,
           "host_encode_images_per_sec_per_core": 1.0 / enc_s,
           "jpeg_bytes_12mp": len(jpeg)}
    # PNG-heavy workload row: rate + size at the active
    # IMAGEPROCESSOR_PNG_COMPRESSION level (default 6 = Go png.Encode
    # parity; level 1 trades size for host throughput).
    from imageprocessor_tpu.runtime.codecs import PNG_COMPRESSION
    png = encode_image(arr, "png")
    png_s = _best(lambda: encode_image(arr, "png"), max(n // 2, 1))
    out["host_png_encode_images_per_sec_per_core"] = round(1.0 / png_s, 2)
    out["png_bytes"] = len(png)
    out["png_compression_level"] = PNG_COMPRESSION
    # Host halves of the device-side JPEG codec (entropy-only passes):
    # streaming scan (decode side) and Annex K emit (encode side).
    try:
        from imageprocessor_tpu.runtime import nativecodec as nc
        planes, qt, dims, samp = nc.scan_jpeg_coefficients(jpeg)
        scan_s = _best(lambda: nc.scan_jpeg_coefficients(jpeg))
        out["host_entropy_scan_images_per_sec_per_core"] = round(
            1.0 / scan_s, 2)
        nc.emit_jpeg_from_coefficients(planes, qt, dims[0], dims[1],
                                       samp[0])
        emit_s = _best(lambda: nc.emit_jpeg_from_coefficients(
            planes, qt, dims[0], dims[1], samp[0]))
        out["host_entropy_emit_images_per_sec_per_core"] = round(
            1.0 / emit_s, 2)
    except Exception:  # pragma: no cover — native lib unavailable
        pass
    # Splice-path host stages (the shipped watermark default):
    # offset-recording scan, band edit (float64 IDCT+blend+FDCT), splice
    # emit. host_splice_total_ms replaces the full-image emit term.
    try:
        from types import SimpleNamespace

        from imageprocessor_tpu.runtime import splice

        op = SimpleNamespace(text="© ImageProcessor", opacity=0.5,
                             position="bottom-right", font_size=36.0,
                             font_color="")
        # min-of-reps, like _best (tools/splicebench.py's convention).
        ctx = nc.scan_jpeg_for_transcode(jpeg)
        scan_s = float("inf")
        for _ in range(n):
            t0 = time.monotonic()
            nc.scan_jpeg_for_transcode(jpeg)
            scan_s = min(scan_s, time.monotonic() - t0)
        out["host_splice_scan_ms"] = round(scan_s * 1000.0, 2)
        planes0 = [p.copy() for p in ctx.planes]
        splice.watermark_band(ctx, op)  # warm the raster cache
        edit_s = float("inf")
        for _ in range(n):
            ctx.planes = [p.copy() for p in planes0]  # outside the window
            ctx.edited = False
            t0 = time.monotonic()
            flags = splice.watermark_band(ctx, op)
            edit_s = min(edit_s, time.monotonic() - t0)
        out["host_splice_edit_ms"] = round(edit_s * 1000.0, 2)
        emit_s = float("inf")
        for _ in range(n):
            t0 = time.monotonic()
            nc.emit_jpeg_transcode(ctx, flags)
            emit_s = min(emit_s, time.monotonic() - t0)
        out["host_splice_emit_ms"] = round(emit_s * 1000.0, 2)
        out["host_splice_total_ms"] = round(
            out["host_splice_scan_ms"] + out["host_splice_edit_ms"]
            + out["host_splice_emit_ms"], 2)
        emit_ips = out.get("host_entropy_emit_images_per_sec_per_core")
        if emit_ips:
            out["splice_emit_speedup_vs_full"] = round(
                (1000.0 / emit_ips)
                / max(out["host_splice_edit_ms"]
                      + out["host_splice_emit_ms"], 1e-9), 1)
    except Exception:  # pragma: no cover — splice scan unavailable
        pass
    # Lossless coefficient-domain rot90 (runtime/coeftx): the transform
    # stage alone — scan/emit costs are already keyed above.
    try:
        from imageprocessor_tpu.domain import OperationType
        from imageprocessor_tpu.models.plan import NormalizedOp
        from imageprocessor_tpu.runtime import coeftx, splice as _sp

        planes, qt, dims, samp = nc.scan_jpeg_coefficients(jpeg)
        ctx = _sp.coef_context(planes, qt, dims, samp)
        rot = NormalizedOp(type=OperationType.ROTATE, angle=90.0)
        prims = coeftx.eligible_prims(rot, ctx.size, ctx.sampling)
        if prims is not None:
            coeftx.apply(ctx, prims)  # warm
            tx_s = _best(lambda: coeftx.apply(ctx, prims))
            out["host_coeftx_rot90_ms"] = round(tx_s * 1000.0, 2)
    except Exception:  # pragma: no cover — coeftx unavailable
        pass
    return out


def bench_latency(n_images: int = 60, size=(480, 640), big_every: int = 10,
                  deadline_ms: float = 25.0, arrival_per_sec: float = 200.0):
    """p99 queue-to-processed latency through the real worker stack.

    Stands up the full in-process stack (usecase -> broker -> batch worker
    -> engine on the live accelerator) and measures produce-to-result
    latency from the results topic, mixing in a 12 MP image every
    `big_every` uploads. Run with --latency.
    """
    import tempfile
    import threading

    from imageprocessor_tpu.broker.memory import MemoryBroker
    from imageprocessor_tpu.config import load as load_config
    from imageprocessor_tpu.domain import (
        OperationParams,
        OperationType,
        ProcessingResult,
    )
    from imageprocessor_tpu.runtime.codecs import encode_image
    from imageprocessor_tpu.service.usecase import ImageUsecase
    from imageprocessor_tpu.service.worker import Worker
    from imageprocessor_tpu.storage import (
        LocalFSObjectStore,
        SQLiteMetadataStore,
    )

    tmp = tempfile.mkdtemp(prefix="ipbench-")
    cfg = load_config({})
    cfg.worker.batch_size = 16
    cfg.worker.batch_deadline_ms = deadline_ms
    meta = SQLiteMetadataStore(":memory:")
    store = LocalFSObjectStore(f"{tmp}/objects")
    broker = MemoryBroker()
    uc = ImageUsecase(meta, store, broker)
    worker = Worker(cfg, meta=meta, store=store, broker=broker)
    worker._idle_sleep = 0.002

    ops = [OperationParams(OperationType.THUMBNAIL,
                           {"size": 200, "crop_to_fit": True}),
           OperationParams(OperationType.RESIZE,
                           {"width": 1024, "height": 768,
                            "keep_aspect": True})]

    h, w = size
    imgs, _ = make_inputs(1, h, w, h, w)
    small_jpeg = encode_image(imgs[0], "jpeg", 85)
    big, _ = make_inputs(1, 3000, 4000, 3000, 4000)
    big_jpeg = encode_image(big[0], "jpeg", 85)

    # Warmup must cover every (bucket, quantized-batch-size) program the
    # load phase can hit — a cold compile costs seconds and would
    # otherwise land inside the timed window.
    _progress("latency warmup: compiling bucket x batch-size programs")
    warm_sets = [(small_jpeg, (16, 8, 4, 2, 1))]
    if big_every > 0:
        warm_sets.append((big_jpeg, (4, 2, 1)))
    for data, copies in warm_sets:
        for n in copies:
            for i in range(n):
                uc.upload_image(data, f"warm{n}-{i}.jpg", "image/jpeg", ops)
            while worker.run_once(max_n=n) > 0:
                pass
    while worker.run_once() > 0:  # drain stragglers
        pass
    broker.poll("image-processed", "bench-warm", max_n=1000)
    _progress("latency warmup done")

    # Stage decomposition starts clean: only the timed window's
    # queue-wait/decode/device/encode observations enter the report.
    from imageprocessor_tpu.utils.metrics import METRICS
    METRICS.reset()

    t_start: dict[str, float] = {}
    t_done: dict[str, float] = {}
    stop = threading.Event()

    def timed_done() -> int:
        # list() snapshots atomically under the GIL: the results thread
        # inserts concurrently, and iterating the live dict raises
        # "dictionary changed size during iteration".
        return sum(1 for k in list(t_done) if k in t_start)

    def consume_results():
        # Record EVERY result's first completion time (setdefault): the
        # worker can finish an upload before the main thread's
        # t_start insert runs, and the old `in t_start` filter acked
        # such results away — that sample then never completed and the
        # run stalled to the full deadline. Scoring filters to timed
        # ids, so stray warmup redeliveries are harmless.
        while not stop.is_set() and timed_done() < n_images:
            for msg in broker.poll("image-processed", "bench", max_n=32):
                res = ProcessingResult.from_json(msg.value)
                t_done.setdefault(res.image_id, time.monotonic())
                broker.ack(msg)
            time.sleep(0.001)

    worker_t = threading.Thread(target=worker.run, daemon=True)
    results_t = threading.Thread(target=consume_results, daemon=True)
    worker_t.start()
    results_t.start()

    is_big: dict[str, bool] = {}
    for i in range(n_images):
        big_one = big_every > 0 and (i + 1) % big_every == 0
        data = big_jpeg if big_one else small_jpeg
        img = uc.upload_image(data, f"l{i}.jpg", "image/jpeg", ops)
        t_start[img.id] = time.monotonic()
        is_big[img.id] = big_one
        time.sleep(1.0 / arrival_per_sec)

    deadline = time.monotonic() + 300
    while timed_done() < n_images and time.monotonic() < deadline:
        time.sleep(0.01)
    worker.stop()
    stop.set()
    results_t.join(timeout=5)   # quiesce before scoring iterates t_done

    lat = sorted(max(0.0, (t_done[k] - t_start[k]) * 1000.0)
                 for k in t_done if k in t_start)
    small_lat = sorted(max(0.0, (t_done[k] - t_start[k]) * 1000.0)
                       for k in t_done if k in t_start and not is_big[k])
    if not lat:
        raise RuntimeError("no latencies measured")
    snap = METRICS.snapshot()["timings"]
    # counts kept: observations per stage give the batch count, hence
    # the mean batch size (n / worker_batch count).
    stages = {name: {k: round(v, 1) for k, v in t.items()}
              for name, t in snap.items()
              if name in ("queue_wait_ms", "engine_decode_ms",
                          "engine_device_ms", "engine_encode_ms",
                          "worker_batch_ms")}

    pct = lambda p: lat[min(int(len(lat) * p), len(lat) - 1)]  # noqa: E731
    spct = (lambda p: small_lat[min(int(len(small_lat) * p),
                                    len(small_lat) - 1)]) if small_lat \
        else (lambda p: 0.0)
    return {
        "metric": "p99 queue-to-processed latency",
        "value": round(pct(0.99), 1),
        "unit": "ms",
        "p50_ms": round(pct(0.50), 1),
        "p90_ms": round(pct(0.90), 1),
        "p99_ms": round(pct(0.99), 1),
        "max_ms": round(lat[-1], 1),
        "small_p50_ms": round(spct(0.50), 1),
        "small_p99_ms": round(spct(0.99), 1),
        "n": len(lat),
        "stages_ms": stages,
        **device_info(),
        "note": ("full stack: upload -> queue -> batch worker -> device "
                 "engine -> storage -> results topic"),
    }


def quick_psnr_check():
    """Fidelity gate: batched device output vs float64 oracle."""
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests"))
    from oracle import psnr, resize_go  # noqa: PLC0415

    from imageprocessor_tpu.ops.resize import batched_resize_bilinear

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, size=(600, 800, 3), dtype=np.uint8)
    batch = np.zeros((1, 640, 1024, 3), dtype=np.uint8)
    batch[0, :600, :800] = img
    out = np.asarray(batched_resize_bilinear(
        batch, np.asarray([[600, 800]], np.int32),
        np.asarray([[300, 400]], np.int32), out_h=300, out_w=400))
    return float(psnr(out[0], resize_go(img, 400, 300)))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--smoke", action="store_true",
                        help="tiny shapes, fast verification run")
    parser.add_argument("--latency", action="store_true",
                        help="p99 queue-to-processed through the full stack")
    parser.add_argument("--lat-arrival", type=float, default=200.0,
                        help="latency run: uploads/sec arrival rate "
                             "(above the host's capacity this measures "
                             "queue growth, not service latency)")
    parser.add_argument("--lat-big-every", type=int, default=10,
                        help="latency run: every Nth upload is 12 MP "
                             "(0 disables)")
    parser.add_argument("--lat-n", type=int, default=60,
                        help="latency run: number of uploads")
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--iters", type=int, default=None)
    args = parser.parse_args()

    # Honor DEVICE_PLATFORM like the service entrypoints.
    from imageprocessor_tpu import config as _config
    from imageprocessor_tpu.runtime import device
    _config.apply_device_platform(_config.load())
    device.enable_compile_cache()
    info = device_info()
    _progress(f"device: {info}")

    if args.latency:
        print(json.dumps(bench_latency(
            n_images=args.lat_n, big_every=args.lat_big_every,
            arrival_per_sec=args.lat_arrival)))
        return 0

    batch = args.batch or (2 if args.smoke else 8)
    iters = args.iters or (2 if args.smoke else 6)
    if args.smoke:
        shape = dict(src_hw_px=(480, 640), resize_to=(96, 128), thumb=64)
        codecs = bench_host_codecs(src_hw_px=(480, 640), n=2)
    else:
        shape = {}
        codecs = bench_host_codecs()
    dev = bench_device_pipeline(batch, iters, **shape)
    spl_step = djpeg = None
    from imageprocessor_tpu.runtime import splice as _splice
    if _splice.enabled():
        spl_step = bench_device_jpeg_step(batch, iters, splice_mode=True,
                                          **shape)
    djpeg = bench_device_jpeg_step(batch, iters, **shape)

    psnr_db = quick_psnr_check()

    fused_rate = dev["fused_ops_images_per_sec"]
    # End-to-end on THIS host, one core, on the path the engine's auto
    # policy picks (runtime/device.py): device JPEG keeps only the
    # entropy scan + emit (or the splice stages) on host.
    from imageprocessor_tpu.runtime.engine import usable_cores
    dec = codecs["host_decode_images_per_sec_per_core"]
    enc = codecs["host_encode_images_per_sec_per_core"]
    scan = codecs.get("host_entropy_scan_images_per_sec_per_core")
    emit = codecs.get("host_entropy_emit_images_per_sec_per_core")
    e2e_host_codec = 1.0 / (1.0 / dec + 1.0 / enc
                            + 1.0 / max(fused_rate, 1e-9))
    auto_dj = device.detect().device_jpeg_auto(
        True, usable_cores(), info["device_count"])
    spl_ms = [codecs.get(k) for k in ("host_splice_scan_ms",
                                      "host_splice_edit_ms",
                                      "host_splice_emit_ms")]
    if spl_step and all(spl_ms) and auto_dj:
        dj_rate = spl_step["device_splice_step_images_per_sec"]
        e2e_one_core = 1.0 / (sum(spl_ms) / 1000.0
                              + 1.0 / max(dj_rate, 1e-9))
        e2e_path = "device_jpeg_splice"
    elif djpeg and scan and emit and auto_dj:
        dj_rate = djpeg["device_jpeg_step_images_per_sec"]
        e2e_one_core = 1.0 / (1.0 / scan + 1.0 / emit
                              + 1.0 / max(dj_rate, 1e-9))
        e2e_path = "device_jpeg"
    else:
        e2e_one_core = e2e_host_codec
        e2e_path = "host_codec"

    if spl_step:
        value = spl_step["device_splice_step_images_per_sec"]
        metric = ("12MP images/sec per device (decode→thumbnail+resize "
                  "on device; watermark by host splice transcode)")
    elif djpeg:
        value = djpeg["device_jpeg_step_images_per_sec"]
        metric = ("12MP images/sec per device (decode→resize→watermark"
                  "→encode front half)")
    else:
        value = fused_rate
        metric = ("12MP images/sec per device (fused thumbnail+resize+"
                  "watermark ops only; no native entropy scanner)")
    out = {
        "metric": metric,
        "value": round(value, 2),
        "unit": "images/sec",
        "psnr_db_vs_oracle": min(round(psnr_db, 2), 99.99),
        **{k: (round(v, 2) if isinstance(v, float) else v)
           for k, v in dev.items()},
        "end_to_end_one_host_core_images_per_sec": round(e2e_one_core, 2),
        "end_to_end_path": e2e_path,
        "end_to_end_one_host_core_host_codec_images_per_sec": round(
            e2e_host_codec, 2),
        **{k: round(v, 3) for step in (spl_step, djpeg) if step
           for k, v in step.items() if k != "batch"},
        **{k: (round(v, 2) if isinstance(v, float) else v)
           for k, v in codecs.items()},
        **info,
        "note": ("device times: best of timed repetitions after warm-up, "
                 "each ending in block_until_ready; host codec rates are "
                 "per single CPU core."),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
