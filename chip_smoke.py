#!/usr/bin/env python
"""Smoke test of the served path on an NVIDIA GPU.

One process, all inputs generated from --seed. With no arguments it
needs one card and runs:

  a. device report: nvidia-smi's name and power limit, JAX's version and
     device kind, the native codec's parts, the optional modules;
  b. the device programs at real width (8 x 12 MP) against the plain
     reference: the XLA JPEG decode vs the host libjpeg decode (4:2:0,
     4:2:2, 4:4:4), the encode front half vs a libjpeg q85 encode, and
     the fused thumbnail/resize/watermark program vs tests/oracle.py
     (float64 Go semantics); each timed per batch beside its
     bytes-and-FLOP lower bound, with XLA's memory analysis;
  c. the served path end to end: the aiohttp app, MemoryBroker, localfs
     and sqlite, and the worker thread, fed 16 seeded 12 MP q85 JPEG
     uploads over HTTP with the reference's default plan plus
     watermark, once with the device JPEG codec off and once on; every
     artifact must decode at the right size and agree with the oracle.

With --chips 4 it runs only the four-card comparison: the engine on a
4-way data mesh serves the phase-c workload (device JPEG off, on, and on
with the splice transcode off so the sharded encode runs) and must
produce the same bytes as a one-card engine, with every card holding
its shard.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}},
printed only when every phase passed. Without a GPU the script exits
non-zero before any phase.

Usage: python chip_smoke.py [--seed N] [--chips 4]
"""

from __future__ import annotations

import argparse
import importlib.util
import io
import json
import os
import sys
import tempfile
import threading
import time
import urllib.request
import uuid

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SRC_HW = (3000, 4000)        # 12 MP, the phone-photo fixture
BATCH = 8
N_UPLOADS = 16
QUALITY = 85
THUMB, RESIZE_WH = 200, (1024, 768)   # reference defaults (handlers.py)
# PIL's JPEG `subsampling` codes and the engine's (fh, fw) chroma factors.
SUBSAMPLINGS = {"4:2:0": (2, (2, 2)), "4:2:2": (1, (1, 2)),
                "4:4:4": (0, (1, 1))}
# Peak rates of one H100 SXM (NVIDIA data sheet, dense): HBM bandwidth
# and non-tensor-core f32 — the codec transforms run at HIGHEST
# precision, which keeps them off the TF32 tensor-core path.
PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                                   "f32_flop_per_s": 67e12}}


class CheckFailed(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def require_gpu(platform: str, count: int, need: int = 1) -> None:
    """Refuse anything but `need` or more GPUs: no phase may fall back."""
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX runs on {platform!r}, not a GPU")
    if count < need:
        raise SystemExit(f"chip_smoke: need {need} GPUs, JAX sees {count}")


def last_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def log(msg: str) -> None:
    print(msg, flush=True)


def oracle():
    """tests/oracle.py (float64 Go semantics), loaded by path: another
    installed package may own the name `tests`."""
    mod = sys.modules.get("ip_oracle")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "ip_oracle", os.path.join(HERE, "tests", "oracle.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["ip_oracle"] = mod
    return mod


def psnr(a, b) -> float:
    return float(oracle().psnr(np.asarray(a), np.asarray(b)))


def photo(rng, h: int, w: int) -> np.ndarray:
    """Photographic-ish content: smooth gradients, a few shapes, mild
    sensor noise."""
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    a, b, c = rng.uniform(0.5, 2.0, 3)
    img = np.stack([200 * yy * a + 40 * xx, 120 + 80 * np.sin(6 * xx * b + yy),
                    255 * (1 - yy) * (0.5 + 0.5 * np.cos(4 * xx * c))], -1)
    img = img + rng.normal(0.0, 6.0, (h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg(arr: np.ndarray, quality: int = QUALITY, subsampling: int = 2
         ) -> bytes:
    from PIL import Image
    bio = io.BytesIO()
    Image.fromarray(arr).save(bio, format="JPEG", quality=quality,
                              subsampling=subsampling)
    return bio.getvalue()


def host_decode(data: bytes) -> np.ndarray:
    """The plain reference decode: libjpeg through PIL."""
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def timed(fn, iters: int = 5) -> float:
    """Best wall milliseconds of fn() ending in block_until_ready, after
    one warm-up call."""
    import jax
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best * 1000.0


def bound_ms(kind: str, nbytes: float, flops: float) -> str:
    peak = PEAKS.get(kind)
    if peak is None:
        return f"bound: no peak table entry for {kind!r}"
    t_b = nbytes / peak["bytes_per_s"] * 1000.0
    t_f = flops / peak["f32_flop_per_s"] * 1000.0
    which = "bytes" if t_b >= t_f else "f32 FLOP"
    return (f"lower bound {max(t_b, t_f):.3f} ms ({which}: "
            f"{nbytes / 1e6:.0f} MB, {flops / 1e9:.1f} GFLOP)")


# ----------------------------------------------------------------- phase a

def phase_a(caps) -> None:
    import jax

    from imageprocessor_tpu.runtime import device, nativecodec
    log(f"[a] jax {jax.__version__}; backend {caps.backend}; "
        f"device_kind {caps.kind}; count {caps.count}")
    log(f"[a] native codec: scan/emit {nativecodec.available()}, "
        f"libjpeg part {nativecodec.has_libjpeg()}")
    mods = {m: importlib.util.find_spec(m) is not None
            for m in ("cv2", "PIL", "matplotlib", "aiohttp", "httpx")}
    log(f"[a] optional modules: {mods}")
    log(f"[a] compile cache: {device.enable_compile_cache()}")


# ----------------------------------------------------------------- phase b

def _coef_group(eng, blobs, plan):
    """The engine's own decode-stage output for `blobs`: entropy scan,
    coef layout, packed canvases (runtime/batcher.Group.pack)."""
    from imageprocessor_tpu.runtime.batcher import BatchItem, group_items
    items = []
    for i, data in enumerate(blobs):
        arr, _fmt, layout, hw, _ctx = eng.decode_for_plan_ex(data, plan)
        check(layout.startswith("coef"), f"no coef layout: {layout}")
        items.append(BatchItem(item_id=str(i), image=arr,
                               plan_key=plan.group_key(),
                               payload=(i, None, "jpeg", plan),
                               layout=layout, valid_hw=hw))
    groups = list(group_items(items, max_batch=len(items)))
    check(len(groups) == 1, "streams split into several groups")
    return groups[0]


def phase_b(rng, kind: str) -> None:
    import jax
    import jax.numpy as jnp

    from imageprocessor_tpu.domain import OperationParams, OperationType
    from imageprocessor_tpu.models.pipeline import (
        PipelineModel,
        plan_output_specs,
    )
    from imageprocessor_tpu.models.plan import normalize_operations
    from imageprocessor_tpu.ops.coords import keep_aspect_dims
    from imageprocessor_tpu.ops.jpeg_encode import (
        batched_encode_420,
        quality_qtables,
    )
    from imageprocessor_tpu.ops.watermark import (
        anchor_baseline,
        rasterize_text,
        resolve_color,
    )
    from imageprocessor_tpu.runtime import nativecodec
    from imageprocessor_tpu.runtime.batcher import bucket_for, coef_factors
    from imageprocessor_tpu.runtime.engine import ProcessingEngine
    resize_go, thumbnail_go, watermark_go = (
        oracle().resize_go, oracle().thumbnail_go, oracle().watermark_go)

    h, w = SRC_HW
    bucket = bucket_for(h, w)
    srcs = [photo(rng, h, w) for _ in range(BATCH)]
    plan_tr = normalize_operations([
        OperationParams(OperationType.THUMBNAIL,
                        {"size": THUMB, "crop_to_fit": True}),
        OperationParams(OperationType.RESIZE,
                        {"width": RESIZE_WH[0], "height": RESIZE_WH[1],
                         "keep_aspect": True})])
    eng = ProcessingEngine(_NullStore(), device_jpeg=True, batch_size=BATCH)

    # b1. XLA decode vs host libjpeg, per subsampling. 4:2:0 runs the
    # full 8-image batch and is timed; the others check two streams.
    decoded = None
    for name, (pil_ss, (fh, fw)) in SUBSAMPLINGS.items():
        n = BATCH if name == "4:2:0" else 2
        blobs = [jpeg(s, subsampling=pil_ss) for s in srcs[:n]]
        group = _coef_group(eng, blobs, plan_tr)
        check(coef_factors(group.layout) == (fh, fw),
              f"{name}: layout {group.layout}")
        host_in, _hw = group.pack(pad_batch_to=n)
        dev_in = [jnp.asarray(a) for a in host_in]   # time device work only

        def run(dev_in=dev_in, fh=fh, fw=fw):
            return eng._decode_coefs(*dev_in, fh, fw, bucket)

        pix = np.asarray(run())
        worst = min(psnr(pix[i, :h, :w], host_decode(blobs[i]))
                    for i in range(n))
        log(f"[b] decode {name}: min PSNR vs libjpeg {worst:.2f} dB "
            f"over {n} streams (limit > 45)")
        check(worst > 45.0, f"decode {name} PSNR {worst:.2f} <= 45 dB")
        if name == "4:2:0":
            decoded = pix
            ms = timed(run)
            px = n * bucket[0] * bucket[1]
            coef_bytes = sum(a.nbytes for a in host_in[:3])
            # two 8-point passes (16 MACs per sample) over luma + chroma
            log(f"[b] decode 4:2:0 {n}x12MP: {ms:.3f} ms/batch; "
                + bound_ms(kind, coef_bytes + 3 * px,
                           2 * 16 * 1.5 * px))
            from imageprocessor_tpu.ops.jpeg_decode import (
                batched_decode_ycbcr,
            )
            log("[b] decode memory analysis: " + str(
                batched_decode_ycbcr.lower(
                    *dev_in, fh=2, fw=2, out_h=bucket[0],
                    out_w=bucket[1]).compile().memory_analysis()))

    # b2. encode front half vs libjpeg q85.
    qt = quality_qtables(QUALITY)
    rgb = jnp.asarray(decoded)
    vh = np.asarray([SRC_HW] * BATCH, np.int32)

    def enc():
        return eng._encode_coefs(rgb, vh, qt)

    yc, cbc, crc = (np.asarray(a) for a in enc())
    gh, gw = -(-h // 16) * 16, -(-w // 16) * 16
    for i in (0, BATCH - 1):
        src = decoded[i, :h, :w]
        ours = nativecodec.emit_jpeg_from_coefficients(
            [yc[i, :gh, :gw], cbc[i, :gh // 2, :gw // 2],
             crc[i, :gh // 2, :gw // 2]], qt, w, h, (2, 2))
        ref = jpeg(src)
        p_ours, p_ref = psnr(host_decode(ours), src), psnr(host_decode(ref),
                                                           src)
        log(f"[b] encode image {i}: PSNR {p_ours:.3f} dB vs libjpeg q85 "
            f"{p_ref:.3f} dB; size {len(ours)} vs {len(ref)} B "
            f"(limits: >= ref - 0.5 dB, < 1.15x)")
        check(p_ours >= p_ref - 0.5, f"encode PSNR {p_ours:.3f} too low")
        check(len(ours) < 1.15 * len(ref), f"encode size {len(ours)}")
    ms = timed(enc)
    px = BATCH * bucket[0] * bucket[1]
    log(f"[b] encode front half {BATCH}x12MP: {ms:.3f} ms/batch; "
        + bound_ms(kind, 3 * px + 2 * 1.5 * px, 2 * 16 * 1.5 * px))
    log("[b] encode memory analysis: " + str(
        batched_encode_420.lower(rgb, jnp.asarray(vh), jnp.asarray(
            qt, jnp.float32)).compile().memory_analysis()))

    # b3. fused thumbnail + resize + watermark vs the float64 oracle.
    plan = normalize_operations([
        OperationParams(OperationType.THUMBNAIL,
                        {"size": THUMB, "crop_to_fit": True}),
        OperationParams(OperationType.RESIZE,
                        {"width": RESIZE_WH[0], "height": RESIZE_WH[1],
                         "keep_aspect": True}),
        OperationParams(OperationType.WATERMARK, {})])
    rw, rh = keep_aspect_dims(w, h, *RESIZE_WH)
    out_hws = {1: np.asarray([[rh, rw]] * BATCH, np.int32)}
    specs = plan_output_specs(plan, bucket)
    src_hw = np.asarray([SRC_HW] * BATCH, np.int32)
    hwc = np.zeros((BATCH, *bucket, 3), np.uint8)
    for i, s in enumerate(srcs):
        hwc[i, :h, :w] = s
    op_wm = plan.ops[2]
    tile = rasterize_text(op_wm.text, op_wm.font_size)
    bx, by = anchor_baseline(op_wm.position, w, h, tile)
    r, g, b, a = resolve_color(op_wm.font_color, op_wm.opacity)
    model = PipelineModel()
    outs = [np.asarray(o) for o in model.run(plan, hwc, src_hw, out_hws,
                                             specs)]
    for i in (0, BATCH - 1):
        src = srcs[i]
        p_t = psnr(outs[0][i], thumbnail_go(src, THUMB, crop_to_fit=True))
        p_r = psnr(outs[1][i, :rh, :rw],
                   resize_go(src, *RESIZE_WH, keep_aspect=True))
        ref_wm = watermark_go(src, tile.coverage, int(bx),
                              int(by) - tile.ascent, (r, g, b), a / 255.0)
        d_wm = int(np.abs(outs[2][i, :h, :w].astype(np.int16)
                          - ref_wm.astype(np.int16)).max())
        log(f"[b] fused ops image {i}: thumbnail {p_t:.2f} dB, resize "
            f"{p_r:.2f} dB (limit > 45); watermark max |diff| {d_wm} LSB "
            "(limit <= 1)")
        check(p_t > 45.0 and p_r > 45.0, "fused ops resample")
        check(d_wm <= 1, f"fused ops watermark off by {d_wm}")
    prog = model.get_program(plan, bucket, BATCH, specs)
    dev = [jax.device_put(hwc) for _ in range(7)]   # donated per call
    it = iter(dev)
    ms = timed(lambda: model.run(plan, next(it), src_hw, out_hws, specs))
    # read the source once, write the full-size watermark and the two
    # small renditions
    nbytes = 2 * hwc.nbytes + BATCH * 3 * (THUMB * THUMB
                                           + RESIZE_WH[0] * RESIZE_WH[1])
    log(f"[b] fused ops {BATCH}x12MP: {ms:.3f} ms/batch; "
        + bound_ms(kind, nbytes, 0.0))
    src_j, hws_j = model._geometry_args(plan, bucket, BATCH, src_hw,
                                        out_hws)
    log("[b] fused memory analysis: " + str(prog.lower(
        jnp.asarray(hwc), src_j, hws_j,
        model.prepare_wm_args(plan)).compile().memory_analysis()))
    del dev
    eng.close()


class _NullStore:
    def save_processed(self, path, data, mime=None):
        pass


# ----------------------------------------------------------------- phase c

def make_uploads(rng):
    """N_UPLOADS seeded 12 MP q85 JPEGs and their libjpeg decodes."""
    blobs = [jpeg(photo(rng, *SRC_HW)) for _ in range(N_UPLOADS)]
    return blobs, [host_decode(bl) for bl in blobs]


def default_plan():
    """The plan an upload with thumbnail, resize and watermark set gets
    (service/handlers.py, the reference's defaults)."""
    from imageprocessor_tpu.models.plan import normalize_operations
    from imageprocessor_tpu.service.handlers import (
        parse_operations_from_form,
    )
    return normalize_operations(parse_operations_from_form(
        {"thumbnail": "true", "resize": "true", "watermark": "true"}))


def oracle_renditions(src: np.ndarray) -> dict:
    """op -> (oracle output, PSNR floor): the floor is how close a
    libjpeg q85 encode of the oracle itself comes to it, less 1 dB —
    artifacts are q85 JPEGs, so that encode is the only loss allowed."""
    from imageprocessor_tpu.ops.watermark import (
        anchor_baseline,
        rasterize_text,
        resolve_color,
    )
    resize_go, thumbnail_go, watermark_go = (
        oracle().resize_go, oracle().thumbnail_go, oracle().watermark_go)

    h, w = src.shape[:2]
    wm = default_plan().ops[2]
    tile = rasterize_text(wm.text, wm.font_size)
    bx, by = anchor_baseline(wm.position, w, h, tile)
    r, g, b, a = resolve_color(wm.font_color, wm.opacity)
    outs = {"thumbnail": thumbnail_go(src, THUMB, crop_to_fit=True),
            "resize": resize_go(src, *RESIZE_WH, keep_aspect=True),
            "watermark": watermark_go(src, tile.coverage, int(bx),
                                      int(by) - tile.ascent, (r, g, b),
                                      a / 255.0)}
    return {op: (o, psnr(host_decode(jpeg(o)), o) - 1.0)
            for op, o in outs.items()}


def check_artifact(op: str, data: bytes, want) -> float:
    """Decodes at the oracle's size and clears its PSNR floor; returns
    the margin in dB."""
    want, floor = want
    got = host_decode(data)
    check(got.shape == want.shape, f"{op}: shape {got.shape} != {want.shape}")
    p = psnr(got, want)
    check(p >= floor, f"{op}: PSNR {p:.2f} dB < {floor:.2f} dB")
    return p - floor


class Service:
    """The standalone stack in this process: aiohttp app on localhost,
    MemoryBroker, localfs + sqlite under a temp dir, worker thread."""

    def __init__(self, root: str, engine):
        import asyncio

        from imageprocessor_tpu.broker.memory import MemoryBroker
        from imageprocessor_tpu.config import load as load_config
        from imageprocessor_tpu.service.worker import Worker
        from imageprocessor_tpu.storage import (
            LocalFSObjectStore,
            SQLiteMetadataStore,
        )

        self.cfg = load_config({})
        self.cfg.worker.batch_size = BATCH
        self.meta = SQLiteMetadataStore(os.path.join(root, "meta.db"))
        self.store = LocalFSObjectStore(os.path.join(root, "objects"))
        engine.store = self.store
        self.broker = MemoryBroker()
        self.worker = Worker(self.cfg, meta=self.meta, store=self.store,
                             broker=self.broker, engine=engine)
        self.worker._idle_sleep = 0.005
        self._loop = asyncio.new_event_loop()
        self._up = threading.Event()
        self.url = None
        self._server_t = threading.Thread(target=self._serve, daemon=True)
        self._worker_t = threading.Thread(target=self.worker.run,
                                          daemon=True)

    def _serve(self):
        import asyncio

        from aiohttp import web

        from imageprocessor_tpu.service.app import build_app
        asyncio.set_event_loop(self._loop)

        async def start():
            runner = web.AppRunner(build_app(
                self.cfg, meta=self.meta, store=self.store,
                broker=self.broker))
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            self.url = f"http://127.0.0.1:{runner.addresses[0][1]}"
            self._runner = runner
            self._up.set()

        self._loop.run_until_complete(start())
        self._loop.run_forever()

    def start_api(self):
        self._server_t.start()
        check(self._up.wait(30), "API server did not start")

    def start_worker(self):
        self._worker_t.start()

    def stop(self):
        self.worker.stop()
        self._worker_t.join(timeout=60)
        fut = __import__("asyncio").run_coroutine_threadsafe(
            self._runner.cleanup(), self._loop)
        fut.result(timeout=30)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._server_t.join(timeout=30)
        self.worker.close()

    # -- stdlib HTTP client ------------------------------------------------

    def upload(self, data: bytes, name: str) -> str:
        boundary = uuid.uuid4().hex
        body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f"name=\"file\"; filename=\"{name}\"\r\nContent-Type: "
                f"image/jpeg\r\n\r\n").encode() + data + \
            f"\r\n--{boundary}--\r\n".encode()
        req = urllib.request.Request(
            f"{self.url}/api/images/upload?thumbnail=true&resize=true"
            "&watermark=true", data=body, method="POST",
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())["id"]

    def status(self, image_id: str) -> str:
        with urllib.request.urlopen(
                f"{self.url}/api/images/{image_id}/status",
                timeout=30) as resp:
            return json.loads(resp.read())["status"]

    def artifact(self, image_id: str, op: str) -> bytes:
        with urllib.request.urlopen(
                f"{self.url}/api/images/{image_id}?operation={op}",
                timeout=60) as resp:
            return resp.read()


def serve_uploads(blobs, engine, label: str) -> list[dict]:
    """Upload every blob over HTTP, then start the worker (so it polls
    full batches) and wait until all are completed; returns each
    upload's artifacts keyed by operation."""
    with tempfile.TemporaryDirectory() as root:
        svc = Service(root, engine)
        svc.start_api()
        try:
            ids = [svc.upload(bl, f"u{i}.jpg") for i, bl in enumerate(blobs)]
            t0 = time.monotonic()
            svc.start_worker()
            deadline = t0 + 600
            pending = set(ids)
            while pending and time.monotonic() < deadline:
                for image_id in list(pending):
                    st = svc.status(image_id)
                    check(st != "failed", f"{label}: {image_id} failed")
                    if st == "completed":
                        pending.discard(image_id)
                time.sleep(0.05)
            wall = time.monotonic() - t0
            check(not pending, f"{label}: {len(pending)} never completed")
            log(f"[c] {label}: {len(ids)} x 12 MP uploads completed in "
                f"{wall:.2f} s ({len(ids) / wall:.2f} images/s, compilation "
                "included; informational)")
            return [{op: svc.artifact(i, op)
                     for op in ("thumbnail", "resize", "watermark")}
                    for i in ids]
        finally:
            svc.stop()


def phase_c(rng) -> None:
    from imageprocessor_tpu.runtime.engine import ProcessingEngine

    blobs, srcs = make_uploads(rng)
    oracles = [oracle_renditions(s) for s in srcs]
    for device_jpeg in (False, True):
        label = f"device_jpeg={'on' if device_jpeg else 'off'}"
        engine = ProcessingEngine(None, codec_threads=8, batch_size=BATCH,
                                  device_jpeg=device_jpeg)
        arts = serve_uploads(blobs, engine, label)
        margins = {op: min(check_artifact(op, a[op], o[op])
                           for a, o in zip(arts, oracles))
                   for op in arts[0]}
        log(f"[c] {label}: {len(arts) * len(margins)} artifacts decode at "
            "the oracle's size; smallest PSNR margin over the q85 floor "
            + ", ".join(f"{op} {m:.2f} dB" for op, m in margins.items()))


# ----------------------------------------------------------------- phase d

def phase_d(rng) -> None:
    """4-card data mesh vs one card on the phase-c workload."""
    import jax

    from imageprocessor_tpu.domain import ProcessingTask
    from imageprocessor_tpu.service.handlers import (
        parse_operations_from_form,
    )
    from imageprocessor_tpu.runtime.engine import ProcessingEngine

    class Capture:
        def __init__(self):
            self.blobs = {}

        def save_processed(self, path, data, mime=None):
            self.blobs[path] = data

    blobs, _srcs = make_uploads(rng)
    ops = parse_operations_from_form(
        {"thumbnail": "true", "resize": "true", "watermark": "true"})

    def tasks():
        out = []
        for bl in blobs:
            iid = str(uuid.uuid4())
            out.append((ProcessingTask(id=iid, image_id=iid,
                                       original_path=f"o/{iid}", bucket="b",
                                       operations=ops, format="jpeg"), bl))
        return out

    variants = [("device_jpeg=off", False, "1"), ("device_jpeg=on", True, "1"),
                ("device_jpeg=on, splice off", True, "0")]
    for label, device_jpeg, splice in variants:
        os.environ["IMAGEPROCESSOR_JPEG_SPLICE"] = splice
        results = {}
        for n in (1, 4):
            store = Capture()
            eng = ProcessingEngine(store, codec_threads=8, batch_size=BATCH,
                                   device_jpeg=device_jpeg, data_axis=n)
            check((eng._mesh is None) == (n == 1), f"mesh for {n} cards")
            t0 = time.monotonic()
            res = eng.process_tasks(tasks())
            wall = time.monotonic() - t0
            for r in res:
                check(r.result.status.value == "completed",
                      f"{label} x{n}: {r.result.error}")
            results[n] = [[store.blobs[a.path] for a in r.artifacts]
                          for r in res]
            log(f"[d] {label}, {n} card(s): {len(res)} uploads in "
                f"{wall:.2f} s (compilation included; informational)")
            eng.close()
        same = sum(a == b for ra, rb in zip(results[1], results[4])
                   for a, b in zip(ra, rb))
        total = sum(len(r) for r in results[1])
        log(f"[d] {label}: {same}/{total} artifacts byte-identical "
            "between 4 cards and 1")
        check(same == total, f"{label}: 4-card artifacts differ")
    os.environ.pop("IMAGEPROCESSOR_JPEG_SPLICE", None)

    # Placement: the sharded program's outputs live on all four cards,
    # one shard each, and every card's allocator saw work.
    from imageprocessor_tpu.models.pipeline import (
        PipelineModel,
        plan_output_specs,
    )
    from imageprocessor_tpu.models.plan import normalize_operations
    from imageprocessor_tpu.parallel.mesh import make_mesh
    from imageprocessor_tpu.runtime.batcher import bucket_for

    mesh = make_mesh(4)
    plan = normalize_operations(ops[:2])
    bucket = bucket_for(*SRC_HW)
    imgs = np.zeros((BATCH, *bucket, 3), np.uint8)
    src_hw = np.asarray([SRC_HW] * BATCH, np.int32)
    out_hws = {1: np.asarray([[768, 1024]] * BATCH, np.int32)}
    outs = PipelineModel().run_sharded(mesh, plan, imgs, src_hw, out_hws,
                                       plan_output_specs(plan, bucket))
    devs = set(mesh.devices.flat)
    for o in outs:
        shards = {s.device for s in o.addressable_shards}
        check(shards == devs and o.sharding.shard_shape(o.shape)[0]
              == BATCH // 4, f"output sharding {o.sharding}")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in devs]
    log(f"[d] output shards on {len(devs)} cards; peak bytes in use per "
        f"card {peaks}")
    check(all(p >= imgs.nbytes // 4 for p in peaks),
          "a card never held its shard")
    jax.block_until_ready(outs)


# ----------------------------------------------------------------- main

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = parser.parse_args(argv)

    import jax

    from imageprocessor_tpu.runtime import device
    caps = device.detect()
    require_gpu(caps.backend, caps.count, args.chips)
    card = device.card_report()
    rng = np.random.default_rng(args.seed)
    t0 = time.monotonic()
    phase_a(caps)
    if args.chips == 4:
        phase_d(rng)
    else:
        phase_b(rng, caps.kind)
        phase_c(rng)
    log(f"all phases passed in {time.monotonic() - t0:.1f} s")
    log(card)
    print(last_line(jax.devices()[0].platform, caps.kind,
                    len(jax.devices())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
