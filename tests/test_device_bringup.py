"""The device decision (runtime/device.py), compile-cache placement, the
API process staying off every backend, mesh placement on 4 virtual
devices, the device-decode hand-off, the libjpeg-free native build and
chip_smoke.py's contract."""

import io
import json
import os
import subprocess
import sys
import uuid

import jax
import numpy as np
import pytest
from PIL import Image

from imageprocessor_tpu.runtime import device, nativecodec
from imageprocessor_tpu.runtime.engine import ProcessingEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPU = device.DeviceCaps("gpu", "NVIDIA H100 80GB HBM3", 4)
CPU = device.DeviceCaps("cpu", "cpu", 8)
CUTOFF = device.DEVICE_JPEG_CORES_PER_CARD


class Capture:
    def __init__(self):
        self.blobs = {}

    def save_processed(self, path, data, mime=None):
        self.blobs[path] = data


def jpeg_bytes(h=120, w=160, seed=0):
    rng = np.random.default_rng(seed)
    arr = np.clip(rng.normal(128, 40, (h, w, 3)), 0, 255).astype(np.uint8)
    bio = io.BytesIO()
    Image.fromarray(arr).save(bio, format="JPEG", quality=90)
    return bio.getvalue()


# ----------------------------------------------------- the device decision

@pytest.mark.parametrize("caps,requested,space,want", [
    (GPU, 0, 1, 4),      # auto: every local card
    (GPU, 0, 2, 2),      # auto with a space axis
    (GPU, 2, 1, 2),      # explicit size wins
    (CPU, 0, 1, 1),      # auto on the CPU: one device
    (CPU, 4, 1, 4),      # tests opt into virtual devices explicitly
])
def test_data_axis_decision(caps, requested, space, want):
    assert caps.data_axis(requested, space) == want


@pytest.mark.parametrize("caps,native,cores,cards,want", [
    (GPU, True, 16, 1, True),              # core-starved GPU host
    (GPU, True, CUTOFF, 1, False),         # at the crossover: host pool
    (GPU, True, 2 * CUTOFF, 4, True),      # the crossover scales by card
    (GPU, False, 16, 1, False),            # no native entropy scanner
    (CPU, True, 1, 1, False),              # never on the CPU
])
def test_device_jpeg_auto_policy(caps, native, cores, cards, want):
    assert caps.device_jpeg_auto(native, cores, cards) is want


@pytest.mark.parametrize("requested,caps,ok", [
    ("gpu", GPU, True), ("cuda", GPU, True), ("", CPU, True),
    ("gpu", CPU, False), ("cpu", GPU, False), ("cpu", CPU, True)])
def test_require_platform(requested, caps, ok):
    if ok:
        device.require_platform(requested, caps)
    else:
        with pytest.raises(device.PlatformError):
            device.require_platform(requested, caps)


def test_engine_takes_its_decision_from_the_backend(monkeypatch):
    """One decision at construction: a (fake) 4-card GPU backend gets a
    4-way mesh and, on a core-starved host, the device codec."""
    monkeypatch.setattr(device, "detect", lambda: GPU)
    monkeypatch.setattr("imageprocessor_tpu.runtime.engine.usable_cores",
                        lambda: 8)
    monkeypatch.delenv("IMAGEPROCESSOR_DEVICE_JPEG", raising=False)
    eng = ProcessingEngine(Capture())
    try:
        assert eng.caps is GPU
        assert int(eng._mesh.shape["data"]) == 4
        assert eng.device_jpeg is nativecodec.available()
    finally:
        eng.close()


def test_worker_refuses_cpu_when_gpu_configured(monkeypatch):
    """DEVICE_PLATFORM=gpu and JAX on the CPU: the worker exits non-zero
    instead of serving there."""
    from imageprocessor_tpu import config as config_mod
    from imageprocessor_tpu.service import __main__ as main_mod

    monkeypatch.setenv("DEVICE_PLATFORM", "gpu")
    monkeypatch.setattr(config_mod, "apply_device_platform",
                        lambda cfg, _jax=None: True)
    monkeypatch.setattr(device, "detect", lambda: CPU)
    assert main_mod.main(["worker"]) == 3


# ------------------------------------------------------ compile cache

def test_compile_cache_dir_placement():
    assert device.compile_cache_dir({}) == os.path.join(REPO, ".jaxcache")
    assert device.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/cache/x"}) == "/cache/x"


@pytest.mark.parametrize("env_set", [False, True])
def test_enable_compile_cache_sets_only_the_default(monkeypatch, tmp_path,
                                                    env_set):
    """JAX reads JAX_COMPILATION_CACHE_DIR itself; code sets a directory
    only when it is unset, and then the fixed <checkout>/.jaxcache."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setattr(device, "REPO_ROOT", tmp_path)
    env = {"JAX_COMPILATION_CACHE_DIR": "/cache/x"} if env_set else {}
    path = device.enable_compile_cache(env)
    if env_set:
        assert path == "/cache/x" and calls == []
    else:
        want = str(tmp_path / ".jaxcache")
        assert path == want and os.path.isdir(want)
        assert calls == [("jax_compilation_cache_dir", want)]


# ------------------------------------------------ the API process

def test_api_upload_initialises_no_backend(tmp_path):
    """Handling an upload over HTTP in a fresh process leaves every JAX
    backend uninitialised: the API never claims a card."""
    code = f"""
import asyncio, io, sys
sys.path.insert(0, {REPO!r})
import numpy as np
from PIL import Image
from aiohttp import FormData
from aiohttp.test_utils import TestClient, TestServer
from jax._src import xla_bridge
from imageprocessor_tpu.broker.memory import MemoryBroker
from imageprocessor_tpu.config import load
from imageprocessor_tpu.service.app import build_app
from imageprocessor_tpu.storage import LocalFSObjectStore, SQLiteMetadataStore

async def main():
    bio = io.BytesIO()
    Image.fromarray(np.zeros((32, 48, 3), np.uint8)).save(bio, "PNG")
    app = build_app(load({{}}), meta=SQLiteMetadataStore(":memory:"),
                    store=LocalFSObjectStore({str(tmp_path)!r}),
                    broker=MemoryBroker())
    async with TestClient(TestServer(app)) as client:
        form = FormData()
        form.add_field("file", bio.getvalue(), filename="a.png",
                       content_type="image/png")
        resp = await client.post("/api/images/upload?thumbnail=true",
                                 data=form)
        assert resp.status < 300, await resp.text()
        image_id = (await resp.json())["id"]
        resp = await client.get(f"/api/images/{{image_id}}/status")
        assert resp.status == 200, await resp.text()
    print("initialised", xla_bridge.backends_are_initialized())

asyncio.run(main())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "initialised False" in out.stdout


# ------------------------------------------------ placement and hand-off

def test_host_batches_go_straight_to_their_shards():
    """With a 4-way data mesh a host batch is placed batch-sharded, each
    device receiving only its slice — not committed to device 0."""
    eng = ProcessingEngine(Capture(), data_axis=4)
    try:
        x = eng._place(np.zeros((8, 16, 16, 3), np.uint8))
        assert len(x.sharding.device_set) == 4
        assert {s.data.shape for s in x.addressable_shards} == {
            (2, 16, 16, 3)}
    finally:
        eng.close()


@pytest.mark.skipif(not nativecodec.available(),
                    reason="native scanner unavailable")
def test_codec_programs_run_under_the_mesh():
    """The device decode's output is split over the mesh's 4 devices."""
    from imageprocessor_tpu.models.plan import normalize_operations
    from imageprocessor_tpu.runtime.batcher import BatchItem, group_items

    eng = ProcessingEngine(Capture(), data_axis=4, device_jpeg=True)
    try:
        plan = normalize_operations([])
        items = []
        for i in range(4):
            arr, _f, layout, hw, _c = eng.decode_for_plan_ex(
                jpeg_bytes(seed=i), plan)
            items.append(BatchItem(item_id=str(i), image=arr, plan_key=0,
                                   layout=layout, valid_hw=hw))
        (group,) = group_items(items, max_batch=4)
        (yc, cbc, crc, qt, cv), _hw = group.pack()
        pix = eng._decode_coefs(yc, cbc, crc, qt, cv, 2, 2, group.bucket)
        assert len({s.device for s in pix.addressable_shards}) == 4
        assert pix.shape == (4, *group.bucket, 3)
    finally:
        eng.close()


@pytest.mark.skipif(not nativecodec.available(),
                    reason="native scanner unavailable")
def test_device_decode_feeds_program_without_host_round_trip(monkeypatch):
    """The decoded batch reaches the pipeline program as a device array:
    no copy back to the host between the codec and the ops."""
    from imageprocessor_tpu.domain import (
        ImageStatus,
        OperationParams,
        OperationType,
        ProcessingTask,
    )

    eng = ProcessingEngine(Capture(), device_jpeg=True)
    seen = []
    run = eng.model.run

    def spy(plan, imgs, *args, **kw):
        seen.append(imgs)
        return run(plan, imgs, *args, **kw)

    monkeypatch.setattr(eng.model, "run", spy)
    ops = [OperationParams(OperationType.THUMBNAIL,
                           {"size": 32, "crop_to_fit": True})]
    task = ProcessingTask(id=str(uuid.uuid4()), image_id=str(uuid.uuid4()),
                          original_path="o", bucket="b", operations=ops,
                          format="jpeg")
    try:
        (res,) = eng.process_tasks([(task, jpeg_bytes())])
    finally:
        eng.close()
    assert res.result.status is ImageStatus.COMPLETED, res.result.error
    assert len(seen) == 1 and isinstance(seen[0], jax.Array)


# ------------------------------------------------ native build

def test_native_library_builds_without_libjpeg(monkeypatch, tmp_path):
    """A host without libjpeg's headers still builds the entropy scanner
    and emitter the device-JPEG route needs; the libjpeg entry points
    then refuse instead of crashing."""
    monkeypatch.setattr(nativecodec, "_SRC", tmp_path / "absent.cpp")
    monkeypatch.setattr(nativecodec, "_LIB", tmp_path / "libipcodec.so")
    monkeypatch.setattr(nativecodec, "_lib", None)
    monkeypatch.setattr(nativecodec, "_load_failed", False)
    assert nativecodec.available()
    assert not nativecodec.has_libjpeg()
    with pytest.raises(nativecodec.NativeCodecError):
        nativecodec.probe_jpeg(jpeg_bytes())
    data = jpeg_bytes()
    planes, qt, (w, h), samp = nativecodec.scan_jpeg_coefficients(data)
    again = nativecodec.emit_jpeg_from_coefficients(planes, qt, w, h,
                                                    samp[0])
    assert nativecodec.scan_jpeg_coefficients(again)[0][0].tolist() == \
        planes[0].tolist()


# ------------------------------------------------ chip_smoke.py

def test_chip_smoke_last_line_is_one_json_object():
    import chip_smoke

    line = chip_smoke.last_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


@pytest.mark.parametrize("platform,count,need", [
    ("cpu", 8, 1), ("gpu", 1, 4)])
def test_chip_smoke_refuses_without_the_cards(platform, count, need):
    import chip_smoke

    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu(platform, count, need)
    assert exc.value.code != 0


def test_chip_smoke_main_fails_on_cpu(capsys):
    """Run here on the CPU backend, the script exits non-zero before any
    phase and prints no result line."""
    import chip_smoke

    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out
