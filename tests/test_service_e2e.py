"""End-to-end service tests: real HTTP server + worker thread, zero mocks.

Replays the reference's README flows (reference: README.md:51-116) against
the standalone stack: aiohttp API + memory broker + localfs objects +
sqlite metadata + the device engine on the CPU backend.
"""

import asyncio
import io
import threading
import time

import httpx
import numpy as np
import pytest
from PIL import Image as PILImage

from imageprocessor_tpu.broker.memory import MemoryBroker
from imageprocessor_tpu.config import load as load_config
from imageprocessor_tpu.service.app import build_app
from imageprocessor_tpu.service.worker import Worker
from imageprocessor_tpu.storage import LocalFSObjectStore, SQLiteMetadataStore

RNG = np.random.default_rng(33)


class ServerHarness:
    """Runs the aiohttp app + worker thread; exposes a base URL."""

    def __init__(self, tmp_path):
        self.cfg = load_config({})
        self.cfg.worker.batch_size = 4
        self.meta = SQLiteMetadataStore(str(tmp_path / "meta.db"))
        self.store = LocalFSObjectStore(str(tmp_path / "objects"))
        self.broker = MemoryBroker()
        self.worker = Worker(self.cfg, meta=self.meta, store=self.store,
                             broker=self.broker)
        self.worker._idle_sleep = 0.01
        self._loop = asyncio.new_event_loop()
        self.port = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run_server, daemon=True)
        self._worker_thread = threading.Thread(target=self.worker.run,
                                               daemon=True)

    def _run_server(self):
        asyncio.set_event_loop(self._loop)

        async def start():
            from aiohttp import web
            app = build_app(self.cfg, meta=self.meta, store=self.store,
                            broker=self.broker)
            runner = web.AppRunner(app)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            self.port = runner.addresses[0][1]
            self._started.set()

        self._loop.run_until_complete(start())
        self._loop.run_forever()

    def start(self):
        self._thread.start()
        assert self._started.wait(10), "server failed to start"
        self._worker_thread.start()
        return f"http://127.0.0.1:{self.port}"

    def stop(self):
        self.worker.stop()
        self._loop.call_soon_threadsafe(self._loop.stop)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    # Module-scoped: XLA programs compiled for the first test's shapes are
    # reused by later tests (compiles dominate wall-time on the 1-core CI).
    h = ServerHarness(tmp_path_factory.mktemp("e2e"))
    url = h.start()
    yield url
    h.stop()


def png_upload(h=300, w=400, name="test.png"):
    arr = RNG.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    bio = io.BytesIO()
    PILImage.fromarray(arr).save(bio, format="PNG")
    return {"file": (name, bio.getvalue(), "image/png")}


def wait_status(client, url, image_id, want="completed", timeout=300):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        r = client.get(f"{url}/api/images/{image_id}/status")
        assert r.status_code == 200, r.text
        status = r.json()["status"]
        if status == want:
            return status
        if status == "failed" and want != "failed":
            raise AssertionError(f"processing failed: {r.text}")
        time.sleep(0.05)
    raise TimeoutError(f"status never became {want}")


def test_upload_process_fetch_delete_flow(server):
    with httpx.Client(timeout=30) as c:
        # health (router.go:48-50)
        r = c.get(f"{server}/api/health")
        assert r.status_code == 200 and r.json() == {"status": "ok"}

        # upload with default operations -> 202 + UploadResponse shape
        r = c.post(f"{server}/api/images/upload", files=png_upload())
        assert r.status_code == 202, r.text
        body = r.json()
        assert set(body) == {"id", "filename", "status", "size", "created_at"}
        assert body["filename"] == "test.png"
        assert body["status"] in ("uploaded", "processing")
        image_id = body["id"]

        wait_status(c, server, image_id)

        # original bytes round-trip
        r = c.get(f"{server}/api/images/{image_id}")
        assert r.status_code == 200
        assert r.headers["Content-Type"] == "image/png"
        assert r.headers["Cache-Control"] == "public, max-age=3600"
        assert 'filename="test.png"' in r.headers["Content-Disposition"]

        # processed variants
        r = c.get(f"{server}/api/images/{image_id}", params={"operation": "thumbnail"})
        assert r.status_code == 200
        thumb = PILImage.open(io.BytesIO(r.content))
        assert thumb.size == (200, 200)
        assert 'filename="test_thumbnail.png"' in r.headers["Content-Disposition"]

        r = c.get(f"{server}/api/images/{image_id}", params={"operation": "resize"})
        assert r.status_code == 200
        rsz = PILImage.open(io.BytesIO(r.content))
        assert rsz.size == (1024, 768)  # 400x300 upscaled keep-aspect 4:3

        # list
        r = c.get(f"{server}/api/images")
        assert r.status_code == 200
        assert any(i["id"] == image_id for i in r.json())

        # delete -> 204, then 404 everywhere
        r = c.delete(f"{server}/api/images/{image_id}")
        assert r.status_code == 204
        r = c.get(f"{server}/api/images/{image_id}/status")
        assert r.status_code == 404
        assert r.json()["message"] == "Image not found"
        r = c.get(f"{server}/api/images")
        assert all(i["id"] != image_id for i in r.json())


def test_watermark_upload_flow(server):
    with httpx.Client(timeout=30) as c:
        r = c.post(f"{server}/api/images/upload", files=png_upload(),
                   data={"watermark": "true", "watermark_text": "COPYRIGHT"})
        assert r.status_code == 202
        image_id = r.json()["id"]
        wait_status(c, server, image_id)
        r = c.get(f"{server}/api/images/{image_id}",
                  params={"operation": "watermark"})
        assert r.status_code == 200
        out = PILImage.open(io.BytesIO(r.content))
        assert out.size == (400, 300)


def test_query_string_operation_flags(server):
    """Go's ParseMultipartForm appends the multipart values to r.Form
    AFTER the query values ParseForm already stored, and form.Get
    returns the first value — so query flags select operations too and
    the QUERY value wins on conflict (image.go:46,68)."""
    with httpx.Client(timeout=30) as c:
        r = c.post(
            f"{server}/api/images/upload"
            "?watermark=true&watermark_text=QUERYTEXT",
            files=png_upload())
        assert r.status_code == 202
        image_id = r.json()["id"]
        wait_status(c, server, image_id)
        r = c.get(f"{server}/api/images/{image_id}",
                  params={"operation": "watermark"})
        assert r.status_code == 200
        # defaults were NOT applied (flags present → explicit ops only)
        r = c.get(f"{server}/api/images/{image_id}",
                  params={"operation": "resize"})
        assert r.status_code == 404
        # query value beats the body value for the same key: thumbnail
        # suppressed -> no explicit ops -> BOTH defaults apply
        r = c.post(f"{server}/api/images/upload?thumbnail=false",
                   files=png_upload(),
                   data={"thumbnail": "true"})
        assert r.status_code == 202
        image_id = r.json()["id"]
        wait_status(c, server, image_id)
        for op in ("thumbnail", "resize"):
            r = c.get(f"{server}/api/images/{image_id}",
                      params={"operation": op})
            assert r.status_code == 200, op


def test_processed_not_found_while_pending(server):
    with httpx.Client(timeout=30) as c:
        r = c.post(f"{server}/api/images/upload", files=png_upload())
        image_id = r.json()["id"]
        wait_status(c, server, image_id)
        r = c.get(f"{server}/api/images/{image_id}",
                  params={"operation": "watermark"})  # was never requested
        assert r.status_code == 404
        assert r.json()["message"] == "Processed version not found"


def test_upload_validation_errors(server):
    with httpx.Client(timeout=30) as c:
        # no file part
        r = c.post(f"{server}/api/images/upload", data={"thumbnail": "true"})
        assert r.status_code == 400

        # bad extension
        r = c.post(f"{server}/api/images/upload",
                   files={"file": ("evil.exe", b"MZ", "image/png")})
        assert r.status_code == 400
        assert "Unsupported file format" in r.json()["message"]

        # extension ok but content not an image -> sniffed at usecase level
        r = c.post(f"{server}/api/images/upload",
                   files={"file": ("fake.png", b"not a png", "image/png")})
        assert r.status_code == 400
        assert r.json()["message"] == "Unsupported file format"

        # content-type not image/*
        r = c.post(f"{server}/api/images/upload",
                   files={"file": ("a.png", b"x", "text/plain")})
        assert r.status_code == 400
        assert r.json()["message"] == "File must be an image"

        # oversized non-file form part must be rejected, not buffered
        r = c.post(f"{server}/api/images/upload", files=png_upload(),
                   data={"watermark_text": "x" * (1 << 20)})
        assert r.status_code == 400
        assert "Form field too large" in r.json()["message"]


def test_unknown_image_404s(server):
    with httpx.Client(timeout=10) as c:
        assert c.get(f"{server}/api/images/nope/status").status_code == 404
        assert c.get(f"{server}/api/images/nope").status_code == 404
        assert c.delete(f"{server}/api/images/nope").status_code == 404


def test_list_pagination_rules(server):
    with httpx.Client(timeout=30) as c:
        for _ in range(3):
            c.post(f"{server}/api/images/upload", files=png_upload(h=64, w=64))
        r = c.get(f"{server}/api/images", params={"limit": "2"})
        assert len(r.json()) == 2
        # invalid limit falls back to default (image.go:167-174)
        r = c.get(f"{server}/api/images", params={"limit": "0"})
        assert len(r.json()) >= 3
        r = c.get(f"{server}/api/images", params={"limit": "abc", "offset": "-5"})
        assert len(r.json()) >= 3


def test_duplicate_file_parts_first_wins(server):
    """Two multipart parts named 'file': the FIRST is stored — matching
    the reference's r.FormFile (reference: internal/http-server/handler/
    image/image.go:51), which returns the first match. Last-wins here
    would store different bytes than the reference for the same body."""
    first = png_upload(h=40, w=52, name="first.png")["file"]
    second = png_upload(h=40, w=52, name="second.png")["file"]
    with httpx.Client(timeout=30) as c:
        r = c.post(f"{server}/api/images/upload?thumbnail=false",
                   files=[("file", first), ("file", second)])
        assert r.status_code == 202, r.text
        body = r.json()
        assert body["filename"] == "first.png"
        image_id = body["id"]
        wait_status(c, server, image_id)
        got = c.get(f"{server}/api/images/{image_id}")
        assert got.status_code == 200
        assert got.content == first[1]   # first part's bytes, untouched


def test_request_deadline_enforced(tmp_path_factory):
    """The SERVER_READ/WRITE_TIMEOUT deadline middleware: a handler
    stalled past the deadline answers 408; a backend socket.timeout
    inside a handler is NOT mislabeled 408 (it 500s via recovery)."""
    import socket as _socket

    from imageprocessor_tpu.config import load as _load

    h = ServerHarness(tmp_path_factory.mktemp("deadline"))
    h.cfg.server.read_timeout_s = 0.2
    h.cfg.server.write_timeout_s = 0.2
    # rebuild the app with the tightened deadline: patch the usecase
    # the handler calls to stall / raise
    url = h.start()
    try:
        with httpx.Client(timeout=30) as c:
            # baseline: normal request inside the deadline
            r = c.get(f"{url}/api/health")
            assert r.status_code == 200
    finally:
        h.stop()

    # direct middleware-level checks (no server restart cost)
    import asyncio as _asyncio

    from aiohttp import web as _web

    from imageprocessor_tpu.service.app import build_app
    from imageprocessor_tpu.broker.memory import MemoryBroker
    from imageprocessor_tpu.storage import (
        LocalFSObjectStore,
        SQLiteMetadataStore,
    )

    cfg = _load({})
    cfg.server.read_timeout_s = 0.15
    cfg.server.write_timeout_s = 0.15
    tmp = tmp_path_factory.mktemp("deadline2")
    app = build_app(cfg, meta=SQLiteMetadataStore(":memory:"),
                    store=LocalFSObjectStore(str(tmp / "obj")),
                    broker=MemoryBroker())

    async def stalled(_request):
        await _asyncio.sleep(5)
        return _web.json_response({})

    async def backend_timeout(_request):
        raise _socket.timeout("backend socket timed out")

    app.router.add_get("/stalled", stalled)
    app.router.add_get("/backend-timeout", backend_timeout)

    async def drive():
        from aiohttp.test_utils import TestClient, TestServer

        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.get("/stalled")
            assert r.status == 408, r.status
            r2 = await client.get("/backend-timeout")
            assert r2.status == 500, r2.status   # recovery, not 408
        finally:
            await client.close()

    asyncio.new_event_loop().run_until_complete(drive())
