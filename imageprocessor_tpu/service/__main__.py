"""Service entrypoints.

Mirrors the reference's two binaries (reference: cmd/image-processor/main.go,
cmd/worker/main.go) plus a standalone mode running both in one process
with zero external services:

    python -m imageprocessor_tpu.service api
    python -m imageprocessor_tpu.service worker
    python -m imageprocessor_tpu.service standalone [--port N] [--data DIR]
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from imageprocessor_tpu import config as config_mod
from imageprocessor_tpu.utils import get_logger, init_logging

log = get_logger("main")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="imageprocessor_tpu.service")
    parser.add_argument("mode", choices=["api", "worker", "standalone",
                                         "kafkaserver"])
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--data", type=str, default=None,
                        help="standalone: data directory root")
    parser.add_argument("--require-env", action="store_true",
                        help="enforce reference-style required env vars")
    parser.add_argument("--pipelined", action="store_true",
                        help="worker: streaming decode/device/encode stages "
                             "with deadline batching (lower p99 under load)")
    args = parser.parse_args(argv)

    cfg = config_mod.load(require=args.require_env)
    if args.port:
        cfg.server.addr = str(args.port)
    if args.data:
        cfg.storage.localfs_root = f"{args.data}/objects"
        cfg.db.sqlite_path = f"{args.data}/metadata.db"
        cfg.broker.sqlite_path = f"{args.data}/broker.db"
    init_logging(cfg.log_level)

    if args.mode == "api":
        # The API process handles uploads only; it must never claim a
        # card that a worker on the same host needs.
        import jax
        jax.config.update("jax_platforms", "cpu")
        from imageprocessor_tpu.service.app import run_api
        run_api(cfg)
        return 0

    if args.mode == "kafkaserver":
        # Zero-dependency dev queue speaking the Kafka wire protocol;
        # point KAFKA_BROKERS at it (see broker/kafkaserver.py).
        from imageprocessor_tpu.broker.kafkaserver import KafkaServer

        server = KafkaServer(host="0.0.0.0", port=args.port or 9092,
                             default_partitions=cfg.broker.partitions)
        log.info("Kafka-wire server listening", addr=server.address)
        stop = threading.Event()
        signal.signal(signal.SIGINT, lambda *_: stop.set())
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        stop.wait()
        server.close()
        return 0

    if args.mode in ("worker", "standalone"):
        if config_mod.apply_device_platform(cfg):
            log.info("Forced JAX platform", platform=cfg.device.platform)
        from imageprocessor_tpu.runtime import device
        try:
            device.require_platform(cfg.device.platform, device.detect())
        except (device.PlatformError, RuntimeError) as exc:
            log.error("Device platform unavailable", error=str(exc))
            return 3
        device.enable_compile_cache()

    if args.mode == "worker":
        if args.pipelined:
            from imageprocessor_tpu.service.pipelined import PipelinedWorker as Worker
        else:
            from imageprocessor_tpu.service.worker import Worker
        worker = Worker(cfg)

        def _sig(_s, _f):
            log.info("Received shutdown signal, stopping worker...")
            worker.stop()

        signal.signal(signal.SIGINT, _sig)
        signal.signal(signal.SIGTERM, _sig)
        worker.run()
        worker.close()
        return 0

    # standalone: shared in-process backends, worker thread + API server
    from imageprocessor_tpu.broker.memory import MemoryBroker
    from imageprocessor_tpu.service.app import build_app, run_api  # noqa: F401
    from imageprocessor_tpu.service.worker import Worker
    from imageprocessor_tpu.storage.metadata import build_metadata_store
    from imageprocessor_tpu.storage.object_store import build_object_store
    from aiohttp import web

    broker = MemoryBroker(default_partitions=cfg.broker.partitions)
    meta = build_metadata_store(cfg.db)
    store = build_object_store(cfg.storage)
    worker = Worker(cfg, meta=meta, store=store, broker=broker)
    thread = threading.Thread(target=worker.run, name="worker", daemon=True)
    thread.start()

    app = build_app(cfg, meta=meta, store=store, broker=broker)

    async def on_shutdown(_app):
        worker.stop()

    app.on_shutdown.append(on_shutdown)
    log.info("Standalone mode", port=cfg.server.port)
    web.run_app(app, port=cfg.server.port,
                shutdown_timeout=cfg.server.shutdown_timeout_s, print=None)
    worker.stop()
    thread.join(timeout=5)
    # Backends are owned by the worker side (build_app does not close
    # injected ones); worker.close() closes meta/store/broker — only
    # after the thread joined, so a mid-image job never writes to a
    # closed connection.
    worker.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
