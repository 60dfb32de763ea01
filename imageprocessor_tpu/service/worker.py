"""Queue worker: broker poll -> engine micro-batches -> metadata + ack.

Replaces the reference's goroutine-pool worker (reference:
internal/worker/worker.go:76-234) with a batch loop shaped for the device:
instead of N goroutines each handling one message, one loop polls up to
`batch_size` messages, the engine processes them as fused device batches,
and acks land per message after its metadata writes — the reference's
commit-after-success contract (worker.go:125-146) with per-image
granularity.

Failure policy (SURVEY.md §5 failure detection):
* decode/param failures are PERMANENT: status=failed is recorded and the
  message is acked — no poison-message loop (the reference leaves these
  uncommitted, which replays them forever on rebalance);
* blob-fetch / infra errors are TRANSIENT: status=failed recorded
  best-effort and the message nacked for redelivery, matching the
  reference's leave-uncommitted-for-retry behavior;
* every completion/failure is also published to the results topic
  (the reference declares `SendResult` but never calls it — here the
  topic is live).
"""

from __future__ import annotations

import queue
import threading
import time

from imageprocessor_tpu.broker.base import Broker, BrokerMessage, build_broker
from imageprocessor_tpu.config import Config
from imageprocessor_tpu.domain import ImageStatus, ProcessedImage, ProcessingTask
from imageprocessor_tpu.runtime.engine import (
    TRANSIENT,
    EngineResult,
    ProcessingEngine,
)
from imageprocessor_tpu.storage.metadata import (
    MetadataStore,
    NotFound,
    build_metadata_store,
)
from imageprocessor_tpu.storage.object_store import (
    ObjectNotFound,
    ObjectStore,
    build_object_store,
)
from imageprocessor_tpu.utils import get_logger, retry_sync
from imageprocessor_tpu.utils.metrics import METRICS
from imageprocessor_tpu.utils.watchdog import Watchdog

log = get_logger("worker")


def post_webhook(url: str, payload: bytes | str, retries=None) -> bool:
    """Completion push: POST a ProcessingResult JSON to the configured
    webhook (WEBHOOK_URL). Failures are logged and swallowed — delivery
    guarantees stay with the results topic; the webhook is a
    convenience channel."""
    if not url:
        return False
    import urllib.request

    body = payload.encode() if isinstance(payload, str) else payload

    def _send():
        req = urllib.request.Request(
            url, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5) as resp:
            if resp.status >= 400:
                raise OSError(f"webhook status {resp.status}")

    try:
        if retries is not None:
            retry_sync(retries, _send)
        else:
            _send()
        return True
    except Exception as exc:
        log.error("Webhook delivery failed", url=url, error=str(exc))
        return False



class Worker:
    def __init__(self, cfg: Config, *, meta: MetadataStore | None = None,
                 store: ObjectStore | None = None,
                 broker: Broker | None = None,
                 engine: ProcessingEngine | None = None):
        self.cfg = cfg
        self.meta = meta or build_metadata_store(cfg.db)
        self.store = store or build_object_store(cfg.storage)
        self.broker = broker or build_broker(cfg.broker)
        self.broker.create_topic(cfg.broker.processing_topic,
                                 cfg.broker.partitions)
        self.broker.create_topic(cfg.broker.results_topic,
                                 cfg.broker.partitions)
        self.engine = engine or ProcessingEngine(
            self.store, codec_threads=cfg.worker.concurrency,
            batch_size=cfg.worker.batch_size,
            # DEVICE_DATA_AXIS / DEVICE_SPACE_AXIS: multi-card serving —
            # one worker process drives all local cards via the engine's
            # mesh (0 = every local GPU; runtime/device.py).
            data_axis=cfg.device.data_axis,
            space_axis=cfg.device.space_axis)
        log.info("Worker device", **self.engine.caps.describe(),
                 mesh=(dict(self.engine._mesh.shape)
                       if self.engine._mesh is not None else None),
                 device_jpeg=self.engine.device_jpeg)
        self._stop = threading.Event()
        self._idle_sleep = max(cfg.worker.batch_deadline_ms / 1000.0, 0.005)
        # Hung-device-RPC watchdog (utils/watchdog.py): a wedged device
        # transport blocks process_tasks forever with no exception;
        # abort-and-restart is the only recovery, leases redeliver.
        self._watchdog = Watchdog(cfg.worker.device_step_timeout_s)
        # Background webhook delivery (never in the batch hot loop).
        self._webhook_q: queue.Queue = queue.Queue(maxsize=1024)
        self._webhook_t: threading.Thread | None = None
        if cfg.worker.webhook_url:
            self._webhook_t = threading.Thread(target=self._webhook_loop,
                                               name="webhook", daemon=True)
            self._webhook_t.start()

    # ---------------------------------------------------------------- one poll

    def _parse_and_fetch(self, msg) -> tuple[ProcessingTask, bytes] | None:
        """Stage-1 policy shared by the batch and pipelined workers:
        unmarshal the task and fetch the original blob. On failure the
        message is already acked (malformed payload / missing blob:
        permanent) or nacked (transient storage error: redeliver) and
        None is returned — ONE copy of the classification so the two
        workers cannot drift."""
        try:
            task = ProcessingTask.from_json(msg.value)
            if not task.image_id:
                raise ValueError("missing ImageID")
        except Exception as exc:
            log.error("Failed to unmarshal task", offset=msg.offset,
                      error=str(exc))
            self._safe_ack(msg)  # malformed payload: permanent
            METRICS.inc("worker_malformed_tasks")
            return None
        try:
            # Retry transient storage errors (reference wraps every
            # MinIO call in retry.Strategy); a missing blob is final.
            blob = retry_sync(
                self.cfg.retry_strategy(),
                lambda path=task.original_path: self.store.get_object(path),
                retryable=lambda e: not isinstance(e, ObjectNotFound))
        except ObjectNotFound:
            # The blob is gone (e.g. the image was deleted while its
            # task sat in the queue): PERMANENT — nacking would
            # redeliver a message that can never succeed, forever.
            log.error("Original blob missing; failing permanently",
                      image_id=task.image_id, path=task.original_path)
            self._mark_failed(task.image_id)
            self._safe_ack(msg)
            METRICS.inc("worker_fetch_missing")
            return None
        except Exception as exc:
            log.error("Failed to get original image",
                      image_id=task.image_id, path=task.original_path,
                      error=str(exc))
            self._mark_failed(task.image_id)
            self._safe_nack(msg)  # transient: redeliver
            METRICS.inc("worker_fetch_failures")
            return None
        return task, blob

    def run_once(self, max_n: int | None = None) -> int:
        """Poll one micro-batch, process it, ack/nack. Returns #messages."""
        topic = self.cfg.broker.processing_topic
        group = self.cfg.broker.group_id
        msgs = self.broker.poll(topic, group,
                                max_n=max_n or self.cfg.worker.batch_size,
                                lease_s=self.cfg.worker.lease_s)
        if not msgs:
            return 0
        t0 = time.monotonic()
        now_wall = time.time()
        for m in msgs:
            if m.enqueued_at > 0:  # stage 0 of the latency decomposition
                METRICS.observe("queue_wait_ms",
                                max(0.0, (now_wall - m.enqueued_at) * 1000.0))
        parsed: list[tuple[BrokerMessage, ProcessingTask | None, bytes | None]] = []
        for msg in msgs:
            got = self._parse_and_fetch(msg)
            if got is not None:
                parsed.append((msg, got[0], got[1]))

        if not parsed:
            return len(msgs)

        # The watchdog arms around each device-group dispatch inside the
        # engine (one deadline per compiled program), not around the
        # whole batch — a mixed-bucket first batch pays one cold compile
        # per bucket, and their SUM can legitimately exceed the deadline.
        results = self.engine.process_tasks(
            [(task, blob) for (_m, task, blob) in parsed],
            device_section=self._watchdog.armed)

        for (msg, task, _blob), eng_res in zip(parsed, results):
            self._finish_message(msg, task, eng_res)

        dur = (time.monotonic() - t0) * 1000.0
        METRICS.observe("worker_batch_ms", dur)
        METRICS.inc("worker_images", len(parsed))
        log.info("Batch processed", size=len(parsed),
                 duration_ms=round(dur, 1))
        return len(msgs)

    def _deliver_webhook(self, res) -> None:
        """Queue the completion webhook for background delivery: the POST
        (with its multi-second retry budget) must never stall the batch
        hot loop. Queue full -> drop with a metric; delivery guarantees
        stay with the results topic."""
        if not self.cfg.worker.webhook_url:
            return
        try:
            self._webhook_q.put_nowait(res.to_json())
        except queue.Full:
            METRICS.inc("worker_webhook_dropped")
            log.error("Webhook queue full; dropping delivery",
                      image_id=res.image_id)

    def _webhook_loop(self) -> None:
        while not self._stop.is_set():
            try:
                payload = self._webhook_q.get(timeout=0.5)
            except queue.Empty:
                continue  # re-check _stop: no sentinel needed to exit
            if payload is None:
                return
            post_webhook(self.cfg.worker.webhook_url, payload,
                         self.cfg.retry_strategy())

    def _mark_failed(self, image_id: str) -> None:
        try:
            self.meta.update_status(image_id, ImageStatus.FAILED)
        except Exception:
            log.error("Failed to update status to failed", image_id=image_id)

    def _safe_ack(self, msg: BrokerMessage) -> None:
        """Ack, tolerating broker errors: the lease expires and the
        message is redelivered — outputs are idempotent, so at-least-once
        is preserved either way (and one broken ack must not abort the
        rest of the batch's completions)."""
        try:
            self.broker.ack(msg)
        except Exception as exc:
            log.error("Broker ack failed; message will be redelivered",
                      offset=msg.offset, error=str(exc))

    def _safe_nack(self, msg: BrokerMessage) -> None:
        try:
            self.broker.nack(msg)
        except Exception as exc:
            log.error("Broker nack failed; lease expiry will redeliver",
                      offset=msg.offset, error=str(exc))

    def _record(self, task: ProcessingTask, eng_res: EngineResult) -> bool:
        """Persist processed rows + final status (worker.go:202-232).
        Returns False when any metadata write failed — the caller must
        NOT ack then (commit-after-success)."""
        res = eng_res.result
        ok = True
        for artifact in eng_res.artifacts:
            try:
                self.meta.save_processed_image(ProcessedImage(
                    id="", image_id=task.image_id,
                    operation=artifact.operation, path=artifact.path,
                    size=artifact.size, mime_type=artifact.mime_type,
                    format=artifact.format, status="completed"))
            except Exception as exc:
                ok = False
                log.error("Failed to save processed row",
                          image_id=task.image_id,
                          operation=artifact.operation, error=str(exc))
        status = (ImageStatus.COMPLETED if res.status is ImageStatus.COMPLETED
                  else ImageStatus.FAILED)
        try:
            self.meta.update_status(task.image_id, status)
        except NotFound:
            # The image was DELETED while its task processed: the
            # delete's sweep ran before this run's writes, so the blobs
            # and rows just (re)created are orphans nothing will ever
            # clean. Deletion wins — undo this run's artifacts and
            # report success so the message is ACKED (a replay can
            # never complete and would just re-leak).
            log.info("Image deleted mid-processing; dropping results",
                     image_id=task.image_id)
            for artifact in eng_res.artifacts:
                try:
                    self.store.delete_object(artifact.path)
                except Exception:
                    log.error("Failed to drop orphaned blob",
                              path=artifact.path)
            try:
                self.meta.delete_processed_images(task.image_id)
            except Exception:
                log.error("Failed to drop orphaned processed rows",
                          image_id=task.image_id)
            return ok
        except Exception:
            ok = False
            log.error("Failed to update final status",
                      image_id=task.image_id)
        if res.status is not ImageStatus.COMPLETED:
            log.error("Image processing failed", image_id=task.image_id,
                      error=res.error)
        return ok

    def _finish_message(self, msg: BrokerMessage, task: ProcessingTask,
                        eng_res: EngineResult) -> None:
        """Record metadata + ack/nack + publish result for ONE message
        (commit-after-success, worker.go:125-146). Never raises: one
        message's broker/metadata trouble must not abort its batchmates'
        completions."""
        recorded = self._record(task, eng_res)
        res = eng_res.result
        if not recorded:
            # The metadata writes failed (DB down): acking a COMPLETED
            # result would mark the work committed while the DB has no
            # record of it, and acking a FAILED one would strand the
            # image in 'processing' forever (the UI polls it
            # indefinitely). Leave for redelivery either way — outputs
            # and writes are idempotent, the replay re-runs them.
            log.error("Metadata writes failed; leaving for redelivery",
                      image_id=task.image_id, status=res.status.value)
            self._safe_nack(msg)
            METRICS.inc("worker_record_failures")
            return
        if res.status is ImageStatus.COMPLETED:
            self._safe_ack(msg)
            METRICS.inc("worker_completed")
        elif eng_res.error_kind == TRANSIENT:
            self._safe_nack(msg)
            METRICS.inc("worker_failed_transient")
        else:
            # Typed classification (engine tags every failure); the
            # reference replays failures forever on rebalance — here
            # permanent input errors are acked to avoid poison loops.
            self._safe_ack(msg)
            METRICS.inc("worker_failed_permanent")
        try:
            self.broker.produce(self.cfg.broker.results_topic,
                                task.image_id.encode(), res.to_json())
        except Exception:
            log.error("Failed to publish result", image_id=task.image_id)
        self._deliver_webhook(res)

    # ------------------------------------------------------------------- loop

    def run(self) -> None:
        log.info("Worker started", batch_size=self.cfg.worker.batch_size,
                 group=self.cfg.broker.group_id)
        last_purge = time.monotonic()
        while not self._stop.is_set():
            try:
                n = self.run_once()
            except Exception as exc:
                # Per-iteration isolation: a transient broker/storage/engine
                # error (e.g. sqlite "database is locked" on the compose
                # shared-volume broker) must not kill the consume loop —
                # the reference worker keeps consuming after per-message
                # errors (worker.go:151-163).
                log.error("Worker iteration failed", error=str(exc),
                          exc_info=True)
                METRICS.inc("worker_iteration_errors")
                self._stop.wait(min(self._idle_sleep * 4, 2.0))
                continue
            if n == 0:
                self._stop.wait(self._idle_sleep)
            # Retention: durable brokers garbage-collect fully-acked
            # messages (Kafka's analog is segment retention).
            if time.monotonic() - last_purge > 300:
                last_purge = time.monotonic()
                purge = getattr(self.broker, "purge_done", None)
                if purge is not None:
                    try:
                        removed = purge(older_than_s=3600.0)
                        if removed:
                            log.info("Purged acked messages", count=removed)
                    except Exception:
                        log.error("Broker purge failed")
        log.info("Worker stopped gracefully")

    def stop(self) -> None:
        self._stop.set()

    def close(self) -> None:
        self.stop()
        if self._webhook_t is not None:
            # Never block shutdown on a full webhook queue (a dead
            # endpoint + retry budget can keep it full indefinitely);
            # the loop also checks _stop after every delivery.
            try:
                self._webhook_q.put_nowait(None)
            except queue.Full:
                pass
            self._webhook_t.join(timeout=10)
        self._watchdog.close()
        self.engine.close()
        for closer in (self.meta, self.store, self.broker):
            try:
                closer.close()
            except Exception:
                pass
