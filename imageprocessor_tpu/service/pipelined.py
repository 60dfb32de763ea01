"""Pipelined worker: decode, device, and encode stages run concurrently.

The batch worker (service/worker.py) serializes its phases per poll:
decode all -> device -> encode all. This worker overlaps them across
micro-batches — the accelerator-side expansion of the reference's
goroutine-pool concurrency (SURVEY.md §2 parallelism table row 1:
"decode thread pool feeding per-device micro-batch queues"):

  stage 1 (fetch/decode threads): poll broker -> fetch blob -> decode ->
           DeadlineBatcher (flush on batch size OR deadline — the p99
           latency lever, SURVEY.md §7 hard part (d))
  stage 2 (device thread): pack group -> fused program -> host outputs
  stage 3 (encode pool): crop/encode/save/record/ack per image

At-least-once semantics are identical to the batch worker: each message
is acked only after its metadata writes, permanent failures are acked
with status=failed, transient ones nacked for redelivery.
"""

from __future__ import annotations

import queue
import threading
import time

from imageprocessor_tpu.broker.base import BrokerMessage
from imageprocessor_tpu.config import Config
from imageprocessor_tpu.domain import ProcessingTask
from imageprocessor_tpu.errors import DecodeError
from imageprocessor_tpu.errors import UnsupportedOperationError
from imageprocessor_tpu.models.plan import (
    InvalidParamsError,
    normalize_operations,
)
from imageprocessor_tpu.runtime.batcher import BatchItem, DeadlineBatcher
from imageprocessor_tpu.runtime.engine import (
    TRANSIENT,
    EngineResult,
)
from imageprocessor_tpu.service.worker import Worker
from imageprocessor_tpu.utils import get_logger
from imageprocessor_tpu.utils.metrics import METRICS
from imageprocessor_tpu.utils.tracing import span

log = get_logger("pipelined")

_SENTINEL = object()


class PipelinedWorker(Worker):
    """Three-stage streaming worker. `run()` blocks until `stop()`."""

    def __init__(self, cfg: Config, **kw):
        super().__init__(cfg, **kw)
        depth = max(cfg.worker.max_queue_depth, 8)
        self._group_q: queue.Queue = queue.Queue(maxsize=8)
        self._finish_q: queue.Queue = queue.Queue(maxsize=8)
        self._batcher = DeadlineBatcher(
            batch_size=cfg.worker.batch_size,
            deadline_ms=cfg.worker.batch_deadline_ms)
        self._batcher_lock = threading.Lock()
        self._inflight = threading.Semaphore(depth)

    # ---------------------------------------------------------------- stage 1

    def _decode_stage(self) -> None:
        topic = self.cfg.broker.processing_topic
        group_id = self.cfg.broker.group_id
        while not self._stop.is_set():
            # Per-iteration isolation, like Worker.run: a transient
            # broker error (sqlite "database is locked" on the shared
            # compose volume, a Kafka reconnect) must not kill the
            # decode thread — the whole pipeline deadlocks without it.
            try:
                msgs = self.broker.poll(topic, group_id,
                                        max_n=self.cfg.worker.batch_size,
                                        lease_s=self.cfg.worker.lease_s)
                if not msgs:
                    self._flush_due()
                    self._stop.wait(self._idle_sleep)
                    continue
                now_wall = time.time()
                for msg in msgs:
                    if msg.enqueued_at > 0:  # stage 0 of the decomposition
                        METRICS.observe(
                            "queue_wait_ms",
                            max(0.0, (now_wall - msg.enqueued_at) * 1000.0))
                    # NEVER block indefinitely on the inflight permits:
                    # items sitting in the DeadlineBatcher each hold a
                    # permit, and only THIS thread can flush them — an
                    # unconditional acquire() here deadlocks the whole
                    # pipeline once pending batcher items exhaust the
                    # semaphore (and any stall delays deadline flushes
                    # past batch_deadline_ms, defeating the p99 lever).
                    while not self._inflight.acquire(
                            timeout=self._batcher.deadline_s):
                        self._flush_due()
                        if self._stop.is_set():
                            return self._drain()
                    self._handle_message(msg)
                self._flush_due()
            except Exception as exc:
                log.error("Decode stage iteration failed", error=str(exc),
                          exc_info=True)
                METRICS.inc("worker_loop_errors")
                self._stop.wait(min(1.0, self._idle_sleep * 10))
        self._drain()

    def _drain(self) -> None:
        """Flush whatever is pending and signal downstream shutdown."""
        with self._batcher_lock:
            for group in self._batcher.flush_all():
                self._dispatch(group)
        self._group_q.put(_SENTINEL)

    def _dispatch(self, group) -> None:
        """Hand a flushed group to the device stage, recording how long
        each item sat in the deadline batcher (bounded by
        batch_deadline_ms + one poll-loop iteration; test-asserted)."""
        now = time.monotonic()
        for it in group.items:
            METRICS.observe("batcher_wait_ms",
                            max(0.0, (now - it.enqueued_at) * 1000.0))
        self._group_q.put(group)

    def _handle_message(self, msg: BrokerMessage) -> None:
        # Stage-1 policy (unmarshal + blob fetch) is shared with the
        # batch worker (Worker._parse_and_fetch); only the permit
        # bookkeeping is pipelined-specific.
        got = self._parse_and_fetch(msg)
        if got is None:
            self._inflight.release()  # message already acked/nacked
            return
        task, blob = got
        try:
            plan = normalize_operations(task.operations)
            with span("decode"):
                arr, detected, layout, valid_hw, sctx = \
                    self.engine.decode_for_plan_ex(
                        blob, plan,
                        task_format=task.format
                        if isinstance(task.format, str) else None)
        except (DecodeError, InvalidParamsError,
                UnsupportedOperationError, ValueError) as exc:
            prefix = ("Failed to decode image" if isinstance(exc, DecodeError)
                      else "Operation failed")
            res = self.engine._failed(task, f"{prefix}: {exc}")
            self._complete(msg, task, res)
            return
        except Exception as exc:
            # Any other decode-path exception (cv2.error, MemoryError on a
            # decompression bomb, ...): same policy as the batch path's
            # _dec_safe catch-all — a decode failure, permanent. Letting
            # it propagate would leak the _inflight permit acquired by
            # the caller and leave the message to redeliver forever.
            log.error("Decode failed with unclassified error",
                      image_id=task.image_id, error=str(exc), exc_info=True)
            res = self.engine._failed(task, f"Failed to decode image: {exc}")
            self._complete(msg, task, res)
            return

        try:
            fmt = (task.format or detected or "jpeg").lower()
            item = BatchItem(item_id=task.id, image=arr,
                             plan_key=plan.group_key(),
                             payload=(msg, task, fmt, plan),
                             layout=layout, valid_hw=valid_hw,
                             splice=sctx)
            with self._batcher_lock:
                group = self._batcher.add(item)
        except Exception as exc:
            # e.g. a non-string Format in the wire payload: an
            # unhandled exception here would leak the caller's
            # _inflight permit (each redelivery leaks another until the
            # cap is exhausted and the pipeline wedges) — classify as
            # permanent and complete, like the decode catch-all above.
            log.error("Failed to stage decoded task",
                      image_id=task.image_id, error=str(exc), exc_info=True)
            res = self.engine._failed(task, f"Operation failed: {exc}")
            self._complete(msg, task, res)
            return
        if group is not None:
            self._dispatch(group)

    def _flush_due(self) -> None:
        with self._batcher_lock:
            due = self._batcher.due()
        for group in due:
            self._dispatch(group)

    # ---------------------------------------------------------------- stage 2

    def _device_stage(self) -> None:
        while True:
            group = self._group_q.get()
            if group is _SENTINEL:
                self._finish_q.put(_SENTINEL)
                return
            try:
                # The watchdog bounds a wedged device RPC (no exception
                # ever fires from a hung transport; see utils/watchdog.py).
                with span("device"), self._watchdog.armed("device_group"):
                    plan, outs_np, out_hws = self.engine.device_group(group)
                self._finish_q.put((group, plan, outs_np, out_hws))
            except Exception as exc:
                log.error("Device stage failed", error=str(exc),
                          exc_info=True)
                for it in group.items:
                    msg, task, _fmt, _plan = it.payload
                    # TRANSIENT: a device/compile hiccup must nack the
                    # micro-batch for redelivery, not permanently fail it.
                    res = self.engine._failed(
                        task, f"device error: {exc}", kind=TRANSIENT)
                    self._complete(msg, task, res)

    # ---------------------------------------------------------------- stage 3

    def _finish_stage(self) -> None:
        while True:
            entry = self._finish_q.get()
            if entry is _SENTINEL:
                return
            group, plan, outs_np, out_hws = entry

            def _one(i):
                msg, task, _fmt, _plan = group.items[i].payload
                try:
                    with span("encode"):
                        res = self.engine.finish_item(group, i, plan,
                                                      outs_np, out_hws)
                except Exception as exc:  # keep the stage thread alive
                    log.error("Finish stage item failed", task_id=task.id,
                              error=str(exc), exc_info=True)
                    res = self.engine._failed(
                        task, f"device error: {exc}", kind=TRANSIENT)
                self._complete(msg, task, res)

            # Submit items INDIVIDUALLY (not pool.map): map's futures are
            # eager, so a submission failure mid-drain can land after some
            # items already completed — a blanket nack-all would then
            # double-release those items' inflight permits, permanently
            # inflating the cap. Per-item submission scopes the recovery
            # to exactly the items whose _one never ran.
            futures: dict[int, object] = {}
            for i in range(len(group.items)):
                try:
                    futures[i] = self.engine._pool.submit(_one, i)
                except Exception as exc:
                    # Pool shut down mid-drain: _one never ran for THIS
                    # item — nack it and release its permit only.
                    log.error("Finish stage submit failed", error=str(exc))
                    self._safe_nack(group.items[i].payload[0])
                    self._inflight.release()
            for i, fut in futures.items():
                try:
                    fut.result()
                except Exception as exc:
                    # _one never raises once it runs (it catches and
                    # completes), so reaching here means it never executed
                    # (e.g. cancelled by shutdown(cancel_futures=True)).
                    log.error("Finish stage item never ran",
                              error=str(exc))
                    self._safe_nack(group.items[i].payload[0])
                    self._inflight.release()

    def _complete(self, msg: BrokerMessage, task: ProcessingTask,
                  eng_res: EngineResult) -> None:
        """Record + ack/nack + publish via the shared Worker logic
        (commit-after-success, worker.go:125-146 semantics), then release
        this message's inflight permit. Never raises."""
        try:
            self._finish_message(msg, task, eng_res)
        except Exception as exc:  # belt-and-braces: keep stages alive
            log.error("Completion failed; leaving message for redelivery",
                      image_id=task.image_id, error=str(exc), exc_info=True)
            self._safe_nack(msg)
        finally:
            self._inflight.release()

    # ------------------------------------------------------------------- run

    def run(self) -> None:
        log.info("Pipelined worker started",
                 batch_size=self.cfg.worker.batch_size,
                 deadline_ms=self.cfg.worker.batch_deadline_ms)
        device_t = threading.Thread(target=self._device_stage,
                                    name="device", daemon=True)
        finish_t = threading.Thread(target=self._finish_stage,
                                    name="finish", daemon=True)
        device_t.start()
        finish_t.start()
        try:
            self._decode_stage()
        finally:
            device_t.join(timeout=60)
            finish_t.join(timeout=60)
        log.info("Pipelined worker stopped gracefully")
