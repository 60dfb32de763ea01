"""Hung-device-step watchdog.

A JAX device call blocks on the runtime: if the device or its driver
wedges, the call never returns, no exception fires, and the worker
becomes a zombie that still answers health checks. The reference has no
analog (its processing is pure in-process CPU work,
image_processor.go:29-182) — this is an accelerator-deployment failure
mode, handled the way production accelerator jobs handle hung
collectives: a watchdog that aborts the process so the supervisor
restarts it. Recovery is then the normal at-least-once path:
broker leases expire (WORKER_LEASE_S) and in-flight messages redeliver.

Usage:
    wd = Watchdog(timeout_s=900)
    with wd.armed("device_step"):
        ...blocking device work...

A section that outlives its deadline triggers the action exactly once:
by default, log CRITICAL, dump every thread's stack to stderr
(faulthandler), and os._exit(70) — sys.exit would only raise in the
monitor thread, and the wedged RPC holds locks that can deadlock a
graceful teardown. Timeout 0 disables arming entirely (zero overhead).
"""

from __future__ import annotations

import faulthandler
import itertools
import os
import sys
import threading
import time
from contextlib import contextmanager

from .logging import get_logger
from .metrics import METRICS

log = get_logger("watchdog")

# Exit code for a watchdog abort (sysexits EX_SOFTWARE): distinguishable
# from clean shutdown (0) and crash signals in supervisor logs.
WATCHDOG_EXIT_CODE = 70


def _default_action(name: str, elapsed_s: float) -> None:
    # Every step before os._exit is best-effort: a broken logger or a
    # wedged/closed stderr must not stop the abort (the whole point of
    # the watchdog is that the process is already unrecoverable).
    try:
        log.critical(
            "Watchdog fired: section exceeded its deadline; aborting so "
            "the supervisor can restart (leased messages redeliver after "
            "WORKER_LEASE_S)", section=name, elapsed_s=round(elapsed_s, 1),
            exit_code=WATCHDOG_EXIT_CODE)
    except Exception:
        pass
    try:
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        sys.stderr.flush()
    except Exception:
        pass
    os._exit(WATCHDOG_EXIT_CODE)


class Watchdog:
    """Deadline monitor for blocking sections.

    Thread-safe; the monitor thread starts lazily on first arm and is a
    daemon (never blocks interpreter exit). `action(name, elapsed_s)`
    runs at most once per Watchdog instance.
    """

    def __init__(self, timeout_s: float, action=None, poll_s: float | None = None):
        self.timeout_s = float(timeout_s)
        self._action = action or _default_action
        self._poll_s = poll_s if poll_s is not None else max(
            0.05, min(5.0, self.timeout_s / 4))
        self._lock = threading.Lock()
        self._sections: dict[int, tuple[str, float]] = {}  # token -> (name, armed_at)
        self._tokens = itertools.count()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._fired = False

    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0

    @contextmanager
    def armed(self, name: str):
        if not self.enabled:
            yield
            return
        token = next(self._tokens)
        with self._lock:
            self._sections[token] = (name, time.monotonic())
            # (Re)start the monitor whenever it is not running: after
            # close() (e.g. the pipelined worker still drains device
            # groups during shutdown — a wedge there must still abort)
            # or after a non-exiting custom action ran on a PREVIOUS
            # instance's thread death. The once-per-instance _fired
            # latch is the only permanent stop.
            if ((self._thread is None or not self._thread.is_alive())
                    and not self._fired):
                self._stop = threading.Event()   # fresh run
                self._thread = threading.Thread(
                    target=self._monitor, name="watchdog", daemon=True)
                self._thread.start()
        try:
            yield
        finally:
            with self._lock:
                self._sections.pop(token, None)

    def close(self) -> None:
        with self._lock:
            self._stop.set()
            # Drop the handle so a later armed() restarts immediately
            # instead of racing the old thread's (stopped) poll loop.
            self._thread = None

    def _monitor(self) -> None:
        while not self._stop.wait(self._poll_s):
            now = time.monotonic()
            expired: tuple[str, float] | None = None
            with self._lock:
                if self._fired:
                    return
                for name, armed_at in self._sections.values():
                    if now - armed_at > self.timeout_s:
                        expired = (name, now - armed_at)
                        self._fired = True
                        break
            if expired is not None:
                try:
                    METRICS.inc("watchdog_fired")
                    self._action(*expired)
                except Exception:
                    # The watchdog only fires when a section is genuinely
                    # wedged; an action that raises (custom action bug,
                    # broken logging) must not leave the process a zombie
                    # with the once-per-instance latch already set —
                    # abort anyway, the guaranteed-abort contract wins.
                    os._exit(WATCHDOG_EXIT_CODE)
                return
