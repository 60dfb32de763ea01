"""Stage tracing: lightweight spans + jax.profiler integration.

The reference has no tracing subsystem (SURVEY.md §5) — only log-line
durations. Here every pipeline stage can be wrapped in `span(...)`, which
feeds the metrics histograms AND annotates the device trace when a
profiler capture is active, so host stages line up with device timelines in
TensorBoard/Perfetto.

    with span("decode"):
        ...
    with profile_capture("/tmp/trace"):   # writes a jax.profiler trace
        engine.process_tasks(batch)
"""

from __future__ import annotations

import contextlib
import time

from imageprocessor_tpu.utils.metrics import METRICS


@contextlib.contextmanager
def span(name: str):
    """Time a host stage; visible in metrics and in device traces."""
    try:
        import jax.profiler

        annotation = jax.profiler.TraceAnnotation(name)
    except Exception:  # pragma: no cover — profiler unavailable
        annotation = contextlib.nullcontext()
    start = time.monotonic()
    with annotation:
        try:
            yield
        finally:
            METRICS.observe(f"span_{name}_ms",
                            (time.monotonic() - start) * 1000.0)


@contextlib.contextmanager
def profile_capture(log_dir: str):
    """Capture a jax.profiler trace around a block (host + device)."""
    import jax.profiler

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
