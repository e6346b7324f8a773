"""Kernel-region tracing (SURVEY.md §5 tracing/profiling tier).

The reference brackets each benchmark's kernel region with VTune ITT
pause/resume hooks (`__itt_pause()/__itt_resume()`, fmi.cpp:46-50,229-231)
and PARSEC ROI markers, driven by scripts/vtune.pc.sh.  The equivalent
here is jax.profiler: `roi()` wraps the kernel region in a profiler
trace (written as a TensorBoard/xprof trace) when profiling is enabled,
and `annotate()` marks sub-phases inside it.

Enable via GENOMICS_TRACE_DIR=/path or roi(trace_dir=...).  Disabled,
both are zero-overhead no-ops — mirroring the reference's pause-until-ROI
behavior.
"""

from __future__ import annotations

import contextlib
import os

ENV_VAR = "GENOMICS_TRACE_DIR"


@contextlib.contextmanager
def roi(trace_dir: str | None = None, name: str = "kernel"):
    """Region-of-interest bracket: profile everything inside when enabled."""
    trace_dir = trace_dir or os.environ.get(ENV_VAR)
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        with jax.profiler.TraceAnnotation(name):
            yield


@contextlib.contextmanager
def annotate(name: str):
    """Named sub-phase annotation (shows up in the xprof timeline)."""
    if not os.environ.get(ENV_VAR):
        yield
        return
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


def device_memory_stats() -> dict:
    """Per-device memory usage (the device analog of the peak-RSS reports)."""
    import jax

    out = {}
    for d in jax.local_devices():
        stats = getattr(d, "memory_stats", lambda: None)()
        if stats:
            out[str(d.id)] = {
                "bytes_in_use": stats.get("bytes_in_use", 0),
                "peak_bytes_in_use": stats.get("peak_bytes_in_use", 0),
                "bytes_limit": stats.get("bytes_limit", 0),
            }
    return out
