"""Profiling & perf observability.

The reference's only instrumentation is a QPC frame timer printed per
frame (RTBase/GamesEngineeringBase.h:900-930,
Main.cpp:112-118).  Here: wall-clock phase timers with rays/sec
reporting plus jax.profiler trace capture for XLA-level analysis.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import jax

from .log import get_logger

_log = get_logger("prof")


class Timer:
    """Accumulating phase timer (device-synchronizing)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            jax.block_until_ready(sync)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, rays: Optional[int] = None) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            line = f"{name}: {total:.3f}s over {n} calls"
            if rays:
                line += f" ({rays * n / total / 1e6:.1f} Mrays/s)"
            lines.append(line)
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str = "/tmp/rtr_trace"):
    """Capture a jax.profiler trace (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
        _log.info("profiler trace written to %s", logdir)


def device_memory_stats() -> dict:
    try:
        return jax.local_devices()[0].memory_stats() or {}
    except Exception:  # pragma: no cover - backend-dependent
        return {}
