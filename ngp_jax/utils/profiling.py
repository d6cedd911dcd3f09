"""Tracing/profiling: EMA-smoothed phase meters + jax.profiler hooks.

Equivalent of the reference's scope-guard timers shown in the GUI
(ref: Ema class common.h:253-298; training_prep/train/render meters
testbed.h:867-874). `jax.profiler` traces replace nsight.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict

from ngp_jax.common import EmaMeter


class PhaseTimers:
    """Named EMA wall-clock meters: with timers.scope("train"): ..."""

    def __init__(self, half_life: float = 1.0):
        self.meters: Dict[str, EmaMeter] = {}
        self.half_life = half_life

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            self.meters.setdefault(name, EmaMeter(self.half_life)).update(ms)

    def report(self) -> str:
        return "  ".join(f"{k}={m.value:.1f}ms"
                         for k, m in sorted(self.meters.items()))


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a jax.profiler device trace for TensorBoard/Perfetto."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
