"""Performance telemetry: Mrays/s accounting and jax.profiler hooks.

The reference's only telemetry was an FPS counter (src/state.rs:400-409,
src/dom.rs:145-158 — 50-frame window, 250 ms UI throttle; that part lives in
interact.appstate). The framework metric is Mrays/s, where a "ray" is one
live ray-bounce segment (W·H·spp·avg_depth), counted exactly by the tracer's
live-mask sum rather than estimated.
"""

from __future__ import annotations

import contextlib
import time


def mrays_per_sec(segments: float, seconds: float) -> float:
    return segments / seconds / 1e6 if seconds > 0 else 0.0


class MraysMeter:
    """Accumulates (segments, wall-clock) across render calls."""

    def __init__(self):
        self.segments = 0.0
        self.seconds = 0.0

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            # count the elapsed time even when the block raises (e.g. a
            # device fault retried one level up) — dropping it would
            # overstate Mrays/s
            self.seconds += time.perf_counter() - t0

    def add_segments(self, n: float) -> None:
        self.segments += float(n)

    @property
    def mrays(self) -> float:
        return mrays_per_sec(self.segments, self.seconds)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Optional jax.profiler trace around a render (device timeline in
    TensorBoard). No-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
