"""Per-stage timing and frame metrics.

The reference's only instrumentation is an fps print (reference
src/scene.cpp:178-180) and unused chrono timestamps (src/main.cpp:87-97).
Here: a metrics registry with wall-clock stage timers, rays/s accounting and
optional jax.profiler trace capture for in-depth device analysis.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict


class FrameMetrics:
    """Accumulates per-stage wall times and counters across frames."""

    def __init__(self):
        self.stage_s: dict[str, float] = defaultdict(float)
        self.stage_n: dict[str, int] = defaultdict(int)
        self.counters: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time a stage; pass a jax array (or pytree) via ``sync`` to block
        on device completion so the time is real, not dispatch."""
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            if sync is not None or "sync" in box:
                import jax

                jax.block_until_ready(box.get("sync", sync))
            self.stage_s[name] += time.perf_counter() - t0
            self.stage_n[name] += 1

    def count(self, name: str, value: float = 1.0):
        self.counters[name] += value

    def summary(self) -> dict:
        out = {}
        for name, total in self.stage_s.items():
            n = max(self.stage_n[name], 1)
            out[f"{name}_ms"] = round(total / n * 1e3, 3)
        frames = self.stage_n.get("frame", 0)
        if frames and "rays" in self.counters:
            total_frame_s = self.stage_s["frame"]
            out["rays_per_s"] = round(self.counters["rays"] / max(total_frame_s, 1e-9))
            out["frames_per_s"] = round(frames / max(total_frame_s, 1e-9), 3)
        out.update({k: v for k, v in self.counters.items()})
        return out

    def report(self) -> str:
        return json.dumps(self.summary())


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard/XProf)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
