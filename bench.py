"""Benchmark on one GPU — prints ONE JSON line.

Cells: the sphere (2,220 triangles) and HD liver (123,224 triangles) scenes
at full width (512 elements x 5 paths x 10 bounces), each as a single
``render_frame`` and as ``render_batch`` of 8. Per cell: the median
end-to-end ms per call (host clock, ending in block_until_ready) and the
device busy ms per call and idle share from a profiler trace of the GPU.
The line names the device (platform, device_kind, count, nvidia-smi name
and power limit); a device without published peaks in
mcray_tpu.utils.roofline, or no GPU at all, is an error.

    python bench.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SCENES = {
    "sphere": "assets/sphere/sphere.scene",
    "hd": "assets/ircad11_hd/santi-liver-hd.scene",
}
BATCH = 8
REPS = 7


def main() -> int:
    import jax

    from mcray_tpu.cli import _enable_compilation_cache
    from mcray_tpu.config import SimConfig
    from mcray_tpu.models.simulator import Simulator
    from mcray_tpu.scene.compile import load_and_compile
    from mcray_tpu.utils.benchmarking import profile_device
    from mcray_tpu.utils.roofline import peaks

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU, JAX found {dev.platform!r}")
    peaks(dev.device_kind)  # unknown device: error before any timing
    _enable_compilation_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()

    cfg = SimConfig()
    cells = {}
    for scene, path in SCENES.items():
        sim = Simulator(load_and_compile(path, cfg), cfg)
        calls = {
            "single": lambda i: sim.render_frame(seed=i)["bmode"],
            f"batch{BATCH}": lambda i: sim.render_batch(
                list(range(i * BATCH, (i + 1) * BATCH))),
        }
        for mode, fn in calls.items():
            jax.block_until_ready(fn(0))  # compile
            walls = []
            for i in range(REPS):
                t0 = time.perf_counter()
                jax.block_until_ready(fn(i + 1))
                walls.append((time.perf_counter() - t0) * 1e3)
            prof = profile_device(fn, lambda i: (i + 100,), n=5)
            frames = BATCH if mode.startswith("batch") else 1
            cells[f"{scene}_{mode}"] = {
                "wall_ms_median": statistics.median(walls),
                "frames_per_s": frames * 1e3 / statistics.median(walls),
                "device_busy_ms": prof["busy_ms"],
                "idle_share": prof["idle_share"],
                "top_kernels_ms": prof["by_kernel"],
                "paths": str(sim.paths),
            }
    print(json.dumps({
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "nvidia_smi": card,
        "cells": cells,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
