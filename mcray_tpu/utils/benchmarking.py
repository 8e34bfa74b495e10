"""Device time from a jax.profiler trace of work on the GPU.

``profile_device`` runs a callable under ``jax.profiler.trace`` and reduces
the trace's GPU device planes: the processes named ``/device:GPU:<n>``, and
on them the CUDA stream lines (threads named ``Stream #<n>...``), which hold
one event per kernel or copy the card ran. Derived lines on the same
process (``XLA Modules``, ``XLA Ops``) repeat those intervals and are not
counted. A trace with no such events raises: there is no host fallback.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import tempfile

import jax

DEVICE_PROCESS_PREFIX = "/device:GPU:"
STREAM_THREAD_PREFIX = "Stream #"


def reduce_gpu_trace(trace: dict, n_calls: int = 1) -> dict:
    """Reduce a Chrome-format trace (``*.trace.json.gz`` of jax.profiler) to
    per-call device metrics: ``busy_ms`` (union of kernel intervals over all
    devices and streams), ``kernel_ms`` (sum of kernel durations; above
    busy_ms when streams overlap), ``window_ms`` (first kernel start to last
    kernel end), ``idle_share`` (1 - busy / window over the whole trace) and
    ``by_kernel`` (ms per call of the 12 largest kernels by name)."""
    events = trace["traceEvents"]
    device_pids = {
        e["pid"] for e in events
        if e.get("ph") == "M" and e.get("name") == "process_name"
        and str(e.get("args", {}).get("name", "")).startswith(DEVICE_PROCESS_PREFIX)
    }
    stream_tids = {
        (e["pid"], e["tid"]) for e in events
        if e.get("ph") == "M" and e.get("name") == "thread_name"
        and e.get("pid") in device_pids
        and str(e.get("args", {}).get("name", "")).startswith(STREAM_THREAD_PREFIX)
    }
    kernels = [
        e for e in events
        if e.get("ph") == "X" and (e.get("pid"), e.get("tid")) in stream_tids
    ]
    if not kernels:
        raise ValueError(
            "no GPU kernel events in the trace (no process named "
            f"{DEVICE_PROCESS_PREFIX}* with {STREAM_THREAD_PREFIX}* lines)"
        )
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in kernels)
    busy = 0.0
    cur_start, cur_end = spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = max(end for _, end in spans) - spans[0][0]
    by_kernel = collections.Counter()
    for e in kernels:
        by_kernel[e["name"]] += e.get("dur", 0)
    us_to_ms = 1e-3 / n_calls
    return {
        "busy_ms": busy * us_to_ms,
        "kernel_ms": sum(by_kernel.values()) * us_to_ms,
        "window_ms": window * us_to_ms,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "by_kernel": {k: v * us_to_ms for k, v in by_kernel.most_common(12)},
    }


def profile_device(fn, make_args, n: int = 5, warmup: int = 1) -> dict:
    """Run ``fn(*make_args(i))`` ``n`` times under a profiler trace (after
    ``warmup`` untraced calls) and return ``reduce_gpu_trace`` of it, per
    call."""
    for i in range(warmup):
        jax.block_until_ready(fn(*make_args(-1 - i)))
    tmpdir = tempfile.mkdtemp(prefix="jaxprof_")
    with jax.profiler.trace(tmpdir):
        for i in range(n):
            jax.block_until_ready(fn(*make_args(i)))
    paths = sorted(glob.glob(os.path.join(tmpdir, "plugins/profile/*/*.trace.json.gz")))
    with gzip.open(paths[-1]) as f:
        return reduce_gpu_trace(json.load(f), n_calls=n)
