"""Measurement plumbing: the GPU trace reduction, the peak table, the
compile-cache rule, the PNG codec, and chip_smoke.py's refusal to run
without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from mcray_tpu.utils.benchmarking import reduce_gpu_trace
from mcray_tpu.utils.roofline import PEAKS, StageCost, peaks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _meta(pid, name, tid=None):
    e = {"ph": "M", "pid": pid, "name": "thread_name" if tid is not None
         else "process_name", "args": {"name": name}}
    if tid is not None:
        e["tid"] = tid
    return e


def _x(pid, tid, ts, dur, name):
    return {"ph": "X", "pid": pid, "tid": tid, "ts": ts, "dur": dur, "name": name}


def _synthetic_trace():
    """Two GPU streams with overlapping kernels, a derived 'XLA Modules'
    line that repeats them, and host events that must all be ignored."""
    return {"traceEvents": [
        _meta(1, "/host:CPU"), _meta(1, "python", tid=7),
        _meta(2, "/device:GPU:0"),
        _meta(2, "Stream #13(compute)", tid=13),
        _meta(2, "Stream #14", tid=14),
        _meta(2, "XLA Modules", tid=99),
        _x(1, 7, 0.0, 1000.0, "host_dispatch"),
        _x(2, 13, 100.0, 50.0, "march_fwd"),
        _x(2, 14, 120.0, 60.0, "loop_fusion"),      # overlaps march_fwd
        _x(2, 13, 300.0, 100.0, "march_fwd"),
        _x(2, 99, 100.0, 300.0, "jit_render"),      # derived: not counted
    ]}


def test_reduce_gpu_trace_busy_union_and_kernels():
    r = reduce_gpu_trace(_synthetic_trace(), n_calls=2)
    # union of [100,150) [120,180) [300,400) = 80 + 100 us over 2 calls
    assert r["busy_ms"] == pytest.approx(0.09)
    assert r["kernel_ms"] == pytest.approx(0.105)
    assert r["window_ms"] == pytest.approx(0.15)
    assert r["idle_share"] == pytest.approx(1 - 180 / 300)
    assert r["by_kernel"] == {
        "march_fwd": pytest.approx(0.075), "loop_fusion": pytest.approx(0.03)
    }


def test_reduce_gpu_trace_without_device_events_raises():
    host_only = {"traceEvents": [
        _meta(1, "/host:CPU"), _meta(1, "python", tid=7),
        _x(1, 7, 0.0, 10.0, "work"),
    ]}
    with pytest.raises(ValueError, match="no GPU kernel events"):
        reduce_gpu_trace(host_only)


def test_peak_table_h100():
    pk = peaks("NVIDIA H100 80GB HBM3")
    assert pk["f32_flops"] == 67e12 and pk["hbm_bytes_s"] == 3.35e12
    assert "data sheet" in pk["source"]
    # 1 GFLOP + 3.35 GB: bandwidth-bound at 1 ms
    s = StageCost("x", 1e9, 3.35e9).summarize(2e-3, "NVIDIA H100 80GB HBM3")
    assert s["bound"] == "bandwidth"
    assert s["roofline_ms"] == pytest.approx(1.0)
    assert s["roofline_share"] == pytest.approx(0.5)


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_table_unknown_device_raises(kind):
    assert kind not in PEAKS
    with pytest.raises(ValueError, match="no published peaks"):
        peaks(kind)


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    from mcray_tpu import cli

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cli.compilation_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_inside_checkout(monkeypatch):
    import jax

    from mcray_tpu import cli

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cli.compilation_cache_dir() == os.path.join(ROOT, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        cli._enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == os.path.join(ROOT, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_png_roundtrip(tmp_path):
    from mcray_tpu.utils.image_io import load_png, save_png, to_u8

    img = np.linspace(-0.2, 1.3, 7 * 11).reshape(7, 11)
    path = str(tmp_path / "x.png")
    save_png(path, img)
    np.testing.assert_array_equal(load_png(path), to_u8(img))
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_stage_models_count_their_work():
    from types import SimpleNamespace

    from mcray_tpu.utils.roofline import (
        MARCH_FLOPS_PER_SAMPLE, MT_FLOPS, SLAB_FLOPS, intersect_cost, march_cost,
    )

    cfg = SimpleNamespace(rf_rows=465)
    m = march_cost(cfg, touched_cells=1000, soa_bytes=64, n_cols=512)
    assert m.flops == 1000 * MARCH_FLOPS_PER_SAMPLE
    assert m.hbm_bytes == 64 + 465 * 512 * 4
    # two bounces, 3 and 0 visited (packet, cluster) pairs, 64 rays, 10 clusters
    i = intersect_cost([3, 0], tile_r=32, tile_t=64, n_rays=64, n_clusters=10)
    assert i.flops == 2 * 64 * 10 * SLAB_FLOPS + 3 * (32 * 64 * MT_FLOPS + 32 * SLAB_FLOPS)
    assert i.hbm_bytes == 3 * 9 * 64 * 4 + 2 * (2 * 10 * 4 * 2)
