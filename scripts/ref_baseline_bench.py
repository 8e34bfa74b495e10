"""Measured CPU baseline: the sequential C++ reference algorithm on this host.

Drives native/ref_baseline.cpp (a single-threaded C++ re-implementation of
the reference's frame loop — trace with BVH closest-hit, segment march with
texture-table lookups, uncentered PSF convolution, peak-lerp envelope, polar
scan conversion) over ctypes on the SAME compiled scene, probe layout, PSF
kernels and scan maps the device path uses: a defensible apples-to-apples
CPU number. The reference itself cannot be built without Bullet/OpenCV dev
libs, and a C++ port of its algorithm at full optimisation is the
charitable stand-in — it even skips the reference's per-call
std::random_device reseeding, so a speedup reported against it is
conservative.

Usage: python scripts/ref_baseline_bench.py [--scene assets/sphere/sphere.scene]
                                            [--frames 5] [--json]
Prints per-stage ms, rays/s (ray-cast queries per second) and frames/s.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mcray_tpu.config import SimConfig
from mcray_tpu.ops import imaging
from mcray_tpu.ops import psf as psf_mod
from mcray_tpu.scene.compile import load_and_compile
from mcray_tpu.utils.native import _LIB_PATH

c_fp = ctypes.POINTER(ctypes.c_float)
c_ip = ctypes.POINTER(ctypes.c_int32)


def _fp(a: np.ndarray):
    return a.ctypes.data_as(c_fp)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="assets/sphere/sphere.scene")
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    if not os.path.exists(_LIB_PATH):
        print("native library missing - run `make -C native` first", file=sys.stderr)
        return 2

    lib = ctypes.CDLL(_LIB_PATH)
    fn = lib.mcray_ref_frame
    fn.restype = ctypes.c_int
    lib.mcray_ref_prepare.restype = ctypes.c_void_p
    lib.mcray_ref_free.argtypes = [ctypes.c_void_p]

    cfg = SimConfig(texture_mode="table")  # the reference's materialised volume
    pack = load_and_compile(args.scene, cfg)

    # probe layout on host via the same pure function the tracer uses
    import jax

    jax.config.update("jax_platforms", "cpu")
    from mcray_tpu.probe.transducer import element_layout

    positions, directions = element_layout(
        pack.transducer_position, pack.transducer_angles, cfg
    )
    positions = np.ascontiguousarray(np.asarray(positions), np.float32)
    directions = np.ascontiguousarray(np.asarray(directions), np.float32)

    # materialised scatterer volume (statistical twin of volume<256,145>)
    rng = np.random.default_rng(args.seed)
    v = cfg.volume_size
    vol_noise = rng.standard_normal((v, v, v), np.float32)
    vol_prob = rng.standard_normal((v, v, v), np.float32)

    ax = psf_mod.axial_kernel_np(cfg)
    lat = psf_mod.lateral_kernel_np(cfg)
    map_row, map_col = imaging.scan_conversion_maps(cfg)

    tris = np.ascontiguousarray(pack.tris, np.float32)
    tri_mid = np.ascontiguousarray(pack.tri_mesh_id, np.int32)
    m_in = np.ascontiguousarray(pack.mesh_mat_inside, np.int32)
    m_out = np.ascontiguousarray(pack.mesh_mat_outside, np.int32)
    vasc = np.ascontiguousarray(pack.mesh_is_vascular, np.uint8)
    mats = np.ascontiguousarray(pack.materials, np.float32)
    spacing = np.ascontiguousarray(pack.spacing, np.float32)

    bmode = np.zeros((cfg.bmode_rows, cfg.bmode_cols), np.float32)
    rf_raw = np.zeros((cfg.rf_rows, cfg.rf_cols), np.float32)
    stage_ms = np.zeros(4, np.float64)
    counters = np.zeros(3, np.int64)

    bvh_handle = lib.mcray_ref_prepare(_fp(tris), ctypes.c_int(pack.n_triangles))

    def run_frame(seed: int):
        rc = fn(
            ctypes.c_void_p(bvh_handle),
            _fp(tris), ctypes.c_int(pack.n_triangles),
            tri_mid.ctypes.data_as(c_ip),
            m_in.ctypes.data_as(c_ip), m_out.ctypes.data_as(c_ip),
            vasc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            _fp(mats), ctypes.c_int(pack.n_materials),
            _fp(positions), _fp(directions), ctypes.c_int(cfg.transducer_elements),
            ctypes.c_int(cfg.samples_per_element), ctypes.c_int(cfg.max_depth),
            ctypes.c_int(pack.starting_material),
            _fp(spacing),
            _fp(vol_noise), _fp(vol_prob), ctypes.c_int(v),
            ctypes.c_float(cfg.resolution_um / 1000.0),
            ctypes.c_float(cfg.transducer_frequency),
            ctypes.c_float(cfg.speed_of_sound),
            ctypes.c_float(float(cfg.max_travel_time_us)),
            ctypes.c_float(cfg.axial_resolution_mm),
            ctypes.c_int(cfg.axial_resolution_um),
            ctypes.c_float(cfg.intensity_epsilon),
            ctypes.c_float(cfg.ray_start_offset),
            _fp(ax), ctypes.c_int(ax.shape[0]), _fp(lat), ctypes.c_int(lat.shape[0]),
            _fp(map_row), _fp(map_col),
            ctypes.c_int(cfg.bmode_rows), ctypes.c_int(cfg.bmode_cols),
            ctypes.c_int(cfg.rf_rows), ctypes.c_uint64(seed),
            _fp(bmode), _fp(rf_raw),
            stage_ms.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            counters.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        )
        assert rc == 0, rc

    run_frame(args.seed)  # warm-up (BVH build happens inside; page-in)
    totals = np.zeros(4, np.float64)
    t0 = time.perf_counter()
    for i in range(args.frames):
        run_frame(args.seed + 1 + i)
        totals += stage_ms
    wall = (time.perf_counter() - t0) / args.frames
    per = totals / args.frames

    rays_per_frame = cfg.transducer_elements * cfg.samples_per_element * cfg.max_depth
    out = {
        "scene": args.scene,
        "workload": f"{cfg.transducer_elements}x{cfg.samples_per_element}x{cfg.max_depth}",
        "triangles": pack.n_triangles,
        "frame_ms": round(wall * 1e3, 2),
        "frames_per_s": round(1.0 / wall, 3),
        "rays_per_s": round(rays_per_frame / wall),
        "stage_ms": {
            "trace": round(per[0], 2),
            "march": round(per[1], 2),
            "conv_envelope": round(per[2], 2),
            "scan_convert": round(per[3], 2),
        },
        "ray_queries": int(counters[0]),
        "collisions": int(counters[1]),
        "segments": int(counters[2]),
        "bmode_nonzero_frac": round(float((bmode != 0).mean()), 4),
        "host": "single-thread C++ -O3 -march=native (see native/ref_baseline.cpp)",
    }
    print(json.dumps(out) if args.json else json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
