"""Command-line frame renderer.

Replaces the reference's blocking interactive driver (reference:
src/main.cpp:42-161, which renders one frame then blocks in cv::waitKey) with
a headless CLI: renders N frames (optionally sweeping probe pose), saves
B-mode PNGs, prints per-stage timings and rays/s.

Usage:
    python -m mcray_tpu.cli path/to/scene.scene --out out.png --frames 1
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import numpy as np

from .config import SimConfig
from .models.simulator import Simulator
from .paths import INTERSECT_PATHS, choose_paths
from .scene.compile import load_and_compile
from .utils.image_io import save_png

# Persistent XLA compile cache when JAX_COMPILATION_CACHE_DIR is not set: one
# fixed directory inside the checkout (listed in .gitignore). The path is
# part of the cache key, so it must not move between runs.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def _force_platform(name: str) -> None:
    # wins over a JAX_PLATFORMS env var as long as no backend is initialised
    jax.config.update("jax_platforms", name)


def compilation_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when it is set, else DEFAULT_CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def _enable_compilation_cache() -> None:
    """Persist XLA compilations across processes: a full-width frame takes
    tens of seconds to compile, a cache hit milliseconds."""
    cache_dir = compilation_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args and args[0] == "fit":
        return fit_main(args[1:])
    if args and args[0] == "sweep":
        return sweep_main(args[1:])
    if args and args[0] == "serve":
        return serve_main(args[1:])
    return render_main(args)


def render_main(argv) -> int:
    p = argparse.ArgumentParser(description="Monte-Carlo ultrasound renderer")
    p.add_argument("scene", help=".scene JSON path (reference schema)")
    p.add_argument("--out", default="bmode.png")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--elements", type=int, default=None, help="override scanline count")
    p.add_argument("--samples", type=int, default=None, help="override MC paths/scanline")
    p.add_argument("--bug-compat", action="store_true", help="replicate reference material-transition bug")
    p.add_argument("--save-rf", default=None, help="also save the raw RF image (npz)")
    p.add_argument("--dump-column", type=int, default=None, metavar="COL",
                   help="print one RF scanline (raw + envelope values per row) "
                        "to stdout — the reference's rf_image::print(column) "
                        "debug dump (src/rfimage.h:166-173)")
    p.add_argument("--platform", default=None, help="force a jax platform (cpu, gpu)")
    p.add_argument("--probe", default=None, choices=["convex", "linear", "phased"],
                   help="probe family (default: convex, the reference's)")
    p.add_argument("--envelope", default=None, choices=["reference", "hilbert"],
                   help="envelope detector (default: reference peak-lerp)")
    p.add_argument("--intersect-mode", default=None, choices=INTERSECT_PATHS,
                   help="closest-hit query: brute (XLA), listed (Pallas "
                        "cluster-list kernel) or bvh (while-loop traversal); "
                        "default: paths.choose_paths for the backend and scene")
    p.add_argument("--scatter-rng", default=None, choices=["boxmuller", "bitsum"],
                   help="per-voxel N(0,1) generator (default: bitsum, the "
                   "transcendental-free dithered binomial; boxmuller = exact "
                   "normals, a different but statistically equivalent "
                   "speckle realisation — see config.scatter_rng)")
    p.add_argument("--texture", default=None, choices=["procedural", "table"],
                   help="scatterer field backend (default: procedural; table "
                        "materialises the reference's voxel-grid layout)")
    args = p.parse_args(argv)

    if args.platform:
        _force_platform(args.platform)
    _enable_compilation_cache()

    overrides = {}
    if args.elements:
        overrides["transducer_elements"] = args.elements
    if args.samples:
        overrides["samples_per_element"] = args.samples
    if args.bug_compat:
        overrides["bug_compat_material_transition"] = True
    if args.probe:
        overrides["probe_type"] = args.probe
    if args.envelope:
        overrides["envelope_mode"] = args.envelope
    if args.texture:
        overrides["texture_mode"] = args.texture
    if args.scatter_rng:
        overrides["scatter_rng"] = args.scatter_rng
    cfg = SimConfig(**overrides)

    t0 = time.perf_counter()
    pack = load_and_compile(args.scene, cfg)
    paths = choose_paths(jax.default_backend(), pack.n_triangles,
                         soft_row_binning=cfg.soft_row_binning,
                         intersect=args.intersect_mode)
    sim = Simulator(pack, cfg, paths=paths, seed=args.seed)
    t_setup = time.perf_counter() - t0
    print(f"scene: {pack.n_triangles} triangles, {pack.n_materials} materials "
          f"(setup {t_setup:.2f}s)")

    out = None
    t_first = t_steady = 0.0
    for i in range(args.frames):
        t0 = time.perf_counter()
        out = sim.render_frame(seed=args.seed + i)
        out["bmode"].block_until_ready()
        dt = time.perf_counter() - t0
        if i == 0:
            t_first = dt
        else:
            t_steady += dt
        rays = sim.rays_per_frame
        print(f"frame {i}: {dt*1e3:.1f} ms  ({rays/dt:,.0f} ray-casts/s)")

    bmode = np.asarray(out["bmode"])
    path = args.out
    if args.frames > 1:
        path = args.out.replace(".png", f"_{args.frames - 1}.png")
    save_png(path, bmode)
    print(f"saved {path}  (min {bmode.min():.3g} max {bmode.max():.3g})")
    if args.save_rf:
        np.savez(args.save_rf, rf_raw=np.asarray(out["rf_raw"]),
                 rf_env=np.asarray(out["rf_env"]), bmode=bmode)
    if args.dump_column is not None:
        col = args.dump_column
        raw = np.asarray(out["rf_raw"])[:, col]
        env = np.asarray(out["rf_env"])[:, col]
        print(f"RF column {col} (row: raw envelope):")
        for r in range(raw.shape[0]):
            print(f"{r:4d}: {raw[r]: .6e} {env[r]: .6e}")

    if args.frames > 1:
        steady = t_steady / (args.frames - 1)
        print(json.dumps({
            "first_frame_s": round(t_first, 4),
            "steady_frame_s": round(steady, 4),
            "fps": round(1.0 / steady, 2),
            "rays_per_s": round(sim.rays_per_frame / steady),
        }))
    return 0


def serve_main(argv) -> int:
    """Interactive render service: the product loop the reference's dead
    input manager aimed at (move probe -> re-render, reference
    src/inputmanager.cpp / SURVEY.md §3.4), as a streaming protocol.

    Reads one JSON request per stdin line:
        {"position": [x,y,z], "angles": [ax,ay,az], "seed": 0, "out": "f.png"}
    (all fields optional; defaults = scene pose, seed auto-increments) and
    writes one JSON response line per frame. Dispatch is pipelined: the next
    request is parsed and dispatched while the previous frame's device work
    drains (JAX async dispatch), so the stream runs at device throughput,
    not at round-trip latency."""
    import jax.numpy as jnp

    p = argparse.ArgumentParser(prog="mcray_tpu.cli serve")
    p.add_argument("scene")
    p.add_argument("--elements", type=int, default=None)
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--platform", default=None)
    p.add_argument("--out-prefix", default="serve")
    args = p.parse_args(argv)
    if args.platform:
        _force_platform(args.platform)
    _enable_compilation_cache()

    overrides = {}
    if args.elements:
        overrides["transducer_elements"] = args.elements
    if args.samples:
        overrides["samples_per_element"] = args.samples
    cfg = SimConfig(**overrides)

    pack = load_and_compile(args.scene, cfg)
    sim = Simulator(pack, cfg)
    pos0 = np.asarray(pack.transducer_position, np.float32)
    ang0 = np.asarray(pack.transducer_angles, np.float32)

    # warm the compile so the first streamed frame is steady-state
    sim.render_frame(seed=0)["bmode"].block_until_ready()
    print(json.dumps({"ready": True, "triangles": pack.n_triangles}), flush=True)

    pending = None  # (bmode_device_array, out_path, t_dispatch, frame_idx)

    def drain(pending):
        bmode, path, t0, idx = pending
        bmode.block_until_ready()
        save_png(path, np.asarray(bmode))
        print(
            json.dumps(
                {
                    "frame": idx,
                    "out": path,
                    "ms": round((time.perf_counter() - t0) * 1e3, 1),
                }
            ),
            flush=True,
        )

    idx = 0
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            pos = jnp.asarray(np.asarray(req.get("position", pos0), np.float32).reshape(3))
            ang = jnp.asarray(np.asarray(req.get("angles", ang0), np.float32).reshape(3))
            seed = int(req.get("seed", idx))
            path = str(req.get("out", f"{args.out_prefix}_{idx:04d}.png"))
            t0 = time.perf_counter()
            out = sim.render_frame(seed=seed, position=pos, angles=ang)
        except Exception as e:  # malformed fields must not kill the stream
            print(json.dumps({"error": f"bad request: {e}"}), flush=True)
            continue
        nxt = (out["bmode"], path, t0, idx)
        # overlap: this frame renders on-device while we write the previous
        if pending is not None:
            drain(pending)
        pending = nxt
        idx += 1
    if pending is not None:
        drain(pending)
    return 0


def sweep_main(argv) -> int:
    """Scripted probe-pose sweep — the product loop the reference stubbed out
    via its dead SFML input manager (reference src/inputmanager.cpp,
    SURVEY.md §3.4): move probe -> re-render, saved as a frame sequence."""
    import jax.numpy as jnp

    p = argparse.ArgumentParser(prog="mcray_tpu.cli sweep")
    p.add_argument("scene")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--delta-pos", type=float, nargs=3, default=[0.0, 0.0, 0.2],
                   help="per-frame probe translation (world units)")
    p.add_argument("--delta-angles", type=float, nargs=3, default=[0.0, 0.0, 0.0],
                   help="per-frame probe rotation (degrees, reference order x,y,z)")
    p.add_argument("--out-prefix", default="sweep")
    p.add_argument("--elements", type=int, default=None)
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--platform", default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.platform:
        _force_platform(args.platform)
    _enable_compilation_cache()

    overrides = {}
    if args.elements:
        overrides["transducer_elements"] = args.elements
    if args.samples:
        overrides["samples_per_element"] = args.samples
    cfg = SimConfig(**overrides)

    pack = load_and_compile(args.scene, cfg)
    sim = Simulator(pack, cfg)
    pos0 = np.asarray(pack.transducer_position, np.float32)
    ang0 = np.asarray(pack.transducer_angles, np.float32)
    dp = np.asarray(args.delta_pos, np.float32)
    da = np.asarray(args.delta_angles, np.float32)

    for i in range(args.frames):
        t0 = time.perf_counter()
        out = sim.render_frame(
            seed=args.seed + i,
            position=jnp.asarray(pos0 + i * dp),
            angles=jnp.asarray(ang0 + i * da),
        )
        out["bmode"].block_until_ready()
        path = f"{args.out_prefix}_{i:03d}.png"
        save_png(path, np.asarray(out["bmode"]))
        print(f"frame {i}: pose {np.round(pos0 + i*dp, 3).tolist()} "
              f"{(time.perf_counter()-t0)*1e3:.1f} ms -> {path}")
    return 0


def fit_main(argv) -> int:
    """Differentiable fit demo: perturb a material parameter, recover it from
    the rendered target by pixel-gradient descent (with checkpoint/resume)."""
    import jax.numpy as jnp

    from .models.trainer import MaterialFitter
    from .ops import physics
    from .utils.checkpoint import load_fit_state, save_fit_state

    cols = {
        "impedance": physics.IMPEDANCE, "attenuation": physics.ATTENUATION,
        "mu0": physics.MU0, "mu1": physics.MU1, "sigma": physics.SIGMA,
    }

    p = argparse.ArgumentParser(prog="mcray_tpu.cli fit")
    p.add_argument("scene")
    p.add_argument("--material", required=True, help="material name to perturb+fit")
    p.add_argument("--param", default="attenuation", choices=sorted(cols))
    p.add_argument("--factor", type=float, default=2.0, help="perturbation factor")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--elements", type=int, default=64)
    p.add_argument("--samples", type=int, default=2)
    p.add_argument("--platform", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.platform:
        _force_platform(args.platform)
    _enable_compilation_cache()

    cfg = SimConfig(
        transducer_elements=args.elements,
        samples_per_element=args.samples,
        soft_scattering=True,
        trilinear_texture=True,
    )
    from .scene.loader import load_scene

    spec = load_scene(args.scene)
    row = spec.material_id(args.material)
    col = cols[args.param]

    pack = load_and_compile(args.scene, cfg)
    # the march kernel carries a custom VJP, so the fit runs on the same
    # paths as rendering
    sim = Simulator(pack, cfg)

    # pose as numpy closures (inlined HLO constants); the simulator's device
    # state rides the fitter's render_args (see simulator.scene_state)
    pos_np = np.asarray(pack.transducer_position, np.float32)
    ang_np = np.asarray(pack.transducer_angles, np.float32)

    def render(key, materials, state):
        out = sim._render_impl(
            key, materials, jnp.asarray(pos_np), jnp.asarray(ang_np), state
        )
        return out["bmode"]

    key = jax.random.PRNGKey(args.seed)
    true_val = float(pack.materials[row, col])
    target = sim._render(key, jnp.asarray(pack.materials),
                         jnp.asarray(pos_np), jnp.asarray(ang_np))["bmode"]

    perturbed = np.array(pack.materials, np.float32)
    perturbed[row, col] *= args.factor
    print(f"{args.material}.{args.param}: true {true_val:.4g}, "
          f"start {perturbed[row, col]:.4g}")

    fitter = MaterialFitter(
        render, jnp.asarray(perturbed), target,
        learning_rate=args.lr, trainable=(col,), trainable_rows=[row],
        fixed_key=key, render_args=(sim._state,),
    )
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        fitter.state = load_fit_state(args.checkpoint, fitter.state)
        print(f"resumed at step {fitter.state.step}")
    losses = fitter.run(args.steps, log_every=max(1, args.steps // 10))
    fitted = float(fitter.state.materials[row, col])
    print(json.dumps({
        "param": f"{args.material}.{args.param}",
        "true": round(true_val, 5),
        "initial": round(float(perturbed[row, col]), 5),
        "fitted": round(fitted, 5),
        "loss_first": round(losses[0], 8),
        "loss_last": round(losses[-1], 8),
    }))
    if args.checkpoint:
        save_fit_state(args.checkpoint, fitter.state)
        print(f"checkpoint -> {args.checkpoint}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
