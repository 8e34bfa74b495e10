#!/usr/bin/env python3
"""End-to-end check of the renderer on one NVIDIA GPU, at full width.

    python3 chip_smoke.py                # one card: every phase below
    python3 chip_smoke.py --four-cards   # four cards: the sharded path only

Full width is the reference's acquisition (SimConfig defaults: 512 elements
x 5 paths x 10 bounces, 4.5 MHz, 15 cm) on the sphere scene (2,220
triangles) and the 123k-triangle HD liver scene. Phases, in order, all in
this one process (a second JAX process on the card would find its memory
taken):

  device   the backend must be a GPU; prints the card's nvidia-smi name and
           power limit
  compile  the full-width sphere frame, with compiled.memory_analysis()
  cli      mcray_tpu.cli render of 3 frames on each scene; checks the PNG
  serve    mcray_tpu.cli serve answering three JSON requests
  fit      two MaterialFitter steps on the sphere
  compare  each kernel against the plain jnp path on the card
  timing   end-to-end medians: kernels vs XLA's plain path per cell

Every phase runs even if an earlier one failed; any failure makes the exit
code non-zero and suppresses the final line. On success the last line of
stdout is {"ok": true, "device": {"platform", "kind", "count"}}. PNGs and
the timing table go to chiprun_out/smoke/.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SPHERE = os.path.join(ROOT, "assets", "sphere", "sphere.scene")
HD = os.path.join(ROOT, "assets", "ircad11_hd", "santi-liver-hd.scene")
OUT = os.path.join(ROOT, "chiprun_out", "smoke")
REPS = 5
BATCH = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    """The card's `name, power.limit`, read by a child that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


class Smoke:
    def __init__(self):
        import jax

        from mcray_tpu.config import SimConfig
        from mcray_tpu.scene.compile import load_and_compile

        self.jax = jax
        self.cfg = SimConfig()
        self.packs = {
            "sphere": load_and_compile(SPHERE, self.cfg),
            "hd": load_and_compile(HD, self.cfg),
        }
        self.failed: list[str] = []
        self.results: dict = {}

    # ------------------------------------------------------------------
    def sim(self, scene: str, paths=None, cfg=None):
        from mcray_tpu.models.simulator import Simulator

        return Simulator(self.packs[scene], cfg or self.cfg, paths=paths)

    def gpu_paths(self, scene: str):
        from mcray_tpu.paths import choose_paths

        return choose_paths("gpu", self.packs[scene].n_triangles)

    def plain_paths(self):
        """XLA's plain version of every stage: jnp march, chunked brute force."""
        from mcray_tpu.paths import BRUTE_CHUNK, Paths

        return Paths(intersect="brute", intersect_chunk=BRUTE_CHUNK, march="jnp")

    def run(self, name: str, fn) -> None:
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
            log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            log(f"phase {name}: FAILED")
            self.failed.append(name)

    # ------------------------------------------------------------------
    def phase_compile(self):
        import jax.numpy as jnp

        sim = self.sim("sphere")
        log(f"paths sphere: {sim.paths}")
        log(f"paths hd: {self.gpu_paths('hd')}")
        pack = self.packs["sphere"]
        lowered = self.jax.jit(sim._render_impl).lower(
            self.jax.random.PRNGKey(0), sim.materials,
            jnp.asarray(pack.transducer_position),
            jnp.asarray(pack.transducer_angles), sim._state,
        )
        t0 = time.perf_counter()
        compiled = lowered.compile()
        log(f"compile s: {time.perf_counter() - t0:.1f}")
        log(f"memory_analysis: {compiled.memory_analysis()}")

    def phase_cli(self):
        from mcray_tpu.cli import main as cli_main
        from mcray_tpu.utils.image_io import load_png

        for scene, path in (("sphere", SPHERE), ("hd", HD)):
            out = os.path.join(OUT, f"cli_{scene}.png")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_main([path, "--frames", "3", "--out", out])
            text = buf.getvalue()
            log(text.strip())
            assert rc == 0, f"cli returned {rc}"
            written = out.replace(".png", "_2.png")
            assert f"saved {written}" in text, "printed path is not the written one"
            check_bmode_png(load_png(written), scene)

    def phase_serve(self):
        from mcray_tpu.cli import serve_main

        outs = [os.path.join(OUT, f"serve_{i}.png") for i in range(3)]
        pos = [float(x) for x in self.packs["sphere"].transducer_position]
        requests = [
            {"seed": 1, "out": outs[0]},
            {"position": [pos[0], pos[1] + 0.3, pos[2]], "out": outs[1]},
            {"angles": [0.0, 0.0, 5.0], "seed": 7, "out": outs[2]},
        ]
        stdin = io.StringIO("".join(json.dumps(r) + "\n" for r in requests))
        buf = io.StringIO()
        old_stdin = sys.stdin
        sys.stdin = stdin
        try:
            with contextlib.redirect_stdout(buf):
                rc = serve_main([SPHERE])
        finally:
            sys.stdin = old_stdin
        lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
        log("\n".join(json.dumps(x) for x in lines))
        assert rc == 0
        frames = [x for x in lines if "frame" in x]
        assert [f["out"] for f in frames] == outs, frames
        assert all(os.path.exists(p) for p in outs)

    def fit_setup(self, paths):
        import jax.numpy as jnp
        import numpy as np

        from mcray_tpu.config import SimConfig
        from mcray_tpu.models.trainer import MaterialFitter
        from mcray_tpu.ops import physics

        cfg = SimConfig(soft_scattering=True, trilinear_texture=True)
        sim = self.sim("sphere", paths=paths, cfg=cfg)
        pack = self.packs["sphere"]
        pos = np.asarray(pack.transducer_position, np.float32)
        ang = np.asarray(pack.transducer_angles, np.float32)

        def render(key, materials, state):
            return sim._render_impl(
                key, materials, jnp.asarray(pos), jnp.asarray(ang), state
            )["bmode"]

        key = self.jax.random.PRNGKey(0)
        target = sim._render(key, sim.materials, jnp.asarray(pos), jnp.asarray(ang))["bmode"]
        start = np.array(pack.materials, np.float32)
        liver = 3
        start[liver, physics.ATTENUATION] *= 2.0
        fitter = MaterialFitter(
            render, jnp.asarray(start), target, learning_rate=5e-2,
            trainable=(physics.ATTENUATION,), trainable_rows=[liver],
            fixed_key=key, render_args=(sim._state,),
        )
        return sim, fitter, render, key, target

    def phase_fit(self):
        import numpy as np

        _, fitter, _, _, _ = self.fit_setup(None)
        m0 = np.asarray(fitter.state.materials)
        losses = fitter.run(2, verbose=False)
        m2 = np.asarray(fitter.state.materials)
        log(f"fit losses: {losses}")
        assert np.all(np.isfinite(losses)), losses
        assert np.isfinite(m2).all() and (m2 != m0).any(), "materials did not move"

    # ------------------------------------------------------------------
    def phase_compare(self):
        """Each kernel against XLA's plain version on the card, at full
        width on both scenes. Strict where only the order of float sums
        differs (march, and whole frames that differ only in the march);
        statistical where the listed kernel and the brute force may pick
        different triangles of a shared edge (PERF.md, Findings)."""
        import jax.numpy as jnp
        import numpy as np

        from mcray_tpu.models import simulator as S
        from mcray_tpu.ops.geometry import intersect_closest
        from mcray_tpu.ops.pallas.intersect import intersect_closest_listed
        from mcray_tpu.paths import BRUTE_CHUNK, Paths

        cfg = self.cfg
        jit = self.jax.jit
        report, problems = {}, []

        def check(ok, what):
            if not ok:
                problems.append(what)

        for scene in ("sphere", "hd"):
            pack = self.packs[scene]
            plain = self.sim(scene, paths=self.plain_paths())
            st = plain._state
            segs = jit(
                lambda k, m, s: S.trace_paths(
                    k, m, jnp.asarray(pack.transducer_position),
                    jnp.asarray(pack.transducer_angles), s["scene"], s["spacing"],
                    s["starting_material"], cfg, paths=plain.paths,
                )
            )(self.jax.random.PRNGKey(11), plain.materials, st)

            # march: kernel vs jnp on the same segments
            rf_k = np.asarray(jit(
                lambda sg, m, v: S.march_and_accumulate_pallas(sg, m, v, cfg)
            )(segs, plain.materials, st["volume"]))
            rf_j = np.asarray(jit(
                lambda sg, m, v: S.march_and_accumulate(sg, m, v, cfg)
            )(segs, plain.materials, st["volume"]))
            scale = float(np.abs(rf_j).max())
            err = np.abs(rf_k - rf_j)
            report[f"{scene}_march_max_abs_err"] = float(err.max())
            report[f"{scene}_march_max_rf"] = scale
            n_bad = int((err > 1e-5 * np.abs(rf_j) + 1e-6 * scale).sum())
            report[f"{scene}_march_cells_outside_tol"] = n_bad
            check(n_bad == 0, f"{scene} march")

            # listed intersect vs brute force on every traced query of the
            # frame: each valid segment, re-cast from its start past its end
            valid = np.asarray(segs["valid"]).reshape(-1)
            frm = np.asarray(segs["from"]).reshape(-1, 3)[valid]
            to = np.asarray(segs["to"]).reshape(-1, 3)[valid]
            dire = np.asarray(segs["direction"]).reshape(-1, 3)[valid]
            o = jnp.asarray(frm + cfg.ray_start_offset * dire)
            sv = jnp.asarray((to - frm) * 1.5)
            tris, mid = st["scene"]["tris"], st["scene"]["tri_mesh_id"]
            a = jit(lambda o, s: intersect_closest(o, s, tris, mid, chunk=BRUTE_CHUNK))(o, sv)
            b = jit(intersect_closest_listed)(o, sv, S.pack_clusters(pack))
            hit_a, hit_b = np.asarray(a["hit"]), np.asarray(b["hit"])
            same = (hit_a == hit_b) & np.where(
                hit_a, np.asarray(a["mesh_id"]) == np.asarray(b["mesh_id"]), True
            )
            both = hit_a & hit_b
            dt_max = float(np.abs(np.asarray(a["t"]) - np.asarray(b["t"]))[both].max())
            n_diff = np.abs(np.asarray(a["normal"]) - np.asarray(b["normal"])).max(1)
            report[f"{scene}_intersect_queries"] = int(valid.sum())
            report[f"{scene}_intersect_agree_frac"] = float(same.mean())
            report[f"{scene}_intersect_max_dt"] = dt_max
            report[f"{scene}_intersect_other_facet_frac"] = float((n_diff[both] > 1e-5).mean())
            check(same.mean() >= 0.9999, f"{scene} intersect hit/mesh_id")
            check(dt_max <= 1e-6, f"{scene} intersect t")

            # whole frames, three seeds. march kernel vs jnp with the listed
            # intersect on both sides: only the march's sum order differs
            kernels = self.sim(scene)
            jnp_march = self.sim(scene, paths=Paths(intersect="listed", march="jnp"))
            for seed in (2, 5, 9):
                bm_k = np.asarray(kernels.render_frame(seed)["bmode"])
                bm_m = np.asarray(jnp_march.render_frame(seed)["bmode"])
                bm_p = np.asarray(plain.render_frame(seed)["bmode"])
                tol = 1e-5 + 1e-4 * np.abs(bm_m)
                n_bad = int((np.abs(bm_k - bm_m) > tol).sum())
                report[f"{scene}_bmode_seed{seed}_march_pixels_outside_tol"] = n_bad
                check(n_bad == 0, f"{scene} bmode march seed {seed}")
                # kernels vs all-plain: paths that graze a shared edge may
                # take the other facet's normal and diverge from there
                out = np.abs(bm_k - bm_p) > 1e-5 + 1e-4 * np.abs(bm_p)
                drift = abs(bm_k.mean() - bm_p.mean()) / bm_p.mean()
                report[f"{scene}_bmode_seed{seed}_plain_pixels_outside_tol_frac"] = float(out.mean())
                report[f"{scene}_bmode_seed{seed}_plain_mean_rel_diff"] = float(drift)
                check(out.mean() <= 0.03 and drift <= 0.01,
                      f"{scene} bmode vs plain seed {seed}")
            bm_k2 = np.asarray(kernels.render_frame(9)["bmode"])
            report[f"{scene}_same_seed_bitwise_equal"] = bool(np.array_equal(bm_k, bm_k2))

        # fit gradients: march kernel VJP vs jnp AD, listed intersect on both
        # sides (test_grad_pallas end-to-end tolerance)
        grads = {}
        for label, paths in (("kernels", None),
                             ("jnp_march", Paths(intersect="listed", march="jnp"))):
            _, fitter, render, key, target = self.fit_setup(paths)

            def loss(m, state, render=render, key=key, target=target):
                return jnp.mean((render(key, m, state) - target) ** 2)

            grads[label] = np.asarray(jit(self.jax.grad(loss))(
                fitter.state.materials, fitter.render_args[0]))
        gscale = np.abs(grads["jnp_march"]).max() + 1e-12
        gerr = float(np.abs(grads["kernels"] - grads["jnp_march"]).max() / gscale)
        report["fit_grad_max_norm_err"] = gerr
        check(gerr <= 5e-3, "fit gradients")
        for k, v in report.items():
            log(f"compare {k}: {v}")
        self.results["compare"] = report
        assert not problems, f"outside tolerance: {problems}"

    # ------------------------------------------------------------------
    def timing_variants(self) -> dict:
        """name -> Paths for the timing cells: each kernel against XLA's
        plain version of its stage, the other stage held fixed."""
        from mcray_tpu.paths import BRUTE_CHUNK, Paths

        brute = dict(intersect="brute", intersect_chunk=BRUTE_CHUNK)
        return {
            "kernels": Paths(intersect="listed", march="kernel"),
            "xla_march": Paths(intersect="listed", march="jnp"),
            "xla_intersect": Paths(**brute, march="kernel"),
            "xla_plain": Paths(**brute, march="jnp"),
        }

    def phase_timing(self):
        import numpy as np

        table, failed = {}, []
        for scene in ("sphere", "hd"):
            sims = {name: self.sim(scene, paths=p)
                    for name, p in self.timing_variants().items()}
            for mode in ("single", "batch8"):
                calls = {}
                for name, sim in sims.items():
                    if mode == "single":
                        fn = lambda i, sim=sim: sim.render_frame(seed=i)["bmode"]
                    else:
                        fn = lambda i, sim=sim: sim.render_batch(
                            list(range(i * BATCH, (i + 1) * BATCH)))
                    calls[name] = fn
                cell = f"{scene}_{mode}"
                log(f"timing cell {cell}")
                table[cell] = time_alternating(calls, failed)
                log(f"timing {cell}: " + ", ".join(
                    f"{k} {v:.3f} ms" for k, v in table[cell].items()))
        fit_calls = {}
        for label, paths in (("kernels", None), ("xla_plain", self.plain_paths())):
            _, fitter, _, key, _ = self.fit_setup(paths)
            fit_calls[label] = (
                lambda i, f=fitter, k=key: f._step(f.state.materials, f.state.opt_state, k)[2]
            )
        log("timing cell sphere_fit_step")
        table["sphere_fit_step"] = time_alternating(fit_calls, failed)
        log("timing sphere_fit_step: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in table["sphere_fit_step"].items()))
        self.results["timing_ms_median"] = table
        self.results["timing_failed_variants"] = failed
        assert not failed, f"variants failed: {failed}"
        assert all(np.isfinite(v) for row in table.values() for v in row.values())

    # ------------------------------------------------------------------
    def phase_four_cards(self):
        import jax.numpy as jnp
        import numpy as np
        import optax

        from mcray_tpu.parallel.shard import ShardedRenderer, make_mesh

        assert len(self.jax.devices()) == 4, self.jax.devices()
        report = {}
        for scene in ("sphere", "hd"):
            one = self.sim(scene)
            four = ShardedRenderer(self.packs[scene], self.cfg, mesh=make_mesh(4))
            a = np.asarray(one.render_frame(3)["bmode"])
            b = np.asarray(four.render_frame(3)["bmode"])
            report[f"{scene}_max_abs_err"] = float(np.abs(a - b).max())
            report[f"{scene}_bitwise_equal"] = bool(np.array_equal(a, b))
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
        pack = self.packs["sphere"]
        r = ShardedRenderer(pack, self.cfg, mesh=make_mesh(4))
        opt = optax.adam(1e-2)
        step = r.make_train_step(opt)
        pos = jnp.asarray(pack.transducer_position)
        ang = jnp.asarray(pack.transducer_angles)
        target = r.render_bmode(self.jax.random.PRNGKey(0), r.materials, pos, ang)
        mats, _, loss = step(
            self.jax.random.PRNGKey(1), r.materials, opt.init(r.materials),
            target, pos, ang,
        )
        report["train_step_loss"] = float(loss)
        for k, v in report.items():
            log(f"four_cards {k}: {v}")
        assert np.isfinite(float(loss))
        assert (np.asarray(mats) != np.asarray(r.materials)).any()


def time_alternating(calls: dict, failed: list) -> dict:
    """Median ms per call of each variant: one warm-up (compile) call each,
    then REPS rounds in alternating order, each call ending in
    block_until_ready. A variant whose warm-up raises is logged, appended
    to ``failed`` and left out."""
    import jax

    for name in list(calls):
        t0 = time.perf_counter()
        try:
            jax.block_until_ready(calls[name](0))
        except Exception as e:  # recorded in `failed`; the caller decides
            log(f"  {name}: warm-up failed: {str(e).splitlines()[0][:200]}")
            failed.append(name)
            del calls[name]
            continue
        log(f"  {name}: compiled + first call {time.perf_counter() - t0:.1f} s")
    times = {name: [] for name in calls}
    order = list(calls)
    for r in range(REPS):
        for name in order if r % 2 == 0 else order[::-1]:
            t0 = time.perf_counter()
            jax.block_until_ready(calls[name](r + 1))
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(ts) for name, ts in times.items()}


def check_bmode_png(img, scene: str) -> None:
    """A good frame: not constant, a dark anechoic near field under the
    probe, and speckle in the tissue below it."""
    import numpy as np

    assert img.shape == (400, 500), img.shape
    assert img.max() > img.min(), "constant image"
    sector = img[:, 150:350].astype(np.float64)
    near = sector[:8].mean()
    tissue = sector[150:250]
    lit = tissue[tissue > 0]
    log(f"png {scene}: near-field mean {near:.1f}, tissue lit share "
        f"{lit.size / tissue.size:.2f}, tissue contrast "
        f"{lit.std() / max(lit.mean(), 1e-9):.2f}")
    assert near < 0.5 * tissue.mean(), "near field is not dark"
    assert lit.size > 0.2 * tissue.size, "no speckle in the tissue"
    assert lit.std() > 0.3 * lit.mean(), "tissue has no speckle contrast"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on a 4-card mesh")
    ap.add_argument("--phases", default="compile,cli,serve,fit,compare,timing",
                    help="comma-separated subset of the one-card phases")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    try:
        import mcray_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the mcray_tpu package is not beside this script ({e})",
              file=sys.stderr)
        return 2

    import jax

    from mcray_tpu.cli import _enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    _enable_compilation_cache()
    os.makedirs(OUT, exist_ok=True)
    log(f"== phase device\ndevice_kind: {dev.device_kind}\ncount: {len(jax.devices())}")
    log(gpu_name_and_power())  # name, power.limit: one line per card

    smoke = Smoke()
    if args.four_cards:
        smoke.run("four_cards", smoke.phase_four_cards)
    else:
        for name in args.phases.split(","):
            smoke.run(name, getattr(smoke, f"phase_{name}"))
    with open(os.path.join(OUT, "results.json"), "w") as f:
        json.dump({"failed": smoke.failed, **smoke.results}, f, indent=1)
    if smoke.failed:
        print(f"chip_smoke: failed phases: {smoke.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
