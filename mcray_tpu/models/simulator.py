"""End-to-end ultrasound simulator: trace -> march -> RF image -> B-mode.

Array-program rebuild of the reference's frame loop (reference: src/main.cpp:92-152
and scene::cast_rays, src/scene.cpp:50-183). Structural translation to XLA:

- the ragged ``array<array<vector<segment>,S>,R>`` becomes a dense
  ``(D, N, field)`` segment tensor with a validity mask (N = R*S paths),
- the per-ray bounce loop becomes one ``lax.scan`` of static depth D over the
  whole path batch,
- the per-segment marching loop becomes a masked (N*D, MAX_STEPS) sample grid
  scatter-added into the RF image in one shot,
- all randomness is keyed (threefry counter PRNG) — one seed renders one
  reproducible frame, vs the reference's per-call std::random_device.

Everything below jit-compiles to a single XLA program; materials, probe pose
and the scatterer field are differentiable inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..config import SimConfig
from ..ops import imaging, physics, texture
from ..ops.bvh import bvh_intersect_closest
from ..ops.geometry import intersect_closest, safe_norm
from ..ops.pallas.intersect import intersect_closest_listed, pack_tris_culled
from ..ops.pallas.march import march_and_accumulate_pallas
from ..paths import Paths, choose_paths
from ..probe.transducer import element_layout

Array = jax.Array

# Segment record field layout (dense equivalent of ray_physics::segment,
# reference src/ray.h:28-36).
SEGMENT_FIELDS = (
    "from",            # (N,3) start of homogeneous span
    "to",              # (N,3) end (inside_point for hits, ray end for misses)
    "direction",       # (N,3)
    "reflected",       # boundary echo intensity (Mattausch Eq. 8 term)
    "initial",         # intensity at segment start (pre-attenuation)
    "attenuation",     # media attenuation
    "distance",        # mm travelled from transducer to segment start
    "media_id",        # i32
    "valid",           # bool
)


def distance_in_mm(a: Array, b: Array, spacing: Array) -> Array:
    """World distance with per-axis spacing, x10 to mm (src/scene.cpp:281-290)."""
    d = jnp.abs(a - b) * spacing
    return safe_norm(d) * 10.0


def trace_paths(
    key: Array,
    materials: Array,          # (M, 8) f32 — differentiable
    probe_position: Array,     # (3,)
    probe_angles_deg: Array,   # (3,)
    scene: dict[str, Any],     # trace_tables() of a ScenePack (+ spacing, start id)
    spacing: Array,            # (3,)
    starting_material: Array,  # scalar i32
    cfg: SimConfig,
    *,
    paths: Paths = Paths(),
    packed=None,
    bvh_arrays: tuple | None = None,
    elements: tuple[Array, Array, Array, Array] | None = None,
) -> dict[str, Array]:
    """Monte-Carlo path tracing for all R*S paths; returns the dense segment
    tensor stacked over bounce depth: each field (D, N, ...).

    ``paths.intersect`` picks the closest-hit query: "brute" (XLA, over
    ``scene["tris"]``), "listed" (Pallas kernel over the ``packed``
    clusters) or "bvh" (while-loop traversal of ``bvh_arrays``).

    ``elements`` overrides the element batch for sharded execution:
    (positions (R_local,3), directions (R_local,3), elem_idx (N_local,) local
    column index, path_ids (N_local,) GLOBAL path ids). Per-path randomness is
    keyed by global path id, so a sharded render is bitwise identical to the
    single-device one.
    """
    n_samples = cfg.samples_per_element
    freq = cfg.transducer_frequency
    eps = cfg.intensity_epsilon

    if elements is None:
        n_rays = cfg.transducer_elements
        positions, directions = element_layout(probe_position, probe_angles_deg, cfg)
        elem_idx = jnp.repeat(jnp.arange(n_rays, dtype=jnp.int32), n_samples)
        path_ids = jnp.arange(n_rays * n_samples, dtype=jnp.uint32)
    else:
        positions, directions, elem_idx, path_ids = elements
    n = elem_idx.shape[0]
    # paths per element in THIS batch (differs from cfg.samples_per_element
    # when the sample axis is sharded)
    local_samples = n // positions.shape[0]
    path_keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, path_ids)

    tris = scene["tris"]
    tri_mesh_id = scene["tri_mesh_id"]
    mesh_in = scene["mesh_mat_inside"]
    mesh_out = scene["mesh_mat_outside"]
    mesh_vasc = scene["mesh_is_vascular"]

    state = {
        "from": jnp.repeat(positions, local_samples, axis=0),
        "dir": jnp.repeat(directions, local_samples, axis=0),
        "media_id": jnp.full((n,), starting_material, jnp.int32),
        "media_outside_id": jnp.full((n,), -1, jnp.int32),
        "intensity": jnp.full((n,), cfg.initial_intensity / n_samples, jnp.float32),
        "distance_mm": jnp.zeros((n,), jnp.float32),
        "alive": jnp.ones((n,), bool),
    }

    # all threefry work batched over (depth, path) in one pass; bitwise
    # identical to deriving per bounce inside the scan
    bounce_draws = physics.draw_bounce_randoms(path_keys, cfg.max_depth)

    # per-mesh inside-thickness, composed on the tiny (n_mesh,) axis so the
    # per-ray lookup below is a single one-hot row (see physics.take_rows)
    thick_by_mesh = physics.take_rows(materials, mesh_in)[:, physics.THICKNESS]

    def bounce(state, draws):
        att = physics.take_rows(
            materials[:, physics.ATTENUATION : physics.ATTENUATION + 1],
            state["media_id"],
        )[:, 0]
        r_length = physics.max_ray_length(
            jnp.maximum(state["intensity"], eps * 1e-3), att, freq, eps
        )
        origin = state["from"] + cfg.ray_start_offset * state["dir"]
        # enlarge(): mm/100 with per-axis spacing (src/scene.cpp:292-298).
        # r_length is detached: it only sets the ray's REACH (a discrete
        # hit/no-hit decision) — the hit point is invariant to the segment
        # scale (t compensates exactly), so its analytic gradient is zero,
        # but computing it in f32 is a catastrophic cancellation of huge
        # log(eps/I)/att^2 terms that amplifies float noise ~1e7x into the
        # material gradients. Detaching removes the noise channel only.
        r_len_ng = jax.lax.stop_gradient(r_length)
        dest = state["from"] + (r_len_ng[:, None] / 100.0) * spacing * state["dir"]
        # dead rays get a zero segment parked far outside every cluster AABB:
        # they can't hit anything (det==0 -> miss), and a packet of dead rays
        # has an empty cluster list in the listed kernel
        alive_col = state["alive"][:, None]
        seg_vec = (dest - origin) * alive_col
        origin = jnp.where(alive_col, origin, 1e9)

        if paths.intersect == "listed":
            hits = intersect_closest_listed(
                origin, seg_vec, packed, interpret=paths.interpret
            )
        elif paths.intersect == "bvh":
            nodes, meta, order = bvh_arrays
            hits = bvh_intersect_closest(
                origin, seg_vec, tris, tri_mesh_id, nodes, meta, order
            )
        else:
            hits = intersect_closest(
                origin, seg_vec, tris, tri_mesh_id, chunk=paths.intersect_chunk
            )
        hit = hits["hit"] & state["alive"]

        # sub-surface penetration fuzz: q ~ |N(0, thickness_inside)|
        # (src/scene.cpp:129-139)
        mesh_id_c = jnp.maximum(hits["mesh_id"], 0)
        thick = physics.take_rows(thick_by_mesh[:, None], mesh_id_c)[:, 0]
        q = jnp.abs(draws["q_normal"] * thick)
        inside_point = hits["point"] + q[:, None] * state["dir"]

        dist_mm = distance_in_mm(state["from"], inside_point, spacing)
        intensity_before = state["intensity"]
        intensity_travelled = intensity_before * physics.travel_attenuation(
            att, dist_mm, freq
        )

        hb = physics.hit_boundary(
            None,
            state["dir"],
            hits["point"],
            hits["normal"],
            intensity_travelled,
            state["media_id"],
            state["media_outside_id"],
            hits["mesh_id"],
            materials,
            mesh_in,
            mesh_out,
            mesh_vasc,
            cfg,
            draws=draws,
        )

        miss = state["alive"] & ~hits["hit"]
        segment = {
            "from": state["from"],
            "to": jnp.where(hit[:, None], inside_point, dest),
            "direction": state["dir"],
            "reflected": jnp.where(hit, hb["back_intensity"], 0.0),
            "initial": intensity_before,
            "attenuation": att,
            "distance": state["distance_mm"],
            "media_id": state["media_id"],
            "valid": hit | miss,
        }

        alive_next = hit & (hb["new_intensity"] > eps)
        if cfg.cull_time_window:
            # the continuation's segment would START at
            # t0 = new_distance_mm * 1000 / c  (segment_march_quantities);
            # t0 >= window means none of its echoes can land in the RF grid
            t0_next = (state["distance_mm"] + dist_mm) * 1000.0 / cfg.speed_of_sound
            alive_next = alive_next & (t0_next < float(cfg.max_travel_time_us))
        new_state = {
            "from": jnp.where(hit[:, None], hb["new_from"], state["from"]),
            "dir": jnp.where(hit[:, None], hb["new_direction"], state["dir"]),
            "media_id": jnp.where(hit, hb["new_media_id"], state["media_id"]),
            "media_outside_id": jnp.where(
                hit, hb["new_media_outside_id"], state["media_outside_id"]
            ),
            "intensity": jnp.where(hit, hb["new_intensity"], state["intensity"]),
            "distance_mm": jnp.where(
                hit, state["distance_mm"] + dist_mm, state["distance_mm"]
            ),
            "alive": alive_next,
        }
        return new_state, segment

    _, segments = jax.lax.scan(bounce, state, bounce_draws)
    segments["element"] = jnp.broadcast_to(elem_idx, (cfg.max_depth, n))
    return segments


def segment_march_quantities(segments: dict[str, Array], materials: Array, cfg: SimConfig):
    """Shared derived quantities of the march loop (used by both the jnp
    scatter path and the Pallas kernel packing, keeping their formulas in
    lockstep): steps (float), start time t0 [us], ln attenuation-per-step,
    per-segment material scattering params."""
    axres = cfg.axial_resolution_mm
    # scene::distance ignores spacing (src/scene.cpp:342-346)
    seg_len = safe_norm(segments["to"] - segments["from"]) * 10.0
    steps = jnp.floor(seg_len / axres)
    t0 = segments["distance"] * 1000.0 / cfg.speed_of_sound
    ln_att_step = -segments["attenuation"] * axres * 0.01 * cfg.transducer_frequency
    rows = physics.take_rows(materials, segments["media_id"])
    mu0 = rows[..., physics.MU0]
    mu1 = rows[..., physics.MU1]
    sigma = rows[..., physics.SIGMA]
    return steps, t0, ln_att_step, mu0, mu1, sigma


def march_and_accumulate(
    segments: dict[str, Array],
    materials: Array,
    volume: dict[str, Array],
    cfg: SimConfig,
    n_cols: int | None = None,
) -> Array:
    """Segment marching + echo scatter-add (reference main loop,
    src/main.cpp:106-141) as one masked dense grid."""
    d, n = segments["valid"].shape
    flat = {k: v.reshape((d * n,) + v.shape[2:]) for k, v in segments.items()}

    axres = cfg.axial_resolution_mm
    t_window = float(cfg.max_travel_time_us)
    dt = cfg.march_dt_us
    max_steps = cfg.max_march_steps

    steps_f, t0, ln_att_step, mu0, mu1, sigma = segment_march_quantities(
        flat, materials, cfg
    )
    steps = steps_f.astype(jnp.int32)

    k = jnp.arange(max_steps, dtype=jnp.float32)[None, :]  # (1, K)
    t_k = t0[:, None] + k * dt
    live = (k < steps[:, None]) & (t_k < t_window) & flat["valid"][:, None]

    points = (
        flat["from"][:, None, :]
        + (k * axres)[..., None] * flat["direction"][:, None, :]
    )  # (DN, K, 3)
    # exp(k * ln(step_factor)) instead of pow: same math, cheaper XLA
    # lowering, and formula-identical to the Pallas march kernel
    intens = flat["initial"][:, None] * jnp.exp(ln_att_step[:, None] * k)
    scat = texture.get_scattering(
        volume,
        mu1[:, None] * jnp.ones_like(t_k),
        mu0[:, None] * jnp.ones_like(t_k),
        sigma[:, None] * jnp.ones_like(t_k),
        points,
        cfg,
    )
    values = intens * scat

    cols = jnp.broadcast_to(flat["element"][:, None], t_k.shape)

    # boundary echo at t0 + dt*(steps-1); steps==0 underflows to a dropped
    # row in the reference (unsigned wrap, src/main.cpp:139) -> mask it out.
    s = cfg.samples_per_element
    b_time = t0 + dt * (steps.astype(jnp.float32) - 1.0)
    b_valid = flat["valid"] & (steps >= 1)
    b_vals = flat["reflected"] / s

    all_cols = jnp.concatenate([cols.reshape(-1), flat["element"]])
    all_vals = jnp.concatenate([values.reshape(-1), b_vals])
    all_valid = jnp.concatenate([live.reshape(-1), b_valid])
    all_times = jnp.concatenate([t_k.reshape(-1), b_time])
    if cfg.soft_row_binning:
        # differentiable two-row split: d(RF)/d(time) flows (probe pose AD)
        return imaging.accumulate_echoes_soft(
            all_times, all_cols, all_vals, all_valid, cfg, n_cols
        )
    all_rows = imaging.time_to_row(all_times, cfg)
    return imaging.accumulate_echoes(all_rows, all_cols, all_vals, all_valid, cfg, n_cols)


def march(segments, materials, volume, cfg: SimConfig, paths: Paths,
          n_cols: int | None = None) -> Array:
    """RF image of a segment tensor by ``paths.march``: the Pallas kernel or
    the jnp scatter path."""
    if paths.march == "kernel":
        return march_and_accumulate_pallas(
            segments, materials, volume, cfg, n_cols, interpret=paths.interpret
        )
    return march_and_accumulate(segments, materials, volume, cfg, n_cols)


def render(
    key: Array,
    materials: Array,
    probe_position: Array,
    probe_angles_deg: Array,
    scene: dict[str, Any],
    spacing: Array,
    starting_material: Array,
    volume: dict[str, Array],
    scan_maps: tuple[Array, Array],
    cfg: SimConfig,
    paths: Paths = Paths(),
    packed=None,
    bvh_arrays: tuple | None = None,
) -> dict[str, Array]:
    """Full frame: returns bmode (bmode_rows, bmode_cols) plus intermediates."""
    k_trace = jax.random.fold_in(key, 0)
    segments = trace_paths(
        k_trace,
        materials,
        probe_position,
        probe_angles_deg,
        scene,
        spacing,
        starting_material,
        cfg,
        paths=paths,
        packed=packed,
        bvh_arrays=bvh_arrays,
    )
    rf_raw = march(segments, materials, volume, cfg, paths)
    rf_conv = imaging.convolve_psf(rf_raw, cfg)
    rf_env = imaging.apply_envelope(rf_conv, cfg)
    if cfg.log_compression:
        rf_env = imaging.log_compress(rf_env)
    bmode = imaging.scan_convert(rf_env, scan_maps[0], scan_maps[1])
    return {
        "bmode": bmode,
        "rf_raw": rf_raw,
        "rf_conv": rf_conv,
        "rf_env": rf_env,
        "segments_valid": segments["valid"],
    }


def pack_clusters(pack):
    """The listed kernel's triangle clusters for a ScenePack: SAH BVH leaf
    order (when the pack has a BVH), nearest clusters to the probe first."""
    return pack_tris_culled(
        pack.tris,
        pack.tri_mesh_id,
        pack.bvh.tri_order if pack.bvh is not None else None,
        sort_origin=pack.transducer_position,
    )


def scene_state(pack, cfg: SimConfig, paths: Paths, seed: int) -> dict[str, Any]:
    """Every device array a render needs, as one pytree: the scene tables,
    the scatterer volume, the scan-conversion maps, and the packed clusters
    or BVH arrays when ``paths.intersect`` reads them. Renderers pass it to
    their jitted functions as an argument rather than closing over it, so
    the arrays are not baked into the executables as constants."""
    maps = imaging.scan_conversion_maps(cfg)
    packed = bvh_arrays = None
    if paths.intersect == "listed":
        packed = pack_clusters(pack)
    elif paths.intersect == "bvh":
        if pack.bvh is None:
            raise ValueError("the bvh intersect path needs a pack compiled "
                             "with_bvh=True")
        b = pack.bvh
        bvh_arrays = (
            jnp.asarray(b.nodes), jnp.asarray(b.meta), jnp.asarray(b.tri_order)
        )
    return {
        "scene": {k: jnp.asarray(v) for k, v in pack.trace_tables().items()},
        "spacing": jnp.asarray(pack.spacing),
        "starting_material": jnp.int32(pack.starting_material),
        "volume": texture.make_texture_volume(
            jax.random.PRNGKey(seed ^ 0x5CA77E7), cfg
        ),
        "scan_maps": (jnp.asarray(maps[0]), jnp.asarray(maps[1])),
        "packed": packed,
        "bvh_arrays": bvh_arrays,
    }


class Simulator:
    """Convenience wrapper binding a compiled scene + config into jitted
    render / rays-per-second entry points.

    ``paths`` defaults to ``choose_paths`` for the default backend and the
    scene's triangle count; ``use_bvh=True`` (CLI --bvh) swaps in the
    while-loop BVH intersect."""

    def __init__(
        self,
        pack,
        cfg: SimConfig,
        *,
        paths: Paths | None = None,
        use_bvh: bool = False,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.pack = pack
        if paths is None:
            paths = choose_paths(
                jax.default_backend(), pack.n_triangles,
                soft_row_binning=cfg.soft_row_binning,
            )
        if use_bvh:
            paths = dataclasses.replace(paths, intersect="bvh")
        self.paths = paths
        self._state = scene_state(pack, cfg, paths, seed)
        self.materials = jnp.asarray(pack.materials)

        def _render_impl(key, materials, pos, ang, state):
            return render(
                key,
                materials,
                pos,
                ang,
                state["scene"],
                state["spacing"],
                state["starting_material"],
                state["volume"],
                state["scan_maps"],
                cfg,
                paths=paths,
                packed=state["packed"],
                bvh_arrays=state["bvh_arrays"],
            )

        _render_jit = jax.jit(_render_impl)
        self._render = lambda key, m, p, a: _render_jit(key, m, p, a, self._state)
        self._render_impl = _render_impl  # closure-free; for nested jits

        @jax.jit
        def _render_batch(keys, materials, pos, ang, state):
            return jax.vmap(
                lambda k: _render_impl(k, materials, pos, ang, state)["bmode"]
            )(keys)

        self._render_batch = lambda keys, m, p, a: _render_batch(
            keys, m, p, a, self._state
        )

        # latency path: only a seed scalar goes host -> device per frame;
        # pose/materials stay device-resident and ride the argument pytree
        _pos0 = jnp.asarray(pack.transducer_position)
        _ang0 = jnp.asarray(pack.transducer_angles)
        _mat0 = self.materials

        @jax.jit
        def _render_seeded_jit(seed, materials, pos, ang, state):
            key = jax.random.PRNGKey(seed)
            return _render_impl(key, materials, pos, ang, state)

        self._render_seeded = lambda seed: _render_seeded_jit(
            seed, _mat0, _pos0, _ang0, self._state
        )

    def render_batch(self, seeds, materials=None, position=None, angles=None):
        """Render many MC frames in ONE device call (vmap over seeds) —
        amortises per-call dispatch; the throughput mode for sweeps, MC
        averaging and serving. Returns (B, H, W)."""
        keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
        return self._render_batch(
            keys,
            self.materials if materials is None else materials,
            jnp.asarray(self.pack.transducer_position if position is None else position),
            jnp.asarray(self.pack.transducer_angles if angles is None else angles),
        )

    def render_compound(self, seeds, **kw):
        """Variance-reduced B-mode: average of independent Monte-Carlo frames
        (speckle compounding). One device call via render_batch."""
        return self.render_batch(seeds, **kw).mean(axis=0)

    def render_frame(self, seed: int = 0, materials=None, position=None, angles=None):
        """Single-frame render. The hot path (no per-call overrides) ships ONE
        int32 scalar to the device — the key is derived inside the jit and the
        pose/materials live device-resident."""
        if materials is None and position is None and angles is None:
            return self._render_seeded(jnp.int32(seed))
        key = jax.random.PRNGKey(seed)
        return self._render(
            key,
            self.materials if materials is None else materials,
            jnp.asarray(self.pack.transducer_position if position is None else position),
            jnp.asarray(self.pack.transducer_angles if angles is None else angles),
        )

    @property
    def rays_per_frame(self) -> int:
        """Traced path-bounce queries per frame (the reference's rayTest
        count upper bound, src/scene.cpp:75-117)."""
        return (
            self.cfg.transducer_elements
            * self.cfg.samples_per_element
            * self.cfg.max_depth
        )
