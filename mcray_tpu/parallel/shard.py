"""Multi-device execution: scanline-sharded rendering and training.

The parallelism layer the reference lacks entirely (its only
concurrency hooks are two commented-out OpenMP pragmas, reference
src/scene.cpp:74,105; design per SURVEY.md §2.3):

- **Ray/scanline data parallelism**: the R transducer elements are sharded
  over the ``"rays"`` mesh axis with ``jax.shard_map``. Each device traces its
  R/ndev scanlines (x S Monte-Carlo samples) against the replicated scene.
- **Device-local RF accumulation**: a scanline's echoes land only in its own
  RF column (reference add_echo indexes column = ray_i, src/rfimage.h:33-40),
  so with a column-sharded RF image the entire echo accumulation is
  device-local — zero communication in the hot loop.
- **Image assembly**: one tiled ``all_gather`` of the (465 x R/ndev) partial
  RF images (~1 MB) before the dense image post-ops, after a ``ppermute``
  halo exchange for the lateral PSF pass.
- **Gradient communication**: the backward pass of ``psum``-free local work
  produces per-device partials of the tiny (M, 8) material-parameter
  gradient; ``shard_map``'s AD inserts the ``psum`` automatically when the
  loss reduces over gathered results.

The mesh is a flat device list: every collective here is a gather, a
neighbour shift or a sum, which need no particular device topology.

Per-path RNG keys are derived from GLOBAL path ids (simulator.trace_paths),
so the sharded render is bitwise identical to the single-device render.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import SimConfig
from ..models import simulator
from ..ops import imaging
from ..paths import Paths, choose_paths
from ..probe.transducer import element_layout

Array = jax.Array


def _default_paths(pack, cfg: SimConfig) -> Paths:
    return choose_paths(
        jax.default_backend(), pack.n_triangles,
        soft_row_binning=cfg.soft_row_binning,
    )


def make_mesh(n_devices: int | None = None, axis: str = "rays") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def make_mesh_2d(n_rays: int, n_samples: int) -> Mesh:
    """2-D mesh: scanlines x Monte-Carlo samples (SURVEY.md §2.3 long axes:
    scanlines shard device-locally; samples are a pure psum reduction axis)."""
    import numpy as np

    devs = np.asarray(jax.devices()[: n_rays * n_samples]).reshape(n_rays, n_samples)
    return Mesh(devs, ("rays", "samples"))


def _shard_render_body(
    key,
    materials,
    positions,      # (R_local, 3) this device's element positions
    directions,     # (R_local, 3)
    elem_global0,   # (1,) global index of this device's first element
    state: dict[str, Any],  # replicated device state (simulator.scene_state)
    cfg: SimConfig,
    paths: Paths,
    axis: str,
    n_shards: int,
    distributed_imaging: bool,
):
    scan_maps = state["scan_maps"]
    r_local = positions.shape[0]
    s = cfg.samples_per_element
    local_elem = jnp.repeat(jnp.arange(r_local, dtype=jnp.int32), s)
    global_path0 = elem_global0[0].astype(jnp.uint32) * s
    path_ids = global_path0 + jnp.arange(r_local * s, dtype=jnp.uint32)

    segments = simulator.trace_paths(
        key,
        materials,
        jnp.zeros(3),
        jnp.zeros(3),
        state["scene"],
        state["spacing"],
        state["starting_material"],
        cfg,
        paths=paths,
        packed=state["packed"],
        bvh_arrays=state["bvh_arrays"],
        elements=(positions, directions, local_elem, path_ids),
    )
    rf_local = simulator.march(
        segments, materials, state["volume"], cfg, paths, n_cols=r_local
    )
    if distributed_imaging:
        # column-sharded convolution with an (R, l-1) ppermute halo, local
        # envelope, then one all_gather of the finished RF for the polar
        # gather of scan conversion (which is fundamentally cross-column)
        rf_conv_local = imaging.convolve_psf_sharded(rf_local, cfg, axis, n_shards)
        rf_env_local = imaging.apply_envelope(rf_conv_local, cfg)
        rf_env = jax.lax.all_gather(rf_env_local, axis, axis=1, tiled=True)
    else:
        # assemble the full RF image on every device (~1 MB) and run the
        # dense post-ops replicated
        rf_full = jax.lax.all_gather(rf_local, axis, axis=1, tiled=True)
        rf_conv = imaging.convolve_psf(rf_full, cfg)
        rf_env = imaging.apply_envelope(rf_conv, cfg)
    if cfg.log_compression:
        # global max -> needs the gathered image in both branches
        rf_env = imaging.log_compress(rf_env)
    bmode = imaging.scan_convert(rf_env, scan_maps[0], scan_maps[1])
    return bmode, rf_local


def _shard_render_body_2d(
    key,
    materials,
    positions,      # (R_local, 3) this device's elements (sharded over "rays")
    directions,
    elem_global0,   # (R_local,) global element indices
    state,
    cfg: SimConfig,
    axis_r: str,
    axis_s: str,
    n_r: int,
    n_s: int,
    paths: Paths,
):
    """2-D mesh body: scanlines sharded over ``axis_r`` (device-local RF
    columns), Monte-Carlo samples sharded over ``axis_s`` (a pure psum
    reduction of partial RF images — SURVEY.md §2.3 long-axis (c))."""
    scan_maps = state["scan_maps"]
    r_local = positions.shape[0]
    s_global = cfg.samples_per_element
    s_local = s_global // n_s
    my_s = jax.lax.axis_index(axis_s)

    local_elem = jnp.repeat(jnp.arange(r_local, dtype=jnp.int32), s_local)
    # global path id = global_elem * S + (my_s * S_local + local_sample)
    elem_g = jnp.repeat(elem_global0.astype(jnp.uint32), s_local)
    samp_g = (my_s * s_local).astype(jnp.uint32) + jnp.tile(
        jnp.arange(s_local, dtype=jnp.uint32), r_local
    )
    path_ids = elem_g * s_global + samp_g

    segments = simulator.trace_paths(
        key, materials, jnp.zeros(3), jnp.zeros(3), state["scene"],
        state["spacing"], state["starting_material"], cfg,
        paths=paths, packed=state["packed"], bvh_arrays=state["bvh_arrays"],
        elements=(positions, directions, local_elem, path_ids),
    )
    rf_partial = simulator.march(
        segments, materials, state["volume"], cfg, paths, n_cols=r_local
    )
    # samples axis: pure reduction of partial RF images
    rf_local = jax.lax.psum(rf_partial, axis_s)
    rf_conv_local = imaging.convolve_psf_sharded(rf_local, cfg, axis_r, n_r)
    rf_env_local = imaging.apply_envelope(rf_conv_local, cfg)
    rf_env = jax.lax.all_gather(rf_env_local, axis_r, axis=1, tiled=True)
    if cfg.log_compression:
        rf_env = imaging.log_compress(rf_env)
    bmode = imaging.scan_convert(rf_env, scan_maps[0], scan_maps[1])
    return bmode, rf_local


class ShardedRenderer2D:
    """Renderer over a ("rays", "samples") 2-D device mesh."""

    def __init__(self, pack, cfg: SimConfig, mesh: Mesh, seed: int = 0,
                 paths: Paths | None = None):
        self.cfg = cfg
        self.pack = pack
        self.mesh = mesh
        axis_r, axis_s = mesh.axis_names
        n_r = mesh.shape[axis_r]
        n_s = mesh.shape[axis_s]
        if cfg.transducer_elements % n_r or cfg.samples_per_element % n_s:
            raise ValueError("elements/samples must divide the mesh axes")
        self.paths = paths or _default_paths(pack, cfg)
        self._state = simulator.scene_state(pack, cfg, self.paths, seed)
        self.materials = jnp.asarray(pack.materials)
        body = functools.partial(
            _shard_render_body_2d,
            cfg=cfg,
            axis_r=axis_r,
            axis_s=axis_s,
            n_r=n_r,
            n_s=n_s,
            paths=self.paths,
        )
        sharded = jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(), P(), P(axis_r), P(axis_r), P(axis_r), P()),
            out_specs=(P(), P(None, axis_r)),
            check_vma=False,
        )

        @jax.jit
        def _render_jit(key, materials, position, angles, state):
            positions, directions = element_layout(position, angles, cfg)
            elem0 = jnp.arange(cfg.transducer_elements, dtype=jnp.int32)
            return sharded(key, materials, positions, directions, elem0, state)

        self._render = lambda key, m, p, a: _render_jit(key, m, p, a, self._state)

    def render_frame(self, seed: int = 0, materials=None, position=None, angles=None):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
        bmode, rf_local = self._render(
            key,
            self.materials if materials is None else materials,
            jnp.asarray(self.pack.transducer_position if position is None else position),
            jnp.asarray(self.pack.transducer_angles if angles is None else angles),
        )
        return {"bmode": bmode, "rf_raw": rf_local}


class ShardedRenderer:
    """Scanline-sharded frame renderer over a 1-D device mesh. ``paths``
    defaults to ``choose_paths`` for the default backend, as in Simulator."""

    def __init__(
        self,
        pack,
        cfg: SimConfig,
        mesh: Mesh | None = None,
        seed: int = 0,
        distributed_imaging: bool = True,
        paths: Paths | None = None,
    ):
        self.cfg = cfg
        self.pack = pack
        self.mesh = mesh or make_mesh()
        self.axis = self.mesh.axis_names[0]
        n_dev = self.mesh.devices.size
        if cfg.transducer_elements % n_dev:
            raise ValueError(
                f"transducer_elements ({cfg.transducer_elements}) must divide "
                f"evenly over {n_dev} devices"
            )
        self.paths = paths or _default_paths(pack, cfg)
        self._state = simulator.scene_state(pack, cfg, self.paths, seed)
        self.materials = jnp.asarray(pack.materials)

        axis = self.axis
        body = functools.partial(
            _shard_render_body,
            cfg=cfg,
            paths=self.paths,
            axis=axis,
            n_shards=n_dev,
            distributed_imaging=distributed_imaging,
        )
        sharded = jax.shard_map(
            body,
            mesh=self.mesh,
            in_specs=(P(), P(), P(axis), P(axis), P(axis), P()),
            out_specs=(P(), P(None, axis)),
            check_vma=False,
        )

        @jax.jit
        def _render_jit(key, materials, position, angles, state):
            positions, directions = element_layout(position, angles, cfg)
            elem0 = jnp.arange(cfg.transducer_elements, dtype=jnp.int32)
            return sharded(key, materials, positions, directions, elem0, state)

        self._render = lambda key, m, p, a: _render_jit(key, m, p, a, self._state)
        self._render_jit = _render_jit

    def make_train_step(self, optimizer, mask=None):
        """One jitted sharded training step: render under shard_map,
        pixel-MSE loss vs target, backward pass (shard_map AD inserts the
        psum of per-device material-gradient partials), masked
        optimiser update. Returns step(key, materials, opt_state, target,
        position, angles) -> (materials, opt_state, loss)."""
        import numpy as np
        import optax

        mask_np = None if mask is None else np.asarray(mask)
        render_jit = self._render_jit

        @jax.jit
        def step(key, materials, opt_state, target, position, angles, state):
            def loss_fn(m):
                bmode = render_jit(key, m, position, angles, state)[0]
                return jnp.mean((bmode - target) ** 2)

            loss, grads = jax.value_and_grad(loss_fn)(materials)
            if mask_np is not None:
                grads = grads * jnp.asarray(mask_np)
            updates, new_opt = optimizer.update(grads, opt_state, materials)
            new_materials = optax.apply_updates(materials, updates)
            return new_materials, new_opt, loss

        return lambda key, m, o, t, p, a: step(key, m, o, t, p, a, self._state)

    def render_bmode(self, key, materials, position, angles):
        """Jitted sharded render returning just the B-mode (for loss fns)."""
        return self._render(key, materials, position, angles)[0]

    def render_frame(self, seed: int = 0, materials=None, position=None, angles=None):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
        bmode, rf_local = self._render(
            key,
            self.materials if materials is None else materials,
            jnp.asarray(self.pack.transducer_position if position is None else position),
            jnp.asarray(self.pack.transducer_angles if angles is None else angles),
        )
        return {"bmode": bmode, "rf_raw": rf_local}
