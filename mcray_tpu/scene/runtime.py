"""Scene runtime facade — the reference's `scene` class surface, in JAX.

Maps the reference API (reference src/scene.h:19-76) onto the functional
pipeline so users migrating from the C++ find the same entry points:

- ``Scene(config_or_path, cfg)``   ~ scene::scene(json, transducer)
- ``.cast_rays(key, ...)``         ~ scene::cast_rays<S,R>() — returns the
  dense segment tensor (the (D, N, field) equivalent of the reference's
  array<array<vector<segment>,S>,R>)
- ``.step(dt)``                    ~ scene::step — a no-op by design: meshes
  are static mass-0 bodies in the reference too (src/scene.cpp:326-330); the
  dynamic input of the system is the probe pose, which is a per-call argument
  here rather than mutable state.
- ``.distance / .distance_in_mm``  ~ the unit helpers (src/scene.cpp:281-298,
  :342-346), including the reference's spacing-ignoring ``distance``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, SimConfig
from ..models import simulator
from .compile import ScenePack, load_and_compile
from .loader import SceneSpec, load_scene


class Scene:
    def __init__(self, scene_path: str, cfg: SimConfig = DEFAULT_CONFIG, **compile_kw):
        self.cfg = cfg
        self.spec: SceneSpec = load_scene(scene_path)
        self.pack: ScenePack = load_and_compile(scene_path, cfg, **compile_kw)
        self._tables = {k: jnp.asarray(v) for k, v in self.pack.trace_tables().items()}

    # -- reference: scene::cast_rays (src/scene.cpp:50-183) -----------------
    def cast_rays(self, key, materials=None, position=None, angles=None, **trace_kw):
        """Trace all R*S Monte-Carlo paths; returns the segment tensor."""
        return simulator.trace_paths(
            key,
            jnp.asarray(self.pack.materials if materials is None else materials),
            jnp.asarray(self.pack.transducer_position if position is None else position),
            jnp.asarray(self.pack.transducer_angles if angles is None else angles),
            self._tables,
            jnp.asarray(self.pack.spacing),
            jnp.int32(self.pack.starting_material),
            self.cfg,
            **trace_kw,
        )

    # -- reference: scene::step (src/scene.cpp:336-339) ---------------------
    def step(self, delta_time: float) -> None:
        """No-op: scene meshes are static (mass-0) exactly as in the
        reference; probe pose is the dynamic input and is passed per call."""

    # -- reference unit helpers ---------------------------------------------
    def distance(self, a, b):
        """World distance x10 -> mm, ignoring spacing (src/scene.cpp:342-346)."""
        return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) * 10.0)

    def distance_in_mm(self, a, b):
        d = np.abs(np.asarray(a) - np.asarray(b)) * np.asarray(self.pack.spacing)
        return float(np.linalg.norm(d) * 10.0)

    def enlarge(self, versor, mm: float):
        """mm -> world-units vector with per-axis spacing (src/scene.cpp:292-298)."""
        assert float(np.dot(versor, versor)) < 1.1
        return mm / 100.0 * np.asarray(self.pack.spacing) * np.asarray(versor)

    @property
    def materials(self):
        return self.pack.materials

    @property
    def n_triangles(self) -> int:
        return self.pack.n_triangles
