"""Scene compiler: SceneSpec -> packed device arrays (ScenePack).

The array-program analogue of the reference's Bullet world construction
(reference: src/scene.cpp:38-48, :300-334): instead of per-mesh
btBvhTriangleMeshShape objects behind pointers, the whole scene becomes one
flat SoA triangle soup in world space plus small per-mesh/material tables,
ready for vectorised intersection and `lax.scan` traversal. The per-mesh
transform matches Bullet exactly: local scaling then translation to
``deltas * scaling^2 + origin`` (src/scene.cpp:313-324).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np

from ..config import SimConfig
from ..ops.bvh import build_bvh, FlatBVH
from .loader import SceneSpec, load_scene
from .obj import load_obj
from . import primitives


@dataclasses.dataclass
class ScenePack:
    """Packed scene, all numpy on host; fields are pytree-able to device."""

    tris: np.ndarray            # (T, 3, 3) f32 world-space triangles
    tri_mesh_id: np.ndarray     # (T,) i32
    materials: np.ndarray       # (M, 8) f32 rows: [Z, att, mu0, mu1, sigma, spec, shin, thick]
    mesh_mat_inside: np.ndarray   # (K,) i32 material id
    mesh_mat_outside: np.ndarray  # (K,) i32
    mesh_is_vascular: np.ndarray  # (K,) bool
    starting_material: int
    transducer_position: np.ndarray  # (3,) f32
    transducer_angles: np.ndarray    # (3,) f32 degrees
    spacing: np.ndarray              # (3,) f32
    bvh: FlatBVH | None = None

    @property
    def n_triangles(self) -> int:
        return int(self.tris.shape[0])

    @property
    def n_materials(self) -> int:
        return int(self.materials.shape[0])

    def trace_tables(self) -> dict[str, Any]:
        """The static (non-differentiable) arrays the tracer closes over."""
        return {
            "tris": self.tris,
            "tri_mesh_id": self.tri_mesh_id,
            "mesh_mat_inside": self.mesh_mat_inside,
            "mesh_mat_outside": self.mesh_mat_outside,
            "mesh_is_vascular": self.mesh_is_vascular,
        }


def compile_scene(
    spec: SceneSpec,
    cfg: SimConfig | None = None,
    *,
    asset_dir: str | None = None,
    with_bvh: bool = True,
) -> ScenePack:
    del cfg  # compilation is config-independent today; kept for future LOD
    asset_dir = asset_dir or spec.working_dir

    all_tris = []
    all_mid = []
    inside, outside, vascular = [], [], []
    for k, mesh in enumerate(spec.meshes):
        path = os.path.join(asset_dir, mesh.filename)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"mesh asset {path} not found; generate fixtures with "
                "mcray_tpu.scene.primitives.ensure_assets / ensure_ircad_assets"
            )
        verts, faces = load_obj(path)
        s = spec.scaling
        pos = np.asarray(mesh.deltas, np.float32) * s * s + np.asarray(spec.origin, np.float32)
        world = verts * s + pos
        tris = world[faces]  # (F, 3, 3)
        all_tris.append(tris.astype(np.float32))
        all_mid.append(np.full((tris.shape[0],), k, np.int32))
        inside.append(spec.material_id(mesh.material))
        outside.append(spec.material_id(mesh.outside_material))
        vascular.append(mesh.is_vascular)

    tris = np.concatenate(all_tris, 0) if all_tris else np.zeros((0, 3, 3), np.float32)
    tri_mesh_id = np.concatenate(all_mid, 0) if all_mid else np.zeros((0,), np.int32)

    pack = ScenePack(
        tris=tris,
        tri_mesh_id=tri_mesh_id,
        materials=np.asarray([m.as_row() for m in spec.materials], np.float32),
        mesh_mat_inside=np.asarray(inside, np.int32),
        mesh_mat_outside=np.asarray(outside, np.int32),
        mesh_is_vascular=np.asarray(vascular, bool),
        starting_material=spec.material_id(spec.starting_material),
        transducer_position=np.asarray(spec.transducer_position, np.float32),
        transducer_angles=np.asarray(spec.transducer_angles, np.float32),
        spacing=np.asarray(spec.spacing, np.float32),
    )
    if with_bvh and tris.shape[0] > 0:
        pack.bvh = build_bvh(tris, tri_mesh_id)
    return pack


def load_and_compile(scene_path: str, cfg: SimConfig | None = None, **kw) -> ScenePack:
    spec = load_scene(scene_path)
    # Auto-generate phantom assets for the shipped example scenes.
    asset_dir = kw.pop("asset_dir", None) or spec.working_dir
    needed = {m.filename for m in spec.meshes}
    missing = [f for f in needed if not os.path.exists(os.path.join(asset_dir, f))]
    if missing:
        if {"BOX.obj", "SPHERE.obj"} & set(missing):
            primitives.ensure_assets(asset_dir)
        elif "mega" in os.path.basename(os.path.normpath(asset_dir)):
            # ~620k-tri phantom set for the mega full-frame scene
            primitives.ensure_ircad_mega_assets(asset_dir)
        elif "hd" in os.path.basename(os.path.normpath(asset_dir)):
            # high-poly (~125k tris) phantom set for *_hd scenes
            primitives.ensure_ircad_hd_assets(asset_dir)
        else:
            primitives.ensure_ircad_assets(asset_dir)
    return compile_scene(spec, cfg, asset_dir=asset_dir, **kw)
