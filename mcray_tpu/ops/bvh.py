"""Flat BVH: host-side build, device-side traversal.

Array-program replacement for Bullet's btBvhTriangleMeshShape + btDbvtBroadphase
(reference: src/scene.cpp:306-309, :115-117). The *builder* runs on host —
in C++ (native/mcray_native.cpp, binned SAH) when built, else this numpy
median-split fallback — and emits a pointerless flat array layout:

- ``nodes``  (N, 6) f32: [min.x,min.y,min.z, max.x,max.y,max.z]
- ``meta``   (N, 2) i32: inner node -> (right_child_index, -1), left child is
  implicitly ``i + 1`` (depth-first layout); leaf -> (first, count) into
  ``tri_order``.
- ``tri_order`` (T,) i32 permutation grouping each leaf's triangles
  contiguously.

Traversal on device is a fixed-size explicit stack inside
``lax.while_loop`` — compiler-friendly control flow instead of pointer
chasing. The brute-force path in ops/geometry.py remains the default for
small scenes (dense streaming beats divergent traversal there).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.native import get_native
from .geometry import NO_HIT_T, _moller_trumbore, normalize

STACK_DEPTH = 64


@dataclasses.dataclass
class FlatBVH:
    nodes: np.ndarray      # (N, 6) f32
    meta: np.ndarray       # (N, 2) i32
    tri_order: np.ndarray  # (T,) i32


def build_bvh(tris: np.ndarray, tri_mesh_id: np.ndarray | None = None, leaf_size: int = 4) -> FlatBVH:
    del tri_mesh_id  # ids are looked up through tri_order at traversal time
    native = get_native()
    if native is not None:
        out = native.build_bvh(np.asarray(tris, np.float32), leaf_size)
        if out is not None:
            nodes, meta, order = out
            return FlatBVH(nodes=nodes, meta=meta, tri_order=order)
    return _build_bvh_py(np.asarray(tris, np.float32), leaf_size)


def _build_bvh_py(tris: np.ndarray, leaf_size: int) -> FlatBVH:
    t = tris.shape[0]
    lo = tris.min(axis=1)  # (T,3)
    hi = tris.max(axis=1)
    centroid = (lo + hi) * 0.5

    nodes: list[list[float]] = []
    meta: list[list[int]] = []
    order: list[int] = []

    def emit(idx: np.ndarray) -> int:
        my = len(nodes)
        bmin = lo[idx].min(axis=0)
        bmax = hi[idx].max(axis=0)
        nodes.append([*bmin, *bmax])
        meta.append([0, 0])  # patched below
        if idx.size <= leaf_size:
            meta[my] = [len(order), idx.size]
            order.extend(int(i) for i in idx)
            return my
        c = centroid[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        key = c[:, axis]
        part = np.argsort(key, kind="stable")
        half = idx.size // 2
        left, right = idx[part[:half]], idx[part[half:]]
        emit(left)  # left child == my + 1
        right_idx = emit(right)
        meta[my] = [right_idx, -1]
        return my

    if t == 0:
        return FlatBVH(
            nodes=np.zeros((1, 6), np.float32),
            meta=np.array([[0, 0]], np.int32),
            tri_order=np.zeros((0,), np.int32),
        )
    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        emit(np.arange(t))
    finally:
        sys.setrecursionlimit(old)
    return FlatBVH(
        nodes=np.asarray(nodes, np.float32),
        meta=np.asarray(meta, np.int32),
        tri_order=np.asarray(order, np.int32),
    )


# ---------------------------------------------------------------------------
# Device traversal
# ---------------------------------------------------------------------------


def _slab_test(origin, inv_seg, bmin, bmax, t_best):
    """Segment-vs-AABB slab test; True if the box can contain a closer hit."""
    t0 = (bmin - origin) * inv_seg
    t1 = (bmax - origin) * inv_seg
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    enter = jnp.max(tmin)
    leave = jnp.min(tmax)
    return (enter <= leave) & (leave > 0.0) & (enter < jnp.minimum(t_best, 1.0))


def bvh_intersect_closest(
    origins: jax.Array,
    seg_vecs: jax.Array,
    tris: jax.Array,
    tri_mesh_id: jax.Array,
    nodes: jax.Array,
    meta: jax.Array,
    tri_order: jax.Array,
    *,
    leaf_size: int = 4,
):
    """Closest-hit query via stack traversal; same contract as
    geometry.intersect_closest. vmapped over rays."""
    # Pre-gather leaf triangles in BVH order so leaves are contiguous gathers.
    tris_o = tris[tri_order]
    v0 = tris_o[:, 0]
    e1 = tris_o[:, 1] - tris_o[:, 0]
    e2 = tris_o[:, 2] - tris_o[:, 0]
    mid_o = tri_mesh_id[tri_order]
    t_total = tris_o.shape[0]

    def one_ray(origin, seg):
        inv_seg = jnp.where(jnp.abs(seg) > 1e-30, 1.0 / seg, 1e30)

        def cond(state):
            sp, _, _, _ = state
            return sp > 0

        def body(state):
            sp, stack, best_t, best_i = state
            sp = sp - 1
            node = stack[sp]
            bmin = jax.lax.dynamic_slice(nodes, (node, 0), (1, 3))[0]
            bmax = jax.lax.dynamic_slice(nodes, (node, 3), (1, 3))[0]
            hit_box = _slab_test(origin, inv_seg, bmin, bmax, best_t)
            m = jax.lax.dynamic_slice(meta, (node, 0), (1, 2))[0]
            is_leaf = m[1] >= 0

            # masked, not lax.cond: under vmap a cond with a per-ray
            # predicate turns into a select that broadcasts every operand it
            # closes over (the whole triangle table) to the batch
            visit = hit_box & is_leaf
            first = m[0]

            def tri_body(k, carry):
                bt, bi = carry
                j = jnp.clip(first + k, 0, t_total - 1)
                t, valid = _moller_trumbore(origin, seg, v0[j], e1[j], e2[j])
                valid = valid & visit & (k < m[1]) & (t < bt)
                return (jnp.where(valid, t, bt), jnp.where(valid, j, bi))

            best_t, best_i = jax.lax.fori_loop(
                0, leaf_size, tri_body, (best_t, best_i)
            )
            push_children = hit_box & ~is_leaf
            # Push right child then left so left (node+1) pops first.
            pushed = jax.lax.dynamic_update_index_in_dim(
                jax.lax.dynamic_update_index_in_dim(stack, m[0], sp, 0),
                node + 1,
                sp + 1,
                0,
            )
            stack = jnp.where(push_children, pushed, stack)
            sp = jnp.where(push_children, sp + 2, sp)
            return (sp, stack, best_t, best_i)

        stack = jnp.zeros((STACK_DEPTH,), jnp.int32)
        state = (jnp.int32(1), stack, jnp.float32(NO_HIT_T), jnp.int32(0))
        _, _, best_t, best_i = jax.lax.while_loop(cond, body, state)
        return best_t, best_i

    best_t, best_i = jax.vmap(one_ray)(origins, seg_vecs)
    hit = best_t < 1.5
    point = origins + best_t[:, None] * seg_vecs
    face_n = normalize(jnp.cross(e1[best_i], e2[best_i]), eps=1e-20)
    flip = jnp.sum(face_n * seg_vecs, axis=-1) > 0.0
    normal = jnp.where(flip[:, None], -face_n, face_n)
    return {
        "hit": hit,
        "t": best_t,
        "point": point,
        "normal": normal,
        "mesh_id": jnp.where(hit, mid_o[best_i], -1).astype(jnp.int32),
    }
