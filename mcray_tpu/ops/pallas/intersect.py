"""Pallas kernel (Triton route): list-driven closest-hit ray-triangle
intersection over spatially coherent triangle clusters.

The jnp brute force (ops.geometry.intersect_closest) tests every ray against
every triangle: on the 123k-triangle scene that is ~3.2e9 tests per frame.
Here triangles are permuted into the SAH BVH's depth-first leaf order, cut
into ``tile_t``-wide clusters that each carry an AABB, and visited
nearest-first from the transducer. A jnp prepass (``_packet_cluster_lists``)
slab-tests every ray against every cluster AABB and gives each ray packet
the list of clusters any of its rays can hit, sorted by the packet's
earliest entry t. The kernel — one program per packet — walks that list
only, re-checks each cluster's box against the rays' TIGHTENED running hit
before spending Moller-Trumbore on it, and stops outright once the next
list entry's key can no longer beat the packet's worst running hit
(the static-shape analogue of ordered BVH descent with early termination;
replaces Bullet's btBvhTriangleMeshShape::rayTest, reference
src/scene.cpp:115-117).

Same hit contract as the jnp path (Bullet both-sided semantics, t in (0,1)).
Differentiability: the kernel only makes the DISCRETE choice (which triangle
wins, did anything hit) — piecewise-constant in the inputs, so AD never
enters it. The hit parameter t is recomputed in plain jnp from the winning
triangle by the same Moller-Trumbore formula, which reproduces the jnp
brute-force path's gradients (whose argmin-gather also routes cotangents
through the winner only).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..geometry import NO_HIT_T, _moller_trumbore, normalize

# Rays per packet (one program) and triangles per cluster: the kernel's
# Moller-Trumbore block is (TILE_T, TILE_R) = 2048 values per temporary, 16
# per thread at NUM_WARPS=4. Powers of two (Triton block rule).
TILE_R = 32
TILE_T = 64
NUM_WARPS = 4


@dataclasses.dataclass
class CulledTris:
    """Host-packed triangle clusters for intersect_closest_listed.

    Registered as a jax pytree (arrays = children, shape ints = static aux)
    so callers thread it through jit boundaries as an argument."""

    tiles: jax.Array         # (n_clusters, 9, tile_t) f32: v0 / e1 / e2 xyz rows
    aabb_cluster: jax.Array  # (n_clusters, 6) f32 [min xyz, max xyz]
    slot_all: jax.Array      # (n_slots, 10) f32 [v0 e1 e2 mesh_id] per slot
    n_slots: int
    tile_t: int = TILE_T


_CULLED_ARRAY_FIELDS = ("tiles", "aabb_cluster", "slot_all")
_CULLED_STATIC_FIELDS = ("n_slots", "tile_t")


def _culled_flatten(p: CulledTris):
    return (
        tuple(getattr(p, f) for f in _CULLED_ARRAY_FIELDS),
        tuple(getattr(p, f) for f in _CULLED_STATIC_FIELDS),
    )


def _culled_unflatten(aux, children):
    kw = dict(zip(_CULLED_ARRAY_FIELDS, children))
    kw.update(zip(_CULLED_STATIC_FIELDS, aux))
    return CulledTris(**kw)


jax.tree_util.register_pytree_node(CulledTris, _culled_flatten, _culled_unflatten)


def pack_tris_culled(
    tris: np.ndarray,
    tri_mesh_id: np.ndarray,
    order: np.ndarray | None = None,
    sort_origin: np.ndarray | None = None,
    tile_t: int = TILE_T,
) -> CulledTris:
    """Permute triangles into spatial ``order`` (e.g. the SAH BVH's
    depth-first tri_order) and pack ``tile_t``-wide clusters with their
    AABBs. Padding slots are degenerate (det==0, never hit).

    ``sort_origin``: if given (typically the transducer position), clusters
    are stored nearest-first relative to it, so equal prepass keys resolve
    front to back."""
    tris = np.asarray(tris, np.float32)
    tri_mesh_id = np.asarray(tri_mesh_id, np.int32)
    t = tris.shape[0]
    order = np.arange(t) if order is None else np.asarray(order)
    n_clusters = max(-(-t // tile_t), 1)
    if sort_origin is not None and t > tile_t:
        so = np.asarray(sort_origin, np.float32)
        cent = tris[order].mean(axis=1)  # (t, 3)
        keys = np.array([
            np.linalg.norm(cent[c * tile_t : (c + 1) * tile_t].mean(axis=0) - so)
            for c in range(n_clusters)
        ])
        cluster_perm = np.argsort(keys, kind="stable")
        order = np.concatenate(
            [order[c * tile_t : (c + 1) * tile_t] for c in cluster_perm]
        )
    tris_o = tris[order]
    n_slots = n_clusters * tile_t

    v0 = np.zeros((n_slots, 3), np.float32)
    e1 = np.zeros((n_slots, 3), np.float32)
    e2 = np.zeros((n_slots, 3), np.float32)
    v0[:t] = tris_o[:, 0]
    e1[:t] = tris_o[:, 1] - tris_o[:, 0]
    e2[:t] = tris_o[:, 2] - tris_o[:, 0]
    tiles = (
        np.concatenate([v0, e1, e2], axis=1)       # (n_slots, 9)
        .reshape(n_clusters, tile_t, 9)
        .transpose(0, 2, 1)
    )
    # Padding clusters (only in an empty scene) carry a FAR degenerate box
    # that fails the slab test's `enter < 1` for every real ray.
    aabb = np.full((n_clusters, 6), 1e30, np.float32)
    for c in range(0, t, tile_t):
        chunk = tris_o[c : c + tile_t].reshape(-1, 3)
        aabb[c // tile_t, 0:3] = chunk.min(axis=0)
        aabb[c // tile_t, 3:6] = chunk.max(axis=0)

    slot_mid = np.full((n_slots, 1), -1.0, np.float32)
    slot_mid[:t, 0] = tri_mesh_id[order]  # mesh ids are small ints: exact in f32
    slot_all = np.concatenate([v0, e1, e2, slot_mid], axis=1)
    return CulledTris(
        tiles=jnp.asarray(np.ascontiguousarray(tiles)),
        aabb_cluster=jnp.asarray(aabb),
        slot_all=jnp.asarray(slot_all),
        n_slots=n_slots,
        tile_t=tile_t,
    )


def _winner_hits(origins, seg_vecs, packed: CulledTris, best_slot, hit, eps):
    """Differentiable t of the kernel-chosen winner plus point/normal/mesh
    id, from ONE (N, 10) slot_all row gather."""
    rows = packed.slot_all[best_slot]
    v0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    mesh = rows[:, 9].astype(jnp.int32)
    t_diff, _ = _moller_trumbore(origins, seg_vecs, v0, e1, e2, eps=eps)
    best_t = jnp.where(hit, t_diff, NO_HIT_T)
    point = origins + best_t[:, None] * seg_vecs
    face_n = normalize(jnp.cross(e1, e2), eps=1e-20)
    flip = jnp.sum(face_n * seg_vecs, axis=-1) > 0.0
    normal = jnp.where(flip[:, None], -face_n, face_n)
    return {
        "hit": hit,
        "t": best_t,
        "point": point,
        "normal": normal,
        "mesh_id": jnp.where(hit, mesh, -1).astype(jnp.int32),
    }


def _inv_dir(s):
    ok = jnp.abs(s) > 1e-30
    return jnp.where(ok, 1.0 / jnp.where(ok, s, 1.0), 1e30)


def _slab(o, inv, lo, hi):
    """Ray-vs-AABB slab test, unrolled over the coordinate axes: ``o``/
    ``inv`` are per-axis lists of ray arrays, ``lo``/``hi`` per-axis box
    bounds (all broadcast together). Returns (enter, leave)."""
    enter = leave = None
    for ax in range(3):
        t0 = (lo[ax] - o[ax]) * inv[ax]
        t1 = (hi[ax] - o[ax]) * inv[ax]
        mn, mx = jnp.minimum(t0, t1), jnp.maximum(t0, t1)
        enter = mn if enter is None else jnp.maximum(enter, mn)
        leave = mx if leave is None else jnp.minimum(leave, mx)
    return enter, leave


def _assemble_lists(any_hit, key):
    """(P, C) survival mask + sound lower-bound key -> (counts, ids, keys)
    in the kernel's contract: survivors first, ascending in key. One stable
    variadic lax.sort carries the cluster ids alongside the keys."""
    key = jnp.where(any_hit, key, jnp.inf)
    iota = jnp.broadcast_to(
        jnp.arange(key.shape[1], dtype=jnp.int32)[None], key.shape
    )
    keys_sorted, ids = jax.lax.sort((key, iota), dimension=1, num_keys=1)
    counts = jnp.sum(any_hit, axis=1).astype(jnp.int32)
    # non-survivor slots get NO_HIT_T (never read: the loop is bounded by
    # counts, but keep them inert)
    keys = jnp.minimum(keys_sorted, NO_HIT_T).astype(jnp.float32)
    return counts, ids, keys


def _packet_cluster_lists(origins, seg_vecs, packed: CulledTris, tile_r: int):
    """Per-packet surviving-cluster lists, computed vectorised in jnp.

    For each tile_r-ray packet, slab-test every ray against every cluster
    AABB (one dense (P, R, C) elementwise pass that XLA fuses into its
    reductions) and emit, per packet:

    - ``counts`` (P,) i32 — how many clusters ANY ray of the packet can hit,
    - ``ids``    (P, C) i32 — those cluster ids FIRST, ordered front-to-back
      by the packet's earliest slab entry t; the rest are never visited,
    - ``keys``   (P, C) f32 — the sorted packet-min entry t per slot. The
      list ascends in this key, so the kernel can stop as soon as the next
      key is >= the packet's worst running hit: every ray's entry t into
      every later cluster is >= that key >= its own best t.
    """
    n = origins.shape[0]
    p = n // tile_r
    o = origins.reshape(p, tile_r, 1, 3)
    inv = _inv_dir(seg_vecs).reshape(p, tile_r, 1, 3)
    box = packed.aabb_cluster[None, None]  # (1, 1, C, 6)
    enter, leave = _slab(
        [o[..., a] for a in range(3)], [inv[..., a] for a in range(3)],
        [box[..., a] for a in range(3)], [box[..., 3 + a] for a in range(3)],
    )  # (P, R, C)
    hit = (enter <= leave) & (leave > 0.0) & (enter < 1.0)
    any_hit = jnp.any(hit, axis=1)
    key = jnp.min(jnp.where(hit, jnp.maximum(enter, 0.0), jnp.inf), axis=1)
    return _assemble_lists(any_hit, key)


def _listed_kernel(counts_ref, ids_ref, keys_ref, rays_ref, t_init_ref,
                   tiles_ref, aabb_ref, t_ref, idx_ref, *, eps: float,
                   tile_r: int, tile_t: int):
    """One program per ray packet: walk the packet's cluster list front to
    back, with the AABB re-check and the early stop described in the module
    docstring. Rays are lanes (1, tile_r), the cluster's triangles rows
    (tile_t, 1); the running closest hit (t, slot) stays in registers."""
    p = pl.program_id(0)
    r0 = p * tile_r
    ray = [rays_ref[f, pl.ds(r0, tile_r)][None, :] for f in range(6)]
    o, s = ray[:3], ray[3:]
    inv = [_inv_dir(x) for x in s]
    n = counts_ref[p]

    def cond(carry):
        it, go, _, _ = carry
        return go & (it < n)

    def visit(c, t_best, i_best):
        lo = [aabb_ref[c, a] for a in range(3)]
        hi = [aabb_ref[c, 3 + a] for a in range(3)]
        enter, leave = _slab(o, inv, lo, hi)
        active = (enter <= leave) & (leave > 0.0) & (enter < jnp.minimum(t_best, 1.0))

        def test(args):
            t_best, i_best = args
            tri = [tiles_ref[c, f, :][:, None] for f in range(9)]
            v0, e1, e2 = tri[0:3], tri[3:6], tri[6:9]
            px = s[1] * e2[2] - s[2] * e2[1]
            py = s[2] * e2[0] - s[0] * e2[2]
            pz = s[0] * e2[1] - s[1] * e2[0]
            det = e1[0] * px + e1[1] * py + e1[2] * pz
            det_ok = jnp.abs(det) > eps
            inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
            tx, ty, tz = o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]
            u = (tx * px + ty * py + tz * pz) * inv_det
            qx = ty * e1[2] - tz * e1[1]
            qy = tz * e1[0] - tx * e1[2]
            qz = tx * e1[1] - ty * e1[0]
            v = (s[0] * qx + s[1] * qy + s[2] * qz) * inv_det
            t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
            valid = (
                det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                & (t > 0.0) & (t < 1.0)
            )
            t = jnp.where(valid, t, NO_HIT_T)  # (tile_t, tile_r)
            tmin = jnp.min(t, axis=0)[None, :]
            targ = jnp.argmin(t, axis=0).astype(jnp.int32)[None, :]
            better = tmin < t_best
            return (
                jnp.where(better, tmin, t_best),
                jnp.where(better, c * tile_t + targ, i_best),
            )

        # max over i32 (Triton lowers no boolean any-reduction)
        any_active = jnp.max(active.astype(jnp.int32)) > 0
        return jax.lax.cond(any_active, test, lambda a: a, (t_best, i_best))

    def body(carry):
        it, _, t_best, i_best = carry
        # early stop: this slot's key lower-bounds every ray's entry t into
        # this and every later cluster of the list
        go = keys_ref[p, it] < jnp.max(t_best)

        def step(args):
            return visit(ids_ref[p, it], *args)

        t_best, i_best = jax.lax.cond(go, step, lambda a: a, (t_best, i_best))
        return it + 1, go, t_best, i_best

    t_init = t_init_ref[pl.ds(r0, tile_r)][None, :]
    _, _, t_best, i_best = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), jnp.bool_(True), t_init,
         jnp.zeros((1, tile_r), jnp.int32)),
    )
    t_ref[...] = jnp.squeeze(t_best, 0)
    idx_ref[...] = jnp.squeeze(i_best, 0)


def intersect_closest_listed(
    origins: jax.Array,   # (N, 3)
    seg_vecs: jax.Array,  # (N, 3)
    packed: CulledTris,
    *,
    interpret: bool = False,
    eps: float = 1e-9,
    tile_r: int = TILE_R,
):
    """Closest hit via the list-driven kernel; same contract and gradient
    transparency as ops.geometry.intersect_closest."""
    n = origins.shape[0]
    n_pad = (-n) % tile_r
    n_tot = n + n_pad
    # padded rays have zero direction -> hit nothing, empty lists
    o = jnp.pad(jax.lax.stop_gradient(origins), ((0, n_pad), (0, 0)))
    s = jnp.pad(jax.lax.stop_gradient(seg_vecs), ((0, n_pad), (0, 0)))
    counts, ids, keys = _packet_cluster_lists(o, s, packed, tile_r)
    # Inert lanes (zero seg_vec: padding and parked dead rays) start at
    # t == 0.0 instead of NO_HIT_T. They can never update (zero direction
    # gives det == 0 and fails the AABB re-check's `leave > 0`), and at
    # NO_HIT_T they would pin the early stop's max(t) at 2.0, above every
    # key, disabling the stop for their whole packet. `hit` re-masks them.
    live = jnp.sum(jnp.abs(s), axis=1) > 0.0
    t_init = jnp.where(live, NO_HIT_T, 0.0).astype(jnp.float32)
    best_t, best_slot = pl.pallas_call(
        functools.partial(
            _listed_kernel, eps=eps, tile_r=tile_r, tile_t=packed.tile_t
        ),
        grid=(n_tot // tile_r,),
        in_specs=[pl.no_block_spec] * 7,
        out_specs=(
            pl.BlockSpec((tile_r,), lambda p: (p,)),
            pl.BlockSpec((tile_r,), lambda p: (p,)),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((n_tot,), jnp.float32),
            jax.ShapeDtypeStruct((n_tot,), jnp.int32),
        ),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="intersect_listed",
    )(
        counts, ids, keys,
        jnp.concatenate([o, s], axis=1).T,  # (6, n_tot) ray SoA
        t_init,
        jax.lax.stop_gradient(packed.tiles),
        jax.lax.stop_gradient(packed.aabb_cluster),
    )
    hit = live[:n] & (best_t[:n] < 1.5)
    best_slot = jnp.clip(best_slot[:n], 0, packed.n_slots - 1)
    return _winner_hits(origins, seg_vecs, packed, best_slot, hit, eps)
