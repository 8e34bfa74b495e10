"""Vector math and ray-triangle intersection.

Array-program replacement for the reference's Bullet vector math and BVH ray
casts (reference: src/scene.cpp:115-117, Bullet btVector3 used throughout
src/ray.cpp). Everything here is pure jax.numpy on packed SoA arrays: rays are
``(N, 3)`` float32 tensors, triangles a ``(T, 3, 3)`` tensor, and the closest
hit is a masked min-reduction — no data-dependent control flow, so XLA can
fuse and tile the whole test.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def rotate(v: Array, axis: Array, angle: Array) -> Array:
    """Rodrigues rotation of ``v`` about unit ``axis`` by ``angle``.

    Bit-matches btVector3::rotate (o + x*cos + y*sin decomposition), which the
    reference chains as rotate(z).rotate(x).rotate(y) for probe pose
    (reference: src/transducer.h:51-56). Broadcasts over leading dims of v.
    """
    axis = jnp.asarray(axis, dtype=v.dtype)
    o = axis * jnp.sum(axis * v, axis=-1, keepdims=True)
    x = v - o
    y = jnp.cross(jnp.broadcast_to(axis, v.shape), v)
    return o + x * jnp.cos(angle) + y * jnp.sin(angle)


def euler_zxy(v: Array, angles_rad: Array) -> Array:
    """The reference's probe rotation chain: about z by angles[2], then x by
    angles[0], then y by angles[1] (reference: src/transducer.h:51-56, with
    x_angle=angles[0], y_angle=angles[1], z_angle=angles[2])."""
    ex = jnp.array([1.0, 0.0, 0.0], dtype=v.dtype)
    ey = jnp.array([0.0, 1.0, 0.0], dtype=v.dtype)
    ez = jnp.array([0.0, 0.0, 1.0], dtype=v.dtype)
    v = rotate(v, ez, angles_rad[2])
    v = rotate(v, ex, angles_rad[0])
    v = rotate(v, ey, angles_rad[1])
    return v


def safe_sqrt(x: Array, eps: float = 0.0) -> Array:
    """sqrt with a finite VJP at 0 (double-where so masked-out lanes cannot
    poison gradients with inf * 0 = NaN)."""
    ok = x > eps
    return jnp.where(ok, jnp.sqrt(jnp.where(ok, x, 1.0)), 0.0)


def safe_norm(v: Array, axis: int = -1, keepdims: bool = False) -> Array:
    """L2 norm with a finite VJP at 0."""
    return safe_sqrt(jnp.sum(v * v, axis=axis, keepdims=keepdims))


def normalize(v: Array, eps: float = 0.0) -> Array:
    n = safe_norm(v, keepdims=True)
    n = jnp.maximum(n, eps if eps else 1e-30)
    return v / n


# ---------------------------------------------------------------------------
# Ray-triangle intersection (Moller-Trumbore, segment-parameterised)
# ---------------------------------------------------------------------------

#: No-hit sentinel for the ray parameter t (t is in [0, 1] along the segment).
NO_HIT_T = 2.0


def _moller_trumbore(origin, seg, v0, e1, e2, eps=1e-9):
    """t, u, v of segment ``origin + t*seg`` against triangles (broadcasted).

    Matches Bullet's both-sided triangle raycast (btTriangleRaycastCallback
    with default flags: front and back faces both hit; the reference never
    sets kF_FilterBackfaces)."""
    pvec = jnp.cross(seg, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    det_ok = jnp.abs(det) > eps
    inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
    tvec = origin - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(seg * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    valid = (
        (jnp.abs(det) > eps)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 0.0)
        & (t < 1.0)
    )
    return t, valid


def intersect_closest(
    origins: Array,  # (N, 3) segment starts
    seg_vecs: Array,  # (N, 3) full segment vectors (dest - origin)
    tris: Array,  # (T, 3, 3) world-space triangle vertices
    tri_mesh_id: Array,  # (T,) int32 owning-mesh index
    *,
    chunk: int = 0,
):
    """Closest hit of each segment against all triangles (brute force).

    Returns dict of (N,)-shaped arrays: ``hit`` bool, ``t`` (NO_HIT_T when
    miss), ``point`` (N,3), ``normal`` (N,3) — the face normal oriented toward
    the segment origin side, matching Bullet's ClosestRayResultCallback
    (reference: src/scene.cpp:115-126) — and ``mesh_id``.

    ``chunk`` > 0 loops over triangle chunks with ``lax.scan`` to bound peak
    memory at (N * chunk); the listed Pallas kernel in ops/pallas/intersect.py
    is the large-scene GPU path (paths.choose_paths).
    """
    v0 = tris[:, 0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]

    def best_over(v0c, e1c, e2c, mid_c):
        t, valid = _moller_trumbore(
            origins[:, None, :], seg_vecs[:, None, :], v0c[None], e1c[None], e2c[None]
        )  # (N, Tc)
        t = jnp.where(valid, t, NO_HIT_T)
        j = jnp.argmin(t, axis=1)  # (N,)
        n = jnp.arange(origins.shape[0])
        return t[n, j], mid_c[j], j

    if chunk and tris.shape[0] > chunk:
        T = tris.shape[0]
        pad = (-T) % chunk
        v0p = jnp.pad(v0, ((0, pad), (0, 0)))
        e1p = jnp.pad(e1, ((0, pad), (0, 0)))
        # Degenerate padding triangles (e2=0) never pass the det test.
        e2p = jnp.pad(e2, ((0, pad), (0, 0)))
        midp = jnp.pad(tri_mesh_id, (0, pad))
        idxp = jnp.arange(T + pad, dtype=jnp.int32)
        nchunks = (T + pad) // chunk

        def body(carry, xs):
            bt, bmid, bidx = carry
            v0c, e1c, e2c, mc, ic = xs
            t, mid_c, j = best_over(v0c, e1c, e2c, mc)
            better = t < bt
            carry = (
                jnp.where(better, t, bt),
                jnp.where(better, mid_c, bmid),
                jnp.where(better, ic[j], bidx),
            )
            return carry, None

        init = (
            jnp.full((origins.shape[0],), NO_HIT_T, jnp.float32),
            jnp.zeros((origins.shape[0],), tri_mesh_id.dtype),
            jnp.zeros((origins.shape[0],), jnp.int32),
        )
        xs = (
            v0p.reshape(nchunks, chunk, 3),
            e1p.reshape(nchunks, chunk, 3),
            e2p.reshape(nchunks, chunk, 3),
            midp.reshape(nchunks, chunk),
            idxp.reshape(nchunks, chunk),
        )
        (best_t, best_mid, best_idx), _ = jax.lax.scan(body, init, xs)
    else:
        best_t, best_mid, j = best_over(v0, e1, e2, tri_mesh_id)
        best_idx = j.astype(jnp.int32)

    hit = best_t < 1.5
    point = origins + best_t[:, None] * seg_vecs
    face_n = normalize(
        jnp.cross(e1[best_idx], e2[best_idx]), eps=1e-20
    )
    # Orient toward the origin side: Bullet reports +n when the origin is on
    # the positive half-space (dist_a > 0), which for a crossing segment is
    # equivalent to n . seg < 0.
    flip = jnp.sum(face_n * seg_vecs, axis=-1) > 0.0
    normal = jnp.where(flip[:, None], -face_n, face_n)
    return {
        "hit": hit,
        "t": best_t,
        "point": point,
        "normal": normal,
        "mesh_id": jnp.where(hit, best_mid, -1).astype(jnp.int32),
    }
