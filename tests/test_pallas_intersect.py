"""Listed intersect kernel (Triton route) vs the jnp brute force, in
interpret mode on the CPU, plus its lowering to Triton IR for the GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcray_tpu.ops.bvh import build_bvh
from mcray_tpu.ops.geometry import intersect_closest
from mcray_tpu.ops.pallas.intersect import (
    NO_HIT_T,
    _assemble_lists,
    _packet_cluster_lists,
    intersect_closest_listed,
    pack_tris_culled,
)
from mcray_tpu.scene.primitives import ellipsoid_mesh


def _random_soup(rng, t=700):
    centers = rng.uniform(-5, 5, (t, 1, 3))
    tris = (centers + rng.standard_normal((t, 3, 3)) * 0.8).astype(np.float32)
    return tris, rng.integers(0, 6, (t,)).astype(np.int32)


def _nested_shells():
    parts, mids = [], []
    for k, r in enumerate([2.0, 4.0, 6.0]):
        v, f = ellipsoid_mesh(radii=(r, r, r), center=(0, 0, 0), n_theta=24, n_phi=48)
        parts.append(v[f])
        mids.append(np.full((f.shape[0],), k, np.int32))
    return np.concatenate(parts).astype(np.float32), np.concatenate(mids)


def _clustered(rng):
    """Triangles packed into a few tight, overlapping blobs: many cluster
    boxes overlap, so packets carry long lists and the early stop matters."""
    centers = rng.uniform(-4, 4, (4, 1, 1, 3))
    tris = centers + rng.standard_normal((4, 150, 3, 3)) * 0.6
    return tris.reshape(-1, 3, 3).astype(np.float32), rng.integers(0, 3, (600,)).astype(np.int32)


def _rays(rng, scene, n):
    if scene == "fan":
        # convex-fan primary rays (the real workload) from one apex
        th = np.linspace(-0.5, 0.5, n)
        o = np.tile([[0.0, -10.0, 0.0]], (n, 1))
        s = np.stack([np.sin(th) * 25, np.cos(th) * 25, np.zeros(n)], -1)
    else:
        o = rng.uniform(-6, 6, (n, 3))
        s = rng.standard_normal((n, 3)) * 8
    o, s = o.astype(np.float32), s.astype(np.float32)
    if scene == "dead":
        # parked dead rays, exactly as the bounce loop parks them
        o[::3] = 1e9
        s[::3] = 0.0
    return jnp.asarray(o), jnp.asarray(s)


@pytest.mark.parametrize("scene", ["soup", "fan", "dead", "clustered"])
def test_listed_intersect_matches_brute_force(rng, scene):
    tris, mid = {
        "soup": _random_soup, "dead": _random_soup, "clustered": _clustered,
        "fan": lambda _: _nested_shells(),
    }[scene](rng)
    packed = pack_tris_culled(tris, mid, build_bvh(tris).tri_order,
                              sort_origin=np.zeros(3))
    o, s = _rays(rng, scene, 150)  # 150 % TILE_R != 0: ray padding
    a = intersect_closest(o, s, jnp.asarray(tris), jnp.asarray(mid))
    b = intersect_closest_listed(o, s, packed, interpret=True)
    hit = np.asarray(a["hit"])
    assert hit.any()
    np.testing.assert_array_equal(hit, np.asarray(b["hit"]))
    np.testing.assert_allclose(np.asarray(a["t"]), np.asarray(b["t"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(
        np.asarray(a["mesh_id"])[hit], np.asarray(b["mesh_id"])[hit]
    )
    if scene != "fan":
        # the fan lies in the shells' z=0 plane of shared triangle edges,
        # where two triangles tie at the same t and either normal is right
        np.testing.assert_allclose(
            np.asarray(a["normal"])[hit], np.asarray(b["normal"])[hit], atol=1e-5
        )
    assert (np.asarray(b["mesh_id"])[~hit] == -1).all()


def test_listed_intersect_no_hits(rng):
    """Empty per-packet lists (no survivors) return misses."""
    tris, mid = _random_soup(rng, 300)
    packed = pack_tris_culled(tris, mid)
    o = jnp.full((40, 3), 100.0)
    s = jnp.tile(jnp.array([[1.0, 0.0, 0.0]]), (40, 1))
    b = intersect_closest_listed(o, s, packed, interpret=True)
    assert not np.asarray(b["hit"]).any()
    assert (np.asarray(b["mesh_id"]) == -1).all()


def test_listed_intersect_batched(rng):
    """vmap over frames batches the kernel grid (render_batch)."""
    tris, mid = _random_soup(rng)
    packed = pack_tris_culled(tris, mid)
    o, s = _rays(rng, "soup", 64)
    single = intersect_closest_listed(o, s, packed, interpret=True)["t"]
    batched = jax.vmap(
        lambda oo: intersect_closest_listed(oo, s, packed, interpret=True)["t"]
    )(jnp.stack([o, o + 0.1]))
    np.testing.assert_array_equal(np.asarray(batched[0]), np.asarray(single))


def test_packet_lists_hold_every_hit_cluster(rng):
    """Each ray's closest hit lies in a cluster on its packet's list, and
    the list's first key lower-bounds it (the early stop's soundness)."""
    from mcray_tpu.ops.geometry import _moller_trumbore

    tris, mid = _random_soup(rng, 900)
    packed = pack_tris_culled(tris, mid, build_bvh(tris).tri_order)
    o, s = _rays(rng, "soup", 128)
    counts, ids, keys = map(np.asarray, _packet_cluster_lists(o, s, packed, 32))
    a = intersect_closest(o, s, jnp.asarray(tris), jnp.asarray(mid))
    hit, t = np.asarray(a["hit"]), np.asarray(a["t"])
    slots = np.asarray(packed.slot_all).reshape(-1, packed.tile_t, 10)
    assert hit.any()
    for r in np.flatnonzero(hit):
        p = r // 32
        listed = slots[ids[p, : counts[p]]].reshape(-1, 10)
        t_l, ok = _moller_trumbore(
            o[r], s[r], jnp.asarray(listed[:, 0:3]), jnp.asarray(listed[:, 3:6]),
            jnp.asarray(listed[:, 6:9]),
        )
        best = np.min(np.where(np.asarray(ok), np.asarray(t_l), NO_HIT_T))
        np.testing.assert_allclose(best, t[r], rtol=1e-5)
        assert keys[p, 0] <= t[r] + 1e-6


def test_assemble_lists_contract(rng):
    """The kernel's loop correctness rests on _assemble_lists' invariants:
    survivors occupy the first `counts` slots, their keys ascend (the early
    stop reads keys[it] as a lower bound for ALL later slots), ids are a
    permutation of range(C), and non-survivor key slots are inert."""
    P, C = 6, 37
    any_hit = rng.random((P, C)) < 0.3
    key = rng.random((P, C)).astype(np.float32)
    counts, ids, keys = map(np.asarray, _assemble_lists(
        jnp.asarray(any_hit), jnp.asarray(key)
    ))
    for p in range(P):
        n = counts[p]
        assert n == any_hit[p].sum()
        assert sorted(ids[p].tolist()) == list(range(C))
        assert any_hit[p, ids[p, :n]].all()
        assert (np.diff(keys[p, :n]) >= 0).all()
        np.testing.assert_allclose(keys[p, :n], np.sort(key[p, any_hit[p]]), rtol=1e-6)
        assert (keys[p, n:] == NO_HIT_T).all()


def test_pack_tris_culled_layout(rng):
    """Clusters hold every triangle once (padding slots degenerate, mesh id
    -1), and each cluster's AABB bounds its triangles."""
    tris, mid = _random_soup(rng, 150)
    packed = pack_tris_culled(tris, mid, sort_origin=np.zeros(3), tile_t=64)
    slots = np.asarray(packed.slot_all)
    assert packed.n_slots == 192 and slots.shape == (192, 10)
    real = slots[:, 9] >= 0
    assert real.sum() == 150
    assert (slots[~real, 3:9] == 0).all()
    np.testing.assert_array_equal(np.sort(slots[real, 9]), np.sort(mid))
    tiles = np.asarray(packed.tiles)  # (n_clusters, 9, tile_t)
    aabb = np.asarray(packed.aabb_cluster)
    for c in range(tiles.shape[0]):
        ok = real[c * 64 : (c + 1) * 64]
        v0 = tiles[c, 0:3].T[ok]
        assert (v0 >= aabb[c, 0:3] - 1e-6).all() and (v0 <= aabb[c, 3:6] + 1e-6).all()


def test_listed_intersect_lowers_to_triton(rng):
    tris, mid = _random_soup(rng)
    packed = pack_tris_culled(tris, mid)
    o, s = _rays(rng, "soup", 64)
    f = jax.jit(jax.vmap(lambda oo: intersect_closest_listed(oo, s, packed)["t"]))
    text = f.trace(jnp.stack([o, o])).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1
