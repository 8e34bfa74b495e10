"""Tiled Gaussian scatterer texture volume.

Array-program rebuild of the reference's 256^3 host-RAM voxel grid
(reference: src/volume.h). Two N(0,1) fields (texture noise, scattering
probability) are generated once on device with a counter-based key — the
reference's std::default_random_engine fill is deterministic but
implementation-defined; we match it statistically, not bitwise (SURVEY.md §4).

Lookup replicates the C++ semantics exactly in hard mode:
- nearest voxel via C-style float->unsigned truncation + % size wrap
  (src/volume.h:52-54); size divides 2^32 so signed truncate-then-mod matches
  the unsigned wrap bit-for-bit.
- Burger13 Eq. 15 threshold: prob >= density ? noise*sigma + mu : 0
  (src/volume.h:58-60).

Soft mode (cfg.soft_scattering / cfg.trilinear_texture) swaps in a sigmoid
gate and trilinear interpolation so the scattering field is differentiable in
position and density — the relaxation flagged in SURVEY.md §7.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SimConfig

Array = jax.Array


def make_texture_volume(key: Array, cfg: SimConfig) -> dict[str, Array]:
    """Scatterer field state.

    ``cfg.texture_mode``:
    - "procedural" (default): no storage — an iid N(0,1)-per-voxel field
      computed on the fly from an integer voxel hash + Box-Muller.
      Identical distribution and identical %size tiling to the reference's
      table, no memory traffic; the whole lookup is integer and float
      arithmetic. The reference's table is itself just cached white noise (src/volume.h:19-35).
    - "table": materialised (size^3) noise + probability fields — the
      reference's memory layout (src/volume.h:19-35; 134 MB at 256^3),
      exercised by the jnp gather path. The table is FILLED from the same
      hash field (``procedural_fields`` evaluated at every voxel), and the
      dict keeps ``seeds`` too, so ``table[i,j,k] == procedural(i,j,k)``
      bit-for-bit: the Pallas march kernel can evaluate the hash instead of
      gathering and produce the identical image (tested in
      tests/test_texture.py / tests/test_pallas_march.py). The reference
      seeds its table with an implementation-defined engine we match only
      statistically (SURVEY.md §4), so defining the table as the cached
      hash field loses nothing.
    """
    k1, k2 = jax.random.split(key)
    seeds = jax.random.randint(k1, (2,), 0, 2**31 - 1, dtype=jnp.int32)
    seeds = seeds.astype(jnp.uint32)
    if cfg.texture_mode == "procedural":
        return {"seeds": seeds}
    s = cfg.volume_size
    ix, iy, iz = jnp.meshgrid(
        jnp.arange(s, dtype=jnp.int32),
        jnp.arange(s, dtype=jnp.int32),
        jnp.arange(s, dtype=jnp.int32),
        indexing="ij",
    )
    noise, prob = procedural_fields(ix, iy, iz, seeds, s, rng=cfg.scatter_rng)
    return {"noise": noise, "prob": prob, "seeds": seeds}


def hash_u32(x: Array) -> Array:
    """lowbias32-style avalanche hash on uint32 (same bit-exact function is
    implemented in the Pallas march kernel — keep in sync)."""
    x = jnp.asarray(x, jnp.uint32)
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


# dithered-binomial normaliser: z = (popcount(hi16) + U(0,1) - 8.5) / sqrt(
# Var[Binomial(16, 1/2)] + Var[U]) = (pc + u - 8.5) / sqrt(4 + 1/12).
# f32-rounded via NUMPY so jnp and the Pallas kernel share the identical
# constant — an import-time jnp value would initialise the XLA backend
# before the CLI can force a platform / jax.distributed can initialize.
import numpy as _np

BITSUM_SCALE = float(_np.float32(1.0 / (4.0 + 1.0 / 12.0) ** 0.5))


def _bitsum_normal(bits: Array) -> Array:
    """~N(0,1) from ONE 32-bit hash word, no transcendentals: popcount of
    the high 16 bits (Binomial(16, 1/2)) plus a (0,1) uniform dither from
    the low 16 bits. Exact mean/variance, symmetric, excess kurtosis -0.12,
    support ±4.2σ, CDF within ~7e-3 of Φ — the "cheaper-polynomial N(0,1)"
    (pure integer ops)."""
    pc = jax.lax.population_count(bits >> 16).astype(jnp.float32)
    u = ((bits & jnp.uint32(0xFFFF)).astype(jnp.float32) + 0.5) * (1.0 / 65536.0)
    return (pc + u - 8.5) * jnp.float32(BITSUM_SCALE)


def procedural_fields(ix: Array, iy: Array, iz: Array, seeds: Array, size: int,
                      rng: str = "boxmuller"):
    """(noise, prob) ~ iid N(0,1) per (wrapped) voxel from an integer hash.

    ``rng``: "boxmuller" (exact normals; log+sqrt+cos+sin) or "bitsum"
    (dithered binomial; transcendental-free — see cfg.scatter_rng)."""
    vid = ((ix.astype(jnp.uint32) * size + iy.astype(jnp.uint32)) * size
           + iz.astype(jnp.uint32))
    b1 = hash_u32(vid ^ seeds[0])
    b2 = hash_u32(vid ^ seeds[1])
    if rng == "bitsum":
        return _bitsum_normal(b1), _bitsum_normal(b2)
    # (bits + 0.5) / 2^24 in (0, 1): log is always finite
    u1 = ((b1 >> 8).astype(jnp.float32) + 0.5) * (1.0 / 16777216.0)
    u2 = ((b2 >> 8).astype(jnp.float32) + 0.5) * (1.0 / 16777216.0)
    r = jnp.sqrt(-2.0 * jnp.log(u1))
    theta = (2.0 * jnp.pi) * u2
    return r * jnp.cos(theta), r * jnp.sin(theta)


def _wrap_mod(q: Array, size: int) -> Array:
    """((q % size) + size) % size for possibly-negative int q. For
    power-of-two sizes (the default 256) this is exactly ``q & (size-1)``
    in two's complement — one AND instead of two int mods (the march
    kernel evaluates six of these per sample)."""
    if size & (size - 1) == 0:
        return q & jnp.int32(size - 1)
    return jnp.mod(jnp.mod(q, size) + size, size)


def _wrap_index(x: Array, res_mm: float, size: int) -> Array:
    """static_cast<unsigned>(x/res) % size for possibly-negative x."""
    q = jnp.trunc(x / res_mm).astype(jnp.int32)
    return _wrap_mod(q, size)


def get_scattering(
    volume: dict[str, Array],
    density: Array,   # (N,) — called with material mu1 (src/main.cpp:126)
    mu: Array,        # (N,) — material mu0
    sigma: Array,     # (N,)
    points: Array,    # (N, 3) world coords (the reference passes them as mm)
    cfg: SimConfig,
) -> Array:
    res = cfg.resolution_um / 1000.0
    size = cfg.volume_size
    # prefer the materialised table when present (reference memory layout,
    # gather path); table volumes also carry "seeds" and are bit-identical
    # to the hash field (see make_texture_volume)
    if "noise" in volume:
        def fetch(ix, iy, iz):
            return volume["noise"][ix, iy, iz], volume["prob"][ix, iy, iz]
    else:
        def fetch(ix, iy, iz):
            return procedural_fields(
                ix, iy, iz, volume["seeds"], size, rng=cfg.scatter_rng
            )

    if cfg.trilinear_texture:
        f = points / res - 0.5
        i0 = jnp.floor(f).astype(jnp.int32)
        w = f - i0

        def tap(offset):
            idx = _wrap_mod(i0 + offset, size)
            n, p = fetch(idx[..., 0], idx[..., 1], idx[..., 2])
            wt = jnp.prod(
                jnp.where(jnp.asarray(offset) == 1, w, 1.0 - w), axis=-1
            )
            return n * wt, p * wt

        noise = jnp.zeros(points.shape[:-1], jnp.float32)
        prob = jnp.zeros(points.shape[:-1], jnp.float32)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    n, p = tap(jnp.array([dx, dy, dz]))
                    noise = noise + n
                    prob = prob + p
    else:
        ix = _wrap_index(points[..., 0], res, size)
        iy = _wrap_index(points[..., 1], res, size)
        iz = _wrap_index(points[..., 2], res, size)
        noise, prob = fetch(ix, iy, iz)

    value = noise * sigma + mu
    if cfg.soft_scattering:
        gate = jax.nn.sigmoid((prob - density) / cfg.soft_scattering_tau)
        return value * gate
    return jnp.where(prob >= density, value, 0.0)
