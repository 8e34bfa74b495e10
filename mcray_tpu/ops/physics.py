"""Acoustic ray physics: boundary interaction, attenuation, sampling.

Array-program rebuild of the reference's scalar per-ray functions
(reference: src/ray.cpp) as vectorised jnp over ``(N,)`` ray batches, with
counter-based ``jax.random`` keys replacing the reference's per-call
``std::random_device`` + mt19937 reseeding (src/ray.cpp:85-87,174-177,216-218)
— deterministic, reproducible, shardable. Materials are rows of an ``(M, 8)``
float32 table (see loader.MATERIAL_FIELDS order), so every physics output is
differentiable w.r.t. the table via plain JAX AD.

Documented deliberate divergences from the C++ (SURVEY.md §7 quirks):
- Under total internal reflection the reference computes sqrt of a negative
  number, yielding a NaN refraction direction whose NaN propagates into the
  back-to-transducer term through std::pow/std::max (src/ray.cpp:63,82,154-162).
  We clamp: TIR contributes only the reflection factor.
- The non-vascular media transition replicates the reference's
  "always material_inside" pointer-comparison bug only when
  ``cfg.bug_compat_material_transition`` is set (src/ray.cpp:44).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SimConfig
from .geometry import normalize

Array = jax.Array

# Material table column indices (loader.MATERIAL_FIELDS order, src/mesh.h:7-10).
IMPEDANCE, ATTENUATION, MU0, MU1, SIGMA, SPECULARITY, SHININESS, THICKNESS = range(8)


def take_rows(table: Array, ids: Array) -> Array:
    """``table[ids]`` for a SMALL first axis via one-hot matmul.

    Timed on an H100 against the plain clipped gather in whole frames: the
    gather won a single (host-bound) sphere frame by 0.6 ms and tied on 8
    sphere frames; the one-hot form won both cells of the 123k-triangle
    scene, by 1.3 ms (8%) on 8 frames (PERF.md). So it stays. Exact: each output row sums one 1.0*value against zeros
    (precision=HIGHEST keeps the multiply f32, with no TF32), and the
    transpose (scatter-add) matches the gather's VJP, so material gradients
    are unchanged bit-for-bit.

    Ids are clamped to [0, M-1] to preserve jnp-gather clamping semantics:
    a raw one-hot would map out-of-range ids to an all-zero row (returning
    0.0) where ``table[ids]`` clamps to the edge row."""
    m = table.shape[0]
    ids = jnp.clip(ids, 0, m - 1)
    oh = jax.nn.one_hot(ids.reshape(-1), m, dtype=table.dtype)
    flat = table.reshape(m, -1)
    out = jax.lax.dot_general(
        oh, flat, (((1,), (0,)), ((), ())), precision=jax.lax.Precision.HIGHEST
    )
    return out.reshape(ids.shape + table.shape[1:])


def safe_pow(base: Array, exponent: Array) -> Array:
    """max(base,0)^exponent with 0^e = 0 — the value the reference's
    max(pow(...), 0) composition intends for positive exponents. Double-where
    keeps the VJP finite at base <= 0."""
    ok = base > 0.0
    return jnp.where(ok, jnp.power(jnp.where(ok, base, 1.0), exponent), 0.0)


def max_ray_length(intensity: Array, attenuation: Array, frequency: float, eps: float) -> Array:
    """Attenuation-bounded ray length [the reference's mm-ish unit]
    (src/ray.cpp:110-113 — including its multiply-by-frequency quirk)."""
    return 10.0 * jnp.log(eps / intensity) / -attenuation * frequency


def travel_attenuation(attenuation: Array, distance_mm: Array, frequency: float) -> Array:
    """Beer-Lambert intensity factor for a travelled span
    (src/ray.cpp:99-103, with its 0.01 scale kept as-is)."""
    return jnp.exp(-attenuation * distance_mm * 0.01 * frequency)


def snells_law(direction: Array, normal: Array, incidence: Array, refraction: Array, ratio: Array) -> Array:
    """Vector-form Snell (src/ray.cpp:115-124); inputs broadcast over (N,)."""
    return ratio[..., None] * direction + (ratio * incidence - refraction)[..., None] * normal


def reflection_intensity(intensity: Array, z1: Array, incidence: Array, z2: Array, refraction: Array) -> Array:
    """Fresnel-like split: I * ((Z1 c1 - Z2 c2)/(Z1 c1 + Z2 c2))^2
    (src/ray.cpp:126-132)."""
    num = z1 * incidence - z2 * refraction
    denom = z1 * incidence + z2 * refraction
    return intensity * jnp.square(num / denom)


def reflected_intensity_burger(intensity: Array, incidence: Array, z_ray: Array, z_hit: Array, spec_hit: Array) -> Array:
    """Burger13 Eq. 10 variant (src/ray.cpp:134-153) — kept for parity with
    the reference's alternative (commented-in-C++) backscatter model."""
    small_enh = 0.2
    custom_enh = 0.05
    specular = safe_pow(incidence, spec_hit)
    imped = jnp.square((z_hit - z_ray) / (z_hit + z_ray))
    inten = safe_pow(intensity, small_enh)
    return jnp.abs(specular * safe_pow(imped, custom_enh) * inten)


def reflected_intensity_mattausch(
    direction: Array, refr_dir: Array, refl_dir: Array, spec_hit: Array, tir: Array
) -> Array:
    """Mattausch Eq. 8 backscatter (src/ray.cpp:154-164); under TIR the
    refraction term is dropped instead of the reference's NaN."""
    refr_cos = jnp.sum(direction * refr_dir, axis=-1)
    refl_cos = jnp.sum(direction * refl_dir, axis=-1)
    refr_term = jnp.where(tir, 0.0, safe_pow(refr_cos, spec_hit))
    refl_term = safe_pow(refl_cos, spec_hit)
    return refr_term + refl_term


def split_each(keys: Array, num: int) -> Array:
    """Split a batch of keys: (N,) keys -> (N, num) keys. Per-path keys make
    every random draw a pure function of (seed, path id, bounce, purpose), so
    renders are bitwise invariant to how paths are sharded across devices."""
    return jax.vmap(lambda k: jax.random.split(k, num))(keys)


def batched_uniform(keys: Array) -> Array:
    return jax.vmap(jax.random.uniform)(keys)


def batched_normal(keys: Array) -> Array:
    return jax.vmap(jax.random.normal)(keys)


def power_cosine_variate(key: Array, shininess: Array, shape=()) -> Array:
    """cos(theta) ~ u^(1/(int(s)+1)) (src/ray.cpp:213-224; the C++ truncates
    the float shininess to int)."""
    u = jnp.maximum(jax.random.uniform(key, shape), 1e-12)
    exponent = 1.0 / (jnp.floor(shininess) + 1.0)
    return jnp.power(u, exponent)


def power_cosine_variate_batched(keys: Array, shininess: Array) -> Array:
    """Per-path-keyed variant of power_cosine_variate; keys/shininess (N,)."""
    u = jnp.maximum(batched_uniform(keys), 1e-12)
    exponent = 1.0 / (jnp.floor(shininess) + 1.0)
    return jnp.power(u, exponent)


def random_unit_vector_batched(keys: Array, v: Array, cos_theta: Array) -> Array:
    """Per-path-keyed variant of random_unit_vector; keys (N,), v (N,3)."""
    ks = split_each(keys, 2)
    return random_unit_vector_from_uniforms(
        batched_uniform(ks[:, 0]), batched_uniform(ks[:, 1]), v, cos_theta
    )


def random_unit_vector_from_uniforms(u_a: Array, u_r: Array, v: Array, cos_theta: Array) -> Array:
    """random_unit_vector_batched with the two U(0,1) draws supplied."""
    a = u_a * (2.0 * jnp.pi)
    r = 0.5 * jnp.sqrt(u_r)
    return _unit_vector_from_disc(a, r, v, cos_theta)


def draw_bounce_randoms(path_keys: Array, n_depth: int) -> dict[str, Array]:
    """All of one frame's random draws, batched over (depth, path) in one
    pass instead of per-bounce threefry chains inside the scan. Key
    derivation chain is IDENTICAL to the per-bounce one
    (fold_in(path_key, depth) -> split(2) -> q normal / split(3) ->
    power-cosine u, unit-vector split(2) u's, roulette u), so every draw is
    bitwise identical to the unhoisted code — threefry is elementwise in the
    key, batching shape doesn't change the stream."""
    depths = jnp.arange(n_depth)
    kd = jax.vmap(
        lambda d: jax.vmap(jax.random.fold_in, in_axes=(0, None))(path_keys, d)
    )(depths)  # (D, N) keys
    n = path_keys.shape[0]
    # keys may be typed (D, N) or raw uint32 (D, N, 2); flatten depth x path
    flat = kd.reshape((n_depth * n,) + kd.shape[2:])
    ks = split_each(flat, 2)
    q_normal = batched_normal(ks[:, 0])
    ks2 = split_each(ks[:, 1], 3)
    angle_u = jnp.maximum(batched_uniform(ks2[:, 0]), 1e-12)
    rks = split_each(ks2[:, 1], 2)
    axis_u = batched_uniform(rks[:, 0])
    radius_u = batched_uniform(rks[:, 1])
    roulette_u = batched_uniform(ks2[:, 2])
    shape = (n_depth, n)
    return {
        "q_normal": q_normal.reshape(shape),
        "angle_u": angle_u.reshape(shape),
        "axis_u": axis_u.reshape(shape),
        "radius_u": radius_u.reshape(shape),
        "roulette_u": roulette_u.reshape(shape),
    }


def random_unit_vector(key: Array, v: Array, cos_theta: Array) -> Array:
    """Random vector at polar angle arccos(cos_theta) around ``v`` — exact
    formula replication of src/ray.cpp:167-211 (disc sampling + component
    swap), vectorised; the C++ rejection loop always accepts on the first
    draw since r <= 0.5 by construction."""
    k1, k2 = jax.random.split(key)
    shape = v.shape[:-1]
    a = jax.random.uniform(k1, shape) * (2.0 * jnp.pi)
    r = 0.5 * jnp.sqrt(jax.random.uniform(k2, shape))
    return _unit_vector_from_disc(a, r, v, cos_theta)


def _unit_vector_from_disc(a: Array, r: Array, v: Array, cos_theta: Array) -> Array:
    px = r * jnp.cos(a)
    py = r * jnp.sin(a)
    p = jnp.maximum(px * px + py * py, 1e-12)

    vx0, vy0, vz = v[..., 0], v[..., 1], v[..., 2]
    flag = jnp.abs(vx0) > jnp.abs(vy0)
    vx = jnp.where(flag, vy0, vx0)
    vy = jnp.where(flag, vx0, vy0)

    b = jnp.maximum(1.0 - vx * vx, 1e-12)
    radicand = jnp.maximum((1.0 - cos_theta * cos_theta) / (p * b), 1e-20)
    c = jnp.sqrt(radicand)
    px = px * c
    py = py * c
    d = cos_theta - vx * px
    wx = vx * cos_theta - b * px
    wy = vy * d + vz * py
    wz = vz * d - vy * py
    out_x = jnp.where(flag, wy, wx)
    out_y = jnp.where(flag, wx, wy)
    return jnp.stack([out_x, out_y, wz], axis=-1)


def material_transition(
    media_id: Array,
    media_outside_id: Array,
    mesh_vascular: Array,
    mesh_mat_inside: Array,
    mesh_mat_outside: Array,
    cfg: SimConfig,
):
    """The vascular in/out media state machine (src/ray.cpp:14-47) on integer
    material ids (-1 == "not inside a vessel"). Returns
    (material_after_collision, media_outside_after) for the refracted branch."""
    in_vessel = media_outside_id >= 0

    # in vessel, hit a vessel -> leaving it, back to stored surrounding media
    m1, o1 = media_outside_id, jnp.full_like(media_id, -1)
    # in vessel, hit a regular organ boundary -> stay in vessel, flip stored tissue
    o2 = jnp.where(media_outside_id == mesh_mat_inside, mesh_mat_outside, mesh_mat_inside)
    m2 = media_id
    # outside, hit a vessel -> enter it, remember current tissue
    m3, o3 = mesh_mat_inside, media_id
    # outside, hit a regular organ
    if cfg.bug_compat_material_transition:
        m4 = mesh_mat_inside
    else:
        m4 = jnp.where(media_id == mesh_mat_inside, mesh_mat_outside, mesh_mat_inside)
    o4 = jnp.full_like(media_id, -1)

    mat_after = jnp.where(
        in_vessel,
        jnp.where(mesh_vascular, m1, m2),
        jnp.where(mesh_vascular, m3, m4),
    )
    out_after = jnp.where(
        in_vessel,
        jnp.where(mesh_vascular, o1, o2),
        jnp.where(mesh_vascular, o3, o4),
    )
    return mat_after, out_after


def hit_boundary(
    keys: Array,  # (N,) per-path PRNG keys
    direction: Array,       # (N, 3) unit
    hit_point: Array,       # (N, 3)
    surface_normal: Array,  # (N, 3) oriented toward ray origin side
    intensity: Array,       # (N,) intensity AFTER travel to the boundary
    media_id: Array,        # (N,) i32
    media_outside_id: Array,  # (N,) i32, -1 = none
    mesh_id: Array,         # (N,) i32 collided mesh
    materials: Array,       # (M, 8) f32 — differentiable parameter table
    mesh_mat_inside: Array,
    mesh_mat_outside: Array,
    mesh_is_vascular: Array,
    cfg: SimConfig,
    draws: dict[str, Array] | None = None,
):
    """Vectorised boundary interaction (src/ray.cpp:11-97).

    Returns dict with back_intensity (N,), and the continued ray's
    new_direction, new_media_id, new_media_outside_id, new_intensity,
    chose_reflection.

    ``draws``: optional pre-drawn randoms for this bounce (one (N,) slice of
    draw_bounce_randoms) — bitwise identical to drawing from ``keys``, but
    lets the caller batch all threefry work outside its bounce loop. When
    given, ``keys`` is unused.
    """
    mesh_id_c = jnp.maximum(mesh_id, 0)  # safe lookup for missed rays (masked upstream)
    # one fused one-hot lookup over the mesh tables (values are small ints,
    # exact in f32; see take_rows for why not a gather)
    mesh_tab = jnp.stack(
        [
            mesh_mat_inside.astype(jnp.float32),
            mesh_mat_outside.astype(jnp.float32),
            mesh_is_vascular.astype(jnp.float32),
        ],
        axis=1,
    )
    mesh_rows = take_rows(mesh_tab, mesh_id_c)
    m_in = mesh_rows[:, 0].astype(jnp.int32)
    m_out = mesh_rows[:, 1].astype(jnp.int32)
    vascular = mesh_rows[:, 2] > 0.5

    mat_after, out_after = material_transition(
        media_id, media_outside_id, vascular, m_in, m_out, cfg
    )

    # one materials-row lookup per distinct id vector; columns sliced below
    rows_media = take_rows(materials, media_id)
    rows_after = take_rows(materials, mat_after)
    shininess = rows_after[:, SHININESS]
    if draws is None:
        ks = split_each(keys, 3)
        random_angle = power_cosine_variate_batched(ks[:, 0], shininess)
        random_normal = random_unit_vector_batched(
            ks[:, 1], surface_normal, random_angle
        )
    else:
        exponent = 1.0 / (jnp.floor(shininess) + 1.0)
        random_angle = jnp.power(draws["angle_u"], exponent)
        random_normal = random_unit_vector_from_uniforms(
            draws["axis_u"], draws["radius_u"], surface_normal, random_angle
        )

    # incidence = |d . n| via the reference's flip-if-negative (src/ray.cpp:53-57)
    incidence = jnp.abs(jnp.sum(direction * random_normal, axis=-1))

    z1 = rows_media[:, IMPEDANCE]
    z2 = rows_after[:, IMPEDANCE]
    ratio = z1 / z2

    refr_sq = 1.0 - ratio * ratio * (1.0 - incidence * incidence)
    tir = refr_sq < 0.0
    # double-where: sqrt's VJP at 0 is inf, which would poison gradients of
    # masked TIR lanes (inf * 0 = NaN)
    refr_angle = jnp.where(tir, 0.0, jnp.sqrt(jnp.where(tir, 1.0, jnp.maximum(refr_sq, 0.0))))

    refr_dir = normalize(
        snells_law(direction, random_normal, incidence, refr_angle, ratio), eps=1e-20
    )
    refl_dir = normalize(direction + 2.0 * incidence[..., None] * random_normal, eps=1e-20)

    i_refl = jnp.where(
        tir, intensity, reflection_intensity(intensity, z1, incidence, z2, refr_angle)
    )
    i_refr = intensity - i_refl

    spec_after = rows_after[:, SPECULARITY]
    back = (
        reflected_intensity_mattausch(direction, refr_dir, refl_dir, spec_after, tir)
        * random_angle
    )

    # Russian roulette: continue with ONE of reflection/refraction
    # (src/ray.cpp:85-94). The branch choice is a detached comparison; the
    # chosen branch's intensity stays differentiable.
    x = batched_uniform(ks[:, 2]) if draws is None else draws["roulette_u"]
    safe_int = jnp.maximum(intensity, cfg.intensity_epsilon)
    reflect = (i_refl / safe_int) > x

    eps = cfg.intensity_epsilon
    refl_int = jnp.where(i_refl > eps, i_refl, 0.0)
    refr_int = jnp.where(i_refr > eps, i_refr, 0.0)

    return {
        "back_intensity": back,
        "new_from": hit_point,
        "new_direction": jnp.where(reflect[..., None], refl_dir, refr_dir),
        "new_media_id": jnp.where(reflect, media_id, mat_after),
        "new_media_outside_id": jnp.where(reflect, media_outside_id, out_after),
        "new_intensity": jnp.where(reflect, refl_int, refr_int),
        "chose_reflection": reflect,
    }
