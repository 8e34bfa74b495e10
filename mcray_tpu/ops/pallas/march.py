"""Pallas kernel (Triton route): output-stationary segment march + RF
accumulation, with a custom VJP so the differentiable fit runs on the kernel
too.

The jnp path (simulator.march_and_accumulate) builds a dense (D*N, K) grid of
(segment, step) samples, most of them masked, and scatter-adds the live ones
into the (rf_rows, rf_cols) RF image. On the GPU that scatter-add runs on
atomics, whose summation order can change from run to run.

This kernel inverts the loop (gather/output-stationary): each RF pixel
(row r, column c) asks the <= S*D segments of its OWN column which march step
lands in row r. Because the march time step exceeds the RF row pitch
(dt = axial_mm/c > rdt = trunc_axial_um/c, reference src/main.cpp:118 vs
src/rfimage.h:35), the row index floor((t0 + k*dt)/rdt) is strictly
increasing in k — every output row receives AT MOST ONE step of a given
segment. So the scatter is really a per-segment monotone relabelling, and
each pixel can solve k = ceil((r - t0/rdt) / (dt/rdt)) directly. Each RF cell
is written by exactly one program in a fixed order: no atomics, and the frame
is bitwise reproducible. The scatterer field is evaluated procedurally
(texture.procedural_fields, bit-identical hash).

Float candidates are verified with the *exact forward formula* the jnp path
uses (floor(t_k / rdt) == r), so kernel and jnp outputs agree up to the
order of the per-pixel sums.

Work skipping: a segment spans ~steps*dt/rdt ~ 47 of 465 rows. A jnp prepass
(``_row_tile_spans``) gives, per (segment, column tile), the range of row
tiles its march rows and boundary echo can touch; a forward program skips
every segment whose range misses its row tile, and a backward program loops
over exactly that range.

Differentiation (the reverse of the reference pipeline at
src/main.cpp:106-149): the backward kernel has one program per (column tile,
segment). It loops over the segment's row tiles inside the program,
recomputes the matched rows and scattering terms, multiplies by the incoming
RF cotangent and row-reduces, and writes that segment's gradient slice once.
No two programs write the same output cell, so the backward needs neither a
zeroed output nor atomics, and does not depend on the order in which the GPU
runs its blocks (pure rematerialisation, no saved intermediates). Gradients
then flow through ``pack_segments`` (plain jnp) into the material table, the
traced segments, and — in trilinear texture mode — the sample positions,
hence the probe pose. Supported texture modes mirror
``texture.get_scattering`` exactly: nearest/trilinear x hard/soft-sigmoid
gate (procedural field only).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ...config import SimConfig

# Segment SoA field indices (layout (SD, F, C))
F_FROM_X, F_FROM_Y, F_FROM_Z, F_DIR_X, F_DIR_Y, F_DIR_Z, F_T0, F_STEPS, \
    F_LN_ATT, F_I0, F_MU0, F_MU1, F_SIGMA, F_B_ROW, F_B_VAL, F_VALID = range(16)
N_FIELDS = 16

# (TILE_ROWS, TILE_C) output tile of one forward program: 1024 cells, eight
# per thread at NUM_WARPS=4, so every per-cell temporary of the trilinear
# texture evaluation stays in registers. Powers of two (Triton block rule).
TILE_ROWS = 32
TILE_C = 32
NUM_WARPS = 4


def _hash_i32(x):
    """lowbias32 on int32 with wrapping multiply + logical shifts —
    bit-identical to texture.hash_u32 on uint32."""
    x = x ^ jax.lax.shift_right_logical(x, 16)
    x = x * jnp.int32(0x7FEB352D)
    x = x ^ jax.lax.shift_right_logical(x, 15)
    x = x * jnp.int32(-2073254261)  # 0x846CA68B as signed i32
    x = x ^ jax.lax.shift_right_logical(x, 16)
    return x


def _bitsum_normal_i32(bits):
    """Dithered-binomial ~N(0,1) on int32 hash words — bit-identical to
    texture._bitsum_normal (popcount of the high 16 bits + 16-bit uniform
    dither; zero transcendentals). See cfg.scatter_rng."""
    from ..texture import BITSUM_SCALE

    pc = jax.lax.population_count(
        jax.lax.shift_right_logical(bits, 16)
    ).astype(jnp.float32)
    u = ((bits & jnp.int32(0xFFFF)).astype(jnp.float32) + 0.5) * (1.0 / 65536.0)
    return (pc + u - 8.5) * jnp.float32(BITSUM_SCALE)


def _voxel_fields(ix, iy, iz, seed0, seed1, size, rng: str = "boxmuller"):
    """(noise, prob) ~ iid N(0,1) for integer voxel indices — the in-kernel
    twin of texture.procedural_fields (bit-identical for both scatter_rng
    modes: hash + Box-Muller, or hash + dithered-binomial bit-sum)."""
    vid = (ix * size + iy) * size + iz
    b1 = _hash_i32(vid ^ seed0)
    b2 = _hash_i32(vid ^ seed1)
    if rng == "bitsum":
        return _bitsum_normal_i32(b1), _bitsum_normal_i32(b2)
    u1 = (jax.lax.shift_right_logical(b1, 8).astype(jnp.float32) + 0.5) * (
        1.0 / 16777216.0
    )
    u2 = (jax.lax.shift_right_logical(b2, 8).astype(jnp.float32) + 0.5) * (
        1.0 / 16777216.0
    )
    r_bm = jnp.sqrt(-2.0 * jnp.log(u1))
    theta = (2.0 * jnp.pi) * u2
    return r_bm * jnp.cos(theta), r_bm * jnp.sin(theta)


def _scat_eval(px, py, pz, mu0, mu1, sigma, seed0, seed1, cfg: SimConfig,
               want_grads: bool):
    """Scattering amplitude at world points (formula-identical to
    texture.get_scattering in procedural mode), plus — when ``want_grads`` —
    its partial derivatives w.r.t. mu0, mu1, sigma and the point coordinates.

    Returns dict with ``scat`` and (if want_grads) ``d_mu0, d_mu1, d_sigma,
    d_px, d_py, d_pz`` (position partials are zero in nearest mode — floor
    and C-cast truncation have zero derivative a.e., matching jnp AD).
    """
    res = cfg.resolution_um / 1000.0
    size = cfg.volume_size
    pow2 = size & (size - 1) == 0

    def wrap_mod(q):
        # two's-complement AND == double-mod wrap for power-of-two sizes
        # (bit-identical twin of texture._wrap_mod)
        if pow2:
            return q & jnp.int32(size - 1)
        return jnp.mod(jnp.mod(q, size) + size, size)

    if cfg.trilinear_texture:
        def prep(x):
            f = x / res - 0.5
            i0 = jnp.floor(f).astype(jnp.int32)
            return i0, f - jnp.floor(f)

        i0x, wx = prep(px)
        i0y, wy = prep(py)
        i0z, wz = prep(pz)
        noise = jnp.zeros_like(px)
        prob = jnp.zeros_like(px)
        dn_dw = [jnp.zeros_like(px) for _ in range(3)] if want_grads else None
        dp_dw = [jnp.zeros_like(px) for _ in range(3)] if want_grads else None
        for ox in (0, 1):
            for oy in (0, 1):
                for oz in (0, 1):
                    n_t, p_t = _voxel_fields(
                        wrap_mod(i0x + ox), wrap_mod(i0y + oy), wrap_mod(i0z + oz),
                        seed0, seed1, size, rng=cfg.scatter_rng,
                    )
                    wfx = wx if ox else 1.0 - wx
                    wfy = wy if oy else 1.0 - wy
                    wfz = wz if oz else 1.0 - wz
                    noise = noise + n_t * (wfx * wfy * wfz)
                    prob = prob + p_t * (wfx * wfy * wfz)
                    if want_grads:
                        sx = 1.0 if ox else -1.0
                        sy = 1.0 if oy else -1.0
                        sz = 1.0 if oz else -1.0
                        dn_dw[0] += n_t * sx * wfy * wfz
                        dn_dw[1] += n_t * sy * wfx * wfz
                        dn_dw[2] += n_t * sz * wfx * wfy
                        dp_dw[0] += p_t * sx * wfy * wfz
                        dp_dw[1] += p_t * sy * wfx * wfz
                        dp_dw[2] += p_t * sz * wfx * wfy
    else:
        def wrap(x):
            return wrap_mod(jnp.trunc(x / res).astype(jnp.int32))

        noise, prob = _voxel_fields(
            wrap(px), wrap(py), wrap(pz), seed0, seed1, size,
            rng=cfg.scatter_rng,
        )

    value = noise * sigma + mu0
    if cfg.soft_scattering:
        gate = jax.nn.sigmoid((prob - mu1) / cfg.soft_scattering_tau)
        dgate_dprob = gate * (1.0 - gate) / cfg.soft_scattering_tau
    else:
        gate = (prob >= mu1).astype(jnp.float32)
        dgate_dprob = None
    out = {"scat": value * gate}
    if not want_grads:
        return out

    out["d_mu0"] = gate
    out["d_sigma"] = noise * gate
    out["d_mu1"] = -value * dgate_dprob if dgate_dprob is not None else jnp.zeros_like(px)
    if cfg.trilinear_texture:
        d_noise = sigma * gate
        d_prob = value * dgate_dprob if dgate_dprob is not None else 0.0
        for axis, name in enumerate(("d_px", "d_py", "d_pz")):
            g = d_noise * dn_dw[axis]
            if dgate_dprob is not None:
                g = g + d_prob * dp_dw[axis]
            out[name] = g / res
    else:
        zero = jnp.zeros_like(px)
        out["d_px"] = out["d_py"] = out["d_pz"] = zero
    return out


def _match_rows(rows_f, t0, steps, valid, row_ok, cfg: SimConfig):
    """Which march step (if any) of this segment lands in each output row —
    the exact inverse of the jnp path's floor(t_k/rdt) binning. Returns
    (matched mask, selected k) with matched implying a unique k per row."""
    dt = cfg.march_dt_us
    rdt = cfg.rf_row_dt_us
    t_window = float(cfg.max_travel_time_us)
    inv_a = rdt / dt

    k_guess = jnp.floor((rows_f - t0 / rdt) * inv_a)
    k_sel = jnp.zeros_like(rows_f)
    matched = jnp.zeros_like(rows_f, dtype=jnp.bool_)
    for cand in (-1.0, 0.0, 1.0, 2.0):
        k = k_guess + cand
        t_k = t0 + k * dt
        hit = (
            (jnp.floor(t_k / rdt) == rows_f)
            & (k >= 0.0)
            & (k < steps)
            & (t_k < t_window)
        )
        k_sel = jnp.where(hit, k, k_sel)
        matched = matched | hit
    return matched & valid & row_ok, k_sel


def _segment_fields(seg_ref, s, c0):
    """The 16 SoA fields of segment ``s`` over this program's column tile,
    each as a (1, TILE_C) row (one dynamic row load per field)."""
    return [seg_ref[s, f, pl.ds(c0, TILE_C)][None, :] for f in range(N_FIELDS)]


def _march_kernel(lo_ref, hi_ref, seeds_ref, seg_ref, out_ref, *, cfg: SimConfig,
                  n_segments: int):
    """Forward: one program per (column tile i, row tile j). Loops over the
    column's segments, skipping those whose row-tile span misses j, and
    writes its (TILE_ROWS, TILE_C) RF tile once."""
    axres = cfg.axial_resolution_mm
    i = pl.program_id(0)
    j = pl.program_id(1)
    c0 = i * TILE_C

    rows_i = j * TILE_ROWS + jnp.arange(TILE_ROWS, dtype=jnp.int32)[:, None]
    rows_f = rows_i.astype(jnp.float32)
    row_ok = rows_i < cfg.rf_rows
    seed0 = seeds_ref[0]
    seed1 = seeds_ref[1]

    def accumulate(s, acc):
        fld = _segment_fields(seg_ref, s, c0)
        matched, k_sel = _match_rows(
            rows_f, fld[F_T0], fld[F_STEPS], fld[F_VALID] > 0.5, row_ok, cfg
        )
        # sample point along the segment (world units; reference treats the
        # mm-valued axial step as world units, src/main.cpp:117)
        scale = k_sel * axres
        scat = _scat_eval(
            fld[F_FROM_X] + scale * fld[F_DIR_X],
            fld[F_FROM_Y] + scale * fld[F_DIR_Y],
            fld[F_FROM_Z] + scale * fld[F_DIR_Z],
            fld[F_MU0], fld[F_MU1], fld[F_SIGMA],
            seed0, seed1, cfg, want_grads=False,
        )["scat"]
        intens = fld[F_I0] * jnp.exp(fld[F_LN_ATT] * k_sel)
        acc = acc + jnp.where(matched, intens * scat, 0.0)
        # boundary echo (Burger13 Eq. 10 term, reference src/main.cpp:139)
        return acc + jnp.where((rows_f == fld[F_B_ROW]) & row_ok, fld[F_B_VAL], 0.0)

    def body(s, acc):
        touches = (lo_ref[s, i] <= j) & (hi_ref[s, i] >= j)
        return jax.lax.cond(
            touches, lambda a: accumulate(s, a), lambda a: a, acc
        )

    out_ref[...] = jax.lax.fori_loop(
        0, n_segments, body, jnp.zeros((TILE_ROWS, TILE_C), jnp.float32)
    )


def _march_bwd_kernel(lo_ref, hi_ref, seeds_ref, seg_ref, g_ref, gout_ref,
                      *, cfg: SimConfig):
    """Backward: one program per (column tile i, segment s). Loops over the
    row tiles of the segment's span, recomputes the forward terms, multiplies
    by the RF cotangent and row-reduces; then writes the segment's
    (N_FIELDS, TILE_C) gradient slice, which no other program touches."""
    axres = cfg.axial_resolution_mm
    i = pl.program_id(0)
    s = pl.program_id(1)
    c0 = i * TILE_C
    seed0 = seeds_ref[0]
    seed1 = seeds_ref[1]
    fld = _segment_fields(seg_ref, s, c0)
    valid = fld[F_VALID] > 0.5
    dx, dy, dz = fld[F_DIR_X], fld[F_DIR_Y], fld[F_DIR_Z]
    grad_fields = (
        F_FROM_X, F_FROM_Y, F_FROM_Z, F_DIR_X, F_DIR_Y, F_DIR_Z, F_LN_ATT,
        F_I0, F_MU0, F_MU1, F_SIGMA, F_B_VAL,
    )

    def body(r, accs):
        rows_i = r * TILE_ROWS + jnp.arange(TILE_ROWS, dtype=jnp.int32)[:, None]
        rows_f = rows_i.astype(jnp.float32)
        row_ok = rows_i < cfg.rf_rows
        g = g_ref[pl.ds(r * TILE_ROWS, TILE_ROWS), pl.ds(c0, TILE_C)]
        matched, k_sel = _match_rows(
            rows_f, fld[F_T0], fld[F_STEPS], valid, row_ok, cfg
        )
        scale = k_sel * axres
        sc = _scat_eval(
            fld[F_FROM_X] + scale * dx,
            fld[F_FROM_Y] + scale * dy,
            fld[F_FROM_Z] + scale * dz,
            fld[F_MU0], fld[F_MU1], fld[F_SIGMA],
            seed0, seed1, cfg, want_grads=True,
        )
        decay = jnp.exp(fld[F_LN_ATT] * k_sel)
        gm = jnp.where(matched, g, 0.0)
        gi = gm * (fld[F_I0] * decay)  # cotangent routed through intens*scat
        gpx = gi * sc["d_px"]
        gpy = gi * sc["d_py"]
        gpz = gi * sc["d_pz"]
        terms = (
            gpx, gpy, gpz, gpx * scale, gpy * scale, gpz * scale,
            gi * k_sel * sc["scat"],
            gm * decay * sc["scat"],
            gi * sc["d_mu0"],
            gi * sc["d_mu1"],
            gi * sc["d_sigma"],
            jnp.where((rows_f == fld[F_B_ROW]) & row_ok, g, 0.0),
        )
        return tuple(a + jnp.sum(t, axis=0) for a, t in zip(accs, terms))

    zero = jnp.zeros((TILE_C,), jnp.float32)
    accs = jax.lax.fori_loop(
        lo_ref[s, i], hi_ref[s, i] + 1, body, (zero,) * len(grad_fields)
    )
    grads = dict(zip(grad_fields, accs))
    for f in range(N_FIELDS):
        gout_ref[s, f, pl.ds(c0, TILE_C)] = grads.get(f, zero)


def _row_tile_spans(soa, cfg: SimConfig, n_row_tiles: int):
    """Per (segment, column tile): the inclusive range [lo, hi] of row tiles
    that the segment's march rows or boundary-echo row can touch in any
    column of the tile (lo > hi when none). A conservative +-1-row guard
    around the exact floor binning; the kernels' exact row match makes any
    extra tile a no-op. Returns (lo, hi), each (SD, C_pad // TILE_C) i32."""
    rdt = cfg.rf_row_dt_us
    dt = cfg.march_dt_us
    sd, _, c_pad = soa.shape
    t0 = soa[:, F_T0, :]
    steps = soa[:, F_STEPS, :]
    valid = soa[:, F_VALID, :] > 0.5
    # the boundary-echo row floor((t0 + dt*(steps-1))/rdt) lies inside
    # [r0, r1] whenever steps >= 1 (the only case it is written)
    n_rows_pad = n_row_tiles * TILE_ROWS
    r0 = jnp.clip(jnp.floor(t0 / rdt) - 1.0, 0.0, n_rows_pad)
    r1 = jnp.clip(jnp.floor((t0 + steps * dt) / rdt) + 1.0, -1.0, n_rows_pad - 1)
    lo = jnp.floor(r0 / TILE_ROWS).astype(jnp.int32)
    hi = jnp.floor(r1 / TILE_ROWS).astype(jnp.int32)
    lo = jnp.where(valid, lo, n_row_tiles)
    hi = jnp.where(valid, hi, -1)
    c_tiles = c_pad // TILE_C
    lo = jnp.min(lo.reshape(sd, c_tiles, TILE_C), axis=2)
    hi = jnp.max(hi.reshape(sd, c_tiles, TILE_C), axis=2)
    return lo, hi


def pack_segments(segments, materials, cfg: SimConfig, n_cols: int):
    """Regroup the (D, N) segment tensor into the kernel's (SD, F, C) SoA.

    Paths are ordered column-major (path = c * S + s), so columns are a
    reshape away. Pads C up to a TILE_C multiple with invalid columns.
    Plain differentiable jnp: the custom-VJP boundary sits below this, so
    material/segment gradients flow through here by ordinary AD.
    """
    from ...models.simulator import segment_march_quantities

    d, n = segments["valid"].shape
    s = cfg.samples_per_element
    c = n_cols
    rdt = cfg.rf_row_dt_us
    dt = cfg.march_dt_us

    def per_col(x):
        # (D, C*S) -> (C, S*D)
        return x.reshape(d, c, s).transpose(1, 2, 0).reshape(c, s * d)

    frm = segments["from"].reshape(d, n, 3)
    dire = segments["direction"].reshape(d, n, 3)

    steps, t0, ln_att, mu0, mu1, sigma = segment_march_quantities(
        segments, materials, cfg
    )

    b_time = t0 + dt * (steps - 1.0)
    b_row = jnp.floor(b_time / rdt)
    b_ok = segments["valid"] & (steps >= 1.0) & (b_row >= 0) & (b_row < cfg.rf_rows)
    b_row = jnp.where(b_ok, b_row, -1.0)
    b_val = segments["reflected"] / s

    fields = [
        frm[..., 0], frm[..., 1], frm[..., 2],
        dire[..., 0], dire[..., 1], dire[..., 2],
        t0, steps, ln_att, segments["initial"],
        mu0, mu1, sigma, b_row, b_val,
        segments["valid"].astype(jnp.float32),
    ]
    soa = jnp.stack([per_col(f) for f in fields], axis=0)  # (F, C, SD)
    soa = soa.transpose(2, 0, 1)  # (SD, F, C)
    pad = (-c) % TILE_C
    if pad:
        soa = jnp.pad(soa, ((0, 0), (0, 0), (0, pad)))
    return soa


@functools.lru_cache(maxsize=None)
def _march_op(cfg: SimConfig, interpret: bool):
    """custom_vjp'd (soa, seeds) -> padded RF image for a given config."""
    n_row_tiles = -(-cfg.rf_rows // TILE_ROWS)
    params = pltriton.CompilerParams(num_warps=NUM_WARPS, num_stages=1)

    def fwd_call(soa, seeds):
        sd, c_pad = soa.shape[0], soa.shape[2]
        lo, hi = _row_tile_spans(soa, cfg, n_row_tiles)
        return pl.pallas_call(
            functools.partial(_march_kernel, cfg=cfg, n_segments=sd),
            grid=(c_pad // TILE_C, n_row_tiles),
            out_specs=pl.BlockSpec((TILE_ROWS, TILE_C), lambda i, j: (j, i)),
            out_shape=jax.ShapeDtypeStruct(
                (n_row_tiles * TILE_ROWS, c_pad), jnp.float32
            ),
            backend="triton",
            compiler_params=params,
            interpret=interpret,
            name="march_fwd",
        )(lo, hi, seeds, soa)

    def bwd_call(soa, seeds, g):
        sd, c_pad = soa.shape[0], soa.shape[2]
        lo, hi = _row_tile_spans(soa, cfg, n_row_tiles)
        # g is the cotangent of the op's padded (n_row_tiles*TILE_ROWS, c_pad)
        # output
        return pl.pallas_call(
            functools.partial(_march_bwd_kernel, cfg=cfg),
            grid=(c_pad // TILE_C, sd),
            out_shape=jax.ShapeDtypeStruct((sd, N_FIELDS, c_pad), jnp.float32),
            backend="triton",
            compiler_params=params,
            interpret=interpret,
            name="march_bwd",
        )(lo, hi, seeds, soa, g)

    @jax.custom_vjp
    def op(soa, seeds):
        return fwd_call(soa, seeds)

    def op_fwd(soa, seeds):
        return fwd_call(soa, seeds), (soa, seeds)

    def op_bwd(res, g):
        soa, seeds = res
        return (
            bwd_call(soa, seeds, g),
            np.zeros(seeds.shape, jax.dtypes.float0),  # int seeds: no tangent
        )

    op.defvjp(op_fwd, op_bwd)
    return op


def march_and_accumulate_pallas(
    segments,
    materials,
    volume,
    cfg: SimConfig,
    n_cols: int | None = None,
    *,
    interpret: bool = False,
):
    """Drop-in replacement for simulator.march_and_accumulate. Returns the
    (rf_rows, n_cols) RF image. Differentiable: carries a custom VJP (see
    module docstring).

    Works for BOTH texture modes: "procedural" volumes carry seeds directly;
    "table" volumes are materialised from the same hash field and carry the
    seeds alongside (make_texture_volume), so evaluating the hash in-kernel
    reproduces the table gather bit-for-bit — no (size^3) gather needed."""
    if "seeds" not in volume:
        raise ValueError(
            "pallas march requires a volume with 'seeds' (make_texture_volume "
            "provides them for both 'procedural' and 'table' modes); externally "
            "supplied raw tables must use the jnp march path"
        )
    if cfg.soft_row_binning:
        raise ValueError("the march kernel bins rows hard; soft_row_binning "
                         "needs the jnp march path")
    c = n_cols or cfg.rf_cols
    soa = pack_segments(segments, materials, cfg, c)
    seeds = volume["seeds"].astype(jnp.int32)
    out = _march_op(cfg, interpret)(soa, seeds)
    return out[: cfg.rf_rows, :c]
