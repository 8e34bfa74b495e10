"""RF image pipeline: echo accumulation, PSF convolution, envelope detection,
scan conversion.

Array-program rebuild of the reference's rf_image<cols, max_t, axial_res>
(reference: src/rfimage.h). The per-echo ``+=`` becomes a masked scatter-add;
the two nested convolution loops become sliced tensor contractions XLA fuses; the sequential per-column peak walk of ``envelope()`` is
re-derived as a closed-form parallel prefix (peaks are exactly the
rise-then-non-rise samples, see proof in ``envelope``); ``cv::remap`` scan
conversion becomes a precomputed gather map + bilinear ``map_coordinates`` —
fully differentiable end to end.

Reference-exact mode (default) replicates the uncentered kernels and the
untouched border regions byte-for-byte in composition (SURVEY.md §7 quirks);
``cfg.centered_psf`` switches to a centered 'same' convolution.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SimConfig
from . import psf as psf_mod

Array = jax.Array


# ---------------------------------------------------------------------------
# Echo accumulation (reference add_echo, src/rfimage.h:33-40)
# ---------------------------------------------------------------------------

def time_to_row(time_us: Array, cfg: SimConfig) -> Array:
    """row = floor(t / (axial_res_um / c)) — the truncated-int binning of
    add_echo (src/rfimage.h:35, int conversion of the dimensionless row)."""
    return jnp.floor(time_us / cfg.rf_row_dt_us).astype(jnp.int32)


def accumulate_echoes(
    rows: Array,   # (N,) i32 target rows (any value; invalid masked)
    cols: Array,   # (N,) i32 target columns
    values: Array, # (N,) f32 echo intensities
    valid: Array,  # (N,) bool
    cfg: SimConfig,
    n_cols: int | None = None,
) -> Array:
    """Masked scatter-add into a fresh (rf_rows, n_cols) image; n_cols
    defaults to the full element count and is the local shard width under
    scanline sharding."""
    ok = valid & (rows >= 0) & (rows < cfg.rf_rows)
    rf = jnp.zeros((cfg.rf_rows, n_cols or cfg.rf_cols), jnp.float32)
    safe_rows = jnp.where(ok, rows, 0)
    safe_cols = jnp.where(ok, cols, 0)
    vals = jnp.where(ok, values, 0.0)
    return rf.at[safe_rows, safe_cols].add(vals)


def accumulate_echoes_soft(
    times_us: Array,  # (N,) f32 echo round-trip times [us]
    cols: Array,      # (N,) i32 target columns
    values: Array,    # (N,) f32 echo intensities
    valid: Array,     # (N,) bool
    cfg: SimConfig,
    n_cols: int | None = None,
) -> Array:
    """Differentiable two-row relaxation of add_echo (cfg.soft_row_binning):
    each echo lands in rows floor(t/rdt) and floor(t/rdt)+1 with linear
    weights, so d(RF)/d(time) is the finite row-difference instead of zero.
    Total deposited energy equals the hard binning's (weights sum to 1)
    EXCEPT at the window's last row: an echo whose r0 == rf_rows-1 has its
    r0+1 share (up to ``frac`` of its value) fall outside the image and be
    dropped, so energy parity with hard binning only holds with >=1 row of
    margin. Kept as-is (clamping r0+1 would double-deposit into the last
    row and bias the boundary); parity comparisons must keep that margin."""
    rf_row = times_us / cfg.rf_row_dt_us
    r0f = jnp.floor(rf_row)
    frac = rf_row - jax.lax.stop_gradient(r0f)  # gradient rides frac only
    r0 = r0f.astype(jnp.int32)
    rows2 = jnp.concatenate([r0, r0 + 1])
    cols2 = jnp.concatenate([cols, cols])
    vals2 = jnp.concatenate([values * (1.0 - frac), values * frac])
    valid2 = jnp.concatenate([valid, valid])
    return accumulate_echoes(rows2, cols2, vals2, valid2, cfg, n_cols)


# ---------------------------------------------------------------------------
# PSF convolution (reference convolve, src/rfimage.h:93-123)
# ---------------------------------------------------------------------------

def convolve_psf(rf: Array, cfg: SimConfig) -> Array:
    ax = psf_mod.axial_kernel(cfg)
    lat = psf_mod.lateral_kernel(cfg)
    if cfg.centered_psf:
        return _convolve_centered(rf, ax, lat)
    return _convolve_reference(rf, ax, lat)


def _convolve_reference(rf: Array, ax: Array, lat: Array) -> Array:
    """Exact reference composition: forward-shifted (uncentered) kernels,
    axial pass into a buffer for rows [A, R-A), lateral pass written back to
    the image only for rows [A, R-A) x cols [L/2, C-L) — all other cells keep
    their RAW pre-convolution echo values (src/rfimage.h:97-122)."""
    rows, cols = rf.shape
    a = ax.shape[0]
    l = lat.shape[0]

    # Degenerate windows: the reference's loops simply don't execute when the
    # image is smaller than the kernel spans (src/rfimage.h:99,113), leaving
    # the raw image untouched.
    if rows <= 2 * a or cols <= l + l // 2:
        return rf

    # conv_ax_valid[r, c] = sum_k rf[r+k, c] * ax[k], r in [0, rows-a]
    rv = rows - a + 1
    conv_ax = sum(rf[k : k + rv, :] * ax[k] for k in range(a))
    # Embed at the reference's row window [a, rows-a). Rows below a in the
    # buffer are never read by the lateral pass.
    buf = jnp.zeros_like(rf).at[a : rows - a, :].set(conv_ax[a : rows - a, :])

    cv = cols - l + 1
    conv_lat = sum(buf[:, k : k + cv] * lat[k] for k in range(l))

    out = rf.at[a : rows - a, l // 2 : cols - l].set(
        conv_lat[a : rows - a, l // 2 : cols - l]
    )
    return out


def convolve_psf_sharded(rf_local: Array, cfg: SimConfig, axis: str, n_shards: int) -> Array:
    """Column-sharded reference convolution inside ``shard_map``.

    The axial pass is column-local. The lateral pass reads up to l-1 columns
    to the RIGHT of each output column (the reference's forward-shifted
    kernel, src/rfimage.h:116-118), so each shard fetches an (R, l-1) halo
    from its right neighbour with one ``ppermute`` — instead of
    gathering the whole RF image. Cells outside the reference's write window
    (global cols [l//2, C-l), rows [a, R-a)) keep their raw echo values.
    """
    ax = psf_mod.axial_kernel(cfg)
    lat = psf_mod.lateral_kernel(cfg)
    rows, c_local = rf_local.shape
    a = ax.shape[0]
    l = lat.shape[0]
    c_global = c_local * n_shards
    if rows <= 2 * a or c_global <= l + l // 2:
        return rf_local

    rv = rows - a + 1
    conv_ax = sum(rf_local[k : k + rv, :] * ax[k] for k in range(a))
    buf = jnp.zeros_like(rf_local).at[a : rows - a, :].set(conv_ax[a : rows - a, :])

    # right-neighbour halo of l-1 columns; when shards are narrower than the
    # kernel the halo spans several neighbours — rotate shard blocks left
    # until enough columns are collected
    n_steps = -(-(l - 1) // c_local)
    parts = [buf]
    rot = buf
    perm = [(j, (j - 1) % n_shards) for j in range(n_shards)]
    for _ in range(n_steps):
        rot = jax.lax.ppermute(rot, axis, perm=perm)
        parts.append(rot)
    buf_ext = jnp.concatenate(parts, axis=1)[:, : c_local + l - 1]

    conv_lat = sum(buf_ext[:, k : k + c_local] * lat[k] for k in range(l))

    my_shard = jax.lax.axis_index(axis)
    col_global = my_shard * c_local + jnp.arange(c_local)
    col_ok = (col_global >= l // 2) & (col_global < c_global - l)
    row_ok = (jnp.arange(rows) >= a) & (jnp.arange(rows) < rows - a)
    write = row_ok[:, None] & col_ok[None, :]
    return jnp.where(write, conv_lat, rf_local)


def convolve_psf_rows_sharded(rf_local: Array, cfg: SimConfig, axis: str, n_shards: int) -> Array:
    """Time-row-sharded reference convolution inside ``shard_map``.

    The depth/time axis is the third long axis of the problem (SURVEY.md §2.3
    long axis (b): ~465 rows at 4.5 MHz, grows with depth x frequency). When
    the RF image is sharded over rows instead of scanline columns, the
    AXIAL pass is the cross-shard one: the reference's forward-shifted 7-tap
    kernel reads rows [r, r+a) (src/rfimage.h:102-104), so each shard fetches
    an (a-1, C) halo from the shard below it with ``ppermute``. The
    lateral pass and the write-window masking are then row-local.

    Composition matches ``_convolve_reference`` exactly: cells outside the
    reference's write window (global rows [a, R-a) x cols [l//2, C-l)) keep
    their raw echo values, and the lateral pass reads a buffer that is zero
    outside the axial row window.
    """
    ax = psf_mod.axial_kernel(cfg)
    lat = psf_mod.lateral_kernel(cfg)
    r_local, cols = rf_local.shape
    a = ax.shape[0]
    l = lat.shape[0]
    r_global = r_local * n_shards
    if r_global <= 2 * a or cols <= l + l // 2:
        return rf_local

    # halo: the axial pass at local row r reads global rows [r, r+a), i.e.
    # up to a-1 rows owned by following shard(s); rotate shard blocks up
    # until enough rows are collected (a-1 may span several shards when
    # shards are shorter than the kernel)
    n_steps = -(-(a - 1) // r_local)
    parts = [rf_local]
    rot = rf_local
    perm = [(j, (j - 1) % n_shards) for j in range(n_shards)]
    for _ in range(n_steps):
        rot = jax.lax.ppermute(rot, axis, perm=perm)
        parts.append(rot)
    ext = jnp.concatenate(parts, axis=0)[: r_local + a - 1, :]
    # ext wraps shard 0's rows onto the last shard's tail; those values are
    # only read by output rows >= R-a, which the write mask discards.
    conv_ax = sum(ext[k : k + r_local, :] * ax[k] for k in range(a))

    my_shard = jax.lax.axis_index(axis)
    row_global = my_shard * r_local + jnp.arange(r_local)
    row_ok = (row_global >= a) & (row_global < r_global - a)
    buf = jnp.where(row_ok[:, None], conv_ax, 0.0)

    cv = cols - l + 1
    conv_lat = sum(buf[:, k : k + cv] * lat[k] for k in range(l))
    conv_full = jnp.zeros_like(rf_local).at[:, :cv].set(conv_lat)

    col_ok = (jnp.arange(cols) >= l // 2) & (jnp.arange(cols) < cols - l)
    write = row_ok[:, None] & col_ok[None, :]
    return jnp.where(write, conv_full, rf_local)


def _convolve_centered(rf: Array, ax: Array, lat: Array) -> Array:
    """Centered separable 'same' correlation with zero padding — the
    fixed-up variant of the reference's shifted kernels."""
    a, l = ax.shape[0], lat.shape[0]
    pa, pl = a // 2, l // 2
    padded = jnp.pad(rf, ((pa, a - 1 - pa), (0, 0)))
    rv = rf.shape[0]
    axial = sum(padded[k : k + rv, :] * ax[k] for k in range(a))
    padded2 = jnp.pad(axial, ((0, 0), (pl, l - 1 - pl)))
    cv = rf.shape[1]
    return sum(padded2[:, k : k + cv] * lat[k] for k in range(l))


# ---------------------------------------------------------------------------
# Envelope (reference envelope, src/rfimage.h:54-91)
# ---------------------------------------------------------------------------

def envelope(rf: Array) -> Array:
    """Parallel closed form of the reference's sequential peak-lerp walk.

    The C++ keeps an ``ascending`` flag and, at the first non-rise after a
    rise, lerps |peak| values across the gap. Unrolling the state machine:
    a peak fires at row i (1 <= i <= R-2) iff x[i-1] < x[i] and x[i] >= x[i+1]
    (the flag is true at i exactly when i-1 -> i rose, since any earlier
    descent would have fired and cleared it). Rows after the last peak, and
    all rows when no peak exists, keep their raw values; rows before the
    first peak lerp from x[0] (raw, not abs — reference init, rfimage.h:63-64).
    """
    rows = rf.shape[0]
    x = rf
    rise = x[:-1] < x[1:]  # rise[i]: x[i] < x[i+1], length rows-1
    peak = jnp.zeros_like(x, dtype=bool)
    # peaks at i in [1, rows-2]: rise[i-1] & ~rise[i]
    peak = peak.at[1:-1].set(rise[:-1] & ~rise[1:])

    idx = jnp.arange(rows)[:, None] if rf.ndim == 2 else jnp.arange(rows)
    big = jnp.int32(rows + 1)
    idx_b = jnp.broadcast_to(idx, rf.shape)
    absx = jnp.abs(x)

    # Peak positions AND |values| travel together through associative scans
    # (combine keeps the extremal key's payload) — XLA lowers the former
    # per-column value gathers (x[pos]) at ~57 ns/element, which made this
    # envelope the dominant cost of the fused-postproc BACKWARD pass
    # (8.5 ms/frame, round 4); keys are row indices, hence unique, so the
    # pair-combine is associative and deterministic.
    def take_min(a, b):
        ka, va = a
        kb, vb = b
        t = kb < ka
        return jnp.where(t, kb, ka), jnp.where(t, vb, va)

    def take_max(a, b):
        ka, va = a
        kb, vb = b
        t = kb > ka
        return jnp.where(t, kb, ka), jnp.where(t, vb, va)

    # next peak strictly after j: reverse min-scan, shifted by 1
    m, mv = jax.lax.associative_scan(
        take_min,
        (jnp.where(peak, idx_b, big), jnp.where(peak, absx, 0.0)),
        axis=0,
        reverse=True,
    )
    npk = jnp.concatenate([m[1:], jnp.full_like(m[:1], big)], axis=0)
    next_val = jnp.concatenate([mv[1:], jnp.zeros_like(mv[:1])], axis=0)

    # previous peak at or before j (or -1)
    ppk, pv = jax.lax.associative_scan(
        take_max,
        (jnp.where(peak, idx_b, -1), jnp.where(peak, absx, 0.0)),
        axis=0,
    )

    prev_pos = jnp.maximum(ppk, 0)
    prev_val = jnp.where(ppk < 0, x[0], pv)

    has_next = npk < big
    npk_pos = jnp.where(has_next, npk, 0)

    denom = jnp.maximum(npk_pos - prev_pos, 1)
    alpha = (idx_b - prev_pos).astype(rf.dtype) / denom.astype(rf.dtype)
    lerped = prev_val * (1.0 - alpha) + next_val * alpha
    return jnp.where(has_next, lerped, x)


def envelope_hilbert(rf: Array) -> Array:
    """Exact envelope: |analytic signal| via FFT along the time (row) axis.

    The reference's envelope is a fast peak-interpolation *stand-in* for the
    Hilbert transform (src/rfimage.h:54-91 — "approximation of the hilbert
    transform"); this is the real thing, offered behind
    ``SimConfig.envelope_mode = "hilbert"`` (SURVEY.md §7 item 4). One
    (R, C) complex FFT per frame is noise next to the march, and the whole
    op is differentiable.
    """
    rows = rf.shape[0]
    spec = jnp.fft.fft(rf, axis=0)
    # analytic-signal filter: double positive freqs, keep DC (and Nyquist
    # for even R), zero negative freqs
    h = np.zeros((rows,), np.float32)
    h[0] = 1.0
    if rows % 2 == 0:
        h[rows // 2] = 1.0
        h[1 : rows // 2] = 2.0
    else:
        h[1 : (rows + 1) // 2] = 2.0
    shape = (rows,) + (1,) * (rf.ndim - 1)
    analytic = jnp.fft.ifft(spec * jnp.asarray(h).reshape(shape), axis=0)
    return jnp.abs(analytic)


def apply_envelope(rf: Array, cfg: SimConfig) -> Array:
    """Dispatch on SimConfig.envelope_mode."""
    if cfg.envelope_mode == "hilbert":
        return envelope_hilbert(rf)
    return envelope(rf)


# ---------------------------------------------------------------------------
# Scan conversion (reference create_mapping + cv::remap, src/rfimage.h:183-215, :139)
# ---------------------------------------------------------------------------

def scan_conversion_maps(cfg: SimConfig) -> tuple[np.ndarray, np.ndarray]:
    """Precomputed polar->Cartesian gather maps, numerically identical to the
    reference's create_mapping (src/rfimage.h:183-215). Returns
    (map_row, map_col), each (bmode_rows, bmode_cols) float32 giving the RF
    image coordinates to sample for each output pixel.

    Linear probes need no polar remap: the maps become a plain bilinear
    resize of the rectangular RF grid to the output size."""
    out_rows, out_cols = cfg.bmode_rows, cfg.bmode_cols
    if cfg.probe_type == "linear":
        i = np.arange(out_rows, dtype=np.float32)[:, None]
        j = np.arange(out_cols, dtype=np.float32)[None, :]
        map_row = np.broadcast_to(i / out_rows * cfg.rf_rows, (out_rows, out_cols))
        map_col = np.broadcast_to(j / out_cols * cfg.rf_cols, (out_rows, out_cols))
        return map_row.astype(np.float32).copy(), map_col.astype(np.float32).copy()
    # phased probe: the radius->0 limit of the convex sector (all beams fan
    # from one apex), so the same polar mapping applies with radius 0
    radius_mm = 0.0 if cfg.probe_type == "phased" else cfg.transducer_radius_cm * 10.0
    total = cfg.transducer_amplitude_rad
    depth_mm = cfg.max_travel_time_us * cfg.speed_of_sound * 0.001

    ratio = (depth_mm + radius_mm - radius_mm * np.cos(total / 2.0)) / out_rows
    shift_y = radius_mm * np.cos(total / 2.0)
    half_width = out_cols / 2.0

    i = np.arange(out_rows, dtype=np.float32)[:, None]
    j = np.arange(out_cols, dtype=np.float32)[None, :]
    fi = i + shift_y / ratio
    fj = j - half_width
    r = np.sqrt(fi * fi + fj * fj)
    angle = np.arctan2(fj, fi)

    map_row = (r * ratio - radius_mm) / depth_mm * cfg.rf_rows
    map_col = (angle + total / 2.0) / total * cfg.rf_cols
    return map_row.astype(np.float32), map_col.astype(np.float32)


def scan_convert(rf: Array, map_row: Array, map_col: Array) -> Array:
    """Bilinear gather with zero fill outside — cv::remap(INTER_LINEAR,
    BORDER_CONSTANT, 0) equivalent, and differentiable."""
    return jax.scipy.ndimage.map_coordinates(
        rf, [map_row, map_col], order=1, mode="constant", cval=0.0
    )


def gaussian_blur(img: Array, sigma: float) -> Array:
    """Separable Gaussian blur with edge padding (static kernel size 6*sigma).
    Used by the speckle-robust pose-registration objective
    (models/trainer.py PoseFitter): blurring the compounded B-mode keeps the
    macro anatomy and suppresses the speckle micro-structure."""
    radius = int(3 * sigma)
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    n = k.shape[0]
    rows, cols = img.shape
    padded = jnp.pad(img, ((radius, radius), (0, 0)), mode="edge")
    out = sum(padded[i : i + rows, :] * k[i] for i in range(n))
    padded = jnp.pad(out, ((0, 0), (radius, radius)), mode="edge")
    return sum(padded[:, i : i + cols] * k[i] for i in range(n))


def log_compress(img: Array) -> Array:
    """The reference's commented-out log compression (src/rfimage.h:131-136),
    available behind a flag."""
    mx = jnp.max(img)
    return jnp.log10(img + 1.0) / jnp.log10(mx + 1.0)
