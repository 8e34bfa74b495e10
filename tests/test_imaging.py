"""Imaging pipeline tests: every stage checked against a direct sequential
port of the reference's C++ loops (the oracle implements src/rfimage.h
line-by-line in numpy; the framework implements the same math as parallel
tensor ops)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcray_tpu.config import SimConfig, small_test_config
from mcray_tpu.ops import imaging
from mcray_tpu.ops.psf import axial_kernel, lateral_kernel


# ---------------------------------------------------------------------------
# Oracles: direct ports of the reference algorithms (for testing ONLY)
# ---------------------------------------------------------------------------

def oracle_envelope(img):
    """Sequential port of rf_image::envelope (src/rfimage.h:54-91)."""
    img = img.copy()
    rows, cols = img.shape
    for c in range(cols):
        ascending = img[0, c] < img[1, c]
        last_peak_pos = 0
        last_peak = img[0, c]
        for i in range(1, rows - 1):
            if img[i, c] < img[i + 1, c]:
                ascending = True
            elif ascending:
                ascending = False
                new_peak = abs(img[i, c])
                for j in range(last_peak_pos, i):
                    alpha = (j - last_peak_pos) / (i - last_peak_pos)
                    img[j, c] = last_peak * (1 - alpha) + new_peak * alpha
                last_peak_pos = i
                last_peak = new_peak
    return img


def oracle_convolve(img, ax, lat):
    """Sequential port of rf_image::convolve (src/rfimage.h:93-123)."""
    img = img.copy()
    rows, cols = img.shape
    a, l = len(ax), len(lat)
    buf = np.zeros_like(img)
    for c in range(cols):
        for r in range(a, rows - a):
            buf[r, c] = sum(img[r + k, c] * ax[k] for k in range(a))
    out = img.copy()
    for r in range(a, rows - a):
        for c in range(l // 2, cols - l):
            out[r, c] = sum(buf[r, c + k] * lat[k] for k in range(l))
    return out


def oracle_add_echo(rf, col, echo, micros, cfg):
    row = int(micros / (cfg.axial_resolution_um / cfg.speed_of_sound))
    if 0 <= row < rf.shape[0]:
        rf[row, col] += echo


# ---------------------------------------------------------------------------


@pytest.fixture
def cfg():
    return small_test_config()


def test_envelope_matches_oracle(rng, cfg):
    img = rng.standard_normal((60, 8)).astype(np.float32)
    ours = np.asarray(imaging.envelope(jnp.asarray(img)))
    ref = oracle_envelope(img)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


def test_envelope_monotone_column_untouched(cfg):
    # strictly increasing column has no peak -> all values unchanged
    img = np.linspace(0, 1, 50, dtype=np.float32)[:, None]
    out = np.asarray(imaging.envelope(jnp.asarray(img)))
    np.testing.assert_allclose(out, img, atol=1e-7)


def test_envelope_tail_after_last_peak_raw(cfg):
    img = np.zeros((20, 1), np.float32)
    img[:, 0] = [0, 1, 0.5, 0.2, 0.1, 0.05, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
    ours = np.asarray(imaging.envelope(jnp.asarray(img)))
    ref = oracle_envelope(img)
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_convolve_reference_matches_oracle(rng):
    cfg = SimConfig()
    img = rng.standard_normal((80, 40)).astype(np.float32)
    ax = np.asarray(axial_kernel(cfg))
    lat = np.asarray(lateral_kernel(cfg))
    ours = np.asarray(imaging.convolve_psf(jnp.asarray(img), cfg))
    ref = oracle_convolve(img, ax, lat)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


def test_convolve_centered_impulse():
    cfg = SimConfig(centered_psf=True)
    img = np.zeros((41, 41), np.float32)
    img[20, 20] = 1.0
    out = np.asarray(imaging.convolve_psf(jnp.asarray(img), cfg))
    ax = np.asarray(axial_kernel(cfg))
    lat = np.asarray(lateral_kernel(cfg))
    # impulse response centered at the impulse; correlation semantics means
    # the response reads out the kernel reversed
    np.testing.assert_allclose(out[20, 20], ax[3] * lat[6], rtol=1e-5)
    np.testing.assert_allclose(out[17:24, 20], ax[::-1] * lat[6], rtol=1e-4, atol=1e-6)


def test_add_echo_binning(rng, cfg):
    rf_ref = np.zeros((cfg.rf_rows, cfg.rf_cols), np.float32)
    n = 500
    cols = rng.integers(0, cfg.rf_cols, n)
    micros = rng.uniform(0, cfg.max_travel_time_us * 1.2, n).astype(np.float32)
    echoes = rng.standard_normal(n).astype(np.float32)
    for c, e, t in zip(cols, echoes, micros):
        oracle_add_echo(rf_ref, c, e, t, cfg)
    rows = imaging.time_to_row(jnp.asarray(micros), cfg)
    ours = np.asarray(
        imaging.accumulate_echoes(
            rows, jnp.asarray(cols, jnp.int32), jnp.asarray(echoes),
            jnp.ones(n, bool), cfg,
        )
    )
    np.testing.assert_allclose(ours, rf_ref, rtol=1e-5, atol=1e-6)


def test_soft_row_binning_conserves_energy_and_differentiates(rng, cfg):
    """cfg.soft_row_binning: per-echo two-row linear split (a) deposits the
    same total energy as the hard floor binning for in-window echoes, (b) is
    differentiable in echo time with the finite row-difference as gradient
    (the hard floor's a.e.-zero derivative is the VERDICT r3 item 7 root
    cause for unusable AD pose gradients)."""
    n = 300
    cols = jnp.asarray(rng.integers(0, cfg.rf_cols, n), jnp.int32)
    # keep an entire row of margin so both split rows stay in-window
    micros = jnp.asarray(
        rng.uniform(cfg.rf_row_dt_us, (cfg.rf_rows - 2) * cfg.rf_row_dt_us, n),
        jnp.float32,
    )
    vals = jnp.asarray(rng.uniform(0.1, 1.0, n), jnp.float32)
    ok = jnp.ones(n, bool)

    hard = imaging.accumulate_echoes(
        imaging.time_to_row(micros, cfg), cols, vals, ok, cfg
    )
    soft = imaging.accumulate_echoes_soft(micros, cols, vals, ok, cfg)
    np.testing.assert_allclose(float(soft.sum()), float(hard.sum()), rtol=1e-5)

    def f(dt_us):
        return jnp.sum(
            imaging.accumulate_echoes_soft(micros + dt_us, cols, vals, ok, cfg)
            * jnp.arange(cfg.rf_rows, dtype=jnp.float32)[:, None]
        )

    g = float(jax.grad(f)(0.0))
    # moving every echo later by rdt shifts each value down one row: the
    # row-weighted sum grows by sum(vals) per rdt
    expected = float(vals.sum()) / cfg.rf_row_dt_us
    np.testing.assert_allclose(g, expected, rtol=1e-3)


def test_scan_maps_reference_formulas():
    cfg = SimConfig()
    map_row, map_col = imaging.scan_conversion_maps(cfg)
    assert map_row.shape == (400, 500)
    # center-top pixel of the fan: i=0, j=250 -> fi = shift/ratio, fj=0
    radius = 30.0
    total = np.deg2rad(60.0)
    depth = 100 * 1500 * 0.001
    ratio = (depth + radius - radius * np.cos(total / 2)) / 400
    shift = radius * np.cos(total / 2)
    fi = 0 + shift / ratio
    r = fi
    expect_row = (r * ratio - radius) / depth * cfg.rf_rows
    np.testing.assert_allclose(map_row[0, 250], expect_row, rtol=1e-4)
    np.testing.assert_allclose(map_col[0, 250], 0.5 * cfg.rf_cols, rtol=1e-5)
    # angles beyond the aperture map outside [0, rf_cols]
    assert map_col[0, 0] < 0 or map_col[0, 0] > cfg.rf_cols


def test_scan_convert_bilinear_and_border():
    rf = jnp.asarray(np.arange(20, dtype=np.float32).reshape(4, 5))
    mr = jnp.asarray(np.array([[1.5, -1.0], [0.0, 3.0]], np.float32))
    mc = jnp.asarray(np.array([[2.0, 2.0], [0.25, 4.0]], np.float32))
    out = np.asarray(imaging.scan_convert(rf, mr, mc))
    np.testing.assert_allclose(out[0, 0], (7 + 12) / 2, rtol=1e-6)
    np.testing.assert_allclose(out[0, 1], 0.0)  # outside -> cval 0
    np.testing.assert_allclose(out[1, 0], 0.25, rtol=1e-6)
    np.testing.assert_allclose(out[1, 1], 19.0, rtol=1e-6)


def test_envelope_hilbert_recovers_modulated_gaussian():
    """|analytic signal| of a cos-modulated Gaussian is the Gaussian, away
    from the window edges."""
    import numpy as np
    from mcray_tpu.ops.imaging import envelope_hilbert

    rows = 256
    t = np.arange(rows, dtype=np.float32)
    env = np.exp(-0.5 * ((t - 128.0) / 12.0) ** 2).astype(np.float32)
    rf = env * np.cos(2 * np.pi * 0.22 * t).astype(np.float32)
    out = np.asarray(envelope_hilbert(jnp.asarray(rf[:, None])))[:, 0]
    core = slice(90, 168)
    np.testing.assert_allclose(out[core], env[core], atol=0.03)


def test_envelope_hilbert_multi_column_and_odd_rows():
    import numpy as np
    from mcray_tpu.ops.imaging import envelope_hilbert

    rng = np.random.default_rng(3)
    rf = rng.standard_normal((129, 7)).astype(np.float32)
    out = np.asarray(envelope_hilbert(jnp.asarray(rf)))
    assert out.shape == rf.shape
    assert np.all(out >= np.abs(rf) - 1e-4)  # envelope bounds the signal


def test_render_with_hilbert_envelope(sphere_pack):
    import dataclasses
    from mcray_tpu.models.simulator import Simulator

    pack, cfg = sphere_pack
    cfg_h = dataclasses.replace(cfg, envelope_mode="hilbert")
    sim = Simulator(pack, cfg_h)
    out = sim.render_frame(seed=0)
    b = np.asarray(out["bmode"])
    assert np.isfinite(b).all() and b.max() > 0


# ---------------------------------------------------------------------------
# The plain-XLA imaging stages at full width (they run on every backend)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("probe", ["convex", "linear", "phased"])
def test_scan_convert_matches_scipy_map_coordinates(rng, probe):
    """imaging.scan_convert is scipy's order-1 map_coordinates with zero fill
    outside the grid (cv::remap INTER_LINEAR, BORDER_CONSTANT: taps beyond
    the edge read 0, which scipy calls "grid-constant") on each probe
    family's maps."""
    from scipy import ndimage

    cfg = SimConfig(probe_type=probe)
    map_row, map_col = imaging.scan_conversion_maps(cfg)
    rf = rng.standard_normal((cfg.rf_rows, cfg.rf_cols)).astype(np.float32)
    ref = ndimage.map_coordinates(
        rf.astype(np.float64), [map_row, map_col], order=1, mode="grid-constant",
        cval=0.0,
    )
    out = np.asarray(
        imaging.scan_convert(jnp.asarray(rf), jnp.asarray(map_row), jnp.asarray(map_col))
    )
    assert out.shape == (cfg.bmode_rows, cfg.bmode_cols)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_scan_convert_border_zero():
    # the convex maps reach outside the RF grid near the sector edges:
    # out-of-range pixels are exactly zero, fully-inside ones interpolate
    cfg = SimConfig()
    map_row, map_col = imaging.scan_conversion_maps(cfg)
    rf = np.ones((cfg.rf_rows, cfg.rf_cols), np.float32)
    out = np.asarray(
        imaging.scan_convert(jnp.asarray(rf), jnp.asarray(map_row), jnp.asarray(map_col))
    )
    fully_out = (map_row < -1) | (map_row > cfg.rf_rows) | (map_col < -1) | (
        map_col > cfg.rf_cols
    )
    assert fully_out.any()
    np.testing.assert_array_equal(out[fully_out], 0.0)
    fully_in = (map_row >= 0) & (map_row <= cfg.rf_rows - 2) & (map_col >= 0) & (
        map_col <= cfg.rf_cols - 2
    )
    np.testing.assert_allclose(out[fully_in], 1.0, rtol=1e-6)


@pytest.mark.parametrize("shape", [(465, 512), (465, 64), (60, 128)])
def test_convolve_envelope_matches_sequential_oracle(rng, shape):
    """PSF convolution + envelope, the post-march stages of every frame,
    against the sequential ports of the reference loops at the full-width
    RF shape, a shard's width, and a short image."""
    cfg = SimConfig()
    rf = rng.standard_normal(shape).astype(np.float32)
    ref = oracle_envelope(
        oracle_convolve(rf.astype(np.float64), np.asarray(axial_kernel(cfg)),
                        np.asarray(lateral_kernel(cfg)))
    )
    out = np.asarray(imaging.envelope(imaging.convolve_psf(jnp.asarray(rf), cfg)))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_convolve_envelope_sparse_rf(rng):
    # realistic sparse RF (mostly zeros + a few echoes) exercises the
    # no-peak / tail-after-last-peak paths
    cfg = small_test_config()
    rf = np.zeros((cfg.rf_rows, 64), np.float32)
    n = 200
    rf[rng.integers(0, cfg.rf_rows, n), rng.integers(0, 64, n)] = rng.standard_normal(n)
    ref = oracle_envelope(
        oracle_convolve(rf.astype(np.float64), np.asarray(axial_kernel(cfg)),
                        np.asarray(lateral_kernel(cfg)))
    )
    out = np.asarray(imaging.envelope(imaging.convolve_psf(jnp.asarray(rf), cfg)))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
