"""Pallas march kernel (Triton route) vs the jnp scatter path, in interpret
mode on the CPU, plus its lowering to Triton IR for the GPU."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcray_tpu.config import small_test_config
from mcray_tpu.models.simulator import march_and_accumulate, trace_paths
from mcray_tpu.ops import texture
from mcray_tpu.ops.pallas import march as march_mod
from mcray_tpu.ops.pallas.march import march_and_accumulate_pallas
from mcray_tpu.scene.compile import load_and_compile


@pytest.fixture(scope="module")
def setup():
    cfg = small_test_config(transducer_elements=32, samples_per_element=2)
    pack = load_and_compile(
        os.path.join(os.path.dirname(__file__), "..", "assets", "sphere", "sphere.scene"),
        cfg,
    )
    scene = {k: jnp.asarray(v) for k, v in pack.trace_tables().items()}
    mats = jnp.asarray(pack.materials)
    segs = trace_paths(
        jax.random.PRNGKey(0), mats,
        jnp.asarray(pack.transducer_position), jnp.asarray(pack.transducer_angles),
        scene, jnp.asarray(pack.spacing), jnp.int32(pack.starting_material), cfg,
    )
    return cfg, mats, segs


@pytest.mark.parametrize("texture_mode", ["procedural", "table"])
@pytest.mark.parametrize("scatter_rng", ["bitsum", "boxmuller"])
@pytest.mark.parametrize("trilinear", [False, True])
def test_pallas_march_matches_jnp(setup, texture_mode, scatter_rng, trilinear):
    """Every texture configuration: the in-kernel hash field is the
    bit-identical twin of texture.procedural_fields, and "table" volumes are
    filled from that same field, so kernel and jnp agree up to float
    association (per-pixel sum order; in trilinear mode also the tap
    weights). The soft gate is covered by the gradient tests."""
    cfg0, mats, segs = setup
    cfg = dataclasses.replace(
        cfg0, texture_mode=texture_mode, scatter_rng=scatter_rng,
        trilinear_texture=trilinear,
    )
    vol = texture.make_texture_volume(jax.random.PRNGKey(1), cfg)
    ref = np.asarray(march_and_accumulate(segs, mats, vol, cfg))
    out = np.asarray(march_and_accumulate_pallas(segs, mats, vol, cfg, interpret=True))
    assert out.shape == ref.shape == (cfg.rf_rows, cfg.rf_cols)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_pallas_march_sharded_width_and_batch(setup):
    """A column count that is not a TILE_C multiple (one shard's width) is
    padded and cropped, and vmap over frames batches the kernel grid."""
    cfg, mats, segs = setup
    vol = texture.make_texture_volume(jax.random.PRNGKey(1), cfg)
    n = 8 * cfg.samples_per_element  # first 8 elements only
    part = {k: v[:, :n] for k, v in segs.items()}
    ref = np.asarray(march_and_accumulate(part, mats, vol, cfg, n_cols=8))
    out = np.asarray(march_and_accumulate_pallas(part, mats, vol, cfg, n_cols=8,
                                                 interpret=True))
    assert out.shape == (cfg.rf_rows, 8)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())
    batched = jax.vmap(
        lambda m: march_and_accumulate_pallas(segs, m, vol, cfg, interpret=True)
    )(jnp.stack([mats, mats * 1.01]))
    single = march_and_accumulate_pallas(segs, mats, vol, cfg, interpret=True)
    np.testing.assert_array_equal(np.asarray(batched[0]), np.asarray(single))


def test_row_tile_spans_cover_every_written_row(setup):
    """The prepass ranges must contain the row tile of every RF cell a
    segment writes (march rows and boundary echo), or the kernel drops it."""
    cfg, mats, segs = setup
    soa = march_mod.pack_segments(segs, mats, cfg, cfg.rf_cols)
    n_row_tiles = -(-cfg.rf_rows // march_mod.TILE_ROWS)
    lo, hi = map(np.asarray, march_mod._row_tile_spans(soa, cfg, n_row_tiles))
    soa = np.asarray(soa)
    rdt, dt = cfg.rf_row_dt_us, cfg.march_dt_us
    checked = 0
    for s in range(soa.shape[0]):
        for c in range(cfg.rf_cols):
            f = soa[s, :, c]
            if f[march_mod.F_VALID] < 0.5:
                continue
            k = np.arange(min(int(f[march_mod.F_STEPS]), cfg.max_march_steps))
            t = f[march_mod.F_T0] + k * dt
            rows = np.floor(t[t < cfg.max_travel_time_us] / rdt)
            rows = rows[(rows >= 0) & (rows < cfg.rf_rows)]
            if f[march_mod.F_B_ROW] >= 0:
                rows = np.append(rows, f[march_mod.F_B_ROW])
            tiles = (rows // march_mod.TILE_ROWS).astype(int)
            ct = c // march_mod.TILE_C
            assert (tiles >= lo[s, ct]).all() and (tiles <= hi[s, ct]).all()
            checked += tiles.size
    assert checked > 0


def test_pallas_march_rejects_seedless_table(setup):
    """Externally supplied raw tables (no seeds) cannot use the kernel."""
    cfg, mats, segs = setup
    table_vol = {"noise": jnp.zeros((4, 4, 4)), "prob": jnp.zeros((4, 4, 4))}
    with pytest.raises(ValueError):
        march_and_accumulate_pallas(segs, mats, table_vol, cfg, interpret=True)


def test_pallas_march_rejects_soft_row_binning(setup):
    cfg, mats, segs = setup
    cfg_s = dataclasses.replace(cfg, soft_row_binning=True)
    vol = texture.make_texture_volume(jax.random.PRNGKey(1), cfg_s)
    with pytest.raises(ValueError):
        march_and_accumulate_pallas(segs, mats, vol, cfg_s, interpret=True)


@pytest.mark.parametrize("trilinear", [False, True])
def test_pallas_march_lowers_to_triton(setup, trilinear):
    """Forward and backward kernels lower to Triton IR for the GPU, batched
    too. Lowering needs no card; only the Triton->PTX step does."""
    cfg0, mats, segs = setup
    cfg = dataclasses.replace(
        cfg0, trilinear_texture=trilinear, soft_scattering=trilinear
    )
    vol = texture.make_texture_volume(jax.random.PRNGKey(1), cfg)

    def loss(m):
        return jnp.sum(march_and_accumulate_pallas(segs, m, vol, cfg) ** 2)

    fwd_bwd = jax.jit(jax.vmap(jax.value_and_grad(loss)))
    text = fwd_bwd.trace(jnp.stack([mats, mats])).lower(
        lowering_platforms=("cuda",)
    ).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 2  # march_fwd + march_bwd
