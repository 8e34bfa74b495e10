"""Multi-device tests on the 8-device virtual CPU mesh (conftest sets
xla_force_host_platform_device_count=8)."""

import jax
import numpy as np
import pytest

from mcray_tpu.models.simulator import Simulator
from mcray_tpu.parallel.shard import ShardedRenderer, make_mesh


@pytest.fixture(scope="module")
def setup():
    import os
    from mcray_tpu.config import small_test_config
    from mcray_tpu.scene.compile import load_and_compile

    cfg = small_test_config()  # 64 elements -> 8 per device
    pack = load_and_compile(
        os.path.join(os.path.dirname(__file__), "..", "assets", "sphere", "sphere.scene"),
        cfg,
    )
    return pack, cfg


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_matches_single_chip(setup):
    pack, cfg = setup
    sim = Simulator(pack, cfg)
    sharded = ShardedRenderer(pack, cfg, mesh=make_mesh(8))
    a = np.asarray(sim.render_frame(0)["bmode"])
    b = np.asarray(sharded.render_frame(0)["bmode"])
    # per-path global RNG keys -> sharding must not change the image
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_sharded_rf_columns_partition(setup):
    pack, cfg = setup
    sim = Simulator(pack, cfg)
    sharded = ShardedRenderer(pack, cfg, mesh=make_mesh(8))
    rf_full = np.asarray(sim.render_frame(0)["rf_raw"])
    rf_sharded = np.asarray(sharded.render_frame(0)["rf_raw"])
    np.testing.assert_allclose(rf_sharded, rf_full, rtol=1e-4, atol=1e-5)


def test_sharded_on_two_devices(setup):
    pack, cfg = setup
    sharded8 = ShardedRenderer(pack, cfg, mesh=make_mesh(8))
    sharded2 = ShardedRenderer(pack, cfg, mesh=make_mesh(2))
    a = np.asarray(sharded8.render_frame(1)["bmode"])
    b = np.asarray(sharded2.render_frame(1)["bmode"])
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_halo_imaging_matches_replicated(setup):
    pack, cfg = setup
    halo = ShardedRenderer(pack, cfg, mesh=make_mesh(8), distributed_imaging=True)
    gathered = ShardedRenderer(pack, cfg, mesh=make_mesh(8), distributed_imaging=False)
    a = np.asarray(halo.render_frame(2)["bmode"])
    b = np.asarray(gathered.render_frame(2)["bmode"])
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rows", [64, 16])  # 16 -> 2 rows/shard: multi-hop halo
def test_row_sharded_convolution_matches_replicated(setup, rows):
    """SURVEY.md §2.3 long axis (b): RF image sharded over time rows; the
    axial 7-tap pass exchanges an (a-1, C) ppermute halo. Must equal the
    replicated reference convolution (including the untouched borders)."""
    import functools
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from mcray_tpu.ops import imaging

    _, cfg = setup
    cols = 32
    rf = jax.random.normal(jax.random.PRNGKey(7), (rows, cols), jnp.float32)
    expected = np.asarray(imaging.convolve_psf(rf, cfg))

    mesh = Mesh(np.asarray(jax.devices()), ("rows",))
    body = functools.partial(
        imaging.convolve_psf_rows_sharded, cfg=cfg, axis="rows", n_shards=8
    )
    out = jax.shard_map(
        body, mesh=mesh, in_specs=P("rows", None), out_specs=P("rows", None),
        check_vma=False,
    )(rf)
    np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-5, atol=1e-6)


def test_sharded_train_step_runs(setup):
    import jax.numpy as jnp
    import optax

    pack, cfg = setup
    r = ShardedRenderer(pack, cfg, mesh=make_mesh(4))
    opt = optax.adam(1e-2)
    step = r.make_train_step(opt)
    pos = jnp.asarray(pack.transducer_position)
    ang = jnp.asarray(pack.transducer_angles)
    key = jax.random.PRNGKey(0)
    target = r.render_bmode(key, r.materials, pos, ang)
    mats, opt_state, loss = step(
        jax.random.PRNGKey(1), r.materials, opt.init(r.materials), target, pos, ang
    )
    assert np.isfinite(float(loss))
    assert np.isfinite(np.asarray(mats)).all()
    assert (np.asarray(mats) != np.asarray(r.materials)).any()


@pytest.mark.parametrize(
    "intersect,march",
    [("brute", "kernel"), ("listed", "jnp"), ("listed", "kernel")],
)
def test_sharded_kernels_match(setup, intersect, march):
    # the Pallas kernels (interpret mode) inside shard_map, alone and
    # together, must reproduce the jnp sharded render
    from mcray_tpu.paths import Paths

    pack, cfg = setup
    ref = ShardedRenderer(pack, cfg, mesh=make_mesh(4))
    pal = ShardedRenderer(
        pack, cfg, mesh=make_mesh(4),
        paths=Paths(intersect=intersect, march=march, interpret=True),
    )
    a = np.asarray(ref.render_frame(3)["bmode"])
    b = np.asarray(pal.render_frame(3)["bmode"])
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_2d_mesh_matches_single_chip(setup):
    # rays x samples mesh: sample axis is a pure psum reduction; global
    # per-path keys keep it equal to the single-device render
    from mcray_tpu.parallel.shard import ShardedRenderer2D, make_mesh_2d

    pack, cfg = setup  # 64 elements x 2 samples -> mesh (4, 2)
    sim = Simulator(pack, cfg)
    r2d = ShardedRenderer2D(pack, cfg, mesh=make_mesh_2d(4, 2))
    a = np.asarray(sim.render_frame(0)["bmode"])
    b = np.asarray(r2d.render_frame(0)["bmode"])
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_uneven_shard_rejected(setup):
    pack, cfg = setup
    import dataclasses

    bad = dataclasses.replace(cfg, transducer_elements=60)
    with pytest.raises(ValueError):
        ShardedRenderer(pack, bad, mesh=make_mesh(8))
