"""End-to-end render tests on the sphere scene (tiny config)."""

import jax
import numpy as np
import pytest

from mcray_tpu.models.simulator import Simulator


@pytest.fixture(scope="module")
def sim(request):
    import os
    from mcray_tpu.config import small_test_config
    from mcray_tpu.scene.compile import load_and_compile

    cfg = small_test_config()
    pack = load_and_compile(
        os.path.join(os.path.dirname(__file__), "..", "assets", "sphere", "sphere.scene"),
        cfg,
        with_bvh=True,
    )
    return Simulator(pack, cfg)


def test_render_shapes_and_finite(sim):
    out = sim.render_frame(0)
    cfg = sim.cfg
    assert out["bmode"].shape == (cfg.bmode_rows, cfg.bmode_cols)
    assert out["rf_raw"].shape == (cfg.rf_rows, cfg.rf_cols)
    for k in ("bmode", "rf_raw", "rf_conv", "rf_env"):
        assert np.isfinite(np.asarray(out[k])).all(), k


def test_render_nonzero_signal(sim):
    out = sim.render_frame(0)
    rf = np.asarray(out["rf_raw"])
    assert rf.max() > 0.0
    # multiple scanlines receive echoes (the fan hits the box)
    assert (np.abs(rf).sum(axis=0) > 0).sum() > sim.cfg.transducer_elements // 2
    assert np.asarray(out["bmode"]).max() > 0.0


def test_deterministic_same_seed(sim):
    a = np.asarray(sim.render_frame(3)["bmode"])
    b = np.asarray(sim.render_frame(3)["bmode"])
    np.testing.assert_array_equal(a, b)


def test_seed_changes_speckle(sim):
    a = np.asarray(sim.render_frame(0)["bmode"])
    b = np.asarray(sim.render_frame(1)["bmode"])
    assert np.abs(a - b).max() > 0.0


def test_bvh_matches_brute_force_trace(sim):
    from mcray_tpu.models.simulator import Simulator

    sim_bvh = Simulator(sim.pack, sim.cfg, use_bvh=True)
    a = np.asarray(sim.render_frame(2)["rf_raw"])
    b = np.asarray(sim_bvh.render_frame(2)["rf_raw"])
    # identical geometry queries -> identical RNG stream -> identical image
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_render_batch_matches_frames(sim):
    batch = np.asarray(sim.render_batch([0, 1]))
    a = np.asarray(sim.render_frame(0)["bmode"])
    b = np.asarray(sim.render_frame(1)["bmode"])
    np.testing.assert_allclose(batch[0], a, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(batch[1], b, rtol=1e-5, atol=1e-6)


def test_compound_reduces_speckle_variance(sim):
    single = np.asarray(sim.render_frame(0)["bmode"])
    compound = np.asarray(sim.render_compound(range(8)))
    # speckle region: compare local variance inside the insonified area
    mask = (single > 0.01) & (compound > 0.01)
    assert mask.sum() > 100
    assert compound[mask].std() < single[mask].std()


def test_many_samples_per_scanline():
    # driver config: high Monte-Carlo path counts per scanline
    import os
    from mcray_tpu.config import small_test_config
    from mcray_tpu.scene.compile import load_and_compile

    cfg = small_test_config(transducer_elements=8, samples_per_element=64)
    pack = load_and_compile(
        os.path.join(os.path.dirname(__file__), "..", "assets", "sphere", "sphere.scene"),
        cfg,
    )
    out = Simulator(pack, cfg).render_frame(0)
    assert np.isfinite(np.asarray(out["bmode"])).all()
    assert np.asarray(out["rf_raw"]).max() > 0


def test_time_window_cull_is_output_invariant():
    """cull_time_window stops tracing once a path leaves the 100us image
    window; the rendered frame must be bit-identical to tracing all 10
    depths (the skipped segments' echoes are discarded by the row-bound /
    t-window guards either way)."""
    import os
    from mcray_tpu.config import small_test_config
    from mcray_tpu.scene.compile import load_and_compile

    scene = os.path.join(
        os.path.dirname(__file__), "..", "assets", "sphere", "sphere.scene"
    )
    frames = {}
    for cull in (False, True):
        cfg = small_test_config(transducer_elements=32, cull_time_window=cull)
        pack = load_and_compile(scene, cfg)
        out = Simulator(pack, cfg).render_frame(3)
        frames[cull] = (np.asarray(out["rf_raw"]), np.asarray(out["bmode"]))
    np.testing.assert_array_equal(frames[False][0], frames[True][0])
    np.testing.assert_array_equal(frames[False][1], frames[True][1])


def test_probe_pose_differentiable(sim):
    import jax.numpy as jnp

    def loss(pos):
        out = sim._render(
            jax.random.PRNGKey(0), sim.materials, pos,
            jnp.asarray(sim.pack.transducer_angles),
        )
        return out["bmode"].sum()

    g = jax.grad(loss)(jnp.asarray(sim.pack.transducer_position))
    assert np.isfinite(np.asarray(g)).all()
