"""Aux subsystem tests: metrics, checkpoint/resume, image IO."""

import numpy as np

from mcray_tpu.utils.image_io import to_u8
from mcray_tpu.utils.profiling import FrameMetrics


def test_metrics_stages_and_rates():
    import time

    m = FrameMetrics()
    for _ in range(3):
        with m.stage("frame"):
            time.sleep(0.01)
        m.count("rays", 100)
    s = m.summary()
    assert s["frame_ms"] >= 10
    assert s["rays"] == 300
    assert 0 < s["rays_per_s"] < 100 * 3 / 0.029

def test_to_u8_matches_opencv_convertto():
    img = np.array([[-0.5, 0.0, 0.5, 1.0, 2.0, np.nan]])
    out = to_u8(img)
    np.testing.assert_array_equal(out, [[0, 0, 128, 255, 255, 0]])


def test_fit_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp
    import optax

    from mcray_tpu.models.trainer import FitState
    from mcray_tpu.utils.checkpoint import load_fit_state, save_fit_state

    opt = optax.adam(1e-2)
    materials = jnp.arange(16.0).reshape(2, 8)
    state = FitState(materials, opt.init(materials), step=7)
    # advance once so opt_state is non-trivial
    g = jnp.ones_like(materials)
    upd, new_opt = opt.update(g, state.opt_state, materials)
    state = FitState(optax.apply_updates(materials, upd), new_opt, 8)

    path = str(tmp_path / "fit.npz")
    save_fit_state(path, state)
    template = FitState(jnp.zeros((2, 8)), opt.init(jnp.zeros((2, 8))), 0)
    restored = load_fit_state(path, template)
    assert restored.step == 8
    np.testing.assert_allclose(np.asarray(restored.materials), np.asarray(state.materials))
    for a, b in zip(
        __import__("jax").tree_util.tree_leaves(restored.opt_state),
        __import__("jax").tree_util.tree_leaves(state.opt_state),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
