"""Kernels compiled for the card (no interpret mode) against the plain jnp
paths. Marked ``gpu``: they skip without a GPU and run on the card with
MCRAY_TEST_PLATFORM=cuda python -m pytest -m gpu tests/ (README)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcray_tpu.config import SimConfig
from mcray_tpu.models.simulator import Simulator
from mcray_tpu.paths import Paths
from mcray_tpu.scene.compile import load_and_compile

pytestmark = pytest.mark.gpu

SCENE = os.path.join(os.path.dirname(__file__), "..", "assets", "sphere", "sphere.scene")


@pytest.fixture(scope="module")
def pack():
    return load_and_compile(SCENE, SimConfig())


@pytest.mark.parametrize("intersect", ["listed", "brute"])
def test_card_march_kernel_frame_matches_jnp_march(gpu, pack, intersect):
    # same intersect on both sides: only the march's sum order differs
    cfg = SimConfig()
    chunk = 8192 if intersect == "brute" else 0
    jnp_march = Simulator(pack, cfg, paths=Paths(intersect=intersect, intersect_chunk=chunk))
    kernel = Simulator(pack, cfg, paths=Paths(intersect=intersect, intersect_chunk=chunk,
                                               march="kernel"))
    a = np.asarray(jnp_march.render_frame(2)["bmode"])
    b = np.asarray(kernel.render_frame(2)["bmode"])
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


def test_card_listed_frame_matches_brute_statistically(gpu, pack):
    """Rays grazing a shared mesh edge may take the other facet's normal in
    the listed kernel than in XLA's brute force (rounding decides the tie),
    and such a path diverges from there: the frames agree pixel for pixel
    except on a few per cent of pixels, and in mean brightness (PERF.md)."""
    cfg = SimConfig()
    brute = Simulator(pack, cfg, paths=Paths(intersect="brute", intersect_chunk=8192,
                                              march="kernel"))
    listed = Simulator(pack, cfg, paths=Paths(intersect="listed", march="kernel"))
    a = np.asarray(brute.render_frame(2)["bmode"])
    b = np.asarray(listed.render_frame(2)["bmode"])
    assert (np.abs(b - a) > 1e-5 + 1e-4 * np.abs(a)).mean() <= 0.03
    assert abs(b.mean() - a.mean()) <= 0.01 * a.mean()


def test_card_frames_are_bitwise_reproducible(gpu, pack):
    sim = Simulator(pack, SimConfig())
    a = np.asarray(sim.render_frame(4)["bmode"])
    b = np.asarray(sim.render_frame(4)["bmode"])
    np.testing.assert_array_equal(a, b)


def test_card_march_grads_match_jnp(gpu, pack):
    cfg = SimConfig(soft_scattering=True, trilinear_texture=True)
    key = jax.random.PRNGKey(0)
    target = jnp.zeros((cfg.bmode_rows, cfg.bmode_cols))

    def grads(paths):
        sim = Simulator(pack, cfg, paths=paths)
        pos = jnp.asarray(pack.transducer_position)
        ang = jnp.asarray(pack.transducer_angles)

        def loss(m):
            out = sim._render_impl(key, m, pos, ang, sim._state)["bmode"]
            return jnp.mean((out - target) ** 2)

        return np.asarray(jax.jit(jax.grad(loss))(sim.materials))

    g_ref = grads(Paths(intersect="listed"))
    g_ker = grads(Paths(intersect="listed", march="kernel"))
    scale = np.abs(g_ref).max()
    assert scale > 0
    np.testing.assert_allclose(g_ker / scale, g_ref / scale, atol=5e-3)
