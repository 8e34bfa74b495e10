"""AD-vs-finite-difference gradient checks.

Monte-Carlo renderers have genuinely discontinuous parameter dependence
(Russian-roulette branch flips, hard scattering threshold), so FD == AD only
holds where the realisation is locally stable. These tests build such
regions: a fixed key, smooth-mode scattering, and perturbations small enough
that no discrete choice flips — there AD must match FD tightly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcray_tpu.config import small_test_config
from mcray_tpu.models.simulator import Simulator
from mcray_tpu.ops import physics
from mcray_tpu.scene.compile import load_and_compile

SCENE = os.path.join(os.path.dirname(__file__), "..", "assets", "sphere", "sphere.scene")


@pytest.fixture(scope="module")
def sim():
    cfg = small_test_config(
        transducer_elements=16,
        samples_per_element=2,
        soft_scattering=True,
        trilinear_texture=True,
    )
    pack = load_and_compile(SCENE, cfg)
    return Simulator(pack, cfg)


def _loss_fn(sim, key):
    def loss(theta, row, col):
        m = sim.materials.at[row, col].set(theta)
        out = sim._render(
            key, m,
            jnp.asarray(sim.pack.transducer_position),
            jnp.asarray(sim.pack.transducer_angles),
        )
        return jnp.sum(out["bmode"] ** 2)

    return loss


@pytest.mark.parametrize(
    "row,col",
    [
        (3, physics.ATTENUATION),  # LIVER attenuation: smooth Beer-Lambert
        (3, physics.MU0),          # LIVER scattering mean: linear
        (3, physics.SIGMA),        # LIVER scattering std: linear
    ],
)
def test_ad_matches_fd_smooth_params(sim, row, col):
    """Two-layer check (r5 rework — the old single-(key, eps) secant was
    realisation-tuned: the envelope's discrete peak choices make any ONE
    small secant unreliable; measured FD of the same loss swung 2.8 -> 6.1
    between eps=3e-4 and 1e-3 while AD matched the converged large-eps
    secant to 1%):
    1. pre-envelope loss (rf_conv): everything up to the PSF conv is smooth
       in these params -> AD == FD tightly at every eps;
    2. full-pipeline loss (bmode): a loose sanity BRACKET only (sign + a
       3x factor at eps=1e-2). Measured across keys and eps, bmode-level
       secants swing by >2x at every probe size (small eps: f32 loss noise
       amplified by 1/eps; large eps: envelope peak-index and path-survival
       flips — e.g. fd=22.7 vs ad=3.7 at eps=3e-2), so a tight bmode-level
       FD assertion would be realisation lottery, not validation. The
       envelope/scanconv VJPs themselves are unit-validated against jnp AD
       in tests/test_grad_pallas.py, which closes the remaining link."""
    key = jax.random.PRNGKey(7)
    theta0 = float(sim.materials[row, col])

    def loss_of(which):
        @jax.jit
        def loss(theta):
            m = sim.materials.at[row, col].set(theta)
            out = sim._render_impl(
                key, m,
                jnp.asarray(sim.pack.transducer_position),
                jnp.asarray(sim.pack.transducer_angles),
                sim._state,
            )
            return jnp.sum(out[which] ** 2)

        return loss

    loss_s = loss_of("rf_conv")
    eps = 1e-3
    g_ad = float(jax.grad(loss_s)(jnp.float32(theta0)))
    g_fd = (
        float(loss_s(jnp.float32(theta0 + eps)))
        - float(loss_s(jnp.float32(theta0 - eps)))
    ) / (2 * eps)
    assert np.isfinite(g_ad) and g_fd != 0.0
    np.testing.assert_allclose(
        g_ad, g_fd, rtol=0.02, err_msg=f"pre-envelope row {row} col {col}"
    )

    loss_f = loss_of("bmode")
    eps = 1e-2
    g_ad = float(jax.grad(loss_f)(jnp.float32(theta0)))
    g_fd = (
        float(loss_f(jnp.float32(theta0 + eps)))
        - float(loss_f(jnp.float32(theta0 - eps)))
    ) / (2 * eps)
    assert np.isfinite(g_ad) and g_fd != 0.0
    assert np.sign(g_ad) == np.sign(g_fd), f"sign row {row} col {col}"
    ratio = g_ad / g_fd
    assert 1.0 / 3.0 < ratio < 3.0, f"bracket row {row} col {col}: {ratio}"


def test_ad_matches_fd_probe_position(sim):
    key = jax.random.PRNGKey(7)

    def loss(dx):
        pos = jnp.asarray(sim.pack.transducer_position) + jnp.array([dx, 0.0, 0.0])
        out = sim._render(
            key, sim.materials, pos,
            jnp.asarray(sim.pack.transducer_angles),
        )
        return jnp.sum(out["bmode"] ** 2)

    g_ad = float(jax.grad(loss)(jnp.float32(0.0)))
    # NOTE: FD here is dominated by discrete staircase jumps (march step
    # counts, RF row bins, roulette flips) that AD deliberately treats as
    # zero-measure; the two are not numerically comparable for pose. Assert
    # the AD path itself is finite, nonzero and stable.
    assert np.isfinite(g_ad)
    assert g_ad != 0.0
    g_ad2 = float(jax.grad(loss)(jnp.float32(0.0)))
    assert g_ad == g_ad2
