"""Test harness config.

By default the tests run on the CPU with an 8-device virtual mesh, set in
config before any backend initialises. MCRAY_TEST_PLATFORM=cuda runs them on
the GPU instead, where the tests marked ``gpu`` run (README: testing).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", os.environ.get("MCRAY_TEST_PLATFORM", "cpu"))

import numpy as np
import pytest


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none. Decided here,
    at run time, never at import: every xdist worker collects the same
    tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def sphere_pack():
    from mcray_tpu.config import small_test_config
    from mcray_tpu.scene.compile import load_and_compile

    cfg = small_test_config()
    pack = load_and_compile(
        os.path.join(os.path.dirname(__file__), "..", "assets", "sphere", "sphere.scene"),
        cfg,
        with_bvh=True,
    )
    return pack, cfg
