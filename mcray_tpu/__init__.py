"""mcray_tpu — differentiable Monte-Carlo ray-tracing ultrasound simulation.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
thepochynsons/MCRay-Tracing reference (Mattausch & Goksel 2016 interactive
ultrasound simulation): convex-probe acoustic path tracing through triangle
meshes, stochastic boundary physics, scatterer-texture echo accumulation, PSF
convolution, envelope detection and polar->Cartesian scan conversion — plus
what the reference lacks: determinism, differentiability w.r.t. materials and
probe pose, multi-device sharding, tests and benchmarks.
"""

from .config import SimConfig, DEFAULT_CONFIG, small_test_config

__version__ = "0.1.0"

__all__ = ["SimConfig", "DEFAULT_CONFIG", "small_test_config", "__version__"]
