"""Simulation configuration.

The reference hardcodes every acquisition constant at compile time
(reference: src/main.cpp:23-37). Here they are runtime flags in a frozen
dataclass so one binary serves every probe/scene, and so the whole config can
be closed over by ``jax.jit`` as static metadata.

Unit conventions (documented once, enforced by convention — replaces the
reference's nholthaus/units compile-time types, see SURVEY.md §2.2):

- world coordinates: the reference's scene unit ("cm-ish": ``scene::distance``
  multiplies world distance by 10 to get mm, reference src/scene.cpp:342-346)
- lengths suffixed _mm / _um are millimetres / micrometres
- times are microseconds, frequencies MHz, speed of sound um/us (== m/s)
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """All formerly compile-time constants of the reference driver.

    Defaults reproduce the reference instantiation exactly
    (reference: src/main.cpp:23-37):
    ``psf<7,13,7,145>``, ``volume<256,145>``, ``rf_image<512,100,322>``,
    ``transducer<512>`` at 4.5 MHz on a 3 cm, 60 degree convex arc.
    """

    # --- acoustics (src/main.cpp:23-31) ---
    speed_of_sound: float = 1500.0          # [m/s] == [um/us]
    transducer_frequency: float = 4.5       # [MHz]
    ultrasound_depth_cm: float = 15.0       # [cm]

    # --- probe geometry (src/main.cpp:26-29) ---
    transducer_elements: int = 512          # scanlines
    samples_per_element: int = 5            # Monte-Carlo paths per scanline
    transducer_amplitude_deg: float = 60.0  # convex arc aperture
    transducer_radius_cm: float = 3.0       # convex arc radius
    # probe family: "convex" (the reference's arc array), "linear", or
    # "phased" (small linear aperture, beams steered across the sector)
    # (elements on a line, parallel beams; B-mode needs no polar remap)
    probe_type: str = "convex"

    # --- ray tracing (src/ray.h:23-24) ---
    max_depth: int = 10                     # bounce depth
    intensity_epsilon: float = 1e-10
    initial_intensity: float = 1.0          # split across samples (src/scene.cpp:92)
    ray_start_offset: float = 0.1           # rayTest origin nudge (src/scene.cpp:115-117)

    # --- imaging (src/main.cpp:33-36) ---
    resolution_um: int = 145                # PSF/scatterer voxel pitch
    psf_axial_size: int = 7
    psf_lateral_size: int = 13
    psf_elevation_size: int = 7             # declared but unused in the reference
    volume_size: int = 256                  # scatterer texture side
    bmode_rows: int = 400                   # scan-converted output (src/rfimage.h:26)
    bmode_cols: int = 500

    # Scatterer field backend: "procedural" (hash-based on-the-fly N(0,1),
    # no memory traffic, the default) or "table" (materialised
    # voxel grid mirroring the reference's volume<256,145>).
    texture_mode: str = "procedural"
    # Per-voxel N(0,1) generator for the procedural field (and hence the
    # march kernel's dominant per-sample cost):
    # - "bitsum" (default): dithered-binomial from the same hash words —
    #   popcount of 16 hash bits + a 16-bit uniform dither, zero
    #   transcendentals. Exact mean/variance, symmetric, excess kurtosis
    #   -0.12, support ±4.2σ; CDF within ~7e-3 of Φ (distributional
    #   validation in tests/test_texture.py). The reference's own field is
    #   an implementation-defined engine matched statistically, not bitwise
    #   (src/volume.h:19-35, SURVEY.md §4), so this stays within the
    #   declared parity contract.
    # - "boxmuller": log+sqrt+cos+sin per voxel pair — exact normals.
    # Changing this changes the realised speckle bit-stream (like reseeding).
    scatter_rng: str = "bitsum"

    # --- PSF parameters (src/main.cpp:54) ---
    psf_var_x: float = 0.05
    psf_var_y: float = 0.2
    psf_var_z: float = 0.1

    # --- behavioural switches (new; the reference has none) ---
    # Replicate the reference's always-material_inside transition for
    # non-vascular boundaries (a C++ pointer-comparison bug, src/ray.cpp:44:
    # `&r.media == &collided_mesh.material_inside` compares the address of a
    # by-value copy and is always false). Off -> sane id-based transition.
    bug_compat_material_transition: bool = False
    # Differentiable relaxations (straight-through scattering threshold,
    # trilinear texture lookup) instead of the reference's hard threshold +
    # nearest-neighbour voxel lookup (src/volume.h:52-58).
    soft_scattering: bool = False
    soft_scattering_tau: float = 0.05
    trilinear_texture: bool = False
    # Center the PSF convolution kernels instead of replicating the
    # reference's forward-shifted (uncentered) indexing (src/rfimage.h:102-118).
    centered_psf: bool = False
    # Apply the reference's commented-out log compression before scan
    # conversion (src/rfimage.h:131-136).
    log_compression: bool = False
    # Envelope detector: "reference" = the C++ peak-lerp Hilbert stand-in
    # (src/rfimage.h:54-91), "hilbert" = exact |analytic signal| via FFT
    # (SURVEY.md §7 item 4 calls for both).
    envelope_mode: str = "reference"
    # Differentiable relaxation of add_echo's row binning: split each echo
    # linearly across the two adjacent RF rows (weights 1-frac/frac of
    # t/rdt) instead of the reference's truncating floor (src/rfimage.h:35).
    # Makes the RF image differentiable in echo TIME — hence in probe pose
    # and geometry — where the hard floor has zero derivative a.e. Changes
    # the forward image (sub-row anti-aliasing), so parity mode keeps it
    # off; jnp march path only (the Pallas march kernel keeps hard binning).
    soft_row_binning: bool = False
    # Stop tracing a path once its round-trip time has left the image
    # window: every later segment starts at t0 >= max_travel_time_us, so its
    # march rows (floor(t_k/rdt) >= rf_rows) and boundary echo are all
    # discarded by the same guards the reference applies
    # (src/main.cpp:124 `t < 100us`, src/rfimage.h:35-37 row bound) — the
    # B-mode image is bit-identical, only provably-invisible bounce work is
    # skipped. The reference traces such paths anyway (src/scene.cpp:102
    # loops all 10 depths); on ircad_hd this flag empties bounce depths >= 6.
    # Off for the trace-loop oracle test, which ports the reference verbatim.
    cull_time_window: bool = True

    def __post_init__(self):
        if self.scatter_rng not in ("bitsum", "boxmuller"):
            raise ValueError(
                f"unknown scatter_rng {self.scatter_rng!r}; expected "
                "'bitsum' or 'boxmuller'"
            )

    # ------------------------------------------------------------------
    # Derived quantities (all pure functions of the fields above).
    # ------------------------------------------------------------------
    @property
    def axial_resolution_mm(self) -> float:
        """1.45/frequency [mm] — 'deduced from Burger13' (src/main.cpp:25)."""
        return 1.45 / self.transducer_frequency

    @property
    def axial_resolution_um(self) -> int:
        """Truncated-to-int um pitch used for RF row binning (src/main.cpp:36)."""
        return int(self.axial_resolution_mm * 1000.0)

    @property
    def max_travel_time_us(self) -> int:
        """Round-trip listening window [us] (src/main.cpp:30-31)."""
        # depth [cm] -> [um] is *1e4; divided by speed [um/us] gives us.
        return int(self.ultrasound_depth_cm * 1e4 / self.speed_of_sound)

    @property
    def rf_rows(self) -> int:
        """(speed * window) / axial_res with integer division (src/rfimage.h:180)."""
        return (int(self.speed_of_sound) * self.max_travel_time_us) // self.axial_resolution_um

    @property
    def rf_cols(self) -> int:
        return self.transducer_elements

    @property
    def rf_row_dt_us(self) -> float:
        """Time per RF row used by add_echo binning (src/rfimage.h:35)."""
        return self.axial_resolution_um / self.speed_of_sound

    @property
    def march_dt_us(self) -> float:
        """Time per march step — uses the *untruncated* axial resolution
        (src/main.cpp:118), deliberately distinct from rf_row_dt_us."""
        return self.axial_resolution_mm * 1000.0 / self.speed_of_sound

    @property
    def max_march_steps(self) -> int:
        """Static bound on per-segment march steps: the time-window guard
        (src/main.cpp:124) caps the loop at window/dt + 1 iterations."""
        return int(math.ceil(self.max_travel_time_us / self.march_dt_us)) + 1

    @property
    def transducer_amplitude_rad(self) -> float:
        return math.radians(self.transducer_amplitude_deg)

    @property
    def element_separation_mm(self) -> float:
        """amplitude * radius / N [mm] (src/main.cpp:66)."""
        return (
            self.transducer_amplitude_rad
            * (self.transducer_radius_cm * 10.0)
            / self.transducer_elements
        )


DEFAULT_CONFIG = SimConfig()


def small_test_config(**overrides) -> SimConfig:
    """A shrunken config for fast CPU tests: fewer elements/samples, tiny
    scatterer volume. Physics and imaging math are unchanged."""
    base = dict(
        transducer_elements=64,
        samples_per_element=2,
        volume_size=32,
        bmode_rows=100,
        bmode_cols=125,
    )
    base.update(overrides)
    return SimConfig(**base)
