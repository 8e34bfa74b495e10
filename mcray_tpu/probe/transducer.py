"""Convex-array transducer layout as a pure, differentiable function of pose.

Functional rebuild of the reference's mutable ``transducer<N>`` class
(reference: src/transducer.h:24-118): instead of an object whose ``update()``
rewrites an element array in place, element positions/directions are a pure
function of ``(position, angles)`` — so probe pose is a differentiable input
and a probe sweep is just a ``vmap`` over poses (the interactive loop the
reference stubbed out via its dead inputmanager, SURVEY.md §3.4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SimConfig
from ..ops.geometry import euler_zxy

Array = jax.Array


def element_layout(
    position: Array,  # (3,) world units
    angles_deg: Array,  # (3,) degrees, reference order [x, y, z]
    cfg: SimConfig,
):
    """Positions and outward directions of all N elements; dispatches on
    cfg.probe_type. Returns (positions (N,3), directions (N,3))."""
    if cfg.probe_type == "linear":
        return element_layout_linear(position, angles_deg, cfg)
    if cfg.probe_type == "phased":
        return element_layout_phased(position, angles_deg, cfg)
    return element_layout_convex(position, angles_deg, cfg)


def element_layout_linear(position: Array, angles_deg: Array, cfg: SimConfig):
    """Linear array: N elements along the (rotated) x axis at the reference's
    element pitch, all beams parallel to the (rotated) +y axis. A new probe
    family the reference lacks (its transducer is convex-only)."""
    n = cfg.transducer_elements
    pitch_world = cfg.element_separation_mm / 10.0  # mm -> world (cm-ish)
    offsets = (jnp.arange(n, dtype=jnp.float32) - (n - 1) / 2.0) * pitch_world
    angles_rad = jnp.deg2rad(jnp.asarray(angles_deg, jnp.float32))
    lateral = euler_zxy(jnp.array([[1.0, 0.0, 0.0]], jnp.float32), angles_rad)[0]
    beam = euler_zxy(jnp.array([[0.0, 1.0, 0.0]], jnp.float32), angles_rad)[0]
    positions = jnp.asarray(position, jnp.float32) + offsets[:, None] * lateral
    directions = jnp.broadcast_to(beam, (n, 3))
    return positions, directions


def element_layout_phased(position: Array, angles_deg: Array, cfg: SimConfig):
    """Phased (sector) array: beam k electronically steered across the
    probe's sector (cfg.transducer_amplitude_deg). A third probe family the
    reference lacks; its B-mode is the radius->0 limit of the convex sector,
    which is exactly what scan_conversion_maps uses for it.

    All beams are emitted from the probe position (the sector apex): the
    radius->0 scan-conversion model assumes a single apex, so tracing from
    laterally offset element positions would misregister targets in the
    B-mode, worst in the near field (advisor finding r1). The physical
    aperture's lateral extent (a few mm at lambda/2 pitch) is below the
    lateral PSF width the pipeline applies anyway."""
    n = cfg.transducer_elements
    total = cfg.transducer_amplitude_rad
    steer = (
        -(total / 2.0)
        + total * (jnp.arange(n, dtype=jnp.float32) + 0.5) / n
    )
    base = jnp.stack(
        [jnp.sin(steer), jnp.cos(steer), jnp.zeros_like(steer)], axis=-1
    )
    angles_rad = jnp.deg2rad(jnp.asarray(angles_deg, jnp.float32))
    directions = euler_zxy(base, angles_rad)
    positions = jnp.broadcast_to(
        jnp.asarray(position, jnp.float32), (n, 3)
    )
    return positions, directions


def element_layout_convex(position: Array, angles_deg: Array, cfg: SimConfig):
    """Convex-arc positions and outward directions.

    Matches the reference arc construction exactly
    (reference: src/transducer.h:41-59): angular pitch = separation/radius,
    first element at -(pitch*N/2) + pitch/2, unit vector (sin a, cos a, 0)
    rotated by the z->x->y chain; position = probe_pos + radius_cm * dir.
    """
    n = cfg.transducer_elements
    radius_mm = cfg.transducer_radius_cm * 10.0
    pitch = cfg.element_separation_mm / radius_mm  # [rad] per element
    angle0 = -(pitch * n / 2.0) + pitch / 2.0
    angles = angle0 + pitch * jnp.arange(n, dtype=jnp.float32)

    base = jnp.stack(
        [jnp.sin(angles), jnp.cos(angles), jnp.zeros_like(angles)], axis=-1
    )  # (N, 3)
    angles_rad = jnp.deg2rad(jnp.asarray(angles_deg, jnp.float32))
    directions = euler_zxy(base, angles_rad)
    # radius.to<float>() is in cm in the reference (world units are cm-ish).
    positions = jnp.asarray(position, jnp.float32) + cfg.transducer_radius_cm * directions
    return positions, directions
