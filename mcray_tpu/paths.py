"""The one place that decides how each stage of a frame runs.

``choose_paths(backend, n_triangles)`` returns the intersect, march and
imaging path for a device backend and a scene size. ``Simulator`` and
``ShardedRenderer`` take its result (or an explicit ``Paths``) and run
exactly that; nothing else in the package tests the backend.

- ``gpu``: the Triton-route Pallas kernels, listed intersect and march,
  which beat XLA's plain version end to end on the card on the 2,220- and
  the 123,224-triangle scene alike (PERF.md, Findings).
- ``cpu``: the plain jnp paths, which the tests and ``--platform cpu`` use.
  Tests that run a kernel on the CPU build ``Paths(..., interpret=True)``
  themselves; ``choose_paths`` never returns interpret mode.
- any other backend raises.
"""

from __future__ import annotations

import dataclasses

INTERSECT_PATHS = ("brute", "listed", "bvh")
MARCH_PATHS = ("jnp", "kernel")
IMAGING_PATHS = ("xla",)

# Triangles per lax.scan step of the brute force when it runs on the card:
# bounds its (rays x chunk) intermediates to 2,560 x 8,192 per frame. On the
# 123k-triangle scene 8,192 beat 4,096 and 32,768 for one frame and lost to
# 4,096 by 11% for batches of 8 (PERF.md).
BRUTE_CHUNK = 8192


@dataclasses.dataclass(frozen=True)
class Paths:
    """How a frame runs, stage by stage.

    intersect: "brute" (ops.geometry, XLA), "listed" (Pallas kernel) or
      "bvh" (ops.bvh while-loop traversal); ``intersect_chunk`` > 0 scans the
      brute force over triangle chunks of that size.
    march: "jnp" (dense masked grid + scatter-add) or "kernel" (Pallas).
    imaging: PSF convolution, envelope and scan conversion; XLA everywhere.
    interpret: run the Pallas kernels in interpret mode (CPU tests only).
    """

    intersect: str = "brute"
    intersect_chunk: int = 0
    march: str = "jnp"
    imaging: str = "xla"
    interpret: bool = False

    def __post_init__(self):
        for name, allowed in (
            ("intersect", INTERSECT_PATHS),
            ("march", MARCH_PATHS),
            ("imaging", IMAGING_PATHS),
        ):
            if getattr(self, name) not in allowed:
                raise ValueError(
                    f"unknown {name} path {getattr(self, name)!r}; "
                    f"expected one of {allowed}"
                )


def choose_paths(backend: str, n_triangles: int, *,
                 soft_row_binning: bool = False,
                 intersect: str | None = None) -> Paths:
    """Paths for a ``jax.default_backend()`` name and a scene size.

    ``soft_row_binning`` (SimConfig) needs the jnp march: the kernel bins
    echoes into rows with the reference's hard floor. ``intersect`` forces
    the closest-hit path (CLI ``--intersect-mode``); a brute force on the
    card is chunked by BRUTE_CHUNK. ``n_triangles`` is unused today: the
    listed kernel won on both measured scene sizes."""
    del n_triangles
    if backend == "gpu":
        intersect = intersect or "listed"
        return Paths(
            intersect=intersect,
            intersect_chunk=BRUTE_CHUNK if intersect == "brute" else 0,
            march="jnp" if soft_row_binning else "kernel",
        )
    if backend == "cpu":
        return Paths(intersect=intersect or "brute")
    raise ValueError(f"no paths for backend {backend!r} (expected gpu or cpu)")
