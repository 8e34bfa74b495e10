"""Multi-process initialisation and mesh construction.

The reference has no distributed path at all (SURVEY.md §2.3). Here
jax.distributed joins the processes, after which every process sees the
global device set and the same ``shard_map`` code from parallel/shard.py runs
unchanged — scanlines sharded over all devices, the ~1 MB RF all_gather and
the (M, 8) material-gradient psum as XLA collectives.

tests/test_multihost.py runs it with two CPU processes over gloo.
"""

from __future__ import annotations

import jax

from .shard import make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Fail-fast jax.distributed init (no-op on single process).

    Pass the coordinator address (``host:port``), the process count and
    this process's id explicitly: nothing detects them.
    """
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "rays"):
    """1-D mesh over every device of every process."""
    return make_mesh(axis=axis)


def is_primary() -> bool:
    return jax.process_index() == 0
