"""Multi-host initialization helpers.

For jobs spanning several processes, JAX requires
``jax.distributed.initialize`` before any backend use; afterwards the global
mesh covers all processes' devices and every collective in this package
(`all_gather` in the sharded SpMV/trsv/M-solve) crosses process boundaries
automatically.  This is the multi-process story the reference never had
(SURVEY.md §2.7).

Tested on the CPU backend (two processes with virtual devices each).  On
GPUs each process owns its own cards (one process per GPU, selected with
``CUDA_VISIBLE_DEVICES``).
"""

from __future__ import annotations

from typing import Optional

import jax

__all__ = ["initialize_multihost", "global_mesh"]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Initialize the JAX distributed runtime (idempotent).

    On a GPU machine no cluster environment is auto-detected: pass the
    coordinator address (``localhost:<port>`` on one host), the process
    count and this process's id.
    """
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def global_mesh(rhs: int = 1):
    """Mesh over every device in the job (all hosts)."""
    from .mesh import make_mesh

    return make_mesh(len(jax.devices()), rhs=rhs)
