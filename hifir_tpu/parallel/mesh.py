"""Device mesh helpers.

The reference has no distribution at all (SURVEY.md §2.7: OpenMP fork-join
only); this implementation scales via ``jax.sharding.Mesh`` + ``shard_map``
with XLA collectives between the devices (SURVEY.md §7.1).  The mesh is a
plain reshape of the device list: the four H100s of one host are joined all
to all over NVLink, so no axis follows a physical topology.  Axes:

- ``rhs``: data parallelism over right-hand sides (the analog of DP),
- ``rows``: 1-D row-block sharding of sparse operators (the analog of TP),
  used by the sharded SpMV / distributed solve.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "P", "Mesh", "NamedSharding"]


def make_mesh(n_devices: Optional[int] = None, rhs: int = 1,
              local: bool = False) -> Mesh:
    """Create a ``(rhs, rows)`` mesh over the first ``n_devices`` devices.

    ``local=True`` restricts to this process's devices — the
    RAS-over-DistPrec composition (BASELINE config 5) runs each process's
    part solves distributed over its OWN chips while the cross-process
    coupling stays additive-Schwarz."""
    devs = jax.local_devices() if local else jax.devices()
    n = len(devs) if n_devices is None else n_devices
    if n % rhs:
        raise ValueError(f"n_devices={n} not divisible by rhs={rhs}")
    arr = np.array(devs[:n]).reshape(rhs, n // rhs)
    return Mesh(arr, axis_names=("rhs", "rows"))
