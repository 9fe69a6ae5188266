"""Distributed level-scheduled sparse triangular solve.

The reference trsv is strictly serial (``CompressedStorage.hpp:1358``); this
is the partitioned counterpart from the BASELINE north star: rows within a
dependency level are independent, so each level-chunk is **split across the
``rows`` mesh axis** — every device computes its slice of the chunk from its
shard of the factor, then the slices are reassembled with a tiled
``all_gather`` before the next chunk (the halo exchange of vector
segments; with levels as chunks the number of collectives equals the chunk
count, not n).

Layout contract: chunk c occupies slots ``[c*C, (c+1)*C)`` in schedule order,
internally laid out ``[dev0 part | dev1 part | ...]`` so the tiled all_gather
reassembles it in place.  Solution stays replicated; the factor (cols/vals)
is the sharded operand — the memory that actually scales with fill.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.trsv import TrsvSchedule, build_trsv_schedule

__all__ = ["ShardedTrsv", "shard_trsv_schedule", "sharded_trsv_apply"]


class ShardedTrsv:
    """Device-sharded chunked schedule (host container of placed arrays)."""

    def __init__(self, mesh, in_rows, cols, vals, out_slots, n, nchunks,
                 chunk, nslots):
        self.mesh = mesh
        self.in_rows = in_rows      # (nslots,) replicated
        self.cols = cols            # (nchunks, C, K) sharded P(None, "rows", None)
        self.vals = vals            # (nchunks, C, K) sharded
        self.out_slots = out_slots  # (n,) replicated
        self.n = n
        self.nchunks = nchunks
        self.chunk = chunk
        self.nslots = nslots


def shard_trsv_schedule(mesh: Mesh, T, lower: bool, chunk: int = 256
                        ) -> ShardedTrsv:
    """Build a schedule whose chunks are divisible by the ``rows`` axis and
    place the factor shards on the mesh."""
    ndev = mesh.shape["rows"]
    C = max(chunk, ndev)
    C -= C % ndev
    sched = build_trsv_schedule(T, lower=lower, chunk=C, k_cap="auto")
    sh_fact = NamedSharding(mesh, P(None, "rows", None))
    sh_rep = NamedSharding(mesh, P())
    return ShardedTrsv(
        mesh,
        jax.device_put(sched.in_rows, sh_rep),
        jax.device_put(sched.cols, sh_fact),
        jax.device_put(sched.vals, sh_fact),
        jax.device_put(sched.out_slots, sh_rep),
        sched.n, sched.nchunks, C, int(sched.in_rows.shape[0]))


def _kernel(n, nchunks, chunk, in_rows, cols, vals, out_slots, b):
    # runs inside shard_map: cols/vals hold this device's slice of every
    # chunk; b and the solution are replicated
    ndev = jax.lax.psum(1, "rows")
    my = jax.lax.axis_index("rows").astype(jnp.int32)
    Cloc = chunk // ndev

    b_ext = jnp.concatenate([b, jnp.zeros((1,), dtype=b.dtype)])
    x = b_ext[in_rows]
    x = jnp.concatenate([x, jnp.zeros((1,), dtype=b.dtype)])

    def body(carry, inputs):
        x, c = carry
        cc, vv = inputs                    # (Cloc, K) local slice
        g = x[cc]
        contrib = (vv * g).sum(axis=1)
        # this device's slice of the chunk starts at c + my*Cloc
        cur = jax.lax.dynamic_slice(x, (c + my * jnp.int32(Cloc),), (Cloc,))
        new_local = cur - contrib
        # reassemble the full chunk and write it back
        new_full = jax.lax.all_gather(new_local, "rows", axis=0, tiled=True)
        x = jax.lax.dynamic_update_slice(x, new_full, (c,))
        return (x, c + jnp.int32(chunk)), None

    (x, _), _ = jax.lax.scan(body, (x, jnp.int32(0)), (cols, vals))
    return x[out_slots]


def sharded_trsv_apply(st: ShardedTrsv, b: jax.Array) -> jax.Array:
    """Solve (I + strict(T)) x = b across the mesh; b and x replicated."""
    if st.nchunks == 0:
        return b
    import functools

    fn = jax.shard_map(
        functools.partial(_kernel, st.n, st.nchunks, st.chunk),
        mesh=st.mesh,
        in_specs=(P(), P(None, "rows", None), P(None, "rows", None), P(),
                  P()),
        out_specs=P(),
        check_vma=False)
    return jax.jit(fn)(st.in_rows, st.cols, st.vals, st.out_slots,
                       jnp.asarray(b))
