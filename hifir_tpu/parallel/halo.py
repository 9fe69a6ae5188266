"""Neighbor-only halo-exchange SpMV via ``ppermute``.

For banded orderings (RCM; stencil problems in natural order) a row shard
only references x entries from adjacent shards.  Instead of the O(n)
``all_gather`` in :mod:`.sharded`, each device exchanges just the halo
segments with its two ring neighbors (``jax.lax.ppermute``) — the
direct realization of the BASELINE north star ("halo vector segments
exchanged via ppermute ... overlapped with local compute"; XLA overlaps the
ppermute with the local gather/FMA automatically).

Host preprocessing computes the halo width from the sharded sparsity; inputs
whose bandwidth exceeds one shard fall back to the all_gather path.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .sharded import pad_rows

__all__ = ["HaloSpMV", "build_halo_spmv", "halo_spmv"]


@dataclasses.dataclass
class HaloSpMV:
    """Row-sharded operator with halo-local column coordinates."""

    mesh: Mesh
    idx: jax.Array      # (D, nb, K) int32 local coords into [halo_l | local | halo_r]
    val: jax.Array      # (D, nb, K)
    n: int              # logical size
    nb: int             # rows per shard
    halo: int           # one-sided halo width (symmetric)


def build_halo_spmv(mesh: Mesh, A, dtype=None) -> HaloSpMV:
    """Pack a host CSR for halo SpMV; raises ValueError when the sparsity
    needs more than one neighbor shard of halo."""
    D = mesh.shape["rows"]
    n = A.nrows
    Ap = pad_rows(A, D)
    npad = Ap.nrows
    nb = npad // D

    rows = np.repeat(np.arange(npad, dtype=np.int64), np.diff(Ap.indptr))
    shard_of_row = rows // nb
    cols = Ap.indices.astype(np.int64)
    # required reach beyond the shard boundaries
    lo = (shard_of_row * nb - cols)
    hi = (cols - ((shard_of_row + 1) * nb - 1))
    halo = int(max(lo.max(initial=0), hi.max(initial=0), 0))
    if halo > nb:
        raise ValueError(
            f"bandwidth needs halo {halo} > shard size {nb}; use the "
            "all_gather SpMV instead")

    counts = np.diff(Ap.indptr)
    K = max(int(counts.max()) if npad else 0, 1)
    width = nb + 2 * halo
    idx = np.full((npad, K), width, dtype=np.int32)   # pad -> sentinel
    val = np.zeros((npad, K), dtype=Ap.data.dtype if dtype is None else dtype)
    if Ap.indices.size:
        offs = (np.arange(Ap.indices.size, dtype=np.int64)
                - np.repeat(Ap.indptr[:-1], counts))
        local = cols - (shard_of_row * nb - halo)
        idx[rows, offs] = local.astype(np.int32)
        val[rows, offs] = Ap.data
    sh = NamedSharding(mesh, P("rows", None, None))
    return HaloSpMV(
        mesh,
        jax.device_put(jnp.asarray(idx.reshape(D, nb, K)), sh),
        jax.device_put(jnp.asarray(val.reshape(D, nb, K)), sh),
        n, nb, halo)


def halo_spmv(H: HaloSpMV, x: jax.Array) -> jax.Array:
    """y = A x with x and y row-sharded; only neighbor halos communicated."""
    D = H.mesh.shape["rows"]
    nb, halo = H.nb, H.halo

    def kernel(idx, val, x_local):
        idx = idx[0]          # (nb, K) after shard squeeze
        val = val[0]
        if halo:
            # send tail right / head left; edge devices receive zeros
            right = [(d, d + 1) for d in range(D - 1)]
            left = [(d, d - 1) for d in range(1, D)]
            from_left = jax.lax.ppermute(x_local[-halo:], "rows", right)
            from_right = jax.lax.ppermute(x_local[:halo], "rows", left)
            x_ext = jnp.concatenate(
                [from_left, x_local, from_right,
                 jnp.zeros((1,), dtype=x_local.dtype)])
        else:
            x_ext = jnp.concatenate(
                [x_local, jnp.zeros((1,), dtype=x_local.dtype)])
        return (val * x_ext[idx]).sum(axis=1)

    fn = jax.shard_map(kernel, mesh=H.mesh,
                       in_specs=(P("rows", None, None), P("rows", None, None),
                                 P("rows")),
                       out_specs=P("rows"), check_vma=False)
    return jax.jit(fn)(H.idx, H.val, x)
