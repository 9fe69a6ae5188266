"""Sharded sparse kernels and the distributed IR/solve step.

This is the genuinely new capability over the reference (which is a
single-process OpenMP library, SURVEY.md §2.7): row-block sharded SpMV and a
multi-device iterative-refinement step combining

- ``rhs`` axis: data parallelism over right-hand sides (each device group
  owns a slice of the RHS batch; no communication),
- ``rows`` axis: 1-D row-block sharding of the operator A; the SpMV gathers
  the needed x entries with ``all_gather`` (the halo exchange of
  SURVEY.md §2.7 item 3; ``ppermute``-based neighbor-only exchange is the
  planned refinement for banded orderings).

The M-solve itself is replicated across the ``rows`` axis in this round (its
operands are small relative to A); the distributed level-scheduled trsv is the
next step (see ROADMAP in README).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..alg.prec import prec_solve_mrhs_device
from ..ops.spmv import ELL, ell_from_csr

__all__ = ["shard_ell_rows", "sharded_spmv", "make_sharded_ir_step",
           "pad_rows"]


def pad_rows(A, multiple: int):
    """Pad a host CSR with empty rows to a multiple (for even row sharding)."""
    from ..ds.csr import CSR

    n = A.nrows
    npad = (-n) % multiple
    if npad == 0:
        return A
    indptr = np.concatenate([A.indptr,
                             np.full(npad, A.indptr[-1], dtype=np.int64)])
    return CSR(n + npad, A.ncols, indptr, A.indices, A.data)


def shard_ell_rows(mesh: Mesh, A, dtype=None) -> ELL:
    """Pack a host CSR into ELL with rows padded to the ``rows`` axis size and
    place it row-sharded on the mesh."""
    nrows_axis = mesh.shape["rows"]
    Ap = pad_rows(A, nrows_axis)
    e = ell_from_csr(Ap, dtype=dtype)
    sh = jax.sharding.NamedSharding(mesh, P("rows", None))
    return ELL(jax.device_put(e.indices, sh), jax.device_put(e.values, sh),
               e.nrows, e.ncols)


def sharded_spmv(mesh: Mesh, A: ELL, x: jax.Array) -> jax.Array:
    """y = A x with A row-sharded; x replicated in, y row-sharded out."""

    def kernel(idx, val, x):
        x_ext = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
        return (val * x_ext[idx]).sum(axis=1)

    return jax.shard_map(kernel, mesh=mesh,
                     in_specs=(P("rows", None), P("rows", None), P()),
                     out_specs=P("rows"))(A.indices, A.values, x)


def make_sharded_ir_step(mesh: Mesh, n: int):
    """Build the jitted multi-device IR step
    ``X <- X + M^{-1}(B - A X)`` with A row-sharded and the RHS batch sharded
    over the ``rhs`` axis.

    Returns ``step(A_ell, levels, tail, X, B) -> X_new`` (jit-compiled over
    the mesh).  Shapes: X, B are (n_padded, nrhs) with nrhs divisible by the
    ``rhs`` axis size and n_padded by the ``rows`` axis size.
    """

    def step(idx, val, levels, tail, X, B):
        # inside shard_map: idx/val hold this device's row block; X/B hold
        # this device's RHS slice (all rows).
        X_ext = jnp.concatenate(
            [X, jnp.zeros((1, X.shape[1]), dtype=X.dtype)])
        Y_local = jnp.einsum("rk,rkj->rj", val, X_ext[idx],
                             precision=jax.lax.Precision.HIGHEST)
        # assemble the full residual on every row-shard (all-gather);
        # B rows for this shard: slice by the rows index
        r_idx = jax.lax.axis_index("rows").astype(jnp.int32)
        nloc = Y_local.shape[0]
        B_local = jax.lax.dynamic_slice(
            B, (r_idx * jnp.int32(nloc), jnp.int32(0)), (nloc, B.shape[1]))
        R_local = B_local - Y_local
        R = jax.lax.all_gather(R_local, "rows", axis=0, tiled=True)
        # replicated M-solve on the padded residual (trim to n)
        dX = prec_solve_mrhs_device(levels, tail, R[:n])
        dX = jnp.concatenate(
            [dX, jnp.zeros((R.shape[0] - n, R.shape[1]), dtype=dX.dtype)])
        return X + dX

    def step_full(idx, val, levels, tail, X, B):
        return jax.shard_map(
            step, mesh=mesh,
            in_specs=(P("rows", None), P("rows", None), P(), P(),
                      P(None, "rhs"), P(None, "rhs")),
            out_specs=P(None, "rhs"),
            check_vma=False)(idx, val, levels, tail, X, B)

    return jax.jit(step_full)
