"""Device SpMV in padded (sliced) ELL form.

Plain-JAX replacement for the reference CRS ``multiply_nt`` family
(``/root/reference/src/hif/ds/CompressedStorage.hpp:1137-1356`` and the OpenMP
``mt::multiply_nt`` in ``utils/mt_mv.hpp:49``).  The scalability-oriented
dropping guarantees a hard per-row nnz cap (ceil(alpha*nnz_row), ref
``alg/thresholds.hpp:72``), which makes padded ELL the natural static-shape
device layout: gathers + elementwise multiply + row reduction, which XLA
fuses into a few kernels on the accelerator.

For matrices with skewed row lengths (the E/F blocks are raw slices of A), a
single global pad width wastes bandwidth; ``SlicedELL`` buckets rows by length
(sliced-ELLPACK), pays padding only within a bucket, and maps results back to
row order with one gather — never a scatter with duplicate indices, which
XLA cannot run in parallel.

mrhs (multiple right-hand sides) comes for free via ``jax.vmap`` over the
vector argument — the analog of the reference ``std::array<V,Nrhs>`` rows.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["ELL", "SlicedELL", "ell_from_csr", "ell_matvec",
           "ell_matvec_mrhs", "sliced_ell_from_csr", "sliced_ell_matvec"]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ELL:
    """Padded sparse matrix: row r holds columns ``indices[r, :]`` with values
    ``values[r, :]``; padding uses column ``ncols`` (one past the end) and
    value 0, so gathers read a sentinel slot appended to ``x``."""

    indices: jax.Array   # (nrows, K) int32, pad = ncols
    values: jax.Array    # (nrows, K)
    nrows: int           # static
    ncols: int           # static

    @property
    def k(self) -> int:
        return self.indices.shape[1]

    def tree_flatten(self):
        return (self.indices, self.values), (self.nrows, self.ncols)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0], aux[1])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SlicedELL:
    """Row-length-bucketed ELL (sliced ELLPACK)."""

    blocks: Tuple[ELL, ...]     # one ELL per bucket (rows sorted by length)
    inv_order: jax.Array        # (nrows,) int32: position of row i in concat
    nrows: int                  # static
    ncols: int                  # static

    def tree_flatten(self):
        return ((self.blocks, self.inv_order), (self.nrows, self.ncols))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0], aux[1])


def ell_from_csr(A, dtype=None, min_k: int = 1) -> ELL:
    """Pack a host CSR matrix into padded ELL device arrays."""
    n = A.nrows
    counts = np.diff(A.indptr)
    K = max(int(counts.max()) if n else 0, min_k)
    idx = np.full((n, K), A.ncols, dtype=np.int32)
    val = np.zeros((n, K), dtype=A.data.dtype if dtype is None else dtype)
    if A.indices.size:
        rows = np.repeat(np.arange(n, dtype=np.int64), counts)
        offs = np.arange(A.indices.size, dtype=np.int64) - np.repeat(
            A.indptr[:-1], counts)
        idx[rows, offs] = A.indices
        val[rows, offs] = A.data
    return ELL(jnp.asarray(idx), jnp.asarray(val), n, A.ncols)


def sliced_ell_from_csr(A, dtype=None, base_k: int = 8) -> SlicedELL:
    """Bucket rows by nnz (powers of two from ``base_k``) and pack each bucket
    as an ELL block; bounds padding waste to 2x within a bucket."""
    from ..ds.csr import CSR

    n = A.nrows
    counts = np.diff(A.indptr)
    order = np.argsort(counts, kind="stable")
    inv_order = np.empty(n, dtype=np.int64)
    inv_order[order] = np.arange(n)

    blocks: List[ELL] = []
    start = 0
    while start < n:
        k_lo = counts[order[start]]
        cap = base_k
        while cap < k_lo:
            cap *= 2
        # all rows with nnz <= cap go into this bucket
        end = int(np.searchsorted(counts[order], cap, side="right"))
        rows = order[start:end]
        sub_counts = counts[rows]
        K = max(int(sub_counts.max()) if rows.size else 1, 1)
        idx = np.full((rows.size, K), A.ncols, dtype=np.int32)
        val = np.zeros((rows.size, K),
                       dtype=A.data.dtype if dtype is None else dtype)
        if rows.size and sub_counts.sum():
            rr = np.repeat(np.arange(rows.size, dtype=np.int64), sub_counts)
            flat = (np.repeat(A.indptr[rows], sub_counts)
                    + np.arange(int(sub_counts.sum()), dtype=np.int64)
                    - np.repeat(np.concatenate(
                        [[0], np.cumsum(sub_counts)[:-1]]), sub_counts))
            offs = (np.arange(int(sub_counts.sum()), dtype=np.int64)
                    - np.repeat(np.concatenate(
                        [[0], np.cumsum(sub_counts)[:-1]]), sub_counts))
            idx[rr, offs] = A.indices[flat]
            val[rr, offs] = A.data[flat]
        blocks.append(ELL(jnp.asarray(idx), jnp.asarray(val),
                          int(rows.size), A.ncols))
        start = end
    return SlicedELL(tuple(blocks), jnp.asarray(inv_order.astype(np.int32)),
                     n, A.ncols)


def ell_matvec(A, x: jax.Array) -> jax.Array:
    """y = A x; A may be ELL or SlicedELL."""
    if isinstance(A, SlicedELL):
        return sliced_ell_matvec(A, x)
    x_ext = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
    return (A.values * x_ext[A.indices]).sum(axis=1)


def sliced_ell_matvec(A: SlicedELL, x: jax.Array) -> jax.Array:
    if not A.blocks:  # empty operator (0 rows): e.g. a level with m == n
        return jnp.zeros((A.nrows,), dtype=x.dtype)
    x_ext = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
    parts = [(blk.values * x_ext[blk.indices]).sum(axis=1)
             for blk in A.blocks]
    cat = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    return cat[A.inv_order]


def ell_matvec_mrhs(A, X: jax.Array) -> jax.Array:
    """Y = A X for X of shape (ncols, nrhs)."""
    X_ext = jnp.concatenate([X, jnp.zeros((1, X.shape[1]), dtype=X.dtype)])
    if isinstance(A, SlicedELL):
        if not A.blocks:  # empty operator (0 rows)
            return jnp.zeros((A.nrows, X.shape[1]), dtype=X.dtype)
        parts = [_ell_rows_mrhs(blk.values, X_ext[blk.indices])
                 for blk in A.blocks]
        cat = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
        return cat[A.inv_order]
    return _ell_rows_mrhs(A.values, X_ext[A.indices])


def _ell_rows_mrhs(values: jax.Array, gathered: jax.Array) -> jax.Array:
    """Row-wise contraction of (r, k) values with gathered (r, k, nrhs)
    operands.  Precision is pinned: an unpinned f32 contraction may run in
    TF32 (about 3 decimal digits) on the GPU."""
    return jnp.einsum("rk,rkj->rj", values, gathered,
                      precision=jax.lax.Precision.HIGHEST)
