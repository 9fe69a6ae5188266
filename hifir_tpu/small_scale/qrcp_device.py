"""Device (jitted) Householder QR with column pivoting.

Device replacement for LAPACK ``geqp3`` (ref ``small_scale/QRCP.hpp`` and
the north-star requirement that the dense last level run as device kernels):
a masked, fixed-shape Householder sweep with greedy column pivoting and
norm downdating, entirely inside one jit — each step is rank-1 updates and
(n,) reductions.

Numerically follows geqp3: pivot = trailing column of largest (downdated)
norm; the downdating drift is guarded by clamping.  Rank determination
mirrors the host QRCP (diag decay against ``rrqr_cond``, default ε^{-2/3}).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["qrcp_device", "qrcp_rank"]

_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


@jax.jit
def qrcp_device(A: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Factorize A[:, piv] = Q R with |diag(R)| non-increasing.

    Returns (Q, R, piv).  Square A only (the HIF dense tail is square).
    """
    n = A.shape[0]
    dtype = A.dtype
    R = A
    Q = jnp.eye(n, dtype=dtype)
    piv = jnp.arange(n, dtype=jnp.int32)
    norms2 = (A * A).sum(axis=0)
    idx = jnp.arange(n)

    def body(k, state):
        R, Q, piv, norms2 = state
        # greedy pivot among trailing columns
        masked = jnp.where(idx >= k, norms2, -jnp.inf)
        j = jnp.argmax(masked)
        # swap columns k <-> j (gather-free via where on a permutation)
        swap = jnp.where(idx == k, j, jnp.where(idx == j, k, idx))
        R = R[:, swap]
        piv = piv[swap]
        norms2 = norms2[swap]
        # Householder vector for column k below row k
        x = jnp.where(idx >= k, R[:, k], 0.0)
        sigma = jnp.linalg.norm(x)
        xk = R[k, k]
        alpha = -jnp.sign(jnp.where(xk == 0, 1.0, xk)) * sigma
        v = x.at[k].add(-alpha)
        vnorm = jnp.linalg.norm(v)
        v = jnp.where(vnorm > 0, v / jnp.where(vnorm > 0, vnorm, 1.0), v)
        # apply the reflector: R -= 2 v (v^T R);  Q -= 2 (Q v) v^T
        R = R - 2.0 * jnp.outer(v, _mm(v, R))
        Q = Q - 2.0 * jnp.outer(_mm(Q, v), v)
        # clean the annihilated entries and set the diagonal exactly
        col = jnp.where(idx > k, 0.0, R[:, k]).at[k].set(alpha)
        R = R.at[:, k].set(col)
        # downdate trailing column norms; clamp drift
        norms2 = jnp.maximum(norms2 - R[k, :] ** 2, 0.0)
        return R, Q, piv, norms2

    R, Q, piv, _ = jax.lax.fori_loop(0, n, body, (R, Q, piv, norms2))
    R = jnp.triu(R)
    return Q, R, piv


def qrcp_rank(R: jax.Array, rrqr_cond: float = 0.0) -> int:
    """Host-side rank decision from |diag R| decay (ref QRCP.hpp:144-161)."""
    d = np.abs(np.asarray(jnp.diagonal(R)))
    if d.size == 0 or d[0] == 0.0:
        return 0
    if rrqr_cond <= 0.0:
        rrqr_cond = float(np.finfo(np.float64).eps) ** (-2.0 / 3.0)
    good = d > d[0] / rrqr_cond
    return int(np.flatnonzero(good)[-1] + 1) if good.any() else 0
