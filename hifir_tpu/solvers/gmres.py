"""Jitted device Krylov drivers: right-preconditioned GMRES(m) and FGMRES-HIFIR.

Device re-design of the reference example solvers
(``/root/reference/examples/advanced/gmres.hpp:18-122`` gmres_hif and
``:127-231`` fgmres_hifir): the whole restart cycle — preconditioner apply
(jitted multilevel M-solve), sliced-ELL SpMV, modified Gram-Schmidt and Givens
QR of the Hessenberg — runs inside one jitted function with static shapes
(fixed restart length, masked after convergence); only the restart loop is in
Python.  All operands (matrix, preconditioner pytree) are jit arguments.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..alg.prec import prec_solve_device
from ..ops.spmv import ell_matvec

__all__ = ["gmres_hif_device", "fgmres_hifir_device", "ir_apply_device",
           "gmres_mrhs_device"]

# Krylov contractions run at full precision: an unpinned f32 contraction may
# run in TF32 (about 3 decimal digits) on the GPU.
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def ir_apply_device(A, levels, tail, b, nirs: int, r=None) -> jax.Array:
    """x = HIFIR(b): nirs steps of x += M^{-1}(b - A x)
    (ref ``alg/IterRefine.hpp:78-105``).  ``r`` (traced) overrides the dense
    tail's truncation rank (the reference FGMRES's per-iteration ``rr``
    control, examples/advanced/gmres.hpp:127-231)."""
    x0 = prec_solve_device(levels, tail, b, r=r)
    if nirs <= 1:
        return x0

    def body(_, x):
        return x + prec_solve_device(levels, tail, b - ell_matvec(A, x),
                                     r=r)

    return jax.lax.fori_loop(1, nirs, body, x0)


@functools.partial(jax.jit, static_argnames=("restart", "nirs"))
def _restart_cycle(A, levels, tail, b, x, rtol_bnrm, restart: int,
                   nirs: int = 1, r=None):
    """One FGMRES(m) restart cycle (fully jitted, static shapes).

    Returns (x_new, |residual| estimate, iters_done).
    """
    n = b.shape[0]
    dtype = b.dtype
    m = restart

    rank_r = r  # keep the rank override out of the residual local's way

    def msolve(v):
        return ir_apply_device(A, levels, tail, v, nirs, r=rank_r)

    r = b - ell_matvec(A, x)
    beta = jnp.linalg.norm(r)
    V = jnp.zeros((m + 1, n), dtype)
    Z = jnp.zeros((m, n), dtype)
    H = jnp.zeros((m + 1, m), dtype)
    cs = jnp.zeros(m, dtype)
    sn = jnp.zeros(m, dtype)
    g = jnp.zeros(m + 1, dtype).at[0].set(beta)
    V = V.at[0].set(jnp.where(beta > 0, r / beta, r))

    def arnoldi_step(carry, j):
        V, Z, H, cs, sn, g, done = carry
        z = msolve(V[j])
        w = ell_matvec(A, z)
        # classical Gram-Schmidt with reorthogonalization (CGS2): two masked
        # (m+1, n) matmuls per pass instead of a slice loop
        mask_v = (jnp.arange(m + 1) <= j).astype(dtype)
        h1 = _mm(V.conj(), w) * mask_v
        w = w - _mm(h1, V)
        h2 = _mm(V.conj(), w) * mask_v
        w = w - _mm(h2, V)
        h = h1 + h2
        H = H.at[:, j].set(h)
        hj1 = jnp.linalg.norm(w)
        H = H.at[j + 1, j].set(hj1)
        V = V.at[j + 1].set(jnp.where(hj1 > 0, w / hj1, w))
        Z = Z.at[j].set(z)
        # apply stored Givens rotations to the new column
        def rot(i, Hcol):
            t = cs[i] * Hcol[i] + sn[i] * Hcol[i + 1]
            Hcol = Hcol.at[i + 1].set(-sn[i] * Hcol[i] + cs[i] * Hcol[i + 1])
            return Hcol.at[i].set(t)
        Hcol = jax.lax.fori_loop(0, j, rot, H[:, j])
        a, bb = Hcol[j], Hcol[j + 1]
        rho = jnp.sqrt(a * a + bb * bb)
        c_new = jnp.where(rho > 0, a / rho, 1.0)
        s_new = jnp.where(rho > 0, bb / rho, 0.0)
        Hcol = Hcol.at[j].set(rho).at[j + 1].set(0.0)
        H = H.at[:, j].set(Hcol)
        cs = cs.at[j].set(c_new)
        sn = sn.at[j].set(s_new)
        g = g.at[j + 1].set(-s_new * g[j])
        g = g.at[j].set(c_new * g[j])
        done = jnp.abs(g[j + 1]) <= rtol_bnrm
        return (V, Z, H, cs, sn, g, done), done

    def cycle_body(carry, j):
        done = carry[-1]
        return jax.lax.cond(done,
                            lambda c, _j: (c, jnp.asarray(True)),
                            arnoldi_step, carry, j)

    (V, Z, H, cs, sn, g, done), dones = jax.lax.scan(
        cycle_body, (V, Z, H, cs, sn, g, jnp.asarray(False)), jnp.arange(m))
    j_used = jnp.where(dones.any(), jnp.argmax(dones) + 1, m)
    # masked back substitution on the used leading block of H
    mask = jnp.arange(m) < j_used
    Hm = jnp.where(mask[None, :] & mask[:, None], H[:m, :m], 0.0)
    Hm = Hm + jnp.diag(jnp.where(mask, 0.0, 1.0))
    y = jax.scipy.linalg.solve_triangular(Hm, jnp.where(mask, g[:m], 0.0),
                                          lower=False)
    x_new = x + _mm(Z.T, y)
    res = jnp.abs(g[jnp.minimum(j_used, m)])
    return x_new, res, j_used


def gmres_hif_device(A, prec, b, restart: int = 30, rtol: float = 1e-6,
                     maxit: int = 500, x0=None) -> Tuple[jax.Array, int, int]:
    """Right-preconditioned restarted GMRES, device-resident.

    ``A`` is an ELL/SlicedELL operator, ``prec`` a DevicePrec.
    Returns (x, flag, iters).
    """
    b = jnp.asarray(b)
    bnrm = float(jnp.linalg.norm(b))
    if bnrm == 0.0:
        return jnp.zeros_like(b), 0, 0
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    levels, tail = prec.operands()
    it = 0
    flag = 1
    while it < maxit:
        x, res, j_used = _restart_cycle(A, levels, tail, b, x,
                                        rtol * bnrm, restart)
        it += int(j_used)
        if float(res) <= rtol * bnrm:
            flag = 0
            break
    return x, flag, it


def fgmres_hifir_device(A, prec, b, restart: int = 30, rtol: float = 1e-6,
                        maxit: int = 500, x0=None, max_inner: int = 4,
                        rank: int = 0
                        ) -> Tuple[jax.Array, int, int]:
    """Flexible GMRES with inner iterative refinement (HIFIR).

    The reference doubles the inner refinement count per outer iteration
    (``nirs = 2^it``, gmres.hpp:164); with static shapes we double per
    *restart cycle*, capped at ``2^max_inner``.
    """
    b = jnp.asarray(b)
    bnrm = float(jnp.linalg.norm(b))
    if bnrm == 0.0:
        return jnp.zeros_like(b), 0, 0
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    levels, tail = prec.operands()
    it = 0
    flag = 1
    outer = 0
    while it < maxit:
        nirs = 1 << min(outer, max_inner)
        rr = jnp.int32(rank) if rank and rank > 0 else None
        x, res, j_used = _restart_cycle(A, levels, tail, b, x,
                                        rtol * bnrm, restart, nirs, r=rr)
        it += int(j_used)
        outer += 1
        if float(res) <= rtol * bnrm:
            flag = 0
            break
    return x, flag, it


@functools.partial(jax.jit, static_argnames=("restart",))
def _restart_cycle_mrhs(A, levels, tail, B, X, restart: int):
    """One batched GMRES(m) restart cycle over R right-hand sides.

    Every Krylov quantity carries a trailing batch axis; the preconditioner
    apply is the batched multilevel solve, so the whole cycle amortizes
    gather/loop overheads across the batch exactly like ``solve_mrhs``.
    Runs all m inner steps (no early exit); returns (X_new, residual
    estimates per RHS).
    """
    from ..alg.prec import prec_solve_mrhs_device
    from ..ops.spmv import ell_matvec_mrhs

    n, R = B.shape
    dtype = B.dtype
    m = restart

    Rsd = B - ell_matvec_mrhs(A, X)
    beta = jnp.linalg.norm(Rsd, axis=0)                     # (R,)
    safe = jnp.where(beta > 0, beta, 1.0)
    V = jnp.zeros((m + 1, n, R), dtype).at[0].set(Rsd / safe)
    Z = jnp.zeros((m, n, R), dtype)
    H = jnp.zeros((m + 1, m, R), dtype)
    cs = jnp.zeros((m, R), dtype)
    sn = jnp.zeros((m, R), dtype)
    g = jnp.zeros((m + 1, R), dtype).at[0].set(beta)

    def arnoldi(carry, j):
        V, Z, H, cs, sn, g = carry
        Zj = prec_solve_mrhs_device(levels, tail, V[j])
        W = ell_matvec_mrhs(A, Zj)
        # batched CGS2
        mask = (jnp.arange(m + 1) <= j).astype(dtype)[:, None]
        h1 = _einsum("ink,nk->ik", V.conj(), W) * mask
        W = W - _einsum("ik,ink->nk", h1, V)
        h2 = _einsum("ink,nk->ik", V.conj(), W) * mask
        W = W - _einsum("ik,ink->nk", h2, V)
        h = h1 + h2
        hj1 = jnp.linalg.norm(W, axis=0)                    # (R,)
        Hcol = h.at[j + 1].set(hj1)
        V = V.at[j + 1].set(jnp.where(hj1 > 0, W / jnp.where(hj1 > 0, hj1,
                                                             1.0), W))
        Z = Z.at[j].set(Zj)

        def rot(i, c):
            t = cs[i] * c[i] + sn[i] * c[i + 1]
            c = c.at[i + 1].set(-jnp.conj(sn[i]) * c[i]
                                + jnp.conj(cs[i]) * c[i + 1])
            return c.at[i].set(t)

        Hcol = jax.lax.fori_loop(0, j, rot, Hcol)
        a = Hcol[j]
        bb = Hcol[j + 1]
        rho = jnp.sqrt(jnp.abs(a) ** 2 + jnp.abs(bb) ** 2)
        c_new = jnp.where(rho > 0, jnp.conj(a) / jnp.where(rho > 0, rho, 1.0),
                          1.0)
        s_new = jnp.where(rho > 0, jnp.conj(bb) / jnp.where(rho > 0, rho, 1.0),
                          0.0)
        Hcol = Hcol.at[j].set(rho.astype(dtype)).at[j + 1].set(0.0)
        H = H.at[:, j].set(Hcol)
        cs = cs.at[j].set(c_new)
        sn = sn.at[j].set(s_new)
        g = g.at[j + 1].set(-jnp.conj(s_new) * g[j])
        g = g.at[j].set(c_new * g[j])
        return (V, Z, H, cs, sn, g), None

    (V, Z, H, cs, sn, g), _ = jax.lax.scan(
        arnoldi, (V, Z, H, cs, sn, g), jnp.arange(m))
    # batched back substitution on the m x m upper triangular systems; per
    # lane, columns past a zero pivot (Krylov breakdown = exact convergence)
    # are masked out with a unit diagonal and zero rhs
    Hm = jnp.moveaxis(H[:m, :m], -1, 0)                     # (R, m, m)
    diag_ok = jnp.abs(jnp.diagonal(Hm, axis1=1, axis2=2)) > 0  # (R, m)
    used = jnp.cumprod(diag_ok, axis=1).astype(bool)           # (R, m)
    msk2 = used[:, :, None] & used[:, None, :]
    Hm = jnp.where(msk2, Hm, 0.0) + jnp.where(
        used, 0.0, 1.0)[:, :, None] * jnp.eye(m, dtype=dtype)[None]
    grhs = jnp.where(used, jnp.moveaxis(g[:m], -1, 0), 0.0)
    y = jax.vmap(lambda Hk, gk: jax.scipy.linalg.solve_triangular(
        Hk, gk, lower=False))(Hm, grhs)                       # (R, m)
    X_new = X + _einsum("jnk,kj->nk", Z, y)
    res = jnp.abs(g[m])                                      # (R,)
    return X_new, res


def gmres_mrhs_device(A, prec, B, restart: int = 30, rtol: float = 1e-6,
                      maxit: int = 500) -> Tuple[jax.Array, int, int]:
    """Batched right-preconditioned GMRES over many right-hand sides.

    Capability the reference cannot express (its mrhs is a compile-time
    array of <= 4): all RHS share every kernel launch, so the per-RHS cost
    approaches the batched M-solve throughput.  Returns (X, flag, cycles).
    """
    B = jnp.asarray(B)
    levels, tail = prec.operands()
    bnrm = jnp.linalg.norm(B, axis=0)
    bsafe = jnp.where(bnrm > 0, bnrm, 1.0)
    X = jnp.zeros_like(B)
    cycles = 0
    flag = 1
    while cycles * restart < maxit:
        X, res = _restart_cycle_mrhs(A, levels, tail, B, X, restart)
        cycles += 1
        if float(jnp.max(res / bsafe)) <= rtol:
            flag = 0
            break
    return X, flag, cycles
