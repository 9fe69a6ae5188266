"""Device-side multilevel preconditioner (jitted M-solve).

Accelerator re-design of the reference apply path
(``/root/reference/src/hif/alg/prec_solve.hpp:333`` recursion over
``std::list<Prec>``): the per-level operands are packed once into static-shape
device pytrees (scalings/permutations as gather indices, L_B/U_B as
level-scheduled trsv schedules, E/F as sliced ELL, the dense tail as QR/eigh
factors) and the whole multilevel solve becomes ONE jitted function - the
recursion unrolls at trace time (levels have distinct shapes anyway).

Operands are always passed as jit *arguments*: XLA embeds closure-captured
arrays as program constants, which both explodes compile time and re-ships
them to the device on every call.

The preconditioner pytree is also the serialization unit: being a pytree of
plain arrays it can be checkpointed/restored directly (an improvement over the
reference, whose state is only exportable per level via
``Prec::export_sparse_data``, ``alg/Prec.hpp:222``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.spmv import SlicedELL, ell_matvec, sliced_ell_from_csr
from ..ops.trsv import (TrsvDense, TrsvSchedule, build_trsv_block_dense,
                        build_trsv_dense, build_trsv_schedule, trsv_apply)

__all__ = ["DeviceLevel", "DenseTail", "DevicePrec", "tail_solve",
           "prec_solve_device", "prec_solve_tran_device",
           "prec_solve_mrhs_device", "prec_solve_tran_mrhs_device",
           "prec_prod_device", "prec_prod_tran_device"]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DenseTail:
    """Dense last level: truncated-rank QRCP, symmetric eigen, or LU factors
    (ref ``small_scale/{QRCP,SYEIG,LUP}.hpp``)."""

    Q: jax.Array          # (nm, nm) Q (QRCP), V (SYEIG), unit-lower L (LUP)
    R: jax.Array          # (nm, nm) upper triangular (QRCP/LUP)
    jpvt: jax.Array       # (nm,) int32 col pivots (QRCP) / eig order / row perm
    w: jax.Array          # (nm,) eigenvalues (SYEIG) or zeros
    rank: int             # static truncation rank
    kind: str             # "qrcp" | "syeig" | "lup"

    def tree_flatten(self):
        return ((self.Q, self.R, self.jpvt, self.w), (self.rank, self.kind))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def _mask1(y, mask):
    """Broadcast a (nm,) bool mask over (nm,) or (nm, k) operands."""
    return mask if y.ndim == 1 else mask[:, None]


def tail_solve_rank(tail, y, r, trans=False):
    """Truncated-rank dense backsolve with a RUNTIME rank ``r`` (traced
    int32), the device analog of the reference's per-solve rank override
    (``HIF::solve(b, x, trans, rank)`` -> ``QRCP.hpp:211`` truncated
    backsolve, builder.hpp:410-424).  Static shapes throughout: the
    truncation is a mask, so one compilation serves every rank.  LUP has no
    rank truncation in the reference either; ``r`` is ignored there."""
    if tail is None:
        return y
    if tail.kind == "lup":
        return tail_solve(tail, y, trans=trans)
    nm = tail.Q.shape[0]
    mask = jnp.arange(nm) < r
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    if tail.kind == "syeig":
        coeff = mm(tail.Q.T.conj(), y)
        safe_w = jnp.where(mask, tail.w, jnp.ones_like(tail.w))
        coeff = jnp.where(_mask1(coeff, mask),
                          coeff / _wcol(safe_w, coeff), 0)
        return mm(tail.Q, coeff)
    # qrcp: solve on a masked R whose trailing diagonal is identity, so the
    # triangular solve stays full-size (static shape) while rows/cols >= r
    # contribute exact zeros
    Rm = jnp.where(mask[:, None] & mask[None, :], tail.R,
                   jnp.diag(jnp.where(mask, 0.0, 1.0)).astype(tail.R.dtype))
    if not trans:
        wv = mm(tail.Q.T.conj(), y)
        wv = jnp.where(_mask1(wv, mask), wv, 0)
        z = jax.scipy.linalg.solve_triangular(Rm, wv, lower=False)
        z = jnp.where(_mask1(z, mask), z, 0)
        return jnp.zeros_like(y).at[tail.jpvt].set(z, unique_indices=True)
    wv = y[tail.jpvt]
    wv = jnp.where(_mask1(wv, mask), wv, 0)
    z = jax.scipy.linalg.solve_triangular(Rm, wv, lower=False, trans=2)
    z = jnp.where(_mask1(z, mask), z, 0)
    return mm(tail.Q, z)


def _wcol(w, like):
    return w if like.ndim == 1 else w[:, None]


def tail_solve(tail, y, trans=False, r=None):
    """Truncated-rank dense backsolve (ref ``QRCP.hpp:211`` / ``SYEIG``).
    ``r`` (optional, traced) overrides the static pack-time rank."""
    if tail is None:
        return y
    if r is not None:
        return tail_solve_rank(tail, y, r, trans=trans)
    r = tail.rank
    if r == 0:
        return jnp.zeros_like(y)
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    if tail.kind == "syeig":
        Vr = tail.Q[:, :r]
        return mm(Vr, mm(Vr.T.conj(), y) / tail.w[:r])
    if tail.kind == "lup":
        L, U, pperm = tail.Q, tail.R, tail.jpvt
        if not trans:
            z = jax.scipy.linalg.solve_triangular(L, y[pperm], lower=True,
                                                  unit_diagonal=True)
            return jax.scipy.linalg.solve_triangular(U, z, lower=False)
        z = jax.scipy.linalg.solve_triangular(U, y, lower=False, trans=2)
        z = jax.scipy.linalg.solve_triangular(L, z, lower=True, trans=2,
                                              unit_diagonal=True)
        return jnp.zeros_like(y).at[pperm].set(z, unique_indices=True)
    # qrcp
    if not trans:
        wv = mm(tail.Q[:, :r].T.conj(), y)
        z = jax.scipy.linalg.solve_triangular(tail.R[:r, :r], wv, lower=False)
        return jnp.zeros_like(y).at[tail.jpvt[:r]].set(z, unique_indices=True)
    wv = y[tail.jpvt[:r]]
    z = jax.scipy.linalg.solve_triangular(tail.R[:r, :r], wv, lower=False,
                                          trans=2)
    return mm(tail.Q[:, :r], z)


def tail_multiply(tail, x, trans=False):
    """Forward product of the dense tail (for mmultiply)."""
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    if tail.kind == "syeig":
        return mm(tail.Q, tail.w * mm(tail.Q.T.conj(), x))
    if tail.kind == "lup":
        # P A = L U  =>  A x = P^T L U x,  A^H x = U^H L^H P x
        L, U, pperm = tail.Q, tail.R, tail.jpvt
        if not trans:
            return jnp.zeros_like(x).at[pperm].set(mm(L, mm(U, x)),
                                                   unique_indices=True)
        return mm(U.T.conj(), mm(L.T.conj(), x[pperm]))
    if not trans:
        return mm(tail.Q, mm(tail.R, x[tail.jpvt]))
    return jnp.zeros_like(x).at[tail.jpvt].set(
        mm(tail.R.T.conj(), mm(tail.Q.T.conj(), x)), unique_indices=True)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceLevel:
    """One level's device operands (ref ``alg/Prec.hpp:82`` struct Prec)."""

    p: jax.Array          # (n,) int32 row permutation (position -> orig)
    q_inv: jax.Array      # (n,) int32 inverse column permutation
    s_p: jax.Array        # (n,) s[p] gather-scaling coefficients
    t: jax.Array          # (n,)
    d: jax.Array          # (m,) diagonal
    L: TrsvSchedule       # strict lower solve schedule of L_B
    U: TrsvSchedule       # strict upper solve schedule of U_B
    E: SlicedELL          # (n-m) x m
    F: SlicedELL          # m x (n-m)
    m: int                # static
    n: int                # static

    def tree_flatten(self):
        return ((self.p, self.q_inv, self.s_p, self.t, self.d, self.L,
                 self.U, self.E, self.F), (self.m, self.n))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class TranLevel:
    """Transpose operands of one level (built on demand)."""

    LT: TrsvSchedule      # schedule of L^H (unit strict upper)
    UT: TrsvSchedule      # schedule of U^H (unit strict lower)
    ET: SlicedELL         # E^H
    FT: SlicedELL         # F^H
    q: jax.Array          # forward column permutation

    def tree_flatten(self):
        return ((self.LT, self.UT, self.ET, self.FT, self.q), ())

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


DENSE_INV_DEFAULT = 2048
"""Largest factor that packs as one explicit dense inverse; factors up to 8x
this pack as blocked inverses of this width.  Chosen so the host inversion
stays sub-second; the crossover against the scan was not measured on the
H100."""


def _pack_ldu(T, lower, dtype, chunk, k_cap, dense_inv):
    """Pack the unit triangular factor ``(I + strict(T))`` for device solves:
    an explicit inverse for small factors, a blocked inverse for mid-size
    ones, the chunked level schedule otherwise (and for the empty factor of
    an m == 0 level)."""
    if dense_inv == "auto":
        dense_inv = DENSE_INV_DEFAULT
    dense_inv = int(dense_inv)
    if T.nrows and T.nrows <= dense_inv:
        return build_trsv_dense(T, lower=lower, dtype=dtype)
    if T.nrows and T.nrows <= 8 * dense_inv:
        # B (SpMV + dense matmul) steps instead of hundreds of scan steps
        return build_trsv_block_dense(T, lower=lower, W=dense_inv,
                                      dtype=dtype)
    return build_trsv_schedule(T, lower=lower, chunk=chunk, dtype=dtype,
                               k_cap=k_cap)


def pack_tail(last, dtype, tail_on_device: bool = False):
    """Device operands of the dense last level (None without a dense tail).

    ``tail_on_device`` refactorizes it with the jitted device QRCP
    (small_scale/qrcp_device.py) instead of reusing the host LAPACK
    factors."""
    if tail_on_device and last.dense_matrix is not None:
        from ..small_scale.qrcp_device import qrcp_device, qrcp_rank

        Qd, Rd, pivd = qrcp_device(jnp.asarray(last.dense_matrix, dtype))
        return DenseTail(Qd, Rd, pivd.astype(jnp.int32),
                         jnp.zeros(last.dense_matrix.shape[0], dtype=dtype),
                         qrcp_rank(Rd), "qrcp")
    ds = last.dense_solver
    if ds is None:
        return None
    if ds.kind == "qrcp":
        return DenseTail(jnp.asarray(ds.Q, dtype=dtype),
                         jnp.asarray(ds.R, dtype=dtype),
                         jnp.asarray(ds.jpvt, dtype=jnp.int32),
                         jnp.zeros(ds.n, dtype=dtype), ds.rank, "qrcp")
    if ds.kind == "syeig":
        order = np.argsort(-np.abs(ds.w))
        return DenseTail(jnp.asarray(ds.V[:, order], dtype=dtype),
                         jnp.zeros((ds.n, ds.n), dtype=dtype),
                         jnp.asarray(order, dtype=jnp.int32),
                         jnp.asarray(ds.w[order], dtype=dtype),
                         ds.rank, "syeig")
    lu = ds.lu  # lup
    return DenseTail(jnp.asarray(np.tril(lu, -1) + np.eye(ds.n), dtype=dtype),
                     jnp.asarray(np.triu(lu), dtype=dtype),
                     jnp.asarray(ds.piv_perm(), dtype=jnp.int32),
                     jnp.zeros(ds.n, dtype=dtype), ds.rank, "lup")


def _ldu_solve(lvl, y):
    """y <- U^{-1} D^{-1} L^{-1} y (ref prec_solve_ldu, prec_solve.hpp:205)."""
    y = trsv_apply(lvl.L, y)
    y = y / lvl.d
    return trsv_apply(lvl.U, y)


def prec_solve_device(levels, tail, b, r=None):
    """Unrolled multilevel solve (ref prec_solve.hpp:333) - pure jittable."""
    wbs = []
    rhs = b
    for lvl in levels:
        wb = lvl.s_p * rhs[lvl.p]
        m = lvl.m
        x1 = _ldu_solve(lvl, wb[:m])
        y2 = wb[m:] - ell_matvec(lvl.E, x1)
        wbs.append(wb)
        rhs = y2
    x_tail = tail_solve(tail, rhs, r=r)
    for lvl, wb in zip(reversed(levels), reversed(wbs)):
        m = lvl.m
        if lvl.n - m:
            x1 = _ldu_solve(lvl, wb[:m] - ell_matvec(lvl.F, x_tail))
        else:
            x1 = _ldu_solve(lvl, wb[:m])
        sol = jnp.concatenate([x1, x_tail])
        x_tail = lvl.t * sol[lvl.q_inv]
    return x_tail


def _ldu_solve_tran(lvl, top, y):
    y = trsv_apply(top.UT, y)        # U^H: unit strict lower
    y = y / jnp.conj(lvl.d)
    return trsv_apply(top.LT, y)     # L^H: unit strict upper


def prec_solve_tran_device(levels, tops, tail, b, r=None):
    """Adjoint multilevel solve (ref prec_solve_tran, prec_solve.hpp:542):
    mirrors the forward recursion with E/F swapped and factors conjugated."""
    wbs = []
    rhs = b
    for lvl, top in zip(levels, tops):
        wb = jnp.conj(lvl.t[top.q]) * rhs[top.q]
        m = lvl.m
        x1 = _ldu_solve_tran(lvl, top, wb[:m])
        y2 = wb[m:] - ell_matvec(top.FT, x1)
        wbs.append(wb)
        rhs = y2
    x_tail = tail_solve(tail, rhs, trans=True, r=r)
    for lvl, top, wb in zip(reversed(levels), reversed(tops), reversed(wbs)):
        m = lvl.m
        if lvl.n - m:
            x1 = _ldu_solve_tran(lvl, top,
                                 wb[:m] - ell_matvec(top.ET, x_tail))
        else:
            x1 = _ldu_solve_tran(lvl, top, wb[:m])
        sol = jnp.concatenate([x1, x_tail])
        out = jnp.zeros_like(sol)
        x_tail = out.at[lvl.p].set(jnp.conj(lvl.s_p) * sol,
                                   unique_indices=True)
    return x_tail


def _solve_pure(levels, tail, b):
    return prec_solve_device(levels, tail, b)


def _solve_tran_pure(levels, tops, tail, b):
    return prec_solve_tran_device(levels, tops, tail, b)


def _solve_rank_pure(levels, tail, b, r):
    return prec_solve_device(levels, tail, b, r=r)


def _solve_tran_rank_pure(levels, tops, tail, b, r):
    return prec_solve_tran_device(levels, tops, tail, b, r=r)


def _solve_mrhs_rank_pure(levels, tail, B, r):
    return prec_solve_mrhs_device(levels, tail, B, r=r)


def _solve_tran_mrhs_rank_pure(levels, tops, tail, B, r):
    return prec_solve_tran_mrhs_device(levels, tops, tail, B, r=r)


def nsp_filter_device(nsp, x):
    """Apply a null-space filter to a device solution (the reference applies
    nsp after every solve, builder.hpp:419-422).  Constant mode is pure jnp;
    a user callback receives (and must return) a jax array."""
    if nsp is None:
        return x
    if getattr(nsp, "user_func", None) is not None:
        return nsp.user_func(x)
    end = x.shape[0] if nsp.end < 0 else nsp.end
    seg = x[nsp.start:end]
    mean = seg.mean(axis=0, keepdims=(x.ndim > 1))
    if x.ndim == 1:
        return x.at[nsp.start:end].set(seg - mean)
    return x.at[nsp.start:end].set(seg - mean)


@dataclasses.dataclass
class DevicePrec:
    """Whole multilevel preconditioner on device, with jitted apply."""

    levels: List[DeviceLevel]
    tail: Optional[DenseTail]
    n: int

    # -- construction -------------------------------------------------------
    @classmethod
    def from_host(cls, precs, dtype=None, chunk="auto",
                  tail_on_device: bool = False, k_cap="auto",
                  dense_inv="auto") -> "DevicePrec":
        """``tail_on_device`` refactorizes the dense tail with the jitted
        device QRCP (small_scale/qrcp_device.py) instead of reusing the host
        LAPACK factors — the fully LAPACK-free mode.

        ``dtype=None`` preserves the host precision, including complex128
        (the reference treats z/c as first-class, libhifir.h).

        ``dense_inv``: levels with m <= this threshold apply L/U via an
        explicit dense inverse (:class:`ops.trsv.TrsvDense`) — one matmul
        instead of a deep latency-bound chunk scan (the frozen bench
        operator's 1.9k-row level carried 264 chunks); up to 8x the
        threshold a blocked inverse (:class:`ops.trsv.TrsvBlockDense`).
        "auto" = :data:`DENSE_INV_DEFAULT`; 0 disables both."""
        if dtype is None:
            dtype = next((np.asarray(p.d).dtype for p in precs if p.m),
                         np.float64)

        levels = []
        for prec in precs:
            m, n = prec.m, prec.n
            levels.append(DeviceLevel(
                p=jnp.asarray(prec.p, dtype=jnp.int32),
                q_inv=jnp.asarray(prec.q_inv, dtype=jnp.int32),
                s_p=jnp.asarray(prec.s[prec.p], dtype=dtype),
                t=jnp.asarray(prec.t, dtype=dtype),
                d=jnp.asarray(prec.d, dtype=dtype),
                L=_pack_ldu(prec.L_B, True, dtype, chunk, k_cap, dense_inv),
                U=_pack_ldu(prec.U_B, False, dtype, chunk, k_cap, dense_inv),
                E=sliced_ell_from_csr(prec.E, dtype=dtype),
                F=sliced_ell_from_csr(prec.F, dtype=dtype),
                m=m, n=n))
        tail = pack_tail(precs[-1], dtype, tail_on_device)
        obj = cls(levels=levels, tail=tail, n=precs[0].n)
        obj._tran = None
        # operands are jit ARGUMENTS (see module docstring)
        obj._solve_jit = jax.jit(_solve_pure)
        obj._solve_tran_jit = jax.jit(_solve_tran_pure)
        return obj

    def pack_transpose(self, host_precs, dtype=None, chunk="auto",
                       dense_inv="auto") -> None:
        """Build transpose operands (U^H/L^H schedules, E^H/F^H ELL);
        ``dtype=None`` preserves the host precision (incl. complex).
        ``dense_inv`` mirrors :meth:`from_host` (explicit inverse for
        small levels)."""

        tops = []
        for lvl, hp in zip(self.levels, host_precs):
            UT_host = hp.U_B.transpose()
            LT_host = hp.L_B.transpose()
            ET_host = hp.E.transpose()
            FT_host = hp.F.transpose()
            for M in (UT_host, LT_host, ET_host, FT_host):
                if np.iscomplexobj(M.data):
                    M.data = np.conj(M.data)
            tops.append(TranLevel(
                LT=_pack_ldu(LT_host, False, dtype, chunk, "auto",
                             dense_inv),
                UT=_pack_ldu(UT_host, True, dtype, chunk, "auto", dense_inv),
                ET=sliced_ell_from_csr(ET_host, dtype=dtype),
                FT=sliced_ell_from_csr(FT_host, dtype=dtype),
                q=jnp.asarray(hp.q, dtype=jnp.int32)))
        self._tran = tops

    # -- public API ----------------------------------------------------------
    def solve(self, b, trans: bool = False, r: int = 0):
        """x = M^{-1} b on device (jitted).

        ``r > 0`` overrides the dense tail's truncation rank at solve time
        (the reference's ``HIF::solve(b, x, trans, rank)`` per-solve rank,
        builder.hpp:410-424) — passed as a traced argument, so every rank
        shares one compilation.  An attached ``self.nsp``/``self.nsp_tran``
        filter is applied to the output (ref builder.hpp:419-422)."""
        b = jnp.asarray(b)
        if trans:
            if self._tran is None:
                raise RuntimeError("call pack_transpose() before trans solves")
            if r and r > 0:
                if not hasattr(self, "_solve_tran_rank_jit"):
                    self._solve_tran_rank_jit = jax.jit(_solve_tran_rank_pure)
                x = self._solve_tran_rank_jit(self.levels, self._tran,
                                              self.tail, b, jnp.int32(r))
            else:
                x = self._solve_tran_jit(self.levels, self._tran, self.tail,
                                         b)
            return nsp_filter_device(getattr(self, "nsp_tran", None), x)
        if r and r > 0:
            if not hasattr(self, "_solve_rank_jit"):
                self._solve_rank_jit = jax.jit(_solve_rank_pure)
            x = self._solve_rank_jit(self.levels, self.tail, b, jnp.int32(r))
        else:
            x = self._solve_jit(self.levels, self.tail, b)
        return nsp_filter_device(getattr(self, "nsp", None), x)

    def pack_prod(self, host_precs, dtype=None) -> None:
        """Build forward-product operands (L_B/U_B as ELL)."""
        self._prod = [
            ProdLevel(Lell=sliced_ell_from_csr(hp.L_B, dtype=dtype),
                      Uell=sliced_ell_from_csr(hp.U_B, dtype=dtype),
                      q=jnp.asarray(hp.q, jnp.int32))
            for hp in host_precs]
        self._prod_jit = jax.jit(prec_prod_device)

    def pack_prod_tran(self, host_precs, dtype=None, chunk="auto") -> None:
        """Build adjoint-product operands (L_B^H / U_B^H as ELL); requires
        (and builds, if absent) the transpose pack for E^H/F^H and the
        conjugate-transposed LDU schedules."""
        if self._tran is None:
            self.pack_transpose(host_precs, dtype=dtype, chunk=chunk)
        prods_t = []
        for hp in host_precs:
            LH = hp.L_B.transpose()
            UH = hp.U_B.transpose()
            for M in (LH, UH):
                if np.iscomplexobj(M.data):
                    M.data = np.conj(M.data)
            prods_t.append(ProdTranLevel(
                LellH=sliced_ell_from_csr(LH, dtype=dtype),
                UellH=sliced_ell_from_csr(UH, dtype=dtype)))
        self._prod_tran = prods_t
        self._prod_tran_jit = jax.jit(prec_prod_tran_device)

    def mmultiply(self, x, trans: bool = False):
        """y = M x (or M^H x) on device (jitted)."""
        if trans:
            if getattr(self, "_prod_tran", None) is None:
                raise RuntimeError("call pack_prod_tran() before trans "
                                   "mmultiply")
            return self._prod_tran_jit(self.levels, self._tran,
                                       self._prod_tran, self.tail,
                                       jnp.asarray(x))
        if getattr(self, "_prod", None) is None:
            raise RuntimeError("call pack_prod() before device mmultiply")
        return self._prod_jit(self.levels, self._prod, self.tail,
                              jnp.asarray(x))

    def solve_mrhs(self, B, trans: bool = False, r: int = 0):
        """X = M^{-1} B (or M^{-H} B) for B of shape (n, nrhs) — the batched
        fast path.  ``r > 0`` overrides the tail rank (traced; one compile
        serves all ranks)."""
        if trans:
            if self._tran is None:
                raise RuntimeError("call pack_transpose() before trans "
                                   "solves")
            if r and r > 0:
                if not hasattr(self, "_solve_tran_mrhs_rank_jit"):
                    self._solve_tran_mrhs_rank_jit = jax.jit(
                        _solve_tran_mrhs_rank_pure)
                return self._solve_tran_mrhs_rank_jit(
                    self.levels, self._tran, self.tail, jnp.asarray(B),
                    jnp.int32(r))
            if not hasattr(self, "_solve_tran_mrhs_jit"):
                self._solve_tran_mrhs_jit = jax.jit(
                    prec_solve_tran_mrhs_device)
            return self._solve_tran_mrhs_jit(self.levels, self._tran,
                                             self.tail, jnp.asarray(B))
        if r and r > 0:
            if not hasattr(self, "_solve_mrhs_rank_jit"):
                self._solve_mrhs_rank_jit = jax.jit(_solve_mrhs_rank_pure)
            X = self._solve_mrhs_rank_jit(self.levels, self.tail,
                                          jnp.asarray(B), jnp.int32(r))
        else:
            if not hasattr(self, "_solve_mrhs_jit"):
                self._solve_mrhs_jit = jax.jit(prec_solve_mrhs_device)
            X = self._solve_mrhs_jit(self.levels, self.tail, jnp.asarray(B))
        # unlike the host path (whose numpy NspFilter is single-vector and
        # errors), the device constant-mode filter is batch-capable
        return nsp_filter_device(getattr(self, "nsp", None), X)

    def operands(self):
        """The (levels, tail) pytree for composition into outer jitted
        solvers - always pass it as a jit argument."""
        return (self.levels, self.tail)


def _ldu_solve_mrhs(lvl, Y):
    from ..ops.trsv import trsv_apply_mrhs

    Y = trsv_apply_mrhs(lvl.L, Y)
    Y = Y / lvl.d[:, None]
    return trsv_apply_mrhs(lvl.U, Y)


def prec_solve_mrhs_device(levels, tail, B, r=None):
    """Multilevel solve with multiple RHS, B of shape (n, nrhs)
    (ref ``prec_solve_mrhs``, prec_solve.hpp:428 — the reference is limited to
    small compile-time Nrhs; here the batch amortizes gather and loop
    overheads across the right-hand sides)."""
    from ..ops.spmv import ell_matvec_mrhs

    wbs = []
    rhs = B
    for lvl in levels:
        wb = lvl.s_p[:, None] * rhs[lvl.p]
        m = lvl.m
        x1 = _ldu_solve_mrhs(lvl, wb[:m])
        y2 = wb[m:] - ell_matvec_mrhs(lvl.E, x1)
        wbs.append(wb)
        rhs = y2
    if tail is None:
        x_tail = rhs
    elif r is not None:
        x_tail = tail_solve_rank(tail, rhs, r)
    elif tail.rank == 0:
        x_tail = jnp.zeros_like(rhs)
    else:
        x_tail = _tail_solve_mrhs(tail, rhs)
    for lvl, wb in zip(reversed(levels), reversed(wbs)):
        m = lvl.m
        if lvl.n - m:
            x1 = _ldu_solve_mrhs(lvl, wb[:m] - ell_matvec_mrhs(lvl.F, x_tail))
        else:
            x1 = _ldu_solve_mrhs(lvl, wb[:m])
        sol = jnp.concatenate([x1, x_tail], axis=0)
        x_tail = lvl.t[:, None] * sol[lvl.q_inv]
    return x_tail


def _tail_solve_mrhs(tail, Y, trans: bool = False):
    r = tail.rank
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    if tail.kind == "syeig":
        Vr = tail.Q[:, :r]
        return mm(Vr, mm(Vr.T.conj(), Y) / tail.w[:r, None])
    if tail.kind == "lup":
        L, U, pperm = tail.Q, tail.R, tail.jpvt
        if not trans:
            Z = jax.scipy.linalg.solve_triangular(L, Y[pperm], lower=True,
                                                  unit_diagonal=True)
            return jax.scipy.linalg.solve_triangular(U, Z, lower=False)
        Z = jax.scipy.linalg.solve_triangular(U, Y, lower=False, trans=2)
        Z = jax.scipy.linalg.solve_triangular(L, Z, lower=True, trans=2,
                                              unit_diagonal=True)
        return jnp.zeros_like(Y).at[pperm].set(Z, unique_indices=True)
    if not trans:
        wv = mm(tail.Q[:, :r].T.conj(), Y)
        Z = jax.scipy.linalg.solve_triangular(tail.R[:r, :r], wv, lower=False)
        return jnp.zeros_like(Y).at[tail.jpvt[:r]].set(Z,
                                                       unique_indices=True)
    wv = Y[tail.jpvt[:r]]
    Z = jax.scipy.linalg.solve_triangular(tail.R[:r, :r], wv, lower=False,
                                          trans=2)
    return mm(tail.Q[:, :r], Z)


def _ldu_solve_tran_mrhs(lvl, top, Y):
    from ..ops.trsv import trsv_apply_mrhs

    Y = trsv_apply_mrhs(top.UT, Y)
    Y = Y / jnp.conj(lvl.d)[:, None]
    return trsv_apply_mrhs(top.LT, Y)


def prec_solve_tran_mrhs_device(levels, tops, tail, B, r=None):
    """Adjoint multilevel solve with multiple RHS (the mrhs counterpart of
    :func:`prec_solve_tran_device`; the reference composes
    ``prec_solve_mrhs`` with transposition in the bindings,
    prec_solve.hpp:428,542)."""
    from ..ops.spmv import ell_matvec_mrhs

    wbs = []
    rhs = B
    for lvl, top in zip(levels, tops):
        wb = jnp.conj(lvl.t[top.q])[:, None] * rhs[top.q]
        m = lvl.m
        x1 = _ldu_solve_tran_mrhs(lvl, top, wb[:m])
        y2 = wb[m:] - ell_matvec_mrhs(top.FT, x1)
        wbs.append(wb)
        rhs = y2
    if tail is None:
        x_tail = rhs
    elif r is not None:
        x_tail = tail_solve_rank(tail, rhs, r, trans=True)
    elif tail.rank == 0:
        x_tail = jnp.zeros_like(rhs)
    else:
        x_tail = _tail_solve_mrhs(tail, rhs, trans=True)
    for lvl, top, wb in zip(reversed(levels), reversed(tops), reversed(wbs)):
        m = lvl.m
        if lvl.n - m:
            x1 = _ldu_solve_tran_mrhs(lvl, top,
                                      wb[:m] - ell_matvec_mrhs(top.ET,
                                                               x_tail))
        else:
            x1 = _ldu_solve_tran_mrhs(lvl, top, wb[:m])
        sol = jnp.concatenate([x1, x_tail], axis=0)
        out = jnp.zeros_like(sol)
        x_tail = out.at[lvl.p].set(jnp.conj(lvl.s_p)[:, None] * sol,
                                   unique_indices=True)
    return x_tail


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ProdLevel:
    """Forward-product operands of one level (L_B/U_B as ELL plus q)."""

    Lell: SlicedELL
    Uell: SlicedELL
    q: jax.Array

    def tree_flatten(self):
        return ((self.Lell, self.Uell, self.q), ())

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ProdTranLevel:
    """Adjoint-product operands of one level: L_B^H / U_B^H as ELL (the
    E^H/F^H blocks and permutation come from the shared :class:`TranLevel`)."""

    LellH: SlicedELL
    UellH: SlicedELL

    def tree_flatten(self):
        return ((self.LellH, self.UellH), ())

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def prec_prod_tran_device(levels, tops, prods_t, tail, x):
    """Adjoint product y = M^H x on device (ref ``prec_prod_tran``,
    alg/prec_prod.hpp:54); mirrors
    :func:`hifir_tpu.alg.prec_solve_np.prec_prod_tran_np`."""
    ws = []
    cur = x
    for lvl in levels:
        w = cur[lvl.p] / jnp.conj(lvl.s_p)
        ws.append(w)
        cur = w[lvl.m:]
    y_tail = tail_multiply(tail, cur, trans=True) if tail is not None else cur
    for lvl, top, pt, w in zip(reversed(levels), reversed(tops),
                               reversed(prods_t), reversed(ws)):
        m = lvl.m
        w1, w2 = w[:m], w[m:]

        def bhat_h(z):
            # (I + U^H) conj(D) (I + L^H) z
            z = z + ell_matvec(pt.LellH, z)
            z = jnp.conj(lvl.d) * z
            return z + ell_matvec(pt.UellH, z)

        if lvl.n - m:
            EHw2 = ell_matvec(top.ET, w2)
            u = w1 + _ldu_solve_tran(lvl, top, EHw2)
            z2 = ell_matvec(top.FT, u) + y_tail
            z1 = bhat_h(w1) + EHw2
            z = jnp.concatenate([z1, z2])
        else:
            z = bhat_h(w1)
        out = jnp.zeros_like(z)
        y_tail = out.at[top.q].set(z / jnp.conj(lvl.t[top.q]),
                                   unique_indices=True)
    return y_tail


def prec_prod_device(levels, prods, tail, x):
    """Forward product y = M x on device (ref ``alg/prec_prod.hpp:54``);
    mirrors :func:`hifir_tpu.alg.prec_solve_np.prec_prod_np`."""
    vs = []
    cur = x
    for lvl, pr in zip(levels, prods):
        v = cur[pr.q] / lvl.t[pr.q]
        vs.append(v)
        cur = v[lvl.m:]
    # bottom-up assembly
    if tail is not None:
        y_tail = tail_multiply(tail, cur)
    else:
        y_tail = cur
    for lvl, pr, v in zip(reversed(levels), reversed(prods), reversed(vs)):
        m = lvl.m
        v1, v2 = v[:m], v[m:]

        def bhat(z):
            z = z + ell_matvec(pr.Uell, z)
            z = lvl.d * z
            return z + ell_matvec(pr.Lell, z)

        if lvl.n - m:
            Fv2 = ell_matvec(lvl.F, v2)
            w = v1 + _ldu_solve(lvl, Fv2)
            u2 = ell_matvec(lvl.E, w) + y_tail
            u1 = bhat(v1) + Fv2
            u = jnp.concatenate([u1, u2])
        else:
            u = bhat(v1)
        out = jnp.zeros_like(u)
        y_tail = out.at[lvl.p].set(u / lvl.s_p, unique_indices=True)
    return y_tail
