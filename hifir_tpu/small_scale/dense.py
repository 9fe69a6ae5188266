"""Dense last-level solvers: LUP, rank-revealing QRCP, SYEIG.

Re-designs ``/root/reference/src/hif/small_scale/{LUP,QRCP,SYEIG}.hpp`` for
this implementation.  Factorization happens once per ``HIF.factorize`` on host (scipy
LAPACK: ``getrf``/``geqp3``/``syev`` — the same routines the reference binds in
``small_scale/lapack.hpp``); the resulting factors are plain arrays that the
jitted device solve path consumes (triangular solves + dense products).

The rank-revealing behavior follows ``QRCP.hpp:109-180``: default condition
threshold ``eps^{-2/3}`` with rank truncation making the preconditioner an
epsilon-accurate pseudoinverse for singular systems.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla

__all__ = ["QRCP", "LUP", "SYEIG", "make_dense_solver"]

_EPS = float(np.finfo(np.float64).eps)


class LUP:
    """Dense LU with partial pivoting (ref ``LUP.hpp:108-143``)."""

    kind = "lup"

    def __init__(self):
        self.lu = None
        self.piv = None
        self.rank = 0
        self.n = 0

    def factorize(self, M: np.ndarray, opts=None) -> None:
        self.n = M.shape[0]
        self.lu, self.piv = sla.lu_factor(M, check_finite=False)
        d = np.abs(np.diag(self.lu))
        if self.n and (d.min() <= _EPS * max(d.max(), 1.0)):
            from ..utils.log import hif_warning

            hif_warning("dense LU appears singular; consider QRCP")
        self.rank = self.n

    def solve(self, y: np.ndarray, rank: int = 0, trans: bool = False
              ) -> np.ndarray:
        return sla.lu_solve((self.lu, self.piv), y, trans=1 if trans else 0,
                            check_finite=False)

    def multiply(self, x: np.ndarray, trans: bool = False) -> np.ndarray:
        L = np.tril(self.lu, -1) + np.eye(self.n, dtype=self.lu.dtype)
        U = np.triu(self.lu)
        P = np.eye(self.n)[self.piv_perm()]
        M = P.T @ L @ U
        return (M.conj().T if trans else M) @ x

    def piv_perm(self) -> np.ndarray:
        perm = np.arange(self.n)
        for i, pi in enumerate(self.piv):
            perm[i], perm[pi] = perm[pi], perm[i]
        return perm


class QRCP:
    """Rank-revealing QR with column pivoting (ref ``QRCP.hpp:50-559``).

    Rank determination: fast diagonal test at ``sqrt(eps)|R_00|`` followed by
    condition-bounded truncation against ``rrqr_cond`` (default
    ``eps^{-2/3}``) — an explicit variant of the reference's ``laic1``
    incremental condition estimation.
    """

    kind = "qrcp"

    def __init__(self):
        self.Q = None
        self.R = None
        self.jpvt = None
        self.rank = 0
        self.n = 0

    def factorize(self, M: np.ndarray, opts=None) -> None:
        self.n = M.shape[0]
        if self.n == 0:
            self.rank = 0
            return
        Q, R, piv = sla.qr(M, pivoting=True, mode="economic",
                           check_finite=False)
        self.Q, self.R, self.jpvt = Q, R, piv
        rrqr_cond = getattr(opts, "rrqr_cond", 0.0) if opts is not None else 0.0
        if rrqr_cond <= 0.0:
            rrqr_cond = _EPS ** (-2.0 / 3.0)
        d = np.abs(np.diag(R))
        if d.size == 0 or d[0] == 0.0:
            self.rank = 0
            return
        # |R_kk| decreases for QRCP; truncate where cond estimate exceeds bound
        good = d > d[0] / rrqr_cond
        self.rank = int(np.flatnonzero(good)[-1] + 1) if good.any() else 0

    def _r(self, rank: int) -> int:
        if rank is None or rank <= 0 or rank > self.rank:
            return self.rank
        return int(rank)

    def solve(self, y: np.ndarray, rank: int = 0, trans: bool = False
              ) -> np.ndarray:
        r = self._r(rank)
        shape = (self.n,) if y.ndim == 1 else (self.n, y.shape[1])
        x = np.zeros(shape, dtype=np.result_type(self.Q, y))
        if r == 0:
            return x
        if not trans:
            w = self.Q[:, :r].conj().T @ y
            z = sla.solve_triangular(self.R[:r, :r], w, check_finite=False)
            x[self.jpvt[:r]] = z
        else:
            w = y[self.jpvt[:r]]
            z = sla.solve_triangular(self.R[:r, :r], w, trans="C",
                                     check_finite=False)
            x = self.Q[:, :r] @ z
        return x

    def multiply(self, x: np.ndarray, trans: bool = False) -> np.ndarray:
        if not trans:
            return self.Q @ (self.R @ x[self.jpvt])
        y = np.zeros_like(x)
        y[self.jpvt] = self.R.conj().T @ (self.Q.conj().T @ x)
        return y


class SYEIG:
    """Symmetric/Hermitian eigen-solver (ref ``SYEIG.hpp:50-333``)."""

    kind = "syeig"

    def __init__(self):
        self.V = None
        self.w = None
        self.rank = 0
        self.n = 0

    def factorize(self, M: np.ndarray, opts=None) -> None:
        self.n = M.shape[0]
        if self.n == 0:
            self.rank = 0
            return
        w, V = sla.eigh(0.5 * (M + M.conj().T), check_finite=False)
        self.w, self.V = w, V
        amax = np.abs(w).max() if w.size else 0.0
        thres = self.n * _EPS * amax
        self.rank = int((np.abs(w) > thres).sum())

    def solve(self, y: np.ndarray, rank: int = 0, trans: bool = False
              ) -> np.ndarray:
        r = self.rank if (rank is None or rank <= 0 or rank > self.rank) \
            else int(rank)
        if r == 0:
            return np.zeros_like(y)
        order = np.argsort(-np.abs(self.w))[:r]
        Vr = self.V[:, order]
        wr = self.w[order] if y.ndim == 1 else self.w[order][:, None]
        return Vr @ ((Vr.conj().T @ y) / wr)

    def multiply(self, x: np.ndarray, trans: bool = False) -> np.ndarray:
        return self.V @ (self.w * (self.V.conj().T @ x))


class DeviceQRCP(QRCP):
    """QRCP whose factorization runs on the device (``qrcp_device``) during
    ``HIF.factorize`` — the device offload of the dense last level (SURVEY
    §7.2-L4; opt-in via ``Options.device_tail``).  Q/R/piv are pulled back
    to host so the solve/multiply paths are identical to :class:`QRCP`
    (complex input falls back to the host path: the device sweep is real)."""

    kind = "qrcp"

    def factorize(self, M: np.ndarray, opts=None) -> None:
        self.n = M.shape[0]
        if self.n == 0:
            self.rank = 0
            return
        if np.iscomplexobj(M):
            return QRCP.factorize(self, M, opts)
        import jax.numpy as jnp

        from .qrcp_device import qrcp_device, qrcp_rank

        Q, R, piv = qrcp_device(jnp.asarray(M))
        self.Q = np.asarray(Q, dtype=M.dtype)
        self.R = np.asarray(R, dtype=M.dtype)
        self.jpvt = np.asarray(piv, dtype=np.int64)
        rrqr_cond = getattr(opts, "rrqr_cond", 0.0) if opts is not None \
            else 0.0
        self.rank = qrcp_rank(R, rrqr_cond)


def make_dense_solver(symm: bool, spd: int = 0, device: bool = False):
    """Solver selection (ref ``small_scale/solver.hpp:42`` trait +
    ``Prec.hpp:104-127``): QRCP by default, SYEIG for symmetric systems;
    ``device`` routes the asymmetric QRCP factorization to the device."""
    if symm:
        return SYEIG()
    return DeviceQRCP() if device else QRCP()
