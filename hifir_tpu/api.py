"""User-facing HIF preconditioner API.

Behavioral equivalent of the reference ``hif::HIF`` class
(``/root/reference/src/hif/builder.hpp:109-601``): ``factorize`` builds the
multilevel preconditioner; ``solve``/``solve_mrhs`` apply M^{-1};
``hifir`` wraps the solve in iterative refinement; ``mmultiply`` applies the
forward operator M; plus statistics and size accessors.

Architecture: factorization is host-orchestrated (serial Crout semantics)
with native C++ kernels when built; the preconditioner is exportable as a
device pytree (:mod:`hifir_tpu.alg.prec`) whose application is a single jitted
function driving FGMRES/GMRES on the accelerator (one H100, or four over
NVLink).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .alg.factor import LevelPrec, level_factorize
from .alg.iter_refine import iter_refine
from .alg.prec_solve_np import prec_prod_np, prec_prod_tran_np, prec_solve_np
from .ds.csr import CSR
from .options import Options, get_default_options
from .small_scale.dense import SYEIG, make_dense_solver
from .utils.log import hif_error, hif_info, hif_warning
from .utils.timer import Timer


def _classify_symmetry(A: CSR) -> int:
    """0 = neither; 1 = exactly A == A^T (values); 2 = exactly A == A^H.

    Real input uses the native O(nnz) test (``ht_value_symm``; the scipy
    fallback is fail-closed on structure to match it); complex input
    compares the sorted CSR of A against A^T and conj(A^T)."""
    if A.data.dtype in (np.float64, np.float32):
        from .pre import _native as _nat

        vals64 = (A.data if A.data.dtype == np.float64
                  else A.data.astype(np.float64))
        vs = _nat.value_symm(A.nrows, A.indptr, A.indices, vals64)
        if vs is None:
            As = A.to_scipy().tocsr()
            As.sort_indices()
            AT = As.T.tocsr()
            AT.sort_indices()
            vs = (np.array_equal(As.indptr, AT.indptr)
                  and np.array_equal(As.indices, AT.indices)
                  and np.array_equal(As.data, AT.data))
        return 1 if vs else 0
    if np.iscomplexobj(A.data):
        As = A.to_scipy().tocsr()
        As.sort_indices()
        AT = As.T.tocsr()
        AT.sort_indices()
        if not (np.array_equal(As.indptr, AT.indptr)
                and np.array_equal(As.indices, AT.indices)):
            return 0
        if np.array_equal(As.data, AT.data):
            return 1
        if np.array_equal(As.data, np.conj(AT.data)):
            return 2
    return 0

__all__ = ["HIF"]


class HIF:
    """Hybrid incomplete factorization with iterative refinement."""

    def __init__(self):
        self.precs: List[LevelPrec] = []
        self.stats_ = np.zeros(6, dtype=np.int64)
        self.nsp = None        # null-space filter (NspFilter)
        self.nsp_tran = None   # left null-space filter
        self._nrows = 0
        self._ncols = 0
        self._device_prec = None

    # -- state accessors (ref builder.hpp:141-234) --------------------------
    def empty(self) -> bool:
        return not self.precs

    def levels(self) -> int:
        """Level count; the dense tail counts as one level
        (ref builder.hpp:141-147)."""
        if not self.precs:
            return 0
        return len(self.precs) + (self.precs[-1].dense_solver is not None)

    def nnz(self) -> int:
        return sum(p.nnz() for p in self.precs)

    def nnz_ef(self) -> int:
        return sum(p.nnz_ef() for p in self.precs)

    def nnz_ldu(self) -> int:
        return sum(p.nnz_ldu() for p in self.precs)

    def rank(self) -> int:
        """Numerical rank: accepted block sizes + dense tail rank."""
        r = sum(p.m for p in self.precs)
        last = self.precs[-1] if self.precs else None
        if last is not None and last.dense_solver is not None:
            r += last.dense_solver.rank
        return r

    def schur_rank(self) -> int:
        last = self.precs[-1] if self.precs else None
        if last is None or last.dense_solver is None:
            return 0
        return last.dense_solver.rank

    def schur_size(self) -> int:
        last = self.precs[-1] if self.precs else None
        if last is None:
            return 0
        return last.n - last.m

    def stats(self, entry: int) -> int:
        """Deferral/dropping counters (ref builder.hpp:204-234)."""
        return int(self.stats_[entry])

    def clear(self) -> None:
        self.precs = []
        self._device_prec = None
        self.stats_[:] = 0

    # -- factorization ------------------------------------------------------
    def factorize(self, A: Union[CSR, "object"], params: Optional[Options] = None,
                  m0: int = 0) -> "HIF":
        """Build the multilevel preconditioner (ref builder.hpp:264-399)."""
        opts = params if params is not None else get_default_options()
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        if opts.check:
            A.check_validity()
        if A.nrows != A.ncols:
            hif_error("only square systems are supported")
        if not 0 <= m0 <= A.nrows:
            hif_error("m0 (symmetric leading block size) must be in [0, n]; "
                      "got %d for n=%d" % (m0, A.nrows))
        self.clear()
        self._nrows, self._ncols = A.nrows, A.ncols
        # native single-precision factorization (the reference's HIF<float>
        # / HIF<complex<float>> instantiations, builder.hpp:109,589): the
        # whole level pipeline runs on f32/c64 operands -- the Crout/Schur
        # kernels are instantiated natively for s/c -- not a post-factorize
        # storage cast.  Matching/ordering decisions stay f64 inside
        # preprocessing (they consume magnitudes only).
        if opts.dtype == "float32":
            want = (np.complex64 if np.iscomplexobj(A.data) else np.float32)
            if A.data.dtype != want:
                A = CSR(A.nrows, A.ncols, A.indptr, A.indices,
                        A.data.astype(want))
        elif opts.dtype == "float64" and A.data.dtype in (np.float32,
                                                          np.complex64):
            # explicit f64 request upcasts single-precision input
            want = (np.complex128 if np.iscomplexobj(A.data)
                    else np.float64)
            A = CSR(A.nrows, A.ncols, A.indptr, A.indices,
                    A.data.astype(want))

        # auto-LDL^T / LDL^H dispatch: a provably symmetric (A == A^T) or
        # Hermitian (A == A^H) input runs the one-sided mirror kernel
        # end-to-end (half the Crout scan work, one stored triangular side
        # per level until the splits).  The reference leaves this to the
        # user (is_symm, ref Options.h:152) — and its own is_symm on COMPLEX
        # input produces a broken preconditioner (measured; BASELINE.md
        # round-5), so the complex modes here are a deliberate correctness
        # improvement.  Detection is one O(nnz) exact test.  m0 > 0 keeps
        # the reference's declared-leading-block semantics instead.
        if (opts.symm_detect and not opts.is_symm and m0 == 0
                and not opts.no_pre):
            kind = _classify_symmetry(A)
            if kind:
                opts = dataclasses.replace(opts, is_symm=1, symm_kind=kind)
                hif_info(opts, "detected exactly %s input; using the "
                               "LDL^%s path (symm_detect=0 disables)",
                         "Hermitian" if kind == 2 else "symmetric",
                         "H" if kind == 2 else "T")
        elif (opts.is_symm and not opts.symm_kind
                and np.iscomplexobj(A.data)):
            # user-declared is_symm on complex input: classify so the kernel
            # knows whether the mirror conjugates (A == A^H) or not
            # (A == A^T); neither -> general path with a warning (the
            # reference would silently factorize wrong here)
            kind = _classify_symmetry(A)
            if kind:
                opts = dataclasses.replace(opts, symm_kind=kind)
            else:
                hif_warning("is_symm set but the complex input is neither "
                            "exactly symmetric nor Hermitian; using the "
                            "general LDU path")
                opts = dataclasses.replace(opts, is_symm=0)
        t = Timer().start()
        n_first = A.nrows
        N = opts.N if opts.N >= 0 else n_first
        row_sizes = np.empty(0, dtype=np.int64)
        col_sizes = np.empty(0, dtype=np.int64)
        S: Optional[CSR] = A
        level = 1
        input_nnz = A.nnz
        while S is not None:
            m_in = S.nrows if (level > 1 or not m0) else m0
            # ref builder.hpp:534-535: a user-declared leading block (m0 > 0)
            # at level 1 selects the symmetric-block mirror factorization
            prec, S, row_sizes, col_sizes = level_factorize(
                S, m_in if m_in else S.nrows, N, level, opts,
                row_sizes, col_sizes, self.stats_,
                sym_block=(level == 1 and m0 > 0))
            self.precs.append(prec)
            level += 1
        # uniform single-precision level payload: the factors already come
        # out f32/c64 from the native s/c kernels; this also narrows the
        # f64 preprocessing scalings s/t (the reference's HIF<float> stores
        # everything in float)
        if opts.dtype == "float32":
            want = (np.complex64 if np.iscomplexobj(A.data) else np.float32)
            self.precs = [p.astype(want) for p in self.precs]
        # factor the dense tail if present (ref factor.hpp:1284-1296)
        last = self.precs[-1]
        if last.dense_matrix is not None:
            # SYEIG assumes a Hermitian tail: correct for real symmetric and
            # complex-Hermitian (LDL^H) levels; a complex-SYMMETRIC tail
            # (A == A^T, symm_kind 1) is not Hermitian, so it takes the
            # rank-revealing QRCP instead
            symm = bool(opts.is_symm) and not (
                np.iscomplexobj(last.dense_matrix) and opts.symm_kind == 1)
            solver = make_dense_solver(symm, opts.spd,
                                       device=bool(opts.device_tail))
            solver.factorize(last.dense_matrix, opts)
            last.dense_solver = solver
        t.finish()
        hif_info(opts, "input nnz(A)=%d, nnz(precs)=%d, ratio=%g, levels=%d, "
                       "time=%gs", input_nnz, self.nnz(),
                 self.nnz() / max(input_nnz, 1), self.levels(), t.time())
        return self

    def factorize_raw(self, n: int, indptr, indices, vals,
                      params: Optional[Options] = None, m0: int = 0) -> "HIF":
        """POD-pointer style factorize (ref builder.hpp:386-399): accepts
        {0,1}-based CSR arrays of any integer/float width."""
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        vals = np.asarray(vals)
        if n and indptr[0] == 1:  # 1-based input normalization
            indptr = indptr - 1
            indices = indices - 1
        elif n and indptr[0] != 0:
            hif_error("only {0,1}-based compressed matrices are supported")
        A = CSR(n, n, indptr, indices, vals)
        return self.factorize(A, params, m0)

    # -- applications -------------------------------------------------------
    def solve(self, b: np.ndarray, trans: bool = False, r: int = 0
              ) -> np.ndarray:
        """x = M^{-1} b (ref builder.hpp:410-424)."""
        if self.empty():
            hif_error("the preconditioner is empty")
        x = prec_solve_np(self.precs, np.asarray(b), r, trans=trans)
        if not trans and self.nsp is not None:
            x = self.nsp.filter(x)
        elif trans and self.nsp_tran is not None:
            x = self.nsp_tran.filter(x)
        return x

    def solve_mrhs(self, B: np.ndarray, r: int = 0, trans: bool = False
                   ) -> np.ndarray:
        """X = M^{-1} B, all columns in one batched multilevel sweep
        (ref ``prec_solve_mrhs``, prec_solve.hpp:428 — the reference fixes
        Nrhs at compile time; here the native mrhs trsv kernels take a
        runtime column count)."""
        if self.empty():
            hif_error("the preconditioner is empty")
        if self.nsp is not None:
            hif_error("multiple RHS does not support null-space filters")
        B = np.asarray(B)
        if B.ndim != 2:
            hif_error("solve_mrhs expects an (n, k) right-hand-side block")
        return prec_solve_np(self.precs, B, r, trans=trans)

    def hifir(self, A, b: np.ndarray, N: int,
              betas: Optional[Tuple[float, float]] = None,
              trans: bool = False, r: int = 0, boost: bool = False):
        """Apply M^{-1} with N-step iterative refinement
        (ref builder.hpp:459-505).  With ``betas`` returns ``(x, iters,
        flag)``; otherwise just x.  ``boost`` accumulates in long double
        (the reference's HIF_HIGH_PRECISION_SOLVE)."""
        x, iters, flag = iter_refine(self, A, b, N, betas, trans, r,
                                     boost=boost)
        if betas is None:
            return x
        return x, iters, flag

    def mmultiply(self, x: np.ndarray, trans: bool = False, r: int = 0
                  ) -> np.ndarray:
        """y = M x (ref builder.hpp:540-556 -> prec_prod)."""
        if self.empty():
            hif_error("the preconditioner is empty")
        if trans:
            return prec_prod_tran_np(self.precs, np.asarray(x), r)
        return prec_prod_np(self.precs, np.asarray(x), r)

    # -- device export ------------------------------------------------------
    def to_device(self, dtype=None):
        """Pack the multilevel preconditioner into a jitted device pytree
        (see :mod:`hifir_tpu.alg.prec`).  Packs are cached per requested
        dtype, so ``to_device(); to_device(dtype=f32)`` returns distinct
        packs rather than silently reusing the first."""
        from .alg.prec import DevicePrec

        key = np.dtype(dtype).name if dtype is not None else None
        if self._device_prec is None:
            self._device_prec = {}
        if key not in self._device_prec:
            self._device_prec[key] = DevicePrec.from_host(self.precs,
                                                          dtype=dtype)
        return self._device_prec[key]
