"""Device (jitted) compute-path tests on the CPU backend.

Validates the device code paths — level-scheduled trsv, sliced-ELL SpMV, the
jitted multilevel solve (single and multiple RHS), and the device Krylov
drivers — against the host anchors.  Runs on the fake CPU backend configured
in conftest (8 virtual devices, x64).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hifir_tpu.api import HIF
from hifir_tpu.models import (convdiff2d, poisson2d, random_sparse,
                              random_strict_triangular, saddle_point_stokes)
from hifir_tpu.options import Options
from hifir_tpu.ops import (build_trsv_schedule, ell_from_csr, ell_matvec,
                           trsv_apply, trsv_apply_mrhs)
from hifir_tpu.ops.spmv import ell_matvec_mrhs, sliced_ell_from_csr


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("chunk", [8, 64])
def test_trsv_schedule_vs_host(lower, chunk):
    n = 150
    T = random_strict_triangular(n, lower=lower, seed=3)
    b = np.random.default_rng(0).standard_normal(n)
    s = build_trsv_schedule(T, lower=lower, chunk=chunk)
    x = np.asarray(trsv_apply(s, jnp.asarray(b)))
    xr = T.solve_as_strict_lower(b) if lower else T.solve_as_strict_upper(b)
    np.testing.assert_allclose(x, xr, rtol=1e-10, atol=1e-10)


def test_trsv_mrhs():
    n = 80
    T = random_strict_triangular(n, lower=True, seed=5)
    B = np.random.default_rng(1).standard_normal((n, 4))
    s = build_trsv_schedule(T, lower=True, chunk=16)
    X = np.asarray(trsv_apply_mrhs(s, jnp.asarray(B)))
    for k in range(4):
        np.testing.assert_allclose(X[:, k], T.solve_as_strict_lower(B[:, k]),
                                   rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("k_cap", [4, 8, "auto"])
def test_trsv_k_cap_packing(lower, k_cap):
    """Wide rows split into partial-sum slots: exact, and memory bounded.

    Matrix: random strict triangle plus a few dense rows (degree >> k_cap) —
    the case where the unsplit (nslots, K) layout blows up by Kmax.  The
    "auto" case is sized so that the memory saving outweighs the extra scan
    steps at the measured step cost (``ops.trsv._STEP_ELEMS``).
    """
    n = 2000 if k_cap == "auto" else 200
    rng = np.random.default_rng(7)
    T = random_strict_triangular(n, lower=lower, seed=11)
    # densify a few rows: row i gets all columns < i (lower) or > i (upper)
    import scipy.sparse as sp

    M = sp.csr_matrix((T.data, T.indices, T.indptr), shape=(n, n)).tolil()
    dense_rows = (0.6, 0.75, 0.995) if lower else (0.0, 0.2, 0.4)
    for i in (int(f * n) for f in dense_rows):
        js = np.arange(i) if lower else np.arange(i + 1, n)
        M[i, js] = rng.standard_normal(js.size) * 0.1
    M = M.tocsr()
    from hifir_tpu.ds import CSR

    T2 = CSR(n, n, M.indptr.astype(np.int64), M.indices.astype(np.int32),
             M.data)
    b = rng.standard_normal(n)
    s0 = build_trsv_schedule(T2, lower=lower, chunk=16)
    s1 = build_trsv_schedule(T2, lower=lower, chunk=16, k_cap=k_cap)
    x0 = np.asarray(trsv_apply(s0, jnp.asarray(b)))
    x1 = np.asarray(trsv_apply(s1, jnp.asarray(b)))
    xr = (T2.solve_as_strict_lower(b) if lower
          else T2.solve_as_strict_upper(b))
    np.testing.assert_allclose(x0, xr, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(x1, xr, rtol=1e-9, atol=1e-9)
    # packed layout strictly smaller than the K=max-degree layout
    assert s1.vals.size < s0.vals.size
    if k_cap != "auto":
        assert s1.cols.shape[2] <= k_cap
    # mrhs path agrees too
    B = rng.standard_normal((n, 3))
    X1 = np.asarray(trsv_apply_mrhs(s1, jnp.asarray(B)))
    for k in range(3):
        np.testing.assert_allclose(
            X1[:, k], (T2.solve_as_strict_lower(B[:, k]) if lower
                       else T2.solve_as_strict_upper(B[:, k])),
            rtol=1e-9, atol=1e-9)


def test_trsv_k_cap_auto_threshold():
    """auto leaves narrow factors unsplit (saving < 2x isn't worth steps)."""
    T = random_strict_triangular(150, lower=True, seed=3)
    s0 = build_trsv_schedule(T, lower=True, chunk=16)
    s1 = build_trsv_schedule(T, lower=True, chunk=16, k_cap="auto")
    assert s1.cols.shape == s0.cols.shape
    assert np.array_equal(np.asarray(s1.cols), np.asarray(s0.cols))


@pytest.mark.parametrize("sliced", [False, True])
def test_ell_spmv(sliced):
    A = random_sparse(120, 9, seed=2, ncols=77)
    x = np.random.default_rng(0).standard_normal(77)
    e = sliced_ell_from_csr(A) if sliced else ell_from_csr(A)
    y = np.asarray(ell_matvec(e, jnp.asarray(x)))
    np.testing.assert_allclose(y, A.matvec(x), rtol=1e-12)
    X = np.random.default_rng(1).standard_normal((77, 3))
    Y = np.asarray(ell_matvec_mrhs(e, jnp.asarray(X)))
    for k in range(3):
        np.testing.assert_allclose(Y[:, k], A.matvec(X[:, k]), rtol=1e-12)


def _factorized(A):
    opts = Options(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5,
                   kappa_d=5, verbose=0, dense_thres=30)
    return HIF().factorize(A, opts)


def test_device_prec_solve_matches_host():
    A = saddle_point_stokes(8)
    M = _factorized(A)
    dp = M.to_device()
    b = np.random.default_rng(0).standard_normal(A.nrows)
    xh = M.solve(b)
    xd = np.asarray(dp.solve(b))
    np.testing.assert_allclose(xd, xh, rtol=1e-12, atol=1e-12 * np.abs(xh).max())


def test_device_prec_solve_mrhs_matches_host():
    A = convdiff2d(10)
    M = _factorized(A)
    dp = M.to_device()
    B = np.random.default_rng(1).standard_normal((A.nrows, 5))
    Xd = np.asarray(dp.solve_mrhs(jnp.asarray(B)))
    for k in range(5):
        np.testing.assert_allclose(Xd[:, k], M.solve(B[:, k]), rtol=1e-10,
                                   atol=1e-10)


def test_device_prec_solve_tran_matches_host():
    A = convdiff2d(9)
    M = _factorized(A)
    dp = M.to_device()
    dp.pack_transpose(M.precs)
    b = np.random.default_rng(2).standard_normal(A.nrows)
    xh = M.solve(b, trans=True)
    xd = np.asarray(dp.solve(b, trans=True))
    np.testing.assert_allclose(xd, xh, rtol=1e-10, atol=1e-10 * np.abs(xh).max())


def test_device_gmres_converges():
    from hifir_tpu.solvers import gmres_hif_device

    A = convdiff2d(12)
    M = _factorized(A)
    dp = M.to_device()
    Aell = sliced_ell_from_csr(A)
    b = np.ones(A.nrows)
    x, flag, iters = gmres_hif_device(Aell, dp, b, restart=20, rtol=1e-8)
    assert flag == 0
    res = np.linalg.norm(b - A.matvec(np.asarray(x))) / np.linalg.norm(b)
    assert res <= 1e-8


def test_device_fgmres_hifir_converges():
    from hifir_tpu.solvers import fgmres_hifir_device

    A = convdiff2d(12)
    M = _factorized(A)
    dp = M.to_device()
    Aell = sliced_ell_from_csr(A)
    b = np.ones(A.nrows)
    x, flag, iters = fgmres_hifir_device(Aell, dp, b, restart=20, rtol=1e-8)
    assert flag == 0
    res = np.linalg.norm(b - A.matvec(np.asarray(x))) / np.linalg.norm(b)
    assert res <= 1e-8


def test_device_ir_mixed_precision():
    """f32 preconditioner + f64 residual refinement reaches f64-level accuracy
    (the reference's lhfsdApply mixed mode, libhifir.h:1231-1282)."""
    from hifir_tpu.solvers import ir_apply_device

    A = convdiff2d(10)
    n = A.nrows
    M = _factorized(A)
    dp32 = M.to_device(dtype=jnp.float32)
    Aell = sliced_ell_from_csr(A)
    b = np.random.default_rng(3).standard_normal(n)
    xd = np.linalg.solve(A.todense(), b)

    levels, tail = dp32.operands()

    # mixed IR on host side: f64 residual, f32 M-solve
    x = np.zeros(n)
    for _ in range(30):
        r = b - A.matvec(x)
        dx = np.asarray(jax.jit(
            lambda lv, tl, v: __import__("hifir_tpu.alg.prec", fromlist=["x"]
                                         ).prec_solve_device(lv, tl, v))(
            levels, tail, jnp.asarray(r, jnp.float32)))
        x = x + dx.astype(np.float64)
    res = np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)
    assert res <= 1e-12

def test_device_tail_in_factorize():
    """Options.device_tail routes the dense-tail QRCP factorization to the
    device DURING factorize (SURVEY §7.2-L4); solve behavior must match
    the host-QRCP-tail factorization."""
    from hifir_tpu.small_scale.dense import DeviceQRCP

    A = convdiff2d(24)
    o = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5,
             kappa_d=5, verbose=0, dense_thres=120)
    Md = HIF().factorize(A, Options(device_tail=1, **o))
    Mh = HIF().factorize(A, Options(**o))
    assert isinstance(Md.precs[-1].dense_solver, DeviceQRCP)
    assert Md.precs[-1].dense_solver.rank == Mh.precs[-1].dense_solver.rank
    b = np.random.default_rng(2).standard_normal(A.nrows)
    xd, xh = Md.solve(b), Mh.solve(b)
    # same rank-revealing behavior; factors differ by orthogonal choices
    np.testing.assert_allclose(xd, xh, rtol=1e-8, atol=1e-8 * np.abs(xh).max())



def test_device_qrcp_factorization():
    """Jitted device QRCP (small_scale/qrcp_device.py) vs host factors."""
    from hifir_tpu.alg.prec import DevicePrec
    from hifir_tpu.small_scale.qrcp_device import qrcp_device, qrcp_rank

    rng = np.random.default_rng(0)
    n = 40
    U = rng.standard_normal((n, 25))
    V = rng.standard_normal((25, n))
    A = U @ V
    Q, R, piv = qrcp_device(jnp.asarray(A))
    np.testing.assert_allclose(np.asarray(Q) @ np.asarray(R),
                               A[:, np.asarray(piv)], atol=1e-10)
    assert qrcp_rank(R) == 25

    Am = saddle_point_stokes(8)
    M = _factorized(Am)
    if M.precs[-1].dense_matrix is None:
        pytest.skip("no dense tail in this configuration")
    dp1 = DevicePrec.from_host(M.precs)
    dp2 = DevicePrec.from_host(M.precs, tail_on_device=True)
    b = np.random.default_rng(1).standard_normal(Am.nrows)
    np.testing.assert_allclose(np.asarray(dp2.solve(b)),
                               np.asarray(dp1.solve(b)), atol=1e-10)


def test_device_mmultiply():
    A = convdiff2d(10)
    M = _factorized(A)
    dp = M.to_device()
    dp.pack_prod(M.precs)
    x = np.random.default_rng(2).standard_normal(A.nrows)
    yd = np.asarray(dp.mmultiply(x))
    np.testing.assert_allclose(yd, M.mmultiply(x), rtol=1e-10, atol=1e-12)


def test_batched_gmres_mrhs():
    """Batched multi-RHS device GMRES (capability beyond the reference's
    compile-time Nrhs<=4), incl. a degenerate zero RHS lane."""
    from hifir_tpu.solvers.gmres import gmres_mrhs_device

    A = convdiff2d(12)
    M = _factorized(A)
    dp = M.to_device()
    Aell = sliced_ell_from_csr(A)
    B = np.random.default_rng(0).standard_normal((A.nrows, 6))
    B[:, 3] = 0.0
    X, flag, cycles = gmres_mrhs_device(Aell, dp, B, restart=20, rtol=1e-8)
    assert flag == 0
    X = np.asarray(X)
    for k in range(6):
        nb = np.linalg.norm(B[:, k])
        if nb == 0:
            assert np.abs(X[:, k]).max() == 0.0
        else:
            assert np.linalg.norm(B[:, k] - A.matvec(X[:, k])) / nb <= 1e-8


def test_device_prec_mmultiply_tran_matches_host():
    """Device adjoint product M^H x vs the host anchor (prec_prod_tran_np,
    ref alg/prec_prod.hpp:54) — completes 4-op-mode parity on device."""
    A = convdiff2d(9)
    M = _factorized(A)
    dp = M.to_device()
    dp.pack_prod(M.precs)
    dp.pack_prod_tran(M.precs)
    x = np.random.default_rng(3).standard_normal(A.nrows)
    yh = M.mmultiply(x, trans=True)
    yd = np.asarray(dp.mmultiply(x, trans=True))
    np.testing.assert_allclose(yd, yh, rtol=1e-10,
                               atol=1e-10 * np.abs(yh).max())
    # forward still consistent
    np.testing.assert_allclose(np.asarray(dp.mmultiply(x)), M.mmultiply(x),
                               rtol=1e-10, atol=1e-10)


def test_device_prec_solve_tran_mrhs_matches_host():
    A = convdiff2d(9)
    M = _factorized(A)
    dp = M.to_device()
    dp.pack_transpose(M.precs)
    B = np.random.default_rng(4).standard_normal((A.nrows, 4))
    Xd = np.asarray(dp.solve_mrhs(jnp.asarray(B), trans=True))
    for k in range(4):
        xh = M.solve(B[:, k], trans=True)
        np.testing.assert_allclose(Xd[:, k], xh, rtol=1e-10,
                                   atol=1e-10 * np.abs(xh).max())


def test_device_complex_prec_matches_host():
    """Complex128 device path (solve, tran solve, mrhs, products) vs host on
    the vendored SuiteSparse young1c system (the reference treats z/c as
    first-class precisions, libhifir.h)."""
    import os

    path = "/root/reference/examples/demo_inputs/young1c.mtx"
    if not os.path.exists(path):
        pytest.skip("reference inputs absent")
    from hifir_tpu.utils import io as hio

    A = hio.read_mm(path)
    M = HIF().factorize(A, Options(verbose=0, dense_thres=50))
    dp = M.to_device()   # dtype=None preserves complex128
    dp.pack_transpose(M.precs)
    dp.pack_prod(M.precs)
    dp.pack_prod_tran(M.precs)
    rng = np.random.default_rng(5)
    b = rng.standard_normal(A.nrows) + 1j * rng.standard_normal(A.nrows)
    xh = M.solve(b)
    xd = np.asarray(dp.solve(b))
    assert np.iscomplexobj(xd)
    np.testing.assert_allclose(xd, xh, rtol=1e-9, atol=1e-9 * np.abs(xh).max())
    xth = M.solve(b, trans=True)
    xtd = np.asarray(dp.solve(b, trans=True))
    np.testing.assert_allclose(xtd, xth, rtol=1e-9,
                               atol=1e-9 * np.abs(xth).max())
    B = np.stack([b, 1j * b], axis=1)
    Xd = np.asarray(dp.solve_mrhs(jnp.asarray(B)))
    np.testing.assert_allclose(Xd[:, 0], xh, rtol=1e-9,
                               atol=1e-9 * np.abs(xh).max())
    yh = M.mmultiply(b)
    yd = np.asarray(dp.mmultiply(b))
    np.testing.assert_allclose(yd, yh, rtol=1e-9, atol=1e-9 * np.abs(yh).max())
    yth = M.mmultiply(b, trans=True)
    ytd = np.asarray(dp.mmultiply(b, trans=True))
    np.testing.assert_allclose(ytd, yth, rtol=1e-9,
                               atol=1e-9 * np.abs(yth).max())


def test_to_device_dtype_cache():
    """to_device() caches per dtype: a later f32 request must not silently
    return the earlier f64 pack."""
    A = convdiff2d(8)
    M = _factorized(A)
    d64 = M.to_device()
    d32 = M.to_device(dtype=jnp.float32)
    assert d64 is M.to_device()
    assert d32 is M.to_device(dtype=jnp.float32)
    assert d64 is not d32
    assert d64.levels[0].d.dtype == jnp.float64
    assert d32.levels[0].d.dtype == jnp.float32


def test_device_solve_empty_ef_level():
    """A factorization whose last level completes (m == n, empty E/F, no
    dense tail) must pack and solve on device (regression: the round-4 AMD
    produces such levels; sliced-ELL ops must handle zero blocks)."""
    A = poisson2d(256)
    o = Options(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5,
                kappa_d=5, verbose=0)
    M = HIF().factorize(A, o)
    if not any(p.m == p.n and p.E.nnz == 0 for p in M.precs):
        import pytest
        pytest.skip("no complete level produced for this configuration")
    dp = M.to_device()
    b = np.random.default_rng(1).standard_normal(A.nrows)
    xd = np.asarray(dp.solve(jnp.asarray(b)))
    np.testing.assert_allclose(xd, M.solve(b), rtol=1e-9, atol=1e-9)


def test_device_rank_override_and_nsp():
    """Device per-solve rank override + null-space filter (VERDICT r4
    Missing #2): the device apply must mirror the host's
    ``solve(b, r=rank)`` truncated-QRCP backsolve (ref builder.hpp:410-424,
    QRCP.hpp:211) and apply attached nsp filters (ref builder.hpp:419-422),
    so config 4 (singular pseudoinverse) runs fully on device."""
    from hifir_tpu.ds.csr import csr_from_dense
    from hifir_tpu.nsp import NspFilter

    rng = np.random.default_rng(5)
    n = 40
    B = rng.standard_normal((n, n))
    D = B @ B.T
    D -= np.outer(D.sum(1), np.ones(n)) / n
    D -= np.outer(np.ones(n), D.sum(0)) / n
    A = csr_from_dense(D, tol=1e-14)
    b = rng.standard_normal(n)
    b -= b.mean()
    M = HIF().factorize(A, Options(verbose=0, dense_thres=50))
    dp = M.to_device(dtype=jnp.float64)
    tail_rank = dp.tail.rank
    assert tail_rank >= 2

    # runtime rank == static rank: identical results (mask path is exact)
    x_static = np.asarray(dp.solve(jnp.asarray(b)))
    x_rt = np.asarray(dp.solve(jnp.asarray(b), r=tail_rank))
    np.testing.assert_allclose(x_rt, x_static, rtol=1e-12, atol=1e-12)

    # truncated rank matches the host truncated backsolve, single and mrhs,
    # forward and adjoint
    for r in (tail_rank - 1, max(tail_rank - 3, 1)):
        xh = M.solve(b, r=r)
        xd = np.asarray(dp.solve(jnp.asarray(b), r=r))
        np.testing.assert_allclose(xd, xh, rtol=1e-10,
                                   atol=1e-10 * np.abs(xh).max())
        xh_t = M.solve(b, trans=True, r=r)
        dp.pack_transpose(M.precs, dtype=jnp.float64)
        xd_t = np.asarray(dp.solve(jnp.asarray(b), trans=True, r=r))
        np.testing.assert_allclose(xd_t, xh_t, rtol=1e-10,
                                   atol=1e-10 * np.abs(xh_t).max())
        Bb = np.stack([b, 2 * b], axis=1)
        Xh = M.solve_mrhs(Bb, r=r)
        Xd = np.asarray(dp.solve_mrhs(jnp.asarray(Bb), r=r))
        np.testing.assert_allclose(Xd, Xh, rtol=1e-10,
                                   atol=1e-10 * np.abs(Xh).max())

    # nsp filter on device output == host nsp path
    M.nsp = NspFilter()
    dp.nsp = NspFilter()
    xh = M.solve(b)
    xd = np.asarray(dp.solve(jnp.asarray(b)))
    assert abs(float(np.asarray(xd).mean())) < 1e-12
    np.testing.assert_allclose(xd, xh, rtol=1e-10,
                               atol=1e-10 * np.abs(xh).max())

    # full device IR trajectory on the singular system reaches the
    # least-norm solution like the host test (config 4 end-to-end on device)
    x = jnp.zeros_like(jnp.asarray(b))
    for _ in range(100):
        rvec = jnp.asarray(b) - jnp.asarray(D) @ x
        x = x + dp.solve(rvec)
    x = np.array(x)
    x -= x.mean()
    x_star = np.linalg.pinv(D) @ b
    res = np.linalg.norm(b - D @ x) / np.linalg.norm(b)
    assert res <= 1e-8
    np.testing.assert_allclose(x, x_star, atol=1e-6 * np.abs(x_star).max())


def test_device_fgmres_rank_control():
    """fgmres_hifir_device threads a per-solve rank override through the
    jitted restart cycle (the reference FGMRES's truncated-rank ``rr``
    control, examples/advanced/gmres.hpp:127-231)."""
    from hifir_tpu.ops.spmv import sliced_ell_from_csr
    from hifir_tpu.solvers.gmres import fgmres_hifir_device

    A = poisson2d(12)
    M = HIF().factorize(A, Options(verbose=0, dense_thres=30))
    dp = M.to_device(dtype=jnp.float64)
    Aell = sliced_ell_from_csr(A, dtype=jnp.float64)
    b = jnp.asarray(np.random.default_rng(0).standard_normal(A.nrows))
    x, flag, iters = fgmres_hifir_device(Aell, dp, b, rtol=1e-8,
                                         rank=dp.tail.rank)
    assert flag == 0
    res = np.linalg.norm(np.asarray(b) - A.matvec(np.asarray(x)))
    assert res / np.linalg.norm(np.asarray(b)) <= 1e-8


@pytest.mark.parametrize("lower", [True, False])
def test_trsv_block_dense_vs_host(lower):
    """Blocked explicit-inverse apply (ops/trsv.py:TrsvBlockDense): oracle
    equality with the host strict-triangular solve, single and mrhs,
    including a non-multiple-of-W size (identity-padded last block)."""
    from hifir_tpu.ops.trsv import build_trsv_block_dense

    for n in (500, 1100):
        T = random_strict_triangular(n, lower=lower, seed=3)
        bd = build_trsv_block_dense(T, lower=lower, W=256)
        b = np.random.default_rng(0).standard_normal(n)
        x = np.asarray(trsv_apply(bd, jnp.asarray(b)))
        xr = (T.solve_as_strict_lower(b) if lower
              else T.solve_as_strict_upper(b))
        np.testing.assert_allclose(x, xr, rtol=1e-12, atol=1e-12)
        B = np.random.default_rng(1).standard_normal((n, 4))
        X = np.asarray(trsv_apply_mrhs(bd, jnp.asarray(B)))
        XR = np.stack([T.solve_as_strict_lower(B[:, j]) if lower
                       else T.solve_as_strict_upper(B[:, j])
                       for j in range(4)], axis=1)
        np.testing.assert_allclose(X, XR, rtol=1e-12, atol=1e-12)
