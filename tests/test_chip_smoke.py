"""CPU tests of ``chip_smoke.py``'s phases at small sizes.

The script itself refuses to run without a GPU; its phase functions are
plain code over the device path and run here on the CPU backend against the
same host references, at ``poisson2d(32)`` and a hand-built dense-only
(m == 0) level.
"""

import json
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from hifir_tpu.alg.factor import LevelPrec  # noqa: E402
from hifir_tpu.alg.prec import DevicePrec  # noqa: E402
from hifir_tpu.api import HIF  # noqa: E402
from hifir_tpu.ds.csr import CSR  # noqa: E402
from hifir_tpu.models import poisson2d  # noqa: E402
from hifir_tpu.ops.spmv import ell_matvec_mrhs, sliced_ell_from_csr  # noqa
from hifir_tpu.ops.trsv import (TrsvBlockDense, TrsvDense,  # noqa: E402
                                TrsvSchedule)
from hifir_tpu.options import Options  # noqa: E402
from hifir_tpu.small_scale.dense import QRCP  # noqa: E402


@pytest.fixture
def clock():
    c = cs.CompileClock()
    yield c
    c.close()


@pytest.fixture(scope="module")
def problem():
    A = poisson2d(32)
    return A, HIF().factorize(A, Options(verbose=0))


def dense_only_hif(n: int = 40, seed: int = 0) -> HIF:
    """A one-level preconditioner whose level keeps nothing (m == 0): the
    whole system goes to the dense tail."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((n, n)) + n * np.eye(n)
    empty = CSR(0, 0, np.zeros(1, np.int64), np.zeros(0, np.int32),
                np.zeros(0))
    E = CSR(n, 0, np.zeros(n + 1, np.int64), np.zeros(0, np.int32),
            np.zeros(0))
    F = CSR(0, n, np.zeros(1, np.int64), np.zeros(0, np.int32), np.zeros(0))
    ident = np.arange(n)
    tail = QRCP()
    tail.factorize(D, Options(verbose=0))
    lvl = LevelPrec(m=0, n=n, L_B=empty, d=np.zeros(0), U_B=empty, E=E, F=F,
                    s=np.ones(n), t=np.ones(n), p=ident, p_inv=ident,
                    q=ident, q_inv=ident, dense_matrix=D, dense_solver=tail)
    M = HIF()
    M.precs = [lvl]
    M._nrows = M._ncols = n
    return M


def test_main_exits_nonzero_without_gpu(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert cs.main([]) != 0
    out, err = capsys.readouterr()
    assert "no GPU" in err
    assert '"ok"' not in out


def test_phase_env_refuses_cpu():
    with pytest.raises(cs.CheckFailed, match="no GPU"):
        cs.phase_env(["NVIDIA H100 80GB HBM3, 700.00 W"])


def test_phase_native_requires_library(clock, capsys):
    cs.phase_native(clock)
    assert "crout=loaded amd=loaded" in capsys.readouterr().out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("dense_inv", [0, 64, "auto"])
def test_phase_kernels_match_host(clock, problem, dtype, dense_inv):
    """Phase 5 on every operator kind: dense_inv=0 packs every level as the
    scan, 64 mixes block-dense and dense inverses, auto is the default."""
    A, M = problem
    dp = cs.phase_pack(clock, M, dtype, dense_inv=dense_inv)
    res = cs.phase_kernels(clock, M, dp)
    assert len(res) == 4 * len(M.precs) + 1       # L, U, E, F per level + tail
    kinds = {type(op) for lvl in dp.levels for op in (lvl.L, lvl.U)}
    if dense_inv == 0:
        assert kinds == {TrsvSchedule}
    elif dense_inv == 64:
        assert TrsvBlockDense in kinds


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_phase_apply_matches_host(clock, problem, dtype):
    A, M = problem
    dp = cs.phase_pack(clock, M, dtype, dense_inv=0)
    out = cs.phase_apply(clock, M, dp, nrhs=8)
    assert out["solve_s"] > 0 and out["mrhs_s"] > 0


def test_phase_gmres(clock, problem):
    A, M = problem
    dp = cs.phase_pack(clock, M, np.float64)
    g = cs.phase_gmres(clock, A, M, dp)
    assert g["res"] <= 2e-6 and abs(g["iters"] - g["host_iters"]) <= 1


def test_phase_ir_contracts(clock):
    assert cs.phase_ir(clock, nx=16) < 0.5


def test_phase_probe_reports_scan_costs(clock, problem, capsys):
    A, M = problem
    dp = cs.phase_pack(clock, M, np.float64, dense_inv=0)
    out = cs.phase_probe(clock, dp, chain=64, wide=(4, 256, 4), reps=1)
    assert out["us_per_chunk"] > 0 and out["step_latency_us"] > 0
    assert "[probe scan]" in capsys.readouterr().out


def test_probe_needs_a_scan_level(clock, problem):
    A, M = problem
    dp = cs.phase_pack(clock, M, np.float64, dense_inv=4096)
    assert cs.largest_schedule(dp) is None
    with pytest.raises(cs.CheckFailed):
        cs.phase_probe(clock, dp)


def test_chain_schedule_has_one_step_per_row():
    s = cs.chain_schedule(50, np.float64)
    assert s.nchunks == 50 and s.chunk == 8


def test_wide_schedule_has_one_step_per_level():
    s = cs.wide_schedule(5, 64, 3, np.float64)
    assert (s.nchunks, s.chunk, s.cols.shape[-1]) == (5, 64, 3)
    x = np.asarray(cs.trsv_apply(s, jnp.ones(320)))
    assert np.all(np.isfinite(x))


@pytest.mark.parametrize("bs", [4, 8])
def test_block_form_matches_sliced_ell(problem, bs):
    A, M = problem
    S = max((p.E for p in M.precs), key=lambda e: e.nnz)
    X = jnp.asarray(np.random.default_rng(0).standard_normal((S.ncols, 5)))
    blk, nbytes = cs.block_ell(S, bs, np.float64, max_bytes=1e9)
    assert nbytes == blk[0].size * 8
    Y = cs.block_ell_matmul(*blk, X, S.nrows)
    Yr = ell_matvec_mrhs(sliced_ell_from_csr(S), X)
    np.testing.assert_allclose(np.asarray(Y), np.asarray(Yr), rtol=1e-12,
                               atol=1e-12)


def test_block_form_respects_budget(problem):
    A, M = problem
    blk, nbytes = cs.block_ell(M.precs[0].E, 8, np.float32, max_bytes=1.0)
    assert blk is None and nbytes > 1


def test_phase_spmv_forms(clock, problem):
    A, M = problem
    rows = cs.phase_spmv_forms(clock, M, nrhs=4, block_sizes=(4,))
    assert {r[1] for r in rows} == {"sliced_ell", "block4"}


def test_operand_bytes_cover_the_pack(clock, problem):
    A, M = problem
    dp = cs.phase_pack(clock, M, np.float32, dense_inv=64)
    by_kind = cs.operand_bytes(dp)
    assert sum(by_kind.values()) == cs.tree_bytes(dp.operands())
    assert by_kind["DenseTail"] > 0 and by_kind["SlicedELL"] > 0


def test_dense_only_level_packs_empty_schedules(clock):
    """An m == 0 level packs empty L/U schedules, not a (2048, 2048)
    identity per side, and still solves like the host."""
    M = dense_only_hif()
    dp = DevicePrec.from_host(M.precs, dtype=np.float64)
    lvl = dp.levels[0]
    for op in (lvl.L, lvl.U):
        assert isinstance(op, TrsvSchedule) and op.nchunks == 0
    assert cs.tree_bytes((lvl.L, lvl.U)) < 1024
    dp.pack_transpose(M.precs, dtype=np.float64)
    assert all(isinstance(op, TrsvSchedule) and op.nchunks == 0
               for op in (dp._tran[0].LT, dp._tran[0].UT))
    res = cs.phase_kernels(clock, M, dp)
    assert [side for _, side, _ in res] == ["L", "U", "E", "F", "tail"]
    cs.phase_apply(clock, M, dp, nrhs=3)


def test_dense_inverse_kinds_for_small_levels(problem):
    """The default pack turns small levels into explicit inverses."""
    A, M = problem
    dp = DevicePrec.from_host(M.precs, dtype=np.float64)
    assert all(isinstance(op, (TrsvDense, TrsvBlockDense))
               for lvl in dp.levels for op in (lvl.L, lvl.U))


def test_run_four_on_virtual_devices(clock, monkeypatch, capsys):
    """The --four path on 4 of the 8 virtual CPU devices (CPU devices report
    no memory statistics, so that one reading is stubbed)."""
    monkeypatch.setattr(cs, "peak_bytes", lambda device: 1)
    cs.run_four(clock, nx=40)
    out = capsys.readouterr().out
    assert "shard_devices=4" in out and "[sharded ir step 4]" in out


def test_last_line_format(monkeypatch, capsys):
    """With a GPU the last stdout line is the JSON result the checker
    reads; the GPU and the phases are stubbed here."""
    info = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    monkeypatch.setattr(cs, "phase_env", lambda cards: info)
    monkeypatch.setattr(cs, "run_default", lambda clock, trace_dir: None)
    assert cs.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": info}
