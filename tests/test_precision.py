"""Every contraction on the device path carries ``Precision.HIGHEST``.

On the GPU an f32 ``dot_general`` without a precision may run in TF32
(about 3 decimal digits).  These tests trace the jaxprs of the device
solves, the Krylov restart cycles and the sharded IR step, walk every
sub-jaxpr (scan, cond, while, pjit, shard_map bodies) and require each
``dot_general`` to be pinned.
"""

import functools

import numpy as np
import pytest

import jax
import jax.extend.core as jcore
import jax.numpy as jnp

from hifir_tpu.alg.prec import (prec_solve_device, prec_solve_mrhs_device,
                                prec_solve_tran_device,
                                prec_solve_tran_mrhs_device)
from hifir_tpu.api import HIF
from hifir_tpu.models import poisson2d
from hifir_tpu.ops.spmv import sliced_ell_from_csr
from hifir_tpu.options import Options
from hifir_tpu.solvers.gmres import _restart_cycle, _restart_cycle_mrhs

HIGHEST = jax.lax.Precision.HIGHEST


def _subjaxprs(value):
    if isinstance(value, jcore.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jcore.Jaxpr):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _subjaxprs(v)


def dot_precisions(jaxpr):
    """The ``precision`` parameter of every dot_general, recursively."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn.params["precision"]
        for v in eqn.params.values():
            for sub in _subjaxprs(v):
                yield from dot_precisions(sub)


def assert_all_highest(fn, *args, min_dots=1):
    precs = list(dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr))
    assert len(precs) >= min_dots
    bad = [p for p in precs
           if p is None or any(q != HIGHEST for q in p)]
    assert not bad, f"{len(bad)} of {len(precs)} dot_generals unpinned"


@pytest.fixture(scope="module")
def packed():
    A = poisson2d(24)
    M = HIF().factorize(A, Options(verbose=0))
    dp = M.to_device(dtype=np.float32)
    dp.pack_transpose(M.precs, dtype=np.float32)
    # dense_inv=0: every level is a scan, so the mrhs scan body is traced
    dps = type(dp).from_host(M.precs, dtype=np.float32, dense_inv=0)
    return A, M, dp, dps


@pytest.mark.parametrize("scan", [False, True])
def test_prec_solves_pinned(packed, scan):
    A, M, dp, dps = packed
    d = dps if scan else dp
    n = A.nrows
    b = jnp.ones(n, jnp.float32)
    B = jnp.ones((n, 3), jnp.float32)
    assert_all_highest(prec_solve_device, d.levels, d.tail, b)
    assert_all_highest(prec_solve_mrhs_device, d.levels, d.tail, B)


def test_transposed_solves_pinned(packed):
    A, M, dp, _ = packed
    n = A.nrows
    assert_all_highest(prec_solve_tran_device, dp.levels, dp._tran, dp.tail,
                       jnp.ones(n, jnp.float32))
    assert_all_highest(prec_solve_tran_mrhs_device, dp.levels, dp._tran,
                       dp.tail, jnp.ones((n, 2), jnp.float32))


def test_restart_cycles_pinned(packed):
    A, M, dp, _ = packed
    n = A.nrows
    Aell = sliced_ell_from_csr(A, dtype=np.float32)
    b = jnp.ones(n, jnp.float32)
    cyc = functools.partial(_restart_cycle, restart=4)
    assert_all_highest(cyc, Aell, dp.levels, dp.tail, b, jnp.zeros_like(b),
                       jnp.float32(1e-6), min_dots=5)
    B = jnp.ones((n, 2), jnp.float32)
    cyc_m = functools.partial(_restart_cycle_mrhs, restart=4)
    assert_all_highest(cyc_m, Aell, dp.levels, dp.tail, B,
                       jnp.zeros_like(B), min_dots=5)


def test_sharded_ir_step_pinned(packed):
    from hifir_tpu.parallel import (make_mesh, make_sharded_ir_step,
                                    shard_ell_rows)

    A, M, dp, _ = packed
    mesh = make_mesh(4, rhs=2)
    Ae = shard_ell_rows(mesh, A, dtype=np.float32)
    step = make_sharded_ir_step(mesh, A.nrows)
    X = jnp.zeros((Ae.nrows, 4), jnp.float32)
    assert_all_highest(step, Ae.indices, Ae.values, dp.levels, dp.tail, X,
                       X, min_dots=2)


def test_walker_sees_unpinned_dots():
    """The check is not vacuous: an unpinned product is reported."""
    def f(x):
        return jax.lax.scan(lambda c, _: (c @ x, None), x, None, length=2)[0]

    precs = list(dot_precisions(jax.make_jaxpr(f)(jnp.eye(3)).jaxpr))
    assert precs and all(p is None for p in precs)
