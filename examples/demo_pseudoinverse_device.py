"""Advanced demo: singular-system pseudoinverse fully on the device
(BASELINE config 4; ref builder.hpp:410-424 per-solve rank + NspFilter,
examples/advanced/demo_hifir.cpp).

A rank-deficient symmetric system (constant null space) is factorized with
a rank-revealing QRCP tail; the DEVICE apply then uses the runtime rank
override (one compilation serves every rank) and the device null-space
filter, driving iterative refinement to the least-norm solution.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax.numpy as jnp

from hifir_tpu.api import HIF
from hifir_tpu.ds.csr import csr_from_dense
from hifir_tpu.nsp import NspFilter
from hifir_tpu.options import Options


def main():
    rng = np.random.default_rng(5)
    n = 40
    B = rng.standard_normal((n, n))
    D = B @ B.T
    D -= np.outer(D.sum(1), np.ones(n)) / n   # rows sum to zero
    D -= np.outer(np.ones(n), D.sum(0)) / n   # cols sum to zero
    A = csr_from_dense(D, tol=1e-14)
    b = rng.standard_normal(n)
    b -= b.mean()                              # consistent RHS

    M = HIF().factorize(A, Options(verbose=0, dense_thres=50))
    dp = M.to_device()  # host precision on device; f64 residuals below
    dp.nsp = NspFilter()                       # constant-mode projector
    print(f"tail rank {dp.tail.rank} of {dp.tail.Q.shape[0]} "
          f"(rank-revealing QRCP found the null space)")

    x = jnp.zeros(n)
    for _ in range(50):
        r = jnp.asarray(b) - jnp.asarray(D) @ x
        x = x + dp.solve(r)                    # device apply + nsp filter
    x = np.array(x)
    x -= x.mean()
    x_star = np.linalg.pinv(D) @ b
    res = np.linalg.norm(b - D @ x) / np.linalg.norm(b)
    err = np.abs(x - x_star).max() / np.abs(x_star).max()
    print(f"device IR (f32 M, f64 residuals): rel.res={res:.2e}, "
          f"vs pinv={err:.2e} (f32 apply floor ~1e-5)")

    # per-solve rank override (the reference's solve(b, x, trans, rank)):
    # a deliberately truncated rank still contracts, full rank solves exactly
    for r in (dp.tail.rank, max(dp.tail.rank - 5, 1)):
        xr = np.asarray(dp.solve(jnp.asarray(b), r=r))
        print(f"rank={r}: |M^+ b|_inf = {np.abs(xr).max():.4g}")


if __name__ == "__main__":
    main()
