"""Device demo: batched M-solve + device FGMRES on a generated PDE system.

Runs on whatever accelerator JAX finds (one process per card).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

from hifir_tpu.api import HIF
from hifir_tpu.models import poisson2d
from hifir_tpu.options import Options
from hifir_tpu.ops.spmv import sliced_ell_from_csr
from hifir_tpu.solvers import fgmres_hifir_device


def main():
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    A = poisson2d(128)
    n = A.nrows
    opts = Options(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5,
                   kappa_d=5, verbose=0)
    M = HIF().factorize(A, opts)
    dp = M.to_device(dtype=jnp.float32)
    B = jnp.asarray(np.random.default_rng(0).standard_normal((n, 64)),
                    jnp.float32)
    dp.solve_mrhs(B).block_until_ready()  # compile
    t0 = time.perf_counter()
    dp.solve_mrhs(B).block_until_ready()
    dt = time.perf_counter() - t0
    print(f"batched M-solve: {dt * 1e3:.1f} ms for 64 RHS "
          f"({M.nnz() * 64 / dt / 1e9:.2f} Gnnz/s)")

    Aell = sliced_ell_from_csr(A)
    dp64 = M.to_device()
    b = jnp.ones(n)
    x, flag, iters = fgmres_hifir_device(Aell, dp64, b, restart=30, rtol=1e-8)
    res = np.linalg.norm(np.ones(n) - A.matvec(np.asarray(x))) / np.sqrt(n)
    print(f"device FGMRES: flag={flag} iters={iters} res={res:.2e}")


if __name__ == "__main__":
    main()
