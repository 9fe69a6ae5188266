"""DistPrec at scale on the virtual 8-device CPU mesh (BASELINE config 5 leg).

Builds a >=10^5-row robust multilevel factorization, distributes it with
:class:`hifir_tpu.parallel.prec_sharded.DistPrec`, and records what stands
between this code and the 100M-row target: factorize time, DistPrec build
time, jit compile time of the unrolled halo-exchange trsv loop, steady-state
solve time, correctness against the host apply, and the per-device memory
split (sharded factor bytes vs replicated bytes vs distributed-vector
bytes).  Run:

    python examples/distprec_scale.py [nx=512] [chunk=4096]

Results are recorded in BASELINE.md ("DistPrec scale measurement").
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# a CPU study of structure and memory on 8 virtual devices
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np

from hifir_tpu.api import HIF
from hifir_tpu.models import poisson2d
from hifir_tpu.options import Options
from hifir_tpu.parallel.mesh import make_mesh
from hifir_tpu.parallel.prec_sharded import DistPrec


def nbytes(tree) -> int:
    return sum(x.nbytes for x in jax.tree_util.tree_leaves(tree)
               if hasattr(x, "nbytes"))


def main():
    nx = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    chunk = sys.argv[2] if len(sys.argv) > 2 else "1024"
    chunk = chunk if chunk == "auto" else int(chunk)
    A = poisson2d(nx)
    n = A.nrows
    print(f"n={n} nnz={A.nnz} chunk={chunk} devices={len(jax.devices())}")

    t0 = time.time()
    M = HIF().factorize(A, Options(verbose=0))
    t_fact = time.time() - t0
    print(f"factorize {t_fact:.1f}s fill={M.nnz()/A.nnz:.2f} "
          f"levels={M.levels()}")

    mesh = make_mesh(len(jax.devices()), rhs=1)
    t0 = time.time()
    dp = DistPrec.from_host(mesh, M, chunk=chunk)
    t_build = time.time() - t0
    nchunks = sum(getattr(l.L_op, "nchunks", 0) + getattr(l.U_op, "nchunks", 0)
                  for l in dp.levels)
    print(f"DistPrec build {t_build:.1f}s halo_factors={dp.n_halo} "
          f"total_chunks={nchunks} comm_elems={dp.comm_elems} "
          f"(tiled-AG scheme would move {dp.allgather_elems})")

    rng = np.random.default_rng(0)
    b = rng.standard_normal(n)
    t0 = time.time()
    x = np.asarray(dp.solve(b))
    t_compile = time.time() - t0
    t0 = time.time()
    reps = 3
    for _ in range(reps):
        x = np.asarray(dp.solve(b))
    t_solve = (time.time() - t0) / reps
    print(f"first solve (jit compile + run) {t_compile:.1f}s; "
          f"steady solve {t_solve*1e3:.0f} ms")

    xh = M.solve(b)
    err = float(np.abs(x - xh).max() / np.abs(xh).max())
    print(f"distributed vs host max rel diff: {err:.2e}")
    assert err < 1e-12, err

    # per-device memory model: what scales as n/D vs what is replicated
    D = len(jax.devices())
    sharded = repl = 0
    for lvl in dp.levels:
        spec = lvl.spec()
        for f in lvl._ARRAYS:
            val, sp = getattr(lvl, f), getattr(spec, f)
            if f in ("L_op", "U_op"):
                for arr, s in zip(jax.tree_util.tree_leaves(val),
                                  jax.tree_util.tree_leaves(sp)):
                    if not hasattr(arr, "nbytes"):
                        continue
                    if getattr(s, "__len__", None) and len(s) and \
                            s[0] == "rows":
                        sharded += arr.nbytes
                    elif "rows" in str(s):
                        sharded += arr.nbytes
                    else:
                        repl += arr.nbytes
            else:
                bts = nbytes(val)
                if "rows" in str(sp):
                    sharded += bts
                else:
                    repl += bts
    tail = nbytes(dp.tail)
    print(f"factor bytes sharded over rows: {sharded/1e6:.1f} MB total "
          f"({sharded/D/1e6:.1f} MB/device); replicated per device: "
          f"{repl/1e6:.1f} MB; dense tail (replicated): {tail/1e6:.1f} MB")
    per_n_repl = repl / n
    print(f"replicated bytes per matrix row: {per_n_repl:.1f} "
          f"(x 1e8 rows = {per_n_repl*1e8/1e9:.1f} GB/device at 100M rows)")


if __name__ == "__main__":
    main()
