"""Worker for the 2-process ``jax.distributed`` smoke test.

Usage: python multihost_worker.py <process_id> <num_processes> <port>

Each process initializes the JAX distributed runtime (CPU backend, 4 virtual
devices per process -> an 8-device global job), factorizes its own part group
of a partitioned HIF (``k % num_processes == process_id``), and the RAS-apply
shares are summed across processes — with a device ``psum`` over the global
mesh when the backend supports cross-process CPU collectives, else through
the distributed KV store.  Process 0 checks the summed apply against the
single-process PartitionedHIF on the same matrix and prints MULTIHOST_OK.

This executes the multi-process claim of
:mod:`hifir_tpu.parallel.partition` (one part group per process) through
:mod:`hifir_tpu.parallel.multihost` (SURVEY.md section 2.7 item 5).
"""
import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
# a CPU-only test: 4 virtual CPU devices per process
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from hifir_tpu.models import poisson2d  # noqa: E402
from hifir_tpu.options import Options  # noqa: E402
from hifir_tpu.parallel.multihost import initialize_multihost  # noqa: E402
from hifir_tpu.parallel.partition import PartitionedHIF  # noqa: E402

initialize_multihost(coordinator_address=f"localhost:{port}",
                     num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
assert jax.process_index() == pid
ndev_global = len(jax.devices())
ndev_local = len(jax.local_devices())
assert ndev_global == 4 * nproc, ndev_global
assert ndev_local == 4, ndev_local

A = poisson2d(48)
opts = Options(verbose=0, tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3,
               kappa=5, kappa_d=5, dense_thres=500)
NPARTS = 4
P = PartitionedHIF().factorize(A, NPARTS, opts, process_rank=pid,
                               process_count=nproc)
owned = [k for k, p in enumerate(P.parts) if p.M is not None]
assert owned == [k for k in range(NPARTS) if k % nproc == pid], owned

rng = np.random.default_rng(7)
b = rng.standard_normal(A.nrows)
share_host = P.local_contrib(b)

# --- config-5 composition: RAS across processes x DistPrec within each
# process's LOCAL device mesh (the distributed M-solve executes across this
# process's 4 virtual devices under the multi-process jax.distributed
# runtime); the share must equal the host-path share to solver precision ---
P.attach_dist_solvers()
assert all(p.M_dist is not None for p in P.parts if p.M is not None)
share = P.local_contrib(b)
dist_err = float(np.abs(share - share_host).max()
                 / max(np.abs(share_host).max(), 1e-300))
assert dist_err < 1e-12, dist_err
print(f"rank {pid}: DistPrec share err vs host {dist_err:.2e}", flush=True)

how = "psum"
try:
    # sum the shares with a device collective over the global job
    from jax.experimental import multihost_utils

    total = np.asarray(multihost_utils.process_allgather(
        share, tiled=False)).sum(axis=0)
except Exception as e:  # pragma: no cover - backend-dependent
    # CPU cross-process collectives unavailable: exchange through the
    # distributed KV store instead (still the jax.distributed runtime)
    how = f"kvstore ({type(e).__name__})"
    import base64

    from jax._src import distributed

    client = distributed.global_state.client
    client.key_value_set(f"share:{pid}",
                         base64.b64encode(share.tobytes()).decode())
    client.wait_at_barrier("shares_ready", 60_000)
    total = np.zeros_like(share)
    for r in range(nproc):
        raw = client.blocking_key_value_get(f"share:{r}", 60_000)
        total += np.frombuffer(base64.b64decode(raw), dtype=share.dtype)

if pid == 0:
    Pfull = PartitionedHIF().factorize(A, NPARTS, opts)
    ref = Pfull.solve(b)
    err = float(np.abs(total - ref).max() / np.abs(ref).max())
    assert err < 1e-12, err
    print(f"MULTIHOST_OK processes={nproc} devices={ndev_global} "
          f"parts={NPARTS} sum={how} dist_solve=on err={err:.2e}",
          flush=True)
else:
    print(f"MULTIHOST_OK rank={pid} sum={how}", flush=True)
