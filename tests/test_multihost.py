"""2-process ``jax.distributed`` smoke test (SURVEY.md section 2.7 item 5).

Launches two fresh Python processes that initialize the JAX distributed
runtime on the CPU backend (4 virtual devices each -> an 8-device global
job), factorize disjoint part groups of a PartitionedHIF, and sum their RAS
shares across the process boundary.  The reference needed none of this
(single-node OpenMP only); this is the multi-host leg of this implementation
(BASELINE.md config 5).  It runs on the CPU only: on GPUs each process
would need its own card (``CUDA_VISIBLE_DEVICES``).
"""
import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_partitioned_factorize():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # the workers run on the CPU backend with virtual devices
    env["JAX_PLATFORMS"] = "cpu"
    workers = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "multihost_worker.py"),
             str(r), "2", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for r in range(2)
    ]
    outs = []
    try:
        for w in workers:
            out, _ = w.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for w in workers:
            w.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))
    for r, (w, out) in enumerate(zip(workers, outs)):
        assert w.returncode == 0, f"rank {r} failed:\n{out}"
        assert "MULTIHOST_OK" in out, f"rank {r} output:\n{out}"
    # rank 0 verified the summed apply against the single-process result
    assert "err=" in outs[0], outs[0]
