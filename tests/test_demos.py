"""Smoke-run the example demos (the reference's CI builds and runs all
examples after the unit tests — .github/workflows/github-actions.yml:20-25).

Each demo is executed as a subprocess exactly as a user would run it; the
expensive/device-bound ones (demo_device_batch, distprec_scale,
partition_study, make_bench_fixture) are exercised elsewhere.
"""

import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
REF_INPUTS = "/root/reference/examples/demo_inputs"

DEMOS = [
    ("demo_simple.py", "iters=2"),
    ("demo_trans.py", "flag=0"),
    ("demo_verbose.py", "done: levels="),
    ("demo_params.py", "optimized"),
    ("demo_multiply.py", "roundtrip error"),
    ("demo_complex.py", "complex HIF"),
    ("demo_pseudoinverse_device.py", "rank-revealing"),
    ("demo_hifir.py", ""),
    ("demo_mixedprecision.py", ""),
    ("demo_sparsifier.py", ""),
    ("demo_fgmres_sparsifier.py", "flag=0"),
    ("demo_partitioned.py", ""),
]


@pytest.mark.parametrize("demo,needle", DEMOS,
                         ids=[d for d, _ in DEMOS])
def test_demo_runs(demo, needle):
    if not os.path.isdir(REF_INPUTS):
        pytest.skip("reference demo inputs not mounted")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", demo)],
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    if needle:
        assert needle in out.stdout, out.stdout[-2000:]
