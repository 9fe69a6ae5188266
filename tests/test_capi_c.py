"""Build and run the compiled C ABI smoke test (tests/capi/test_capi.c).

This is the parity check for the reference's compiled runtime library
(``/root/reference/libhifir/tests/test_real.c``): a plain C program links
``libhifir_tpu_capi.so`` and drives factorize/apply/IR/mixed-precision
through the C ABI with no Python of its own.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
CAPI = REPO / "hifir_tpu" / "native" / "capi"
SHIM = CAPI / "libhifir_tpu_capi.so"


@pytest.mark.skipif(shutil.which("gcc") is None, reason="no C compiler")
def test_capi_end_to_end(tmp_path):
    if not SHIM.exists():
        r = subprocess.run(
            ["make", "-C", str(REPO / "hifir_tpu" / "native"),
             "capi/libhifir_tpu_capi.so"], capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
    exe = tmp_path / "test_capi"
    r = subprocess.run(
        ["gcc", "-O2", "-std=c99", f"-I{CAPI}",
         str(REPO / "tests" / "capi" / "test_capi.c"),
         str(SHIM), f"-Wl,-rpath,{CAPI}", "-lm", "-o", str(exe)],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr

    env = dict(os.environ)
    env["LHF_PYTHON"] = sys.executable
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # the embedded interpreter runs its JAX code on the CPU backend
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([str(exe)], capture_output=True, text=True, env=env,
                       timeout=600)
    sys.stdout.write(r.stdout)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "all checks passed" in r.stdout
