"""Test configuration: CPU backend with 8 virtual devices, 64-bit mode, and
the native host library built from the tracked sources.

The suite runs on the CPU.  Multi-device logic is tested on a fake 8-device
CPU backend, mirroring the strategy in SURVEY.md §4 ("runnable on CPU via
--xla_force_host_platform_device_count").  Tests that need an NVIDIA GPU
carry the ``gpu`` marker and skip here; ``python chip_smoke.py`` is the
on-card check.
"""

import fcntl
import os
import subprocess
import warnings

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "hifir_tpu", "native")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on the CPU backend")
    config.addinivalue_line(
        "markers", "slow: long-running; deselected by -m 'not slow'")


@pytest.fixture(scope="session", autouse=True)
def native_library():
    """Build ``libhifir_tpu.so`` once for the whole run.

    Every xdist worker runs this fixture; the file lock makes the first one
    build while the others wait and then find the library up to date.  The
    loader's cached result (possibly "absent", from an import during
    collection) is reset so the fresh library is picked up.  A failed build
    warns and leaves the pure-Python anchors in charge."""
    lock_path = os.path.join(NATIVE_DIR, ".build.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            r = subprocess.run(["make", "-j4", "-C", NATIVE_DIR,
                                "libhifir_tpu.so"],
                               capture_output=True, text=True)
            err = r.stderr[-2000:] if r.returncode else None
        except OSError as e:  # no make on this machine
            err = str(e)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if err is not None:
        warnings.warn("native library build failed; tests use the Python "
                      "anchors:\n" + err)
    from hifir_tpu.pre import _native

    _native._LIB = None
    _native._TRIED = False
