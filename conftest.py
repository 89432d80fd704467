"""Configuration shared by every pytest run from the root of the checkout
(`pytest tests`, `pytest portbench/tests`): pytest.ini puts the rootdir
here, so this file loads before the test directories' own conftest.py
files, and its pytest_configure runs in pytest-xdist's controller before
any worker starts."""

import os
import subprocess

REPO = os.path.dirname(os.path.abspath(__file__))


def _build_jax_native_once():
    """Build native/libbptranscript.so before any test imports the JAX
    package, one process at a time.

    The JAX package builds that library at its first import when it is
    missing, in native/ and with no lock (core/_native.py; utils/strobe.py
    gives up after 120 s).  Several pytest-xdist workers importing it at
    once delete each other's object files (build.sh ends in `rm -f *.o`),
    and a worker whose build fails keeps the pure-Python STROBE for its
    whole life, on which the JAX batch prover raises (`'PyStrobe128'
    object has no attribute 'buf'`) and every test of that worker that
    compares with it fails.  A build that fails here leaves the JAX
    package's own fallback as it was."""
    from bulletproofs_tpu_torch._build import build_lock
    native = os.path.join(REPO, "native")
    so = os.path.join(native, "libbptranscript.so")
    if os.path.exists(so):
        return
    with build_lock("jax_native"):
        if not os.path.exists(so):
            try:
                subprocess.run(["sh", "build.sh"], cwd=native,
                               capture_output=True, timeout=600)
            except (OSError, subprocess.SubprocessError):
                pass


def pytest_configure(config):
    _build_jax_native_once()
