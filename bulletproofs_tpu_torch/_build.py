"""Build directory and cross-process build lock for the port's compiled
artifacts (the native host library and the CUDA kernel libraries).

Everything is built at first use into `bulletproofs_tpu_torch/_build/`
(listed in .gitignore).  Several processes may reach first use at once
(pytest-xdist workers, a test subprocess), so each build runs under an
exclusive file lock and publishes its output with an atomic rename.
"""

from __future__ import annotations

import contextlib
import fcntl
import os

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(PKG_DIR)


@contextlib.contextmanager
def build_lock(name: str):
    """Exclusive lock `_build/<name>.lock` for the duration of a build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, name + ".lock"), "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
