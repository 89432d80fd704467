"""Build, load and launch the port's CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc -gencode arch=compute_90a,code=sm_90a`
into a shared library with a plain C interface, loaded with ctypes.  The
libraries are built at first launch (never at import), all sources in
parallel, into `_build/cuda/`; a library's file name carries a hash of its
sources, so an edited kernel is rebuilt and a stale one never loaded.

Every exported C function takes its tensors as device pointers (None is
a null pointer), its sizes as 64-bit ints and the CUDA stream last,
launches on that stream and returns `cudaGetLastError()`.  `launch` raises
on a non-zero return and adds one to the kernel's entry in `LAUNCHES` and,
with the recorder on, to the open span's `launches` (tracing.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict

import torch

from .. import tracing
from .._build import BUILD_DIR, PKG_DIR, build_lock

CSRC = os.path.join(PKG_DIR, "csrc")
CUDA_DIR = os.path.join(BUILD_DIR, "cuda")

# library -> its .cu source; headers shared by all sources are hashed too
SOURCES = {"decompress": "decompress.cu", "emit": "emit.cu", "msm": "msm.cu",
           "compress": "compress.cu", "fixed_msm": "fixed_msm.cu",
           "fold": "fold.cu", "keccak": "keccak.cu", "fmul13": "fmul13.cu",
           "scalar": "scalar.cu"}
HEADERS = ("fe25519.cuh", "sc25519.cuh", "common.cuh", "emit.cuh",
           "reduce.cuh", "keccak.cuh", "fmul13.cuh", "sc_vec.cuh",
           "msm_bin.cuh", "fixed_direct.cuh")

# kernel name -> number of launches since the last reset_counts()
LAUNCHES: Dict[str, int] = {"decompress": 0, "emit": 0, "msm_accumulate": 0,
                            "msm_reduce": 0, "msm_horner": 0, "compress": 0,
                            "fixed_accumulate": 0, "fixed_accumulate_vt": 0,
                            "fixed_reduce": 0, "fixed_merge": 0,
                            "fold": 0, "smul": 0, "digits": 0,
                            "msm_bin": 0, "msm_accumulate_z": 0,
                            "msm_bin_niels": 0,
                            "fixed_accumulate2": 0,
                            "keccak_f1600": 0, "sinv": 0, "fmul13_chain": 0,
                            "fmul13_chain_mma": 0, "sc_mul": 0, "sc_add": 0,
                            "sc_tree_sum": 0, "chacha_scalars": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _digest(src: str) -> str:
    h = hashlib.sha1()
    for name in (src,) + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:12]


def _so_path(lib: str) -> str:
    return os.path.join(CUDA_DIR, f"lib{lib}-{_digest(SOURCES[lib])}.so")


def build_all() -> Dict[str, str]:
    """Compile every missing library (one nvcc per source, all at once);
    returns {library: nvcc output (with ptxas' register report)} for the
    libraries it built.  Raises if any build fails."""
    logs: Dict[str, str] = {}
    with build_lock("cuda"):
        os.makedirs(CUDA_DIR, exist_ok=True)
        procs = {}
        for lib, src in SOURCES.items():
            so = _so_path(lib)
            if os.path.exists(so):
                continue
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-I", CSRC, "-o", so + ".tmp",
                   os.path.join(CSRC, src)]
            procs[lib] = (so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        errors = []
        for lib, (so, proc) in procs.items():
            out, _ = proc.communicate(timeout=900)
            logs[lib] = out.decode(errors="replace")
            if proc.returncode != 0:
                errors.append(f"{lib}:\n{logs[lib]}")
            else:
                os.replace(so + ".tmp", so)
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return logs


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        so = _so_path(name)
        if not os.path.exists(so):
            build_all()
        lib = _LIBS[name] = ctypes.CDLL(so)
    return lib


def check(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Validate a kernel argument (its shape is the wrapper's to check): on
    a CUDA device, of `dtype`, contiguous."""
    if t.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError("expected a contiguous tensor")
    return t


def launch(kernel: str, lib: str, fn: str, *args) -> None:
    """Call C function `fn` of library `lib` with tensors as device
    pointers, None as a null pointer and ints as int64, on the current
    stream of the tensors' device, made the current device for the call
    (a sharded MSM launches on every card of its mesh from one thread);
    count a launch of `kernel`."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{fn} takes tensors on one device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    f = getattr(_lib(lib), fn)
    cargs, types = [], []
    for a in args:
        if a is None or isinstance(a, torch.Tensor):
            cargs.append(ctypes.c_void_p(None if a is None else a.data_ptr()))
            types.append(ctypes.c_void_p)
        else:
            cargs.append(ctypes.c_int64(int(a)))
            types.append(ctypes.c_int64)
    f.argtypes = types + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = f(*cargs,
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"CUDA launch of {fn} failed: cudaError {err}")
    LAUNCHES[kernel] += 1
    if tracing.ON:
        tracing.count("launches")
