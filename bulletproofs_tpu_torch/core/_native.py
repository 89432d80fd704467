"""ctypes binding to the native host curve backend (the repo's
framework-neutral C++ in `native/`: ristretto.cpp, transcript.cpp,
verify_prep.cpp, ...).

The port keeps its own copy of the library: `native/*.cpp` are compiled
UNCHANGED, with the flags of `native/build.sh`, into
`bulletproofs_tpu_torch/_build/host/libbptranscript.so` at first import of
this module (one g++ per source, run together; ~7 s), under a file lock so
concurrent processes build once.  Exposes `LIB` (the loaded shared library
with argtypes configured) or None when the build fails or is disabled.  Set
BPTPU_NO_NATIVE=1 to force the pure-Python paths.

Boundary formats (see native/ristretto.cpp):
  point  = 128 bytes (X, Y, Z, T as 32-byte little-endian field elements)
  scalar = 32 bytes little-endian, reduced mod l
"""

from __future__ import annotations

import ctypes
import os
import subprocess

from .._build import BUILD_DIR, REPO_DIR, build_lock

NATIVE_SRC = os.path.join(REPO_DIR, "native")
HOST_DIR = os.path.join(BUILD_DIR, "host")
SO_PATH = os.path.join(HOST_DIR, "libbptranscript.so")

# native/build.sh, one g++ per source (same flags)
_PLAIN = ("transcript", "verify_prep", "prove_prep", "ristretto", "sc_vec",
          "linear_prep")
_IFMA = ("ristretto_ifma", "verify_emit_ifma")
_CFLAGS = ["-O3", "-march=native", "-c", "-fPIC"]
_IFMA_FLAGS = ["-O3", "-march=native", "-mavx512ifma", "-mavx512vl",
               "-mavx512f", "-c", "-fPIC"]


def build() -> str:
    """Compile and link the host library if absent; returns its path."""
    with build_lock("host"):
        if os.path.exists(SO_PATH):
            return SO_PATH
        os.makedirs(HOST_DIR, exist_ok=True)
        procs = []
        for names, flags in ((_PLAIN, _CFLAGS), (_IFMA, _IFMA_FLAGS)):
            for name in names:
                procs.append(subprocess.Popen(
                    ["g++"] + flags + [os.path.join(NATIVE_SRC, name + ".cpp"),
                                       "-o", os.path.join(HOST_DIR, name + ".o")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        errors = []
        for p in procs:
            out, _ = p.communicate(timeout=600)
            if p.returncode != 0:
                errors.append(out.decode(errors="replace"))
        if errors:
            raise RuntimeError("native host build failed:\n" + "\n".join(errors))
        tmp = SO_PATH + ".tmp"
        subprocess.run(
            ["g++", "-shared", "-o", tmp]
            + [os.path.join(HOST_DIR, n + ".o") for n in _PLAIN + _IFMA],
            check=True, capture_output=True, timeout=600)
        os.replace(tmp, SO_PATH)
        return SO_PATH


_C, _SZ, _U64 = ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64
# the entry points this package calls: name -> (argtypes, restype); the
# STROBE and Keccak ones are declared by utils/strobe.py and utils/keccak.py
_SIGNATURES = {
    "rist_msm": ([_SZ, _C, _C, _C], None),
    "rist_msm_ct": ([_SZ, _C, _C, _C], None),
    "rist_msm_rows": ([_SZ, _SZ, _C, _C, _C], None),
    "rist_msm_rows_ct": ([_SZ, _SZ, _C, _C, _C], None),
    "rist_bit_commit": ([_SZ, _U64, _C, _C, _C, _C, _C], None),
    "rist_scalar_mul": ([_C] * 3, None),
    "rist_compress": ([_C] * 2, None),
    "rist_batch_compress": ([_SZ, _C, _C], None),
    "rist_decompress": ([_C] * 2, ctypes.c_int),
    "rist_batch_decompress": ([_SZ] + [_C] * 3, ctypes.c_int),
    "rist_is_identity": ([_C], ctypes.c_int),
    "rist_from_uniform_bytes": ([_C] * 2, None),
    "sc_invert1": ([_C] * 2, None),
    "ipp_round_scalars": ([_SZ, _SZ] + [_C] * 8, None),
    "ipp_fold": ([_SZ, _SZ] + [_C] * 6, None),
    "rangeproof_verify_replay_batch_c": (
        [_C, _SZ, _C, _SZ, _C] + [_U64] * 3 + [_C] * 3, ctypes.c_int),
    # the chunked verifier's prep: per-point dynamic scalars, static
    # scalars accumulated across calls into one buffer
    "rangeproof_verify_prep_batch": (
        [_C, _SZ, _C, _SZ, _C] + [_U64] * 3 + [_C] * 3, ctypes.c_int),
    # the batch prover's Fiat-Shamir stages (native/prove_prep.cpp)
    "rp_reduce_wide": ([_U64, _C, _C], ctypes.c_int),
    "rp_ts_yz": ([_U64, _C, _U64, _U64, _U64, _C, _C], ctypes.c_int),
    "rp_ts_x": ([_U64, _C, _U64, _C, _C], ctypes.c_int),
    "rp_ts_w": ([_U64, _C, _U64, _U64, _C, _C], ctypes.c_int),
    "rp_ts_round": ([_U64, _C, _U64, _C, _C, _C], ctypes.c_int),
    # the host prove engine (m = 1): per-proof state of rp_state_size(n)
    # bytes, advanced stage by stage
    "rp_state_size": ([_U64], _U64),
    "rp_prove_stage0": ([_U64, _U64, ctypes.POINTER(_U64)] + [_C] * 4,
                        ctypes.c_int),
    "rp_prove_stage1": ([_U64, _U64, _C, _U64] + [_C] * 4, ctypes.c_int),
    "rp_prove_stage2": ([_U64, _U64, _C, _U64, _C, _C], ctypes.c_int),
    "rp_prove_round_coefs": ([_U64] * 3 + [_C] * 2, ctypes.c_int),
    "rp_prove_round_absorb": ([_U64] * 3 + [_C, _U64, _C, _C],
                              ctypes.c_int),
    "rp_prove_finish": ([_U64, _U64, _C, _C], ctypes.c_int),
    # the R1CS prover's and verifier's vector stages (native/sc_vec.cpp)
    "r1cs_lr_polys": ([_SZ] + [_C] * 17, None),
    "r1cs_lr_eval": ([_SZ, _SZ] + [_C] * 11, None),
    "r1cs_verify_scalars": ([_SZ, _SZ, _SZ] + [_C] * 14, None),
    "r1cs_hg_factors": ([_SZ, _SZ] + [_C] * 4, None),
    "sc_vec_axpy": ([_SZ] + [_C] * 3, None),
    # the linear proof's batched replay (native/linear_prep.cpp)
    "linear_verify_replay_batch_c": (
        [_C, _SZ, _C, _SZ] + [_C] * 5 + [_U64, _U64] + [_C] * 3,
        ctypes.c_int),
}


def _load():
    from ..config import settings
    if settings.no_native:
        return None
    try:
        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


LIB = _load()
