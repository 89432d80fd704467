"""Framework configuration for the PyTorch port (the knobs its code reads).

One `settings` object.  Each field is seeded from its BPTPU_* environment
variable at import; code paths read `settings.<field>` at call time, so
tests and embedders can also flip them directly before first use.

| field                  | env var                   | consumer |
|------------------------|---------------------------|----------|
| no_native              | BPTPU_NO_NATIVE           | core/_native.py (force pure-Python) |
| fused_verify_chunk     | BPTPU_FUSED_VERIFY_CHUNK  | parallel/batch_verify sub-batch size (0 = default) |
| verify_chunk_pts       | BPTPU_VERIFY_CHUNK_PTS    | parallel/batch_verify chunked route: dynamic points per chunk |
| fused_verify_max_nm    | BPTPU_FUSED_VERIFY_MAX_NM | parallel/batch_verify: largest nm on the fused route |
| require_consttime      | BPTPU_REQUIRE_CONSTTIME   | vartime_witness_fallback (hard gate) |
| msm_device_floor       | BPTPU_MSM_DEVICE_FLOOR    | ops/msm.msm_host_auto crossover |
| linear_device_msm_floor| BPTPU_LINEAR_DEVICE_FLOOR | proofs/linear.batch_verify device route |
| r1cs_device_msm_floor  | BPTPU_R1CS_DEVICE_FLOOR   | proofs/r1cs/verifier device mega-MSM |
| enable_r1cs            | BPTPU_ENABLE_R1CS         | proofs/r1cs (the `yoloproofs` feature flag) |

The three floors keep the JAX package's defaults (its config.py), so the
port routes as it does; PERF.md records where the H100's crossover lies.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_opt_int(name: str):
    v = os.environ.get(name)
    if not v:
        return None
    try:
        return int(v)
    except ValueError:
        return None


@dataclass
class Settings:
    # force the pure-Python curve/scalar oracle (tests cross-check backends)
    no_native: bool = field(
        default_factory=lambda: bool(os.environ.get("BPTPU_NO_NATIVE")))

    # fused-path sub-batch size (proofs per device dispatch); 0 = the
    # BatchVerifier default (2048)
    fused_verify_chunk: int = field(
        default_factory=lambda: _env_int("BPTPU_FUSED_VERIFY_CHUNK", 0))

    # chunked verification route: dynamic-point budget per chunk (one
    # C++ prep call and one partial MSM each)
    verify_chunk_pts: int = field(
        default_factory=lambda: _env_int("BPTPU_VERIFY_CHUNK_PTS", 8192))

    # largest aggregation size nm verified on the fused route; larger
    # aggregations take the chunked route (the JAX package's default and
    # rule, config.py:111-124)
    fused_verify_max_nm: int = field(
        default_factory=lambda: _env_int("BPTPU_FUSED_VERIFY_MAX_NM", 256))

    # witness-carrying proving REQUIRES the constant-time native backend:
    # raise instead of falling back to the variable-time pure-Python oracle.
    # Default off: the fallback warns once and proceeds (test oracle use).
    require_consttime: bool = field(
        default_factory=lambda: bool(os.environ.get("BPTPU_REQUIRE_CONSTTIME")))

    # point count from which msm_host_auto takes the device MSM; None =
    # auto (2^18 with the C++ backend built, 32 without)
    msm_device_floor: int | None = field(
        default_factory=lambda: _env_opt_int("BPTPU_MSM_DEVICE_FLOOR"))

    # total point count from which LinearProof.batch_verify routes its
    # fused MSM to the device (dynamic points uploaded compressed)
    linear_device_msm_floor: int = field(
        default_factory=lambda: _env_int("BPTPU_LINEAR_DEVICE_FLOOR",
                                         1 << 20))

    # padded multiplier count from which the R1CS verification mega-MSM
    # runs on the device
    r1cs_device_msm_floor: int = field(
        default_factory=lambda: _env_int("BPTPU_R1CS_DEVICE_FLOOR", 1 << 14))

    # the reference gates R1CS behind its unstable `yoloproofs` feature;
    # on by default, enforced at proofs/r1cs import
    enable_r1cs: bool = field(
        default_factory=lambda: os.environ.get("BPTPU_ENABLE_R1CS", "1") != "0")


settings = Settings()


class VartimeFallbackWarning(RuntimeWarning):
    """A witness-carrying operation ran on the variable-time pure-Python
    path because the constant-time native backend is unavailable."""


_vartime_warned: set = set()


def vartime_witness_fallback(what: str) -> None:
    """Gate for witness-carrying operations about to run variable-time:
    raise under settings.require_consttime, warn once per call site
    otherwise (the pure-Python oracle makes no timing guarantees)."""
    if settings.require_consttime:
        raise RuntimeError(
            f"{what}: constant-time native backend unavailable and "
            "BPTPU_REQUIRE_CONSTTIME is set; refusing to run "
            "witness-carrying code on the variable-time pure-Python path")
    if what not in _vartime_warned:
        _vartime_warned.add(what)
        import warnings
        warnings.warn(
            f"{what}: running witness-carrying code on the VARIABLE-TIME "
            "pure-Python fallback (native backend unavailable); timing "
            "side-channels are not mitigated on this path",
            VartimeFallbackWarning, stacklevel=3)
