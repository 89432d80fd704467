"""The least work of a prove call's fixed-base multi-scalar
multiplications, counted from its shapes alone, and the card's peaks to
hold it against.

The program's fixed-base MSM (tables of 2^(4w) B_j for 64 windows w,
signed base-16 digits in [-7, 8], bucket accumulation) adds one table
point per non-zero digit: a mixed addition of 7 field products, each 100
limb products of two 32-bit multiply-adds (1,400 multiply-adds).  The
least work of a stream is its expected non-zero digits at that cost; the
least bytes are the table rows and digits read once and each output
point written once.  A later change of the program's digit width or
tables does not change these counts, so the roofline share reads what
the card does with the same work."""

from __future__ import annotations

import subprocess
from typing import Dict, List, Tuple

WINDOWS = 64
MADD_MADS = 1400                # multiply-adds of one mixed addition
TABLE_ROW_BYTES = 3 * 10 * 4    # a Niels point: 3 x 10 int32 limbs
POINT_BYTES = 4 * 10 * 4        # an extended output point
DIGIT_BYTES = 1

# One NVIDIA H100 SXM: HBM3 at 3.35 TB/s (data sheet); 64 32-bit integer
# multiply-adds per clock per SM (CUDA C++ Programming Guide, throughput
# of arithmetic instructions, compute capability 9.0), 132 SMs
PEAK_BYTES_PER_S = 3.35e12
IMAD_PER_CLOCK_SM = 64
SMS = 132


def carry_shares(windows: int) -> List[float]:
    """P(carry out of window w) of the signed recoding of uniform 4-bit
    windows: digit n + c above 8 becomes n + c - 16 and carries 1."""
    out, p = [], 0.0
    for _ in range(windows):
        p = (1 - p) * 7 / 16 + p * 8 / 16
        out.append(p)
    return out


def nonzero_digits(value_windows: int) -> float:
    """Expected non-zero digits of a uniform value of `value_windows`
    4-bit windows (64 bits: 16; a scalar mod l below 2^252 + 2^125: 63),
    the last carry included.  A digit is 0 when n + c is 0 or 16: 1 in 16
    whatever the carry."""
    return value_windows * 15 / 16 + carry_shares(value_windows)[-1]


UNIFORM = nonzero_digits(63)
VALUE64 = nonzero_digits(16)


def prove_streams(n: int, m: int, proofs: int) -> List[Tuple[str, int, int, float]]:
    """The fixed-base MSMs of one prove call of `proofs` statements:
    [(what, table rows, lanes, non-zero digits a lane)].  V = v B + vb B~
    a value; A = ab B~ + the bits (one +-1 digit a position); S over B~,
    G, H; T_1, T_2 over B, B~; per IPP round L and R over N + 1 bases."""
    N = n * m
    rounds = N.bit_length() - 1
    out = [("V", 2 * WINDOWS, m * proofs, VALUE64 + UNIFORM),
           ("A", WINDOWS + 2 * N, proofs, UNIFORM + N),
           ("S", (2 * N + 1) * WINDOWS, proofs, (2 * N + 1) * UNIFORM),
           ("T", 2 * WINDOWS, 2 * proofs, 2 * UNIFORM)]
    out += [("LR", (N + 1) * WINDOWS, proofs, (N + 1) * UNIFORM)] * (2 * rounds)
    return out


def stream_work(rows: int, lanes: int, nonzero_per_lane: float
                ) -> Tuple[float, float]:
    """(multiply-adds, bytes) of one fixed-base MSM."""
    mads = lanes * nonzero_per_lane * MADD_MADS
    nbytes = rows * TABLE_ROW_BYTES + rows * lanes * DIGIT_BYTES \
        + lanes * POINT_BYTES
    return mads, nbytes


def peak_imads_per_s(max_sm_mhz: float) -> float:
    return SMS * IMAD_PER_CLOCK_SM * max_sm_mhz * 1e6


def prove_bound_s(n: int, m: int, proofs: int, imads_per_s: float) -> float:
    """Least seconds of one call's fixed-base MSMs: each stream at the
    larger of its multiply-adds at the integer rate and its bytes at the
    memory rate."""
    total = 0.0
    for _, rows, lanes, nz in prove_streams(n, m, proofs):
        mads, nbytes = stream_work(rows, lanes, nz)
        total += max(mads / imads_per_s, nbytes / PEAK_BYTES_PER_S)
    return total


def card() -> Dict[str, str]:
    """The card's name, power limit and maximum SM clock, by nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name, limit, mhz = (s.strip() for s in out.split(","))
    return {"name": name, "power_limit_w": limit, "max_sm_mhz": mhz}
