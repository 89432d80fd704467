"""GF(2^255 - 19) host arithmetic and ristretto255 constants.

This is the host-side scalar core: plain Python integers, used for protocol
glue (transcript appends, single-point compressions, test oracles).  The
wide, batched counterpart lives in `bulletproofs_tpu_torch.ops.field` as
packed-limb TPU kernels; both are tested against each other.

Field semantics mirror curve25519-dalek's `FieldElement` (the reference's
L0 backend, SURVEY.md §1): little-endian 32-byte encodings with the top bit
masked on decode, canonical encodings on encode, and `IS_NEGATIVE` = lowest
bit of the canonical encoding (RFC 9496 conventions).
"""

from __future__ import annotations

P = 2 ** 255 - 19

# Edwards curve: -x^2 + y^2 = 1 + d x^2 y^2  (a = -1)
D = (-121665 * pow(121666, P - 2, P)) % P
EDWARDS_D2 = (2 * D) % P


def _nonneg_sqrt_candidate(x: int) -> int:
    """Principal square-root candidate via 2^((p-1)/4)-twists, normalized to
    the non-negative (even) representative."""
    r = pow(x, (P + 3) // 8, P)
    if (r * r) % P != x % P:
        r = (r * SQRT_M1) % P
    if (r * r) % P != x % P:
        raise ValueError("not a square")
    if r & 1:
        r = P - r
    return r


# sqrt(-1): the non-negative root (matches the dalek/RFC 9496 SQRT_M1 constant)
SQRT_M1 = pow(2, (P - 1) // 4, P)
if SQRT_M1 & 1:
    SQRT_M1 = P - SQRT_M1

ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = ((D - 1) * (D - 1)) % P
# sqrt(a*d - 1) with a = -1.  NOTE: dalek uses the *negative* (odd) root
# here -- verified against the reference's golden proof vectors.
SQRT_AD_MINUS_ONE = P - _nonneg_sqrt_candidate((-D - 1) % P)
assert SQRT_AD_MINUS_ONE == 25063068953384623474111414158702152701244531502492656460079210482610430750235
# 1/sqrt(a - d) with a = -1
INVSQRT_A_MINUS_D = pow(_nonneg_sqrt_candidate((-1 - D) % P), P - 2, P)


def fe_from_bytes(b: bytes) -> int:
    """Decode 32 little-endian bytes, masking the top bit (dalek
    `FieldElement::from_bytes`); the result may be non-canonical mod p."""
    assert len(b) == 32
    return int.from_bytes(b, "little") & ((1 << 255) - 1)


def fe_to_bytes(x: int) -> bytes:
    return (x % P).to_bytes(32, "little")


def is_negative(x: int) -> bool:
    return bool((x % P) & 1)


def ct_abs(x: int) -> int:
    x %= P
    return P - x if x & 1 else x


def invert(x: int) -> int:
    return pow(x, P - 2, P)


def sqrt_ratio_m1(u: int, v: int) -> tuple:
    """(was_square, r) with r = sqrt(u/v) or sqrt(i*u/v), non-negative.

    RFC 9496 SQRT_RATIO_M1; also computes 1/sqrt(v) when u == 1.
    """
    u %= P
    v %= P
    v3 = (v * v % P) * v % P
    v7 = (v3 * v3 % P) * v % P
    r = (u * v3 % P) * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * (r * r % P) % P

    correct = check == u
    flipped = check == (P - u) % P
    flipped_i = check == (P - u) * SQRT_M1 % P

    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    r = ct_abs(r)
    return (correct or flipped), r
