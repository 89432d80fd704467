"""Arithmetic mod l = 2^252 + 27742317777372353535851937790883648493 on
int64 tensors (the JAX package's ops/vec_scalar.py): the wrappers of
kernels K14 and K17-K20 with their plain PyTorch versions, the twins of
csrc/sc25519.cuh and csrc/sc_vec.cuh.

Layout (ops/limbs.py): (..., 9, N) limbs of 29 bits, kept CANONICAL
(exact limbs, value < l) between operations, so sums never need a lazy
headroom analysis and digit extraction needs no renormalisation.
Multiplication is Montgomery (CIOS, R = 2^261): `mont_mul(a, b)` =
a b R^-1 mod l.  Callers either work in the Montgomery domain
(`to_mont` / `from_mont`, as the emit kernel does) or use `smul`, which
multiplies plain canonical values.

Kernels (csrc/scalar.cu, csrc/fold.cu), one launch per call:
`mont_mul` and `smul` are K17 sc_mul (`to_mont`, `from_mont` and
`sreduce` by composition), `sadd` and `sneg` K18 sc_add, `tree_sum` and
`tree_sum_prefix` K19 sc_tree_sum (two launches where a second adds its
row slices), `from_wide_bytes` K20 chacha_scalars (its wide form; the
same kernel draws ops/chacha.random_scalars) and `sinv` K14.  Each
wrapper runs its plain version (`*_plain`) for a CPU tensor and launches
its kernel for a CUDA tensor.  K17 and K18 broadcast like the plain
versions: each operand goes to the kernel with its strides, 0 where it
is broadcast, and the output is a fresh contiguous tensor of the
broadcast shape.  A wrapper never reads a tensor's value on the host.
The plain versions call only plain versions: they are the oracles that
the kernels (K2, K8, K9 and K14 too) are held to on the card.

Column bound of `mont_mul`: each of the 9 rounds adds at most two 58-bit
products to a limb position, 9 * 2^59 < 2^63, so int64 holds it.
"""

from __future__ import annotations

import torch

from ..core.scalar import L as ELL
from . import _cuda
from .limbs import SC_BITS, SC_LIMBS, SC_MASK, sc_from_bytes, \
    sc_ints_to_limbs

L = SC_LIMBS
R_BITS = SC_BITS * SC_LIMBS
LINV = (-pow(ELL, -1, 1 << SC_BITS)) % (1 << SC_BITS)     # -l^-1 mod 2^29
R2 = pow(2, 2 * R_BITS, ELL)                              # R^2 mod l
ONE_M = pow(2, R_BITS, ELL)                               # R mod l (1 in Montgomery form)
W256_M = pow(2, 256 + R_BITS, ELL)                        # 2^256 R mod l

_CONSTS = {}


def const(v: int, device) -> torch.Tensor:
    """(9, 1) int64 limbs of the Python int v (< 2^261) on `device`."""
    key = (v, str(device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.as_tensor(sc_ints_to_limbs([v]), device=device)
    return _CONSTS[key]


def normalize(t: torch.Tensor) -> torch.Tensor:
    """Sequential carry: exact 29-bit limbs, the top limb keeps the rest
    (signed inputs allowed; the value must be >= 0 for exact limbs)."""
    rows = list(t.unbind(-2))
    for k in range(len(rows) - 1):
        c = rows[k] >> SC_BITS
        rows[k] = rows[k] & SC_MASK
        rows[k + 1] = rows[k + 1] + c
    return torch.stack(rows, dim=-2)


def cond_sub_l(t: torch.Tensor) -> torch.Tensor:
    """Exact limbs of a value < 2l -> the value mod l."""
    d = normalize(t - const(ELL, t.device))
    return torch.where((d[..., L - 1:, :] < 0), t, d)


# -- the kernels' operands -----------------------------------------------------

def _row_groups(shape, views):
    """The leading dimensions of `shape` merged into at most two row
    groups, each a size and one stride per view (dims merge while every
    view's strides allow: its outer stride = inner stride x inner size)
    -> ((R0, R1), [(s0, s1) per view])."""
    groups = []
    for d, size in enumerate(shape[:-2]):
        if size == 1:
            continue
        st = [v.stride(d) for v in views]
        if groups and all(g == s * size for g, s in zip(groups[-1][1], st)):
            groups[-1] = [groups[-1][0] * size, st]
        else:
            groups.append([size, st])
    if len(groups) > 2:
        raise ValueError(f"scalar kernels take at most two row dimensions "
                         f"that do not merge, got shape {tuple(shape)}")
    while len(groups) < 2:
        groups.insert(0, [1, [0] * len(views)])
    (r0, s0), (r1, s1) = groups
    return (r0, r1), list(zip(s0, s1))


def _launch_elementwise(kernel: str, fn: str, code: int, a, b):
    """K17 / K18 on CUDA operands a and b (b None for a unary op): shapes
    (..., 9, P) broadcast against each other, every operand passed with
    its (row0, row1, limb, column) strides -> a fresh contiguous output."""
    ops = [a] if b is None else [a, b]
    for t in ops:
        if t.device.type != "cuda":
            raise ValueError(f"{fn}: expected CUDA tensors, got one on "
                             f"{t.device}")
        if t.dtype != torch.int64:
            raise TypeError(f"{fn}: expected torch.int64, got {t.dtype}")
        if t.dim() < 2 or t.shape[-2] != L:
            raise ValueError(f"{fn}: expected (..., {L}, P) limbs, got "
                             f"{tuple(t.shape)}")
    shape = torch.broadcast_shapes(*(t.shape for t in ops))
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    if out.numel() == 0:
        return out
    views = [t.expand(shape) for t in ops]
    (r0, r1), rows = _row_groups(shape, views)
    args = []
    for t, v, (s0, s1) in zip(ops, views, rows):
        args += [t, s0, s1, v.stride(-2), v.stride(-1)]
    if b is None:
        args += [None, 0, 0, 0, 0]
    _cuda.launch(kernel, "scalar", fn, *args, out, r0, r1, shape[-1], code)
    return out


# -- K17: products -------------------------------------------------------------

def mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical a, b -> canonical a b R^-1 mod l (CIOS Montgomery)."""
    a, b = torch.broadcast_tensors(a, b)
    ell = const(ELL, a.device)
    t = torch.zeros(a.shape[:-2] + (L + 1,) + a.shape[-1:],
                    dtype=torch.int64, device=a.device)
    zero = torch.zeros_like(t[..., :1, :])
    for i in range(L):
        t[..., :L, :] += a[..., i: i + 1, :] * b
        mq = ((t[..., :1, :] & SC_MASK) * LINV) & SC_MASK
        t[..., :L, :] += mq * ell
        c = t[..., :1, :] >> SC_BITS
        t = torch.cat([t[..., 1:2, :] + c, t[..., 2:, :], zero], dim=-2)
    return cond_sub_l(normalize(t[..., :L, :]))


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < R, b < l, (..., 9, P) broadcast against each other -> canonical
    a b R^-1 mod l: kernel K17 (mode 0) on CUDA tensors."""
    if a.device.type == "cpu":
        return mont_mul_plain(a, b)
    return _launch_elementwise("sc_mul", "bp_sc_mul", 0, a, b)


def smul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return mont_mul_plain(mont_mul_plain(a, b), const(R2, a.device))


def smul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical a, b -> a b mod l: kernel K17 (mode 1, both Montgomery
    products in one launch) on CUDA tensors."""
    if a.device.type == "cpu":
        return smul_plain(a, b)
    return _launch_elementwise("sc_mul", "bp_sc_mul", 1, a, b)


def to_mont_plain(x: torch.Tensor) -> torch.Tensor:
    return mont_mul_plain(x, const(R2, x.device))


def to_mont(x: torch.Tensor) -> torch.Tensor:
    """x (any value < 2^256, exact limbs) -> x R mod l."""
    return mont_mul(x, const(R2, x.device))


def from_mont_plain(x: torch.Tensor) -> torch.Tensor:
    return mont_mul_plain(x, const(1, x.device))


def from_mont(x: torch.Tensor) -> torch.Tensor:
    return mont_mul(x, const(1, x.device))


def sreduce_plain(x: torch.Tensor) -> torch.Tensor:
    return from_mont_plain(to_mont_plain(x))


def sreduce(x: torch.Tensor) -> torch.Tensor:
    """Exact limbs of any value < 2^256 -> the value mod l."""
    return from_mont(to_mont(x))


# -- K18: sums -----------------------------------------------------------------

def sadd_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return cond_sub_l(normalize(a + b))


def sadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical a, b -> a + b mod l: kernel K18 (op 0) on CUDA tensors."""
    if a.device.type == "cpu":
        return sadd_plain(a, b)
    return _launch_elementwise("sc_add", "bp_sc_add", 0, a, b)


def sneg_plain(a: torch.Tensor) -> torch.Tensor:
    return cond_sub_l(normalize(const(ELL, a.device) - a))


def sneg(a: torch.Tensor) -> torch.Tensor:
    """Canonical a -> -a mod l: kernel K18 (op 1) on a CUDA tensor."""
    if a.device.type == "cpu":
        return sneg_plain(a)
    return _launch_elementwise("sc_add", "bp_sc_add", 1, a, None)


def reduce_top(x: torch.Tensor) -> torch.Tensor:
    """Exact limbs of any value < 2^261 -> the value mod l
    (csrc/sc25519.cuh sc_reduce_top): with q = floor(x / 2^252) < 2^9,
    x - q l lies in (-l, 2^252), so one conditional addition of l ends it.
    The identity on canonical x."""
    q = x[..., L - 1:, :] >> 20                  # limb 8 starts at bit 232
    e = normalize(x - q * const(ELL, x.device))
    return normalize(e + torch.where(e[..., L - 1:, :] < 0,
                                     const(ELL, x.device), 0))


# -- K14: inversion ------------------------------------------------------------

# bits of the Fermat exponent l - 2, most significant first
_INV_BITS = [(ELL - 2) >> i & 1
             for i in range((ELL - 2).bit_length() - 1, -1, -1)]


def sinv_plain(x: torch.Tensor) -> torch.Tensor:
    """Canonical x -> x^(l-2) mod l = x^-1, canonical (0 -> 0): the
    square-and-multiply ladder over the static bits of l - 2, most
    significant first, in Montgomery form, starting at the top bit.  Kernel
    K14 (csrc/sc25519.cuh sc_invert) computes the same inverse by another
    algorithm, a safegcd of fixed length; both are exact and canonical, so
    their limbs agree, and each checks the other."""
    xm = to_mont_plain(x)
    acc = xm
    for bit in _INV_BITS[1:]:
        acc = mont_mul_plain(acc, acc)
        if bit:
            acc = mont_mul_plain(acc, xm)
    return from_mont_plain(acc)


def sinv(x: torch.Tensor) -> torch.Tensor:
    """(9, P) canonical scalars -> their inverses mod l, 0 -> 0
    (vec_scalar.sinv): kernel K14 (csrc/fold.cu, a safegcd inversion) on a
    CUDA tensor, the plain version (the Fermat ladder) on a CPU tensor."""
    if x.dim() != 2 or x.shape[0] != L or x.dtype != torch.int64:
        raise ValueError(f"sinv takes a ({L}, P) int64 tensor")
    if x.device.type == "cpu":
        return sinv_plain(x)
    x = _cuda.check(x, torch.int64)
    out = torch.empty_like(x)
    if x.shape[1]:
        _cuda.launch("sinv", "fold", "bp_sinv", x, out, x.shape[1])
    return out


# -- K20 (wide form): 64-byte values mod l -------------------------------------

def from_bytes32(raw: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 little-endian -> (9, N) exact limbs (value < 2^256)."""
    return sc_from_bytes(raw)


def from_wide_bytes_plain(raw: torch.Tensor) -> torch.Tensor:
    lo = from_bytes32(raw[:, :32].contiguous())
    hi = from_bytes32(raw[:, 32:].contiguous())
    return sadd_plain(smul_plain(hi, const(pow(2, 256, ELL), raw.device)),
                      sreduce_plain(lo))


def from_wide_bytes(raw: torch.Tensor) -> torch.Tensor:
    """(N, 64) uint8 of any strides -> (9, N) canonical (lo + 2^256 hi) mod
    l (vec_scalar.from_wide_bytes; the host's rp_reduce_wide): kernel K20's
    wide form on a CUDA tensor."""
    if raw.dim() != 2 or raw.shape[1] != 64 or raw.dtype != torch.uint8:
        raise ValueError(f"from_wide_bytes takes an (N, 64) uint8 tensor, "
                         f"got {raw.dtype} {tuple(raw.shape)}")
    if raw.device.type == "cpu":
        return from_wide_bytes_plain(raw)
    n = raw.shape[0]
    out = torch.empty((L, n), dtype=torch.int64, device=raw.device)
    if n:
        _cuda.launch("chacha_scalars", "scalar", "bp_chacha_scalars", raw,
                     raw.stride(0), raw.stride(1), *[0] * 8, out, n)
    return out


# -- sequences and K19: sums over rows -----------------------------------------

def power_sequence(y: torch.Tensor, n: int) -> torch.Tensor:
    """y (9, P) canonical -> (n, 9, P): [1, y, .., y^(n-1)]
    (vec_scalar.power_sequence).  Built by doubling the prefix (log2 n
    vector multiplications instead of n - 1 serial ones); the values are
    canonical, so the order of multiplication does not show."""
    seq = const(1, y.device).expand_as(y)[None]
    step = y
    while seq.shape[0] < n:
        seq = torch.cat([seq, smul(seq, step)])
        step = smul(step, step)
    return seq[:n].contiguous()


def tree_sum_plain(v: torch.Tensor) -> torch.Tensor:
    while v.shape[0] > 1:
        h = v.shape[0] // 2
        lo = sadd_plain(v[:h], v[h: 2 * h])
        v = torch.cat([lo, v[2 * h:]]) if v.shape[0] % 2 else lo
    return v[0]


# K19's first launch: 32 columns a block; where those blocks number fewer
# than half an H100's 132 SMs, it splits the rows into slices as well,
# until there are about two blocks an SM, a slice at least 32 rows (four
# a thread); a second launch then adds the slices' sums.  (On an H100,
# from memory, one launch beat two slices at 64 x 4096, and 17 slices
# beat more at 1024 x 512.)
TS_COLS = 32
_TS_SMS = 132
_TS_MIN_ROWS = 32


def tree_slices(n: int, P: int) -> int:
    """Row slices of K19's first launch over n rows of P columns: 1 (one
    launch) when its column blocks fill half the card or the rows are
    few, else one more launch adds the slices' sums."""
    cols = -(-P // TS_COLS)
    if 2 * cols >= _TS_SMS:
        return 1
    return max(1, min(-(-2 * _TS_SMS // max(cols, 1)), n // _TS_MIN_ROWS))


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """(n, 9, P) canonical, n >= 1 -> (9, P) their sum mod l
    (vec_scalar.tree_sum): by halving over the leading axis on the CPU,
    kernel K19 on a CUDA tensor (row slices of 32 columns a block, then,
    where there are several slices, a second launch adding them); the sum
    is canonical, so the order does not show."""
    if v.dim() != 3 or v.shape[1] != L or v.shape[0] == 0:
        raise ValueError(f"tree_sum takes an (n >= 1, {L}, P) tensor, got "
                         f"{tuple(v.shape)}")
    if v.device.type == "cpu":
        return tree_sum_plain(v)
    return _tree_sum_launch(v, None, None)


def tree_sum_prefix_plain(x: torch.Tensor, y: torch.Tensor,
                          h: torch.Tensor) -> torch.Tensor:
    live = (torch.arange(x.shape[0], device=x.device) < h)[:, None, None]
    return tree_sum_plain(torch.where(live, torch.cat([x, y], dim=-1), 0))


def tree_sum_prefix(x: torch.Tensor, y: torch.Tensor,
                    h: torch.Tensor) -> torch.Tensor:
    """x, y (n, 9, P) canonical of any strides, h a 0-dim int64 tensor (the
    rows to sum, at most n) -> (9, 2P) [sum of x[:h] | sum of y[:h]] mod
    l: the IPP round's two cross terms (prover_stages.round_emit_dyn).  On
    the CPU the masked composition tree_sum(where(j < h, cat([x, y]),
    0)); on CUDA tensors kernel K19 reading both operands by their strides
    and h from device memory, so that every round launches the same."""
    if x.dim() != 3 or x.shape[1] != L or x.shape != y.shape \
            or x.shape[0] == 0 or h.dim() != 0:
        raise ValueError(f"tree_sum_prefix takes two (n >= 1, {L}, P) "
                         f"tensors and a 0-dim row count, got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}, "
                         f"{tuple(h.shape)}")
    if x.device.type == "cpu":
        return tree_sum_prefix_plain(x, y, h)
    if h.dtype != torch.int64 or h.device != x.device:
        raise TypeError(f"tree_sum_prefix: h must be int64 on {x.device}")
    return _tree_sum_launch(x, y, h)


def _tree_sum_launch(a: torch.Tensor, b, h) -> torch.Tensor:
    """K19 over the columns of a, then of b (None: a alone), and the rows
    below h (None: all): one launch over tree_slices slices, and one
    adding the slices when there are several."""
    for t in (a, b):
        if t is not None and t.dtype != torch.int64:
            raise TypeError(f"tree_sum: expected torch.int64, got {t.dtype}")
    n, _, Pa = a.shape
    Pt = Pa if b is None else 2 * Pa
    out = torch.empty((L, Pt), dtype=torch.int64, device=a.device)
    if not Pt:
        return out
    k = tree_slices(n, Pt)
    part = out if k == 1 else torch.empty((k, L, Pt), dtype=torch.int64,
                                          device=a.device)
    bv = (None, 0, 0, 0) if b is None else (b,) + b.stride()
    _cuda.launch("sc_tree_sum", "scalar", "bp_sc_tree_sum", a, *a.stride(),
                 *bv, Pa, Pt, n, h, part, k)
    if k > 1:
        _cuda.launch("sc_tree_sum", "scalar", "bp_sc_tree_sum", part,
                     L * Pt, Pt, 1, None, 0, 0, 0, Pt, Pt, k, None, out, 1)
    return out


# 64 nibbles: nibble w covers bits [4w, 4w + 4), inside one limb or across
# two (29 is odd)
_NIB = [((4 * w) // SC_BITS, (4 * w) % SC_BITS) for w in range(64)]


def digits64(x: torch.Tensor) -> torch.Tensor:
    """(..., 9, N) exact limbs (value < 2^256) -> (..., 64, N) int64
    unsigned 4-bit digits."""
    padded = torch.cat([x, torch.zeros_like(x[..., :1, :])], dim=-2)
    rows = []
    for limb, off in _NIB:
        v = padded[..., limb, :] >> off
        if off > SC_BITS - 4:
            v = v | (padded[..., limb + 1, :] << (SC_BITS - off))
        rows.append(v & 15)
    return torch.stack(rows, dim=-2)


_SEVENS = sum(7 << (4 * w) for w in range(64))


def signed_digits(x: torch.Tensor) -> torch.Tensor:
    """(9, N) canonical scalars -> (64, N) int8 signed base-16 digits in
    [-7, 8] with sum_w d_w 16^w = x.  Digits of x + 0x77..7, minus 7: the
    same digits as the sequential recode (msm.to_signed_digits), since
    [-7, 8] is a complete residue system mod 16; valid for x < 8 * 2^252."""
    biased = normalize(x + const(_SEVENS % (1 << 261), x.device))
    return (digits64(biased) - 7).to(torch.int8)
