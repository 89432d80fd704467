"""Kernel K13's round step (`csrc/keccak.cuh`, launched by `csrc/keccak.cu`
`keccak_f1600_kernel`) against the port's host permutation
`utils/keccak.f1600_state` and the plain version
`keccak_device.f1600_state_bytes_plain`, on the CPU.

The header is compiled with the host g++ behind a C harness that runs the
kernel's schedule for 32 states, the block's count: five threads a state
(one a column), the 24 rounds as the kernel's two phases, each phase run
for every thread before the next begins (the kernel's barriers), the
threads in ascending or descending order (a phase must not read what
another thread of the same phase writes), the states `stride` bytes and
words apart as in shared memory.  Built twice: with the header's portable
64-bit rotation and with the card's (funnel shifts of the halves, here
emulated).  Exact bytes."""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from bulletproofs_tpu_torch.ops import keccak_device as K
from bulletproofs_tpu_torch.ops._cuda import CSRC
from bulletproofs_tpu_torch.utils.keccak import f1600_state

HARNESS = r"""
#include <stdint.h>
#include <vector>
#define __device__
#define __constant__
#define __forceinline__ inline
#ifdef FUNNEL
// the card's funnel shift: the high word of (hi:lo) << (s & 31)
#define __CUDA_ARCH__ 900
static inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, int s) {
  return (uint32_t)((((uint64_t)hi << 32 | lo) << (s & 31)) >> 32);
}
#endif
#include "keccak.cuh"

extern "C" {
// st: (200, S) bytes, state s in column s; permuted in place by the
// kernel's schedule with 5 S threads, thread t = x S + s, each of a
// round's two phases run for every thread before the next begins (the
// kernel's barriers)
void h_permute(uint8_t* st, int S, int descending) {
  const int T = 5 * S;
  std::vector<uint64_t> lanes(25 * S), par(5 * S);
  std::vector<KeccakColumn> col(T);
  for (int t = 0; t < T; ++t) col[t] = keccak_column(t / S, st + t % S, S);
  for (int t = 0; t < T; ++t) keccak_parity(col[t], par.data() + t % S, S);
  for (int rnd = 0; rnd < 24; ++rnd) {
    for (int i = 0; i < T; ++i) {
      const int t = descending ? T - 1 - i : i;
      keccak_theta_rho_pi(col[t], par.data() + t % S, lanes.data() + t % S,
                          S);
    }
    for (int i = 0; i < T; ++i) {
      const int t = descending ? T - 1 - i : i;
      keccak_chi_iota(col[t], lanes.data() + t % S, S, KECCAK_RC[rnd],
                      par.data() + t % S);
    }
  }
  for (int t = 0; t < T; ++t) keccak_store(col[t], st + t % S, S);
}
}
"""


@pytest.fixture(scope="module", params=["portable", "funnel"])
def lib(request, tmp_path_factory):
    """The harness with the header's portable rotation, and with the card's
    (two funnel shifts of the halves, emulated)."""
    d = tmp_path_factory.mktemp("keccak_header")
    src, so = d / "harness.cpp", d / f"libkeccak_{request.param}.so"
    src.write_text(HARNESS)
    flags = ["-DFUNNEL"] if request.param == "funnel" else []
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", *flags,
                    "-I", CSRC, "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=120)
    return ctypes.CDLL(str(so))


def _permute(lib, st, descending):
    out = np.ascontiguousarray(st.copy())
    lib.h_permute(out.ctypes.data_as(ctypes.c_void_p),
                  ctypes.c_int(st.shape[1]), ctypes.c_int(descending))
    return out


@pytest.mark.parametrize("descending", [0, 1])
def test_round_step_matches_host_and_plain(lib, descending):
    """32 seeded states (the all-zero and all-0xff states among them),
    once and three times over, against f1600_state and the plain
    version."""
    st = np.random.default_rng(97).integers(0, 256, (200, 32)).astype(np.uint8)
    st[:, 0] = 0
    st[:, 1] = 255
    got = _permute(lib, st, descending)
    for p in range(32):
        assert got[:, p].tobytes() == f1600_state(st[:, p].tobytes()), p
    assert np.array_equal(got, K.f1600_state_bytes_plain(
        torch.as_tensor(st)).numpy())
    again = _permute(lib, _permute(lib, got, descending), descending)
    want = torch.as_tensor(got)
    for _ in range(2):
        want = K.f1600_state_bytes_plain(want)
    assert np.array_equal(again, want.numpy())


def test_round_step_with_a_transcript_pad(lib):
    """The pad the device transcript XORs in before a permutation (the
    kernel XORs it into the staged bytes; the round step sees the padded
    state): against the plain version with the pad and the host
    permutation of state ^ pad."""
    rng = np.random.default_rng(98)
    st = rng.integers(0, 256, (200, 32)).astype(np.uint8)
    pad = np.zeros((200, 1), np.uint8)
    pad[[0, 1, 40, 167], 0] = [3, 0x04, 0x55, 0x80]
    got = _permute(lib, st ^ pad, 0)
    assert np.array_equal(got, K.f1600_state_bytes_plain(
        torch.as_tensor(st), torch.as_tensor(pad)).numpy())
    for p in (0, 17, 31):
        assert got[:, p].tobytes() == f1600_state((st[:, p] ^ pad[:, 0])
                                                  .tobytes())
