"""bulletproofs_tpu_torch: the PyTorch / CUDA port of bulletproofs_tpu.

Same protocol layer as `bulletproofs_tpu` (its own copy of the host tier:
transcript, generators, host curve core, range-proof codec and prover),
with the batched range-proof verifier, the batch prover, the R1CS
verifier's and the linear proof's batch verification mega-MSMs running on
an NVIDIA H100 through hand-written CUDA kernels (`ops/`, sources in
`csrc/`).  Entry points take `device=` ("cuda" by default; tests pass
"cpu", which runs each kernel's plain PyTorch version).

Names are exported lazily: `import bulletproofs_tpu_torch` builds nothing;
the first use of the host tier builds the native host library
(`core/_native.py`), the first CUDA launch builds the kernels
(`ops/_cuda.py`).
"""

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "ProofError": ".errors", "MPCError": ".errors",
    "Transcript": ".transcript",
    "PedersenGens": ".generators", "BulletproofGens": ".generators",
    "Scalar": ".core.scalar",
    "RistrettoPoint": ".core.ristretto", "RISTRETTO_BASEPOINT": ".core.ristretto",
    "InnerProductProof": ".proofs.ipp",
    "RangeProof": ".proofs.rangeproof",
    "BatchVerifier": ".parallel.batch_verify",
    "BatchProver": ".proofs.batch_prover",
    "R1CSError": ".errors",
    "LinearProof": ".proofs.linear",
}
# submodules exported by name, as the JAX package's `r1cs` and
# `range_proof_mpc`
_MODULES = {"r1cs": ".proofs.r1cs", "range_proof_mpc": ".range_proof_mpc"}

__all__ = sorted(_EXPORTS) + sorted(_MODULES)


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(_MODULES[name], __name__)
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod, __name__), name)
