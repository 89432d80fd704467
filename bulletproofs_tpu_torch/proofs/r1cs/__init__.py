"""R1CS constraint-system proofs (the reference's `yoloproofs` feature).

Prove arbitrary rank-1 constraint systems over committed values, with the
two-phase randomized-constraint protocol (challenges bound to first-phase
commitments).  API mirrors the reference's src/r1cs/ module: gadget
functions build constraints against a ConstraintSystem, the Prover/Verifier
consume themselves to produce/check an R1CSProof built on the shared
inner-product argument.
"""

from ...config import settings as _settings

if not _settings.enable_r1cs:
    # the reference gates this entire module behind the unstable
    # `yoloproofs` Cargo feature (dalek-bulletproofs/src/lib.rs:40-49)
    raise ImportError(
        "R1CS proofs are disabled (BPTPU_ENABLE_R1CS=0, the analog of "
        "building the reference without its `yoloproofs` feature)")

from .linear_combination import Variable, LinearCombination
from .constraint_system import (ConstraintSystem, RandomizableConstraintSystem,
                                RandomizedConstraintSystem)
from .proof import R1CSProof
from .prover import Prover, RandomizingProver
from .verifier import Verifier, RandomizingVerifier, batch_verify

__all__ = [
    "Variable", "LinearCombination", "ConstraintSystem",
    "RandomizableConstraintSystem", "RandomizedConstraintSystem",
    "R1CSProof", "Prover", "RandomizingProver", "Verifier",
    "RandomizingVerifier", "batch_verify",
]
