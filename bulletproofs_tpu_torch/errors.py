"""Error types, mirroring the reference's layered error enums
(dalek-bulletproofs/src/errors.rs:12-167)."""

from __future__ import annotations

from typing import List


class ProofError(Exception):
    """Error in proof creation, verification, or parsing
    (reference src/errors.rs:12-54)."""

    VERIFICATION = "VerificationError"
    FORMAT = "FormatError"
    WRONG_NUM_BLINDING_FACTORS = "WrongNumBlindingFactors"
    INVALID_BITSIZE = "InvalidBitsize"
    INVALID_AGGREGATION = "InvalidAggregation"
    INVALID_GENERATORS_LENGTH = "InvalidGeneratorsLength"
    INVALID_INPUT_LENGTH = "InvalidInputLength"
    PROVING_ERROR = "ProvingError"

    def __init__(self, kind: str, message: str = None, inner: "MPCError" = None):
        self.kind = kind
        self.inner = inner
        super().__init__(message or kind)

    @classmethod
    def verification(cls):
        return cls(cls.VERIFICATION, "Proof verification failed.")

    @classmethod
    def format(cls):
        return cls(cls.FORMAT, "Proof data could not be parsed.")

    @classmethod
    def invalid_bitsize(cls):
        return cls(cls.INVALID_BITSIZE, "Invalid bitsize, must have n = 8,16,32,64.")

    @classmethod
    def invalid_aggregation(cls):
        return cls(cls.INVALID_AGGREGATION, "Invalid aggregation size, m must be a power of 2.")

    @classmethod
    def invalid_generators_length(cls):
        return cls(cls.INVALID_GENERATORS_LENGTH, "Invalid generators size, too few generators for proof")

    @classmethod
    def from_mpc(cls, e: "MPCError") -> "ProofError":
        """Layered conversion (reference src/errors.rs:56-65)."""
        if e.kind == MPCError.INVALID_BITSIZE:
            return cls.invalid_bitsize()
        if e.kind == MPCError.INVALID_AGGREGATION:
            return cls.invalid_aggregation()
        if e.kind == MPCError.INVALID_GENERATORS_LENGTH:
            return cls.invalid_generators_length()
        return cls(cls.PROVING_ERROR, f"Internal error during proof creation: {e}", inner=e)


class MPCError(Exception):
    """Error during the multiparty proof-aggregation protocol
    (reference src/errors.rs:76-120)."""

    MALICIOUS_DEALER = "MaliciousDealer"
    INVALID_BITSIZE = "InvalidBitsize"
    INVALID_AGGREGATION = "InvalidAggregation"
    INVALID_GENERATORS_LENGTH = "InvalidGeneratorsLength"
    WRONG_NUM_BIT_COMMITMENTS = "WrongNumBitCommitments"
    WRONG_NUM_POLY_COMMITMENTS = "WrongNumPolyCommitments"
    WRONG_NUM_PROOF_SHARES = "WrongNumProofShares"
    MALFORMED_PROOF_SHARES = "MalformedProofShares"

    def __init__(self, kind: str, message: str = None, bad_shares: List[int] = None):
        self.kind = kind
        self.bad_shares = bad_shares or []
        super().__init__(message or kind)

    @classmethod
    def malicious_dealer(cls):
        return cls(cls.MALICIOUS_DEALER, "Dealer gave a malicious challenge value.")

    @classmethod
    def malformed_proof_shares(cls, bad_shares: List[int]):
        return cls(cls.MALFORMED_PROOF_SHARES,
                   f"Malformed proof shares from parties {bad_shares}",
                   bad_shares=bad_shares)


class R1CSError(Exception):
    """Error during constraint-system proving/verifying
    (reference src/errors.rs:125-155)."""

    INVALID_GENERATORS_LENGTH = "InvalidGeneratorsLength"
    FORMAT = "FormatError"
    VERIFICATION = "VerificationError"
    MISSING_ASSIGNMENT = "MissingAssignment"
    GADGET_ERROR = "GadgetError"

    def __init__(self, kind: str, message: str = None):
        self.kind = kind
        super().__init__(message or kind)

    @classmethod
    def missing_assignment(cls):
        return cls(cls.MISSING_ASSIGNMENT, "Variable does not have a value assignment.")

    @classmethod
    def gadget_error(cls, description: str):
        return cls(cls.GADGET_ERROR, f"Gadget error: {description}")

    @classmethod
    def from_proof_error(cls, e: ProofError) -> "R1CSError":
        if e.kind == ProofError.INVALID_GENERATORS_LENGTH:
            return cls(cls.INVALID_GENERATORS_LENGTH)
        if e.kind == ProofError.FORMAT:
            return cls(cls.FORMAT, "Proof data could not be parsed.")
        if e.kind == ProofError.VERIFICATION:
            return cls(cls.VERIFICATION, "R1CSProof did not verify correctly.")
        raise ValueError("unexpected error type in conversion")
