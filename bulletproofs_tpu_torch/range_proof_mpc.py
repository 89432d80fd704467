"""Online multi-party computation API for aggregated range proofs.

Mirrors the reference's `range_proof_mpc` module surface
(dalek-bulletproofs/src/lib.rs:40-45): dealer and party state machines plus
the serializable message types.  The message dataclasses are the wire
format; the protocol runs identically in-process (single-party proving),
across processes, or with dealer reductions mapped to collectives
(SURVEY.md §2c.5).
"""

from .proofs import dealer, party, messages
from .proofs.dealer import (Dealer, DealerAwaitingBitCommitments,
                            DealerAwaitingPolyCommitments,
                            DealerAwaitingProofShares)
from .proofs.party import (Party, PartyAwaitingPosition,
                           PartyAwaitingBitChallenge,
                           PartyAwaitingPolyChallenge)
from .proofs.messages import (BitCommitment, BitChallenge, PolyCommitment,
                              PolyChallenge, ProofShare)
from .errors import MPCError

__all__ = [
    "dealer", "party", "messages", "Dealer", "Party", "MPCError",
    "BitCommitment", "BitChallenge", "PolyCommitment", "PolyChallenge",
    "ProofShare",
]
