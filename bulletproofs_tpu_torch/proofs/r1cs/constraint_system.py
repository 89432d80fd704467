"""Constraint-system interfaces (reference src/r1cs/constraint_system.rs).

Gadget functions are written against `ConstraintSystem` so the same code
builds the constraints for both proving and verification.  The two-phase
protocol: constraints registered via `specify_randomized_constraints` run
after the first-phase witness is committed, with access to transcript-bound
challenge scalars (`RandomizedConstraintSystem.challenge_scalar`).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, Optional, Tuple

from ...core.scalar import Scalar
from .linear_combination import LinearCombination, Variable


class ConstraintSystem(ABC):
    """The interface gadgets program against (reference
    constraint_system.rs:19-77)."""

    @abstractmethod
    def transcript(self):
        """The proof transcript, for committing gadget-specific public data."""

    @abstractmethod
    def multiply(self, left, right) -> Tuple[Variable, Variable, Variable]:
        """Allocate a multiplication gate l*r=o with l=left, r=right
        constrained; returns (l, r, o)."""

    @abstractmethod
    def allocate(self, assignment: Optional[Scalar]) -> Variable:
        """Allocate one low-level variable (packed pairwise into gates)."""

    @abstractmethod
    def allocate_multiplier(self, input_assignments: Optional[Tuple[Scalar, Scalar]]
                            ) -> Tuple[Variable, Variable, Variable]:
        """Allocate an unconstrained multiplication gate."""

    @abstractmethod
    def multipliers_len(self) -> int:
        """Number of allocated multipliers."""

    @abstractmethod
    def constrain(self, lc) -> None:
        """Enforce lc == 0."""


class RandomizableConstraintSystem(ConstraintSystem):
    """CS supporting deferred randomized constraints
    (reference constraint_system.rs:84-110)."""

    @abstractmethod
    def specify_randomized_constraints(self, callback: Callable) -> None:
        """Defer `callback(randomized_cs)` to the randomization phase."""


class RandomizedConstraintSystem(ConstraintSystem):
    """CS in the randomization phase (reference constraint_system.rs:117-135)."""

    @abstractmethod
    def challenge_scalar(self, label: bytes) -> Scalar:
        """Draw a challenge bound to the first-phase commitments."""
