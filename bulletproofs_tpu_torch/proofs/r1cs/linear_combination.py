"""Variables and linear combinations for the R1CS API.

Mirrors the reference's src/r1cs/linear_combination.rs: `Variable` is a
tagged index into the committed / multiplier-left / -right / -output
witness vectors (or the constant One), and `LinearCombination` is a list of
(Variable, Scalar) terms with full operator-overload algebra so gadget code
reads naturally: `cs.constrain(a + b - Scalar(7) * c)`.
"""

from __future__ import annotations

from typing import List, Tuple, Union

from ...core.scalar import Scalar

_COMMITTED = "Committed"
_MULT_LEFT = "MultiplierLeft"
_MULT_RIGHT = "MultiplierRight"
_MULT_OUTPUT = "MultiplierOutput"
_ONE = "One"


def _as_scalar(x) -> Scalar:
    if isinstance(x, Scalar):
        return x
    if isinstance(x, int):
        return Scalar(x)
    raise TypeError(f"cannot coerce {type(x)} to Scalar")


class Variable:
    """A reference to one witness slot (reference linear_combination.rs:9-20)."""

    __slots__ = ("kind", "index")

    def __init__(self, kind: str, index: int = 0):
        self.kind = kind
        self.index = index

    # constructors
    @classmethod
    def committed(cls, i: int):
        return cls(_COMMITTED, i)

    @classmethod
    def multiplier_left(cls, i: int):
        return cls(_MULT_LEFT, i)

    @classmethod
    def multiplier_right(cls, i: int):
        return cls(_MULT_RIGHT, i)

    @classmethod
    def multiplier_output(cls, i: int):
        return cls(_MULT_OUTPUT, i)

    @classmethod
    def one(cls):
        return _VAR_ONE

    def is_committed(self):
        return self.kind == _COMMITTED

    def is_multiplier_left(self):
        return self.kind == _MULT_LEFT

    def is_multiplier_right(self):
        return self.kind == _MULT_RIGHT

    def is_multiplier_output(self):
        return self.kind == _MULT_OUTPUT

    def is_one(self):
        return self.kind == _ONE

    def __repr__(self):
        return f"Variable({self.kind}, {self.index})"

    def __eq__(self, o):
        return isinstance(o, Variable) and (self.kind, self.index) == (o.kind, o.index)

    def __hash__(self):
        return hash((self.kind, self.index))

    # -- algebra: Variable promotes to LinearCombination --------------------
    def to_lc(self) -> "LinearCombination":
        return LinearCombination([(self, _SC_ONE)])

    def __add__(self, other):
        return self.to_lc() + other

    def __radd__(self, other):
        return self.to_lc() + other

    def __sub__(self, other):
        return self.to_lc() - other

    def __rsub__(self, other):
        return -(self.to_lc()) + other

    def __neg__(self):
        return -self.to_lc()

    def __mul__(self, other):
        return self.to_lc() * other

    def __rmul__(self, other):
        return self.to_lc() * other


class LinearCombination:
    """sum of coeff * variable (reference linear_combination.rs:105-197)."""

    __slots__ = ("terms",)

    def __init__(self, terms: List[Tuple[Variable, Scalar]] = None):
        self.terms = list(terms) if terms else []

    @classmethod
    def from_value(cls, x) -> "LinearCombination":
        if isinstance(x, LinearCombination):
            return cls(x.terms)
        if isinstance(x, Variable):
            return x.to_lc()
        return cls([(_VAR_ONE, _as_scalar(x))])

    def __add__(self, other):
        o = LinearCombination.from_value(other)
        return LinearCombination(self.terms + o.terms)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        o = LinearCombination.from_value(other)
        return LinearCombination(self.terms + [(v, -c) for v, c in o.terms])

    def __rsub__(self, other):
        return (-self).__add__(other)

    def __neg__(self):
        return LinearCombination([(v, -c) for v, c in self.terms])

    def __mul__(self, other):
        s = _as_scalar(other)
        return LinearCombination([(v, c * s) for v, c in self.terms])

    def __rmul__(self, other):
        return self.__mul__(other)

    def __repr__(self):
        return "LC(" + " + ".join(f"{c.v}*{v}" for v, c in self.terms) + ")"


def to_lc(x) -> LinearCombination:
    """Coerce Variable / Scalar / int / LC to a LinearCombination."""
    return LinearCombination.from_value(x)


# shared immutable singletons: gadget replay at 2^16 multipliers allocates
# hundreds of thousands of these; Scalars/Variables are value-immutable so
# sharing is safe and saves ~1 us per term
_SC_ONE = Scalar(1)
_VAR_ONE = Variable(_ONE, 0)
