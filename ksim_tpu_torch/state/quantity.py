"""Kubernetes resource.Quantity parsing with exact integer semantics.

The reference (and upstream kube-scheduler) does all resource math on
``resource.Quantity`` values lowered to int64: ``MilliValue()`` for CPU and
``Value()`` for memory/storage/pods (upstream
k8s.io/kubernetes/pkg/scheduler/framework/types.go, Resource.Add).  Bit-exact
score parity (BASELINE.md config 4) requires reproducing that lowering
exactly, so quantities are parsed to exact rationals (suffix grammar from
apimachinery/pkg/api/resource/quantity.go) and rounded the way Go does:
``Value()``/``MilliValue()`` round *up* (away from zero) to the nearest
integer at the requested scale.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from fractions import Fraction
from functools import lru_cache

# Decimal SI suffixes (powers of 10) and binary suffixes (powers of 1024).
_DECIMAL_SUFFIXES = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
}
_BINARY_SUFFIXES = {
    "Ki": Fraction(1024),
    "Mi": Fraction(1024**2),
    "Gi": Fraction(1024**3),
    "Ti": Fraction(1024**4),
    "Pi": Fraction(1024**5),
    "Ei": Fraction(1024**6),
}

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>[0-9]+(?:\.[0-9]*)?|\.[0-9]+)"
    r"(?:(?P<suffix>[numkMGTPE]|[KMGTPE]i)|[eE](?P<exp>[+-]?[0-9]+))?$"
)


def _ceil_div(a: int, b: int) -> int:
    return -((-a) // b)


@dataclass(frozen=True, slots=True)
class Quantity:
    """An exact rational resource quantity."""

    raw: Fraction

    @property
    def value(self) -> int:
        """Integer value, rounded up — matches Go Quantity.Value()."""
        return self.scaled(1)

    @property
    def milli_value(self) -> int:
        """Milli-units, rounded up — matches Go Quantity.MilliValue()."""
        return self.scaled(Fraction(1, 1000))

    def scaled(self, unit: Fraction | int) -> int:
        """Number of ``unit``-sized chunks, rounded up (away from zero).
        Cached — featurization rescales the same handful of distinct
        (value, unit) pairs for every pod every pass."""
        return _scaled_cached(self.raw, unit)

    @property
    def is_integer(self) -> bool:
        return self.raw.denominator == 1

    def __add__(self, other: "Quantity") -> "Quantity":
        return Quantity(self.raw + other.raw)

    def __str__(self) -> str:  # canonical-ish rendering for serialization
        if self.raw.denominator == 1:
            return str(self.raw.numerator)
        m = self.raw * 1000
        if m.denominator == 1:
            return f"{m.numerator}m"
        n = self.raw * 10**9
        return f"{_ceil_div(n.numerator, n.denominator)}n"


@lru_cache(maxsize=65536)
def _scaled_cached(raw: Fraction, unit: Fraction | int) -> int:
    q = raw / Fraction(unit)
    if q >= 0:
        return _ceil_div(q.numerator, q.denominator)
    return -_ceil_div(-q.numerator, q.denominator)


def parse_quantity(s: str | int | float | Quantity) -> Quantity:
    """Parse a Kubernetes quantity string ("100m", "2Gi", "1.5", "1e3").
    Cached — clusters repeat a handful of distinct quantity strings, and
    featurization parses them for every pod every scheduling pass."""
    if isinstance(s, Quantity):
        return s
    return _parse_quantity_cached(s)


@lru_cache(maxsize=65536)
def _parse_quantity_cached(s: str | int | float) -> Quantity:
    if isinstance(s, int):
        return Quantity(Fraction(s))
    if isinstance(s, float):
        return Quantity(Fraction(s).limit_denominator(10**9))
    m = _QUANTITY_RE.match(s.strip())
    if m is None:
        raise ValueError(f"invalid quantity: {s!r}")
    num = Fraction(m.group("num"))
    if m.group("sign") == "-":
        num = -num
    suffix = m.group("suffix")
    exp = m.group("exp")
    if exp is not None:
        num *= Fraction(10) ** int(exp)
    elif suffix:
        if suffix in _BINARY_SUFFIXES:
            num *= _BINARY_SUFFIXES[suffix]
        else:
            num *= _DECIMAL_SUFFIXES[suffix]
    return Quantity(num)


ZERO = Quantity(Fraction(0))
