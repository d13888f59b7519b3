"""Basis functions for the LSMC regression.

The string mini-DSL of the reference (``"1 + x_st + s*x0**2"``,
``BasisFunctionsBuilder.cs:90-129``) parsed into plain monomial descriptors
``(spot_power, ((factor_index, power), ...))`` and evaluated as a design
matrix on tensors — the counterpart of ``storage_tpu.basis``.  Only monomials
are ported; generic callables and the combinator DSL wait for ROADMAP Queue
1, the rest of the host layer.
"""
from __future__ import annotations

import re
import typing as tp

import torch


class Monomial(tp.NamedTuple):
    spot_power: int
    factor_powers: tp.Tuple[tp.Tuple[int, int], ...]  # ((factor_index, power), ...)

    def __str__(self) -> str:
        parts = []
        if self.spot_power:
            parts.append("s" if self.spot_power == 1 else f"s**{self.spot_power}")
        for idx, p in self.factor_powers:
            parts.append(f"x{idx}" if p == 1 else f"x{idx}**{p}")
        return " * ".join(parts) if parts else "1"


_TOKEN_RE = re.compile(r"^(?:(?P<one>1)|(?P<spot>[sS])|x(?P<factor>\d+))(?:\*\*(?P<power>\d+))?$")

# Factor aliases used by three_factor_seasonal_value (multi_factor.py:125-126).
_FACTOR_ALIASES = {"x_st": "x0", "x_lt": "x1", "x_sw": "x2"}


def parse_basis_functions(expression: str) -> tp.List[Monomial]:
    """Parse the basis-function DSL into monomials: ``+``-separated
    ``*``-products of ``1``, ``s``/``S`` (spot) and ``xN`` (Markov factor N),
    each optionally raised with ``**p``.  Repeated monomial strings raise."""
    if expression is None:
        raise ValueError("Basis function expression cannot be None.")
    for alias, canonical in _FACTOR_ALIASES.items():
        expression = expression.replace(alias, canonical)
    monomial_strs = [m.strip() for m in expression.split("+")]
    if any(not m for m in monomial_strs):
        raise ValueError("Basis function expression contains an empty monomial.")
    if len(set(monomial_strs)) < len(monomial_strs):
        raise ValueError("Basis function expression contains repeated monomials.")
    return [_parse_monomial(m) for m in monomial_strs]


def _parse_monomial(monomial: str) -> Monomial:
    spot_power = 0
    factor_powers: tp.Dict[int, int] = {}
    for token in (t.strip() for t in _split_product(monomial)):
        match = _TOKEN_RE.match(token)
        if not match:
            raise ValueError(f"Cannot parse basis function term '{token}' in '{monomial}'.")
        power = int(match.group("power")) if match.group("power") else 1
        if match.group("one"):
            continue
        if match.group("spot"):
            spot_power += power
        else:
            idx = int(match.group("factor"))
            factor_powers[idx] = factor_powers.get(idx, 0) + power
    return Monomial(spot_power, tuple(sorted(factor_powers.items())))


def _split_product(monomial: str) -> tp.List[str]:
    """Split on single ``*`` but not ``**``."""
    return [p.replace("\0", "**") for p in monomial.replace("**", "\0").split("*")]


def coerce_basis_functions(value) -> tp.List[Monomial]:
    """Accept the string DSL or a sequence of ``Monomial``; anything else
    (generic callables, combinator expressions) is not ported yet."""
    if isinstance(value, str):
        return parse_basis_functions(value)
    if isinstance(value, (list, tuple)) and all(isinstance(m, Monomial) for m in value):
        if len(set(value)) < len(value):
            raise ValueError("Basis function expression contains repeated monomials.")
        return list(value)
    raise NotImplementedError(
        "storage_tpu_torch takes basis functions as a DSL string or a list of "
        "Monomial; generic callables and the combinator DSL wait for ROADMAP "
        "Queue 1, the rest of the host layer."
    )


def num_factors_required(monomials: tp.Sequence[Monomial]) -> int:
    highest = -1
    for m in monomials:
        for idx, _ in m.factor_powers:
            highest = max(highest, idx)
    return highest + 1


def _ipow(x, p: int):
    """x**p for small static integer p via repeated multiplication."""
    result = x
    for _ in range(p - 1):
        result = result * x
    return result


def design_columns(monomials: tp.Sequence[Monomial], spot, factors) -> tp.List[torch.Tensor]:
    """The design matrix's columns, each [..., S], from ``spot`` [..., S] and
    ``factors`` [..., F, S].  Products are taken in the same order as the
    JAX package and the kernels: the spot power first, then each factor
    power in index order."""
    cols = []
    for m in monomials:
        col = torch.ones_like(spot)
        if m.spot_power:
            col = col * _ipow(spot, m.spot_power)
        for idx, p in m.factor_powers:
            col = col * _ipow(factors[..., idx, :], p)
        cols.append(col)
    return cols


def design_matrix(monomials: tp.Sequence[Monomial], spot, factors):
    """Design matrix [..., S, B] (``LsmcStorageValuation.PopulateDesignMatrix``,
    :838-855)."""
    return torch.stack(design_columns(monomials, spot, factors), dim=-1)
