"""Counterfactual scenario grids: the stress-sweep DSL (the port's copy of
the reference's ``scenario/grid.py``, which it matches id for id and bit
for bit).

A *scenario* is an ordered list of per-feature perturbations applied to the
portfolio's feature matrix before scoring: rate shocks (additive deltas),
income/DTI multipliers, or arbitrary ``set`` overrides. A *grid* is the
cross product of perturbation axes, the standard stress-testing shape
("every rate shock x every income haircut").

Determinism is the contract everything downstream leans on:

- `ScenarioGrid.expand` enumerates the cross product in a fixed order:
  axes in declaration order, the RIGHTMOST axis varying fastest (exactly
  `itertools.product`), so scenario index ``i`` means the same
  perturbation on every run, which is what lets the portfolio scorer's
  chunk checkpoints name work items ``(scenario, chunk)`` and resume.
- Scenario ids are derived from the perturbations (``installment+50,
  annual_incx0.9``), not from enumeration state, so reports stay
  join-able across runs and grids.
- `to_json`/`from_json` round-trip the axes losslessly, order included;
  the JSON form is what ``tools.score_portfolio --scenarios`` reads and
  what the scorer folds into its config fingerprint.
- `Perturbation.apply` is one float32 operation per cell (``add`` and
  ``mul`` take the value as a float32 scalar, so numpy never promotes the
  column to float64).

Perturbations are expressed on the model's *serving features* (the
post-engineering matrix), not raw application fields: a "rate shock"
against this model's 20-feature contract lands on ``installment``
(payment re-amortization is the caller's concern, not the DSL's).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

__all__ = [
    "BASELINE",
    "Perturbation",
    "Scenario",
    "ScenarioAxis",
    "ScenarioGrid",
    "feature_delta",
    "feature_multiplier",
    "feature_set",
]

#: Supported per-feature operations, in report-legend order.
OPS = ("add", "mul", "set")


def _fmt(value: float) -> str:
    return f"{value:g}"


@dataclasses.dataclass(frozen=True)
class Perturbation:
    """One feature-column edit: ``add`` a delta, ``mul`` by a factor, or
    ``set`` an override."""

    feature: str
    op: str
    value: float

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"op {self.op!r} not one of {OPS}")

    @property
    def label(self) -> str:
        if self.op == "add":
            return f"{self.feature}{self.value:+g}"
        if self.op == "mul":
            return f"{self.feature}x{_fmt(self.value)}"
        return f"{self.feature}={_fmt(self.value)}"

    def apply(self, col: np.ndarray) -> np.ndarray:
        if self.op == "add":
            return col + np.float32(self.value)
        if self.op == "mul":
            return col * np.float32(self.value)
        return np.full_like(col, np.float32(self.value))

    def to_json(self) -> dict:
        return {"feature": self.feature, "op": self.op,
                "value": float(self.value)}

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "Perturbation":
        return cls(str(obj["feature"]), str(obj["op"]), float(obj["value"]))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, ordered bundle of perturbations — one grid point."""

    scenario_id: str
    perturbations: tuple[Perturbation, ...] = ()

    @property
    def is_baseline(self) -> bool:
        return not self.perturbations

    @property
    def features(self) -> tuple[str, ...]:
        """Perturbed feature names, first-occurrence order, deduplicated."""
        seen: dict[str, None] = {}
        for p in self.perturbations:
            seen.setdefault(p.feature, None)
        return tuple(seen)

    def apply(
        self, X: np.ndarray, feature_names: Sequence[str]
    ) -> np.ndarray:
        """The perturbed copy of ``X`` (float32, input left untouched).

        Raises KeyError for a feature the model does not serve — a typo'd
        grid must fail loudly before any scoring happens."""
        index = {name: j for j, name in enumerate(feature_names)}
        out = np.array(X, dtype=np.float32, copy=True)
        for p in self.perturbations:
            if p.feature not in index:
                raise KeyError(
                    f"scenario {self.scenario_id!r} perturbs unknown "
                    f"feature {p.feature!r}"
                )
            j = index[p.feature]
            out[:, j] = p.apply(out[:, j])
        return out

    def to_json(self) -> dict:
        return {
            "id": self.scenario_id,
            "perturbations": [p.to_json() for p in self.perturbations],
        }


#: The unperturbed portfolio — always scenario 0 of a sweep.
BASELINE = Scenario("baseline", ())


@dataclasses.dataclass(frozen=True)
class ScenarioAxis:
    """One swept dimension: the same (feature, op) at each of ``values``."""

    feature: str
    op: str
    values: tuple[float, ...]

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"op {self.op!r} not one of {OPS}")
        if not self.values:
            raise ValueError(f"axis over {self.feature!r} has no values")
        object.__setattr__(
            self, "values", tuple(float(v) for v in self.values)
        )

    def points(self) -> list[Perturbation]:
        return [Perturbation(self.feature, self.op, v) for v in self.values]

    def to_json(self) -> dict:
        return {"feature": self.feature, "op": self.op,
                "values": list(self.values)}

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "ScenarioAxis":
        return cls(str(obj["feature"]), str(obj["op"]),
                   tuple(obj["values"]))


def feature_delta(feature: str, deltas: Iterable[float]) -> ScenarioAxis:
    """Additive sweep — the rate-shock shape (`+25, +50, +100` on the
    payment/rate feature the model actually serves)."""
    return ScenarioAxis(feature, "add", tuple(deltas))


def feature_multiplier(feature: str, factors: Iterable[float]) -> ScenarioAxis:
    """Multiplicative sweep — income haircuts, DTI inflation."""
    return ScenarioAxis(feature, "mul", tuple(factors))


def feature_set(feature: str, values: Iterable[float]) -> ScenarioAxis:
    """Override sweep — pin a feature to fixed stress points."""
    return ScenarioAxis(feature, "set", tuple(values))


class ScenarioGrid:
    """Cross product of axes, expanded in a deterministic order."""

    def __init__(self, axes: Sequence[ScenarioAxis], name: str = "grid"):
        self.axes = tuple(axes)
        self.name = name

    def __len__(self) -> int:
        n = 1
        for ax in self.axes:
            n *= len(ax.values)
        return n if self.axes else 0

    def expand(self) -> list[Scenario]:
        """Every grid point, axes in declaration order, rightmost axis
        fastest (`itertools.product` semantics). Ids are derived from the
        perturbations, so they are stable across runs by construction."""
        if not self.axes:
            return []
        out = []
        for combo in itertools.product(*(ax.points() for ax in self.axes)):
            out.append(
                Scenario(",".join(p.label for p in combo), tuple(combo))
            )
        return out

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "axes": [ax.to_json() for ax in self.axes],
        }

    def to_json_str(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True)

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "ScenarioGrid":
        return cls(
            [ScenarioAxis.from_json(a) for a in obj.get("axes", [])],
            name=str(obj.get("name", "grid")),
        )
