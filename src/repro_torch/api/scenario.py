"""``ScenarioSpec``: the declarative adversarial scenario beside
``ServerPlan``, the counterpart of ``repro.api.scenario``.

A plan says how the server aggregates; a scenario says what it is up
against: the attack the byzantine workers mount, how many of them there
are, and the attack's tunables.  It is frozen, validated at construction
(``PlanError``) and reads and writes the reference's canonical JSON, so
one document names a scenario in both packages:

    spec = ScenarioSpec(attack="alie", byz_frac=0.25, z_max=2.0)
    attack = spec.build()            # the registry Attack, tunables bound
    spec = ScenarioSpec(attack="adaptive", budget=8)
    attack = spec.build(plan)        # gradient ascent against THIS plan

``attack`` is a ``repro_torch.core.attacks`` registry name or one of the
adaptive kinds, ``"adaptive"`` (the deviation objective by default) and
``"autogm"`` (the min-max descent objective), which optimise against a
``ServerPlan`` and therefore need ``build(plan)``.  ``byz_frac`` is read
by the launchers when they make the cohort; ``n_byz(n)`` maps it to a
count.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

from .plan import PlanError

__all__ = ["ScenarioSpec", "ADAPTIVE_ATTACKS"]

ADAPTIVE_ATTACKS = ("adaptive", "autogm")
_OBJECTIVES = ("deviation", "descent")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One adversarial scenario.

    ``attack``     registry name (none/bf/sf/lf/alie/ipm/shb/gauss) or
                   "adaptive" / "autogm"
    ``byz_frac``   byzantine fraction in [0, 1] (None: the caller owns
                   the count)
    ``z_max``      ALIE strength; ``eps`` IPM scale; ``scale`` gauss scale
    ``budget``, ``lr``, ``objective``  the adaptive adversary's tunables
    """

    attack: str = "none"
    byz_frac: Optional[float] = None
    z_max: float = 1.5
    eps: float = 1.1
    scale: float = 10.0
    budget: int = 8
    lr: float = 0.5
    objective: str = "deviation"

    def __post_init__(self):
        from ..core.attacks import ATTACKS

        known = set(ATTACKS) | set(ADAPTIVE_ATTACKS)
        if self.attack not in known:
            raise PlanError(f"unknown scenario attack {self.attack!r}; have "
                            f"{sorted(known)}")
        if self.byz_frac is not None and not 0.0 <= self.byz_frac <= 1.0:
            raise PlanError(f"byz_frac must be in [0, 1], got {self.byz_frac}")
        for name in ("z_max", "eps", "scale", "lr"):
            v = getattr(self, name)
            if not v > 0:
                raise PlanError(f"{name} must be > 0, got {v}")
        if self.budget < 1:
            raise PlanError(f"adaptive budget must be >= 1, got {self.budget}")
        if self.objective not in _OBJECTIVES:
            raise PlanError(f"unknown adaptive objective {self.objective!r}; "
                            f"have {_OBJECTIVES}")

    def n_byz(self, n: int) -> Optional[int]:
        """The byzantine count of an ``n``-client cohort (None when the
        scenario leaves it to the caller)."""
        if self.byz_frac is None:
            return None
        return int(round(self.byz_frac * n))

    def build(self, plan=None):
        """The scenario's :class:`repro_torch.core.attacks.Attack`: the
        adaptive kinds optimise against ``plan`` (required for them),
        registry attacks get their tunables bound."""
        from ..core.attacks import make_attack

        if self.attack in ADAPTIVE_ATTACKS:
            if plan is None:
                raise PlanError(
                    f"attack {self.attack!r} gradient-ascends against the "
                    "server's aggregation rule; pass the ServerPlan: "
                    "spec.build(plan)")
            from ..scenarios.adaptive import make_adaptive_attack

            objective = ("descent" if self.attack == "autogm"
                         else self.objective)
            return make_adaptive_attack(plan, budget=self.budget, lr=self.lr,
                                        objective=objective, name=self.attack)
        params = {"alie": {"z_max": self.z_max}, "ipm": {"eps": self.eps},
                  "gauss": {"scale": self.scale}}.get(self.attack, {})
        return make_attack(self.attack, **params)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise PlanError(f"unknown scenario fields {sorted(unknown)}; have "
                            f"{sorted(fields)}")
        return cls(**d)

    @classmethod
    def from_json(cls, doc: str) -> "ScenarioSpec":
        try:
            d = json.loads(doc)
        except ValueError as e:
            raise PlanError(f"unparseable scenario JSON: {e}") from e
        if not isinstance(d, dict):
            raise PlanError("scenario JSON must be an object")
        return cls.from_dict(d)
