"""The attack stage (the ported slice of repro.scenarios)."""
from .stage import AttackStage, SyntheticCohort, make_context  # noqa: F401
