"""The attack stage of the engine (the ported slice of repro.scenarios)."""
from .stage import AttackStage, make_context  # noqa: F401
