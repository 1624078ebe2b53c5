"""Logical-axis sharding rules, the counterpart of ``repro.sharding``."""
