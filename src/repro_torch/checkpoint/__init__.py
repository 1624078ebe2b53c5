"""Tree checkpoints in the reference's on-disk format."""
from .checkpoint import latest_step, restore, save, verify_step  # noqa: F401
