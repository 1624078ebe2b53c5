"""Tree checkpoints in the reference's on-disk format."""
from .checkpoint import (  # noqa: F401
    has_leaf,
    latest_step,
    restore,
    save,
    verify_step,
)
