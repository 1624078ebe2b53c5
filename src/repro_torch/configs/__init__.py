"""Architecture configs (assigned pool) + input shapes + paper problems,
the counterpart of ``repro.configs``."""
from .registry import ARCHS, get_config, get_smoke_config, list_archs  # noqa: F401
from .shapes import SHAPES, input_specs, shape_for  # noqa: F401
