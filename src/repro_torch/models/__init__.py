"""Model zoo: every assigned architecture as a functional PyTorch model,
the counterpart of ``repro.models``."""
from .model import (  # noqa: F401
    ModelConfig,
    apply_decode,
    apply_prefill,
    apply_train,
    init_cache,
    init_params,
    param_count,
    params_from_numpy,
    params_to_numpy,
)
