"""Optimizers & schedules (hand-rolled, over the port's trees), the
counterpart of ``repro.optim``."""
from .optimizers import Optimizer, adamw, momentum, sgd  # noqa: F401
from .schedules import constant, cosine_decay, warmup_cosine  # noqa: F401
