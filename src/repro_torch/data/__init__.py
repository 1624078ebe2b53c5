"""Data pipeline: synthetic token/frame streams and federated splits, the
counterpart of ``repro.data``."""
from .pipeline import TokenStream, make_batch_iterator, synthetic_batch  # noqa: F401
from .federated import dirichlet_split, federated_shards  # noqa: F401
