"""Core library: the paper's engine and its parts (the ported slice)."""
from .aggregators import (  # noqa: F401
    Aggregator,
    RowSelection,
    bucketing,
    centered_clip,
    coordinate_median,
    geometric_median,
    krum,
    make_aggregator,
    mean,
    multi_krum,
    trimmed_mean,
)
from .attacks import ATTACKS, Attack, AttackContext, make_attack  # noqa: F401
from .clipping import (  # noqa: F401
    clip,
    clip_rows,
    clip_tree,
    marina_radius,
    theorem41_alpha,
    theorem42_alpha,
)
from .compressors import (  # noqa: F401
    Compressor,
    identity,
    l2_quantization,
    make_compressor,
    rand_fraction,
    rand_k,
)
from .estimators import page_update, page_update_tree, p_choice  # noqa: F401
from .heuristic import (  # noqa: F401
    ClippedPPConfig,
    ClippedPPMomentum,
    ClippedPPState,
    ClippedPPTape,
)
from .marina_pp import (  # noqa: F401
    ByzVRMarinaPP,
    MarinaPPConfig,
    MarinaPPState,
    MarinaPPTape,
)
from .problems import (  # noqa: F401
    FedProblem,
    MLPProblem,
    logistic_problem,
    mlp_problem,
    mlp_problem_from_numpy,
    problem_from_numpy,
)
from .theory import (  # noqa: F401
    MarinaTheory,
    cohort_probabilities,
    stepsize,
    theorem41_A,
    theorem42_A,
)
