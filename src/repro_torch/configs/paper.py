"""The paper's own experimental configurations (Section 5 / Appendix F).

fig1: homogeneous l2-regularized logistic regression (a9a-like synthetic),
      15 good + 5 byzantine, CM over Bucketing(2), shift-back, 20% sampling.
fig2: heterogeneous MLP (MNIST-like synthetic) with the eq.-10 heuristic
      around robust momentum SGD; {CM, RFA} x {BF, LF, ALIE, SHB}.
"""
from typing import Optional

from repro_torch.api import AggregatorSpec, BucketSpec, ClipSpec, ServerPlan
from repro_torch.core import ClippedPPConfig, MarinaPPConfig


def paper_plan(aggregator: str = "cm",
               clip_alpha: Optional[float] = 1.0) -> ServerPlan:
    """``aggregator`` over Bucketing(2), clipping at lambda_k =
    clip_alpha * ||x^k - x^{k-1}|| (``None``: the "no clip" baseline)."""
    return ServerPlan(
        aggregate=AggregatorSpec(aggregator),
        clip=ClipSpec(alpha=clip_alpha) if clip_alpha is not None else None,
        bucket=BucketSpec(s=2),
    )


def fig1_marina_pp(use_clipping: bool = True,
                   clip_alpha: float = 1.0) -> MarinaPPConfig:
    return MarinaPPConfig(
        gamma=0.5, p=0.2, C=4, C_hat=20, batch=32,
        plan=paper_plan("cm", clip_alpha if use_clipping else None),
        attack="shb", seed=1,
    )


def fig1_problem_kwargs() -> dict:
    return dict(n_clients=20, n_good=15, m=300, dim=40, homogeneous=True,
                l2=0.01)


def fig2_heuristic(aggregator: str = "cm", attack: str = "shb",
                   use_clipping: bool = True) -> ClippedPPConfig:
    return ClippedPPConfig(
        gamma=0.1, beta=0.9, C=4, batch=32,
        plan=paper_plan(aggregator, 1.0 if use_clipping else None),
        attack=attack,
    )


def fig2_problem_kwargs(attack: str = "shb") -> dict:
    return dict(n_clients=20, n_good=15, m=128, in_dim=32, hidden=16,
                heterogeneous=True, label_flip_byz=(attack == "lf"))
