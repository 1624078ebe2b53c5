"""The paper's Fig. 1 configuration (Section 5 / Appendix F): homogeneous
l2-regularized logistic regression (a9a-like synthetic), 15 good + 5
byzantine, CM over Bucketing(2), shift-back, 20% sampling.  Fig. 2 comes
with ROADMAP queue 1 item 7."""
from typing import Optional

from repro_torch.api import AggregatorSpec, BucketSpec, ClipSpec, ServerPlan
from repro_torch.core import MarinaPPConfig


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
