"""Quickstart: Byzantine-robust federated logistic regression on the card.

The paper's headline result (Fig. 1 left): under the shift-back attack
with 20% client sampling and 5/20 byzantine clients, Byz-VR-MARINA-PP
converges; without the clipping it diverges.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""
import argparse

from repro_torch.api import AggregatorSpec, BucketSpec, ClipSpec, ServerPlan
from repro_torch.core import ByzVRMarinaPP, MarinaPPConfig, logistic_problem


def main(device=None) -> dict:
    """Run the clipped and the unclipped configuration; returns
    {use_clipping: per-step losses}."""
    problem = logistic_problem(
        0,
        n_clients=20,
        n_good=15,  # clients 15..19 are byzantine
        m=300,
        dim=40,
        homogeneous=True,  # the paper's Fig.-1 setting (zeta = 0)
        device=device,
    )
    losses = {}
    for use_clipping in (True, False):
        plan = ServerPlan(
            aggregate=AggregatorSpec("cm"),  # coordinate median ...
            bucket=BucketSpec(s=2),          # ... with bucketing (s=2)
            # lambda_k = 1.0 * ||x^k - x^{k-1}||; dropping the clip stage
            # is the paper's diverging "no clip" ablation
            clip=ClipSpec(alpha=1.0) if use_clipping else None,
        )
        cfg = MarinaPPConfig(gamma=0.5, p=0.2, C=4, C_hat=20, batch=32,
                             plan=plan, attack="shb")
        algo = ByzVRMarinaPP(problem, cfg, device=device)
        _, metrics = algo.run(300)
        losses[use_clipping] = metrics["loss"]
        tag = "with clipping   " if use_clipping else "without clipping"
        print(f"{tag}: loss @ steps [1,100,200,300] = "
              + ", ".join(f"{float(metrics['loss'][i]):.4f}"
                          for i in (0, 99, 199, 299)))
    return losses


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    main(ap.parse_args().device)
