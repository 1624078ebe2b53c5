"""End to end: train a transformer with Byz-VR-MARINA-PP on the
port's distributed mesh trainer, the counterpart of
``examples/train_marina_pp.py``.

It runs the full path (``make_train_step``, the sharding rules, the
plan's robust-aggregation collective schedule) on the reference's
(data=4, model=2) mesh as eight ranks of ``launch.mesh.spawn`` joined in
one gloo group: four workers, one of them bit-flipping, trained on the
synthetic token pipeline.  Each worker's forward and backward pass is
split over its two "model" ranks (the tensor-parallel split of
``repro_torch.models.tp``), as the reference's GSPMD splits it: a rank
holds its pieces of params and g; the final params are gathered whole
for the digest and the checkpoint.  With ``--device cpu`` the ranks run on the
CPU; otherwise every rank runs on cuda:0 (gloo stages the card's
tensors through host memory).

    PYTHONPATH=src python -m repro_torch.train_marina_pp --steps 200
    PYTHONPATH=src python -m repro_torch.train_marina_pp --steps 8 --smoke
    PYTHONPATH=src python -m repro_torch.train_marina_pp --smoke --device cpu
"""
import argparse
import hashlib
import os
import time

import numpy as np
import torch

from repro_torch.core.tree_utils import tree_flatten
from repro_torch.models import ModelConfig, param_count, params_to_numpy

RANKS = 8  # the (data=4, model=2) mesh


def build_config(smoke: bool) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="tiny", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
            d_ff=256, vocab=512, remat=False, dtype="float32",
        )
    # ~100M params: 12L, d=640, vocab 32k
    return ModelConfig(
        name="repro-100m", n_layers=12, d_model=640, n_heads=10,
        n_kv_heads=2, d_ff=2048, vocab=32000, head_dim=64, remat=False,
        dtype="float32",
    )


def params_digest(params) -> str:
    """sha256 of the params' bytes, leaves in flatten order."""
    h = hashlib.sha256()
    for leaf in tree_flatten(params_to_numpy(params))[0]:
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()


def _rank(rank, args):
    """One rank of the run; rank 0 prints, checkpoints and returns the
    losses and the final params' digest."""
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.launch.cli import plan_from_args
    from repro_torch.launch.mesh import make_debug_mesh, num_workers
    from repro_torch.launch.train import (ByzTrainConfig, initial_state,
                                          make_train_step, train_loss)
    from repro_torch.models import init_params
    from repro_torch.models.model import gather_params
    from repro_torch.core.tree_utils import tree_map

    dev = torch.device(args.device)
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // RANKS))
    cfg = build_config(args.smoke)
    mesh = make_debug_mesh(data=4, model=2)
    W = num_workers(mesh)
    lead = rank == 0
    if lead:
        print(f"model {cfg.name}: {param_count(cfg) / 1e6:.1f}M params; "
              f"{W} workers ({args.n_byz} byzantine), mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}, device {dev}",
              flush=True)
    plan = plan_from_args(args, byz_bound=args.n_byz, clip_alpha=2.0)
    tc = ByzTrainConfig.from_plan(plan, gamma=0.3 if args.smoke else 0.1,
                                  p=0.125, n_byz=args.n_byz, attack="bf")
    step_fn = make_train_step(cfg, mesh, tc)
    # weights and batches are drawn on the CPU, so that a run on the card
    # starts from the CPU run's (a CUDA generator draws other numbers)
    it = (tree_map(lambda t: t.to(dev), b) for b in make_batch_iterator(
        cfg, W * args.per_worker_batch, args.seq, device="cpu"))
    params = tree_map(lambda t: t.to(dev), init_params(0, cfg, device="cpu"))
    batch0 = next(it)
    state = initial_state(params, cfg, mesh, tc, batch0)
    losses = []
    t0 = time.time()
    for k in range(args.steps):
        state = step_fn(state, next(it))
        if k % 10 == 0 or k == args.steps - 1:
            loss = train_loss(state.params, cfg, batch0, mesh)
            losses.append(loss)
            if lead:
                print(f"step {k:4d}  loss {loss:.4f}  "
                      f"({(time.time() - t0) / (k + 1):.2f}s/step)",
                      flush=True)
    final = gather_params(state.params, mesh, cfg)  # every rank takes part
    if not lead:
        return None
    if args.ckpt_dir:
        from repro_torch.checkpoint import save

        print("checkpoint:", save(args.ckpt_dir, args.steps, final),
              flush=True)
    return losses, params_digest(final)


def main(argv=None):
    from repro_torch._device import resolve_device
    from repro_torch.launch.cli import add_plan_args
    from repro_torch.launch.mesh import spawn

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--per-worker-batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-byz", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; every rank on cuda:0) or cpu")
    # the full server-step composition comes from the shared ServerPlan
    # flag group (repro_torch.launch.cli)
    add_plan_args(ap)
    args = ap.parse_args(argv)
    args.device = str(resolve_device(args.device))

    losses, digest = spawn(_rank, RANKS, (args,), timeout=3600)[0]
    print(f"final params sha256 {digest}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"training must reduce the loss: {losses}")
    print("OK")


if __name__ == "__main__":
    # import by the package's name, so that the spawned ranks find _rank
    from repro_torch import train_marina_pp

    train_marina_pp.main()
