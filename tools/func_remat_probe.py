#!/usr/bin/env python3
"""Can the trainer take per-worker gradients with ``torch.func``?

    python3 tools/func_remat_probe.py [--device cpu]

The mesh trainer needs one gradient a worker.  This asks the installed
torch whether ``torch.func.vmap(torch.func.grad(loss))`` over a stack of
worker batches runs through the port's models, and whether it equals a
loop of ``torch.autograd.grad``, in three settings on the smoke configs
of a dense (minitron-8b), an MoE (arctic-480b) and an SSM (mamba2-780m)
architecture, f32, 3 workers of batch 1 x seq 16:

- ``remat``: the models as they are, remat on (``torch.utils.checkpoint``
  around every layer group and every cross-entropy chunk);
- ``no-remat``: remat off (the cross-entropy chunks still checkpointed);
- ``no-checkpoint``: ``torch.utils.checkpoint`` replaced by a plain call
  everywhere.

Prints the torch version, then one JSON line a (setting, architecture):
``ok`` and the largest difference from the loop, or the error's type
and first line.  Runs on the card unless ``--device cpu``.
"""
import argparse
import json
import sys
from pathlib import Path

ARCHS = ("minitron_8b", "arctic_480b", "mamba2_780m")
WORKERS, SEQ = 3, 16


def _probe(arch, setting, device):
    import torch
    from torch.func import grad, vmap

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.tree_utils import tree_flatten, tree_unflatten
    from repro_torch.data import synthetic_batch
    from repro_torch.models import apply_train, init_params

    cfg = get_smoke_config(arch).replace(dtype="float32",
                                         remat=setting == "remat")
    params = init_params(0, cfg, device=device)
    tokens = torch.stack([synthetic_batch(i + 1, cfg, 1, SEQ,
                                          device=device)["tokens"]
                          for i in range(WORKERS)])

    def loss(p, tok):
        return apply_train(p, cfg, {"tokens": tok})[0]

    leaves, treedef = tree_flatten(params)
    loop = []
    for w in range(WORKERS):
        ls = [leaf.detach().requires_grad_(True) for leaf in leaves]
        loop.append(torch.autograd.grad(
            loss(tree_unflatten(treedef, ls), tokens[w]), ls))
    try:
        batched, _ = tree_flatten(vmap(grad(loss), in_dims=(None, 0))(
            params, tokens))
    except Exception as e:  # the answer this probe reports
        return {"ok": False, "error": type(e).__name__,
                "message": str(e).splitlines()[0][:200]}
    err = max(float((b[w] - loop[w][i]).abs().max())
              for i, b in enumerate(batched) for w in range(WORKERS))
    return {"ok": True, "max_abs_vs_loop": err}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run off the card (default: the card)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    import torch

    from repro_torch._device import resolve_device
    from repro_torch.models import model as model_mod

    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(0) if device.type == "cuda"
            else "cpu")
    print(f"torch {torch.__version__} on {name}")
    checkpoint = model_mod.checkpoint
    for setting in ("remat", "no-remat", "no-checkpoint"):
        if setting == "no-checkpoint":
            model_mod.checkpoint = lambda fn, *a, **kw: fn(*a)
        try:
            for arch in ARCHS:
                print(json.dumps({"setting": setting, "arch": arch,
                                  **_probe(arch, setting, device)}))
        finally:
            model_mod.checkpoint = checkpoint


if __name__ == "__main__":
    main()
