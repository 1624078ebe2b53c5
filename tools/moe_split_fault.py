#!/usr/bin/env python3
"""Hold ``chip_smoke.py``'s moe-v3-full-experts checks against a planted
fault at full width on one CUDA card.

    python3 tools/moe_split_fault.py

deepseek-v3-671b cut to 2 layers (the dense prefix layer and one MoE
layer of all 256 experts), bf16, remat on, one sequence of 4,096 tokens:
phase 12's one-rank whole runs in a process of their own (train-tp-v3-
wide's, then moe-v3-full-experts': its loss, routing and the gradient
leaves its split is held to), then moe-v3-full-experts' split on 2 gloo
ranks of a (1, 2) mesh on cuda:0 twice: as it is, and with the MoE
combine's ``reduce_from_model`` left out (each rank keeps its own
experts' and its shared-expert piece's partial sum).  For each, and each
rank, the readings phase 12 holds against its limits (``V3_LOSS_RTOL``,
``V3_G_REL``): the loss routed as the whole run and on the split's own
routing, relative to the whole run's; the (token, choice) pairs the
split's own routing sends to another expert; each gradient piece's max
error of its leaf's max-abs and its root-mean-square error of its
root-mean-square.  Prints the card's name and power limit, a line per
run and rank, and one JSON line.  Needs one card with 80 GB.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


class _NoCombineReduce:
    """``models.tp`` as ``models.moe`` sees it, with
    ``reduce_from_model`` the identity: the planted fault."""

    def __getattr__(self, name):
        from repro_torch.models import tp

        return getattr(tp, name)

    @staticmethod
    def reduce_from_model(x, axis):
        return x


def _job(rank, ref_path, fault):
    import torch

    from repro_torch.models import moe

    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    if fault:
        moe.tp_mod = _NoCombineReduce()
    return cs._v3_full_split(ref_path)


def _whole(rank, card, work):
    """moe-v3-full-experts' one-rank whole run, in a process of its own."""
    import torch

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False  # as the script's runs
    return cs._v3_full_whole(card, Path(work))


def _reading(rep):
    def rel(key):
        return abs(rep[key] - rep["want_loss"]) / abs(rep["want_loss"])

    others = {k: v for k, v in rep["errs"].items() if k[1] is None}
    return {
        "loss_rel": rel("loss"), "own_loss_rel": rel("own_loss"),
        "flips": rep["flips"][0], "choices": rep["flips"][1],
        "max_abs": max(rep["errs"].values()),
        "max_abs_non_expert": max(others.values()),
        "max_abs_experts": {f"leaf {i} expert {e}": v
                            for (i, e), v in rep["errs"].items()
                            if e is not None},
        "min_max_abs": min(rep["errs"].values()),
        "rms": max(rep["rms"].values()),
        "min_rms": min(rep["rms"].values()),
        "passes": (rel("loss") <= cs.V3_LOSS_RTOL
                   and rel("own_loss") <= cs.V3_LOSS_RTOL
                   and max(rep["errs"].values()) <= cs.V3_G_REL),
    }


def main():
    import shutil

    import torch

    from repro_torch.launch.mesh import spawn

    if not torch.cuda.is_available():
        sys.exit("this needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    work = ROOT / "build" / "moe_split_fault"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {"card": card, "limits": {"loss_rtol": cs.V3_LOSS_RTOL,
                                    "g_rel": cs.V3_G_REL}}
    try:
        sys.stdout.flush()
        whole = spawn(_whole, 1, (card, str(work)),
                      timeout=cs.MOE_TIMEOUT)[0]
        # the ranks share the card at some 36 GB each (as phase 12)
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        for name, fault in (("sound", False), ("fault", True)):
            reps = spawn(_job, 2, (whole["ref"], fault),
                         timeout=cs.MOE_TIMEOUT)
            out[name] = [_reading(rep) for rep in reps]
            for rank, r in enumerate(out[name]):
                print(f"  {name} rank {rank}: loss {r['loss_rel']:.3e} "
                      f"relative routed as the whole run, "
                      f"{r['own_loss_rel']:.3e} on its own routing "
                      f"({r['flips']:,} of {r['choices']:,} choices "
                      f"elsewhere); gradient pieces of max-abs "
                      f"{r['min_max_abs']:.3e}-{r['max_abs']:.3e} "
                      f"(non-expert {r['max_abs_non_expert']:.3e}, experts "
                      f"{r['max_abs_experts']}), of rms "
                      f"{r['min_rms']:.3e}-{r['rms']:.3e}; phase 12's "
                      f"checks {'pass' if r['passes'] else 'fail'}",
                      flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    if not all(r["passes"] for r in out["sound"]) or \
            any(r["passes"] for r in out["fault"]):
        sys.exit("the limits do not separate the sound split from the "
                 "fault")


if __name__ == "__main__":
    main()
