#!/usr/bin/env python3
"""The readings that set ``chip_smoke.py`` phase 15's vision-wide limits,
taken on the CPU at a reduced width:

    PYTHONPATH=src python3 tools/vision_split_fault.py

llama-3.2-vision-90b's first two layers as vision-wide cuts them
(``chip_smoke.VISION_WIDE``: the cross-attention layer and a
self-attention layer, each with its dense MLP), bf16, remat on, gates
opened to 0.5, one row of 4,096, at the width ``WIDTH`` (d_model 256, 4
heads of 64, 2 kv heads, d_ff 512, vocab 4,096; the 1,601 vision tokens
kept).  The one-rank whole run's step-0 loss and g^0, then vision-wide's
own split start (``chip_smoke._tp_wide_start``) on 2 gloo ranks of a
(1, 2) mesh twice: as it is, and with the planted fault of
``tests/test_torch_tp_cross.py`` (``cross_wo_unsummed``: the
cross-attention's row-split ``wo`` product left unsummed).  For each run
and rank, the readings phase 15 holds against ``VISION_LOSS_RTOL`` and
``VISION_G0_REL``: the step-0 loss relative to the whole run's, and each
g^0 piece's max error of its leaf's max-abs, with its root-mean-square
error of its root-mean-square; one JSON line at the end.  Exits non-zero
unless the limits pass the sound split and fail the fault.  Every process
it starts ends with it.
"""
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

WIDTH = dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
             vocab=4096)


def _config():
    from repro_torch.configs import get_config

    return get_config(cs.VISION_ARCH, **cs.VISION_WIDE, **WIDTH)


def _job(rank, ref_path, fault):
    import contextlib

    import torch

    from test_torch_tp_cross import cross_wo_unsummed

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    with cross_wo_unsummed() if fault else contextlib.nullcontext():
        out = cs._tp_wide_start(ref_path, _config(), device="cpu")[0]
    return out


def main():
    import torch

    from repro_torch.data import synthetic_batch
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.train import worker_grads
    from repro_torch.models import apply_train, init_params
    from repro_torch.models.model import param_count

    cfg = _config()
    print(f"{cfg.name}: 2 layers (cross/dense, attn/dense), d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, "
          f"{cfg.n_kv_heads} kv heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.n_vision_tokens} vision tokens, seq {cs.TRAIN_SEQ}, bf16, "
          f"remat on, gates {cs.VISION_GATE}; {param_count(cfg):,} "
          "parameters; cpu", flush=True)
    # the one-rank whole run, as chip_smoke's _vision_wide_whole
    batches = [synthetic_batch(cs.MODEL_SEED + 1 + k, cfg, 1, cs.TRAIN_SEQ,
                               device="cpu") for k in range(2)]
    params = cs._open_gates(init_params(cs.MODEL_SEED, cfg, device="cpu"),
                            cfg)
    with torch.no_grad():
        loss0 = float(apply_train(params, cfg, batches[1])[0])
    g0 = worker_grads(params, cfg, batches[0])
    print(f"whole: loss {loss0:.6f}", flush=True)
    out = {"limits": {"loss_rtol": cs.VISION_LOSS_RTOL,
                      "g0_rel": cs.VISION_G0_REL}}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "g0.pt")
        torch.save(list(g0), path)
        del params, g0
        for name, fault in (("sound", False), ("fault", True)):
            out[name] = []
            for rank, rep in enumerate(spawn(_job, 2, (path, fault),
                                             timeout=3600)):
                r = {"loss_rel": abs(rep["loss0"] - loss0) / abs(loss0),
                     "g0_max": max(rep["g0_errs"]),
                     "g0_max_min_leaf": min(rep["g0_errs"]),
                     "g0_rms": max(rep["g0_rms"])}
                r["passes"] = (r["loss_rel"] <= cs.VISION_LOSS_RTOL
                               and r["g0_max"] <= cs.VISION_G0_REL)
                out[name].append(r)
                print(f"{name} rank {rank}: loss {r['loss_rel']:.3e} "
                      f"relative; g^0 max-abs {r['g0_max']:.3e} (by leaf "
                      f"{', '.join(f'{e:.1e}' for e in rep['g0_errs'])}); "
                      f"rms {r['g0_rms']:.3e}; phase 15's checks "
                      f"{'pass' if r['passes'] else 'fail'}", flush=True)
    print(json.dumps(out))
    if not all(r["passes"] for r in out["sound"]) or \
            any(r["passes"] for r in out["fault"]):
        sys.exit("the limits do not separate the sound split from the "
                 "fault")


if __name__ == "__main__":
    main()
