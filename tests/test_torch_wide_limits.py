"""The limits of ``chip_smoke.py``'s frames-wide (phase 16) and
zero3-wide (phase 17) checks, set on the CPU at a reduced width between
the sound split and a planted fault, through the wide runs' own start
(``chip_smoke._tp_wide_start``) on 2 gloo ranks of a (1, 2) mesh.

frames-wide: hubert-xlarge's first 4 layers (``chip_smoke.FRAMES_WIDE``)
at d_model 256, 4 heads of 64, d_ff 512 (frame_dim 512 and vocab 504
kept), bf16, remat on, one row of ``SEQ`` frames with the pipeline's
targets and mask, under "tp".  The fault: the frame projection's gather
summing its gradient over "model" (``tp.gather_from_model`` in place of
``tp.gather_replicated``), which leaves the loss as it is and doubles the
frame projection's gradient.  zero3-wide: minitron-8b's 2 layers
(``chip_smoke.FSDP_WIDE``) at d_model 256, 4 heads of 64, 2 kv heads,
d_ff 512, vocab 4,096, 2 rows of ``SEQ`` under zero3, the rows split
over "model".  The fault: the reduce-scatter left out (each rank keeps
its own rows' gradient of its piece, ``DataAxis.grad`` "narrow").

Each run is held against a one-rank whole run on the same weights and
batches, as on the card: the step-0 loss relative to the whole run's and
each g^0 piece's max error of its leaf's max-abs.  The sound splits must
pass the script's limits and the faults must fail them.

The serve runs of phase 18 (``chip_smoke._serve_wide_whole`` and
``_serve_wide_split``, bf16, on 2 gloo ranks of a (1, 2) mesh) likewise:
serve-tp-wide's minitron-8b with 2 layers at d_model 256, 4 heads of 64,
2 kv heads, d_ff 512, vocab 4,096, a prefill of ``SERVE_SEQ`` and 8
decode steps of 8 rows on a cache of ``SERVE_SEQ`` from its middle less
4, across the blocks' boundary; serve-v3-wide's deepseek-v3 cut at
d_model 256, 4 heads of 32, MLA ranks 96 / 64 / 16, d_ff 64, a dense
prefix of 256, vocab 4,096, 32 experts, its decode routed as the whole
run's.  The fault: the softmax's merge over "model" left out
(``models.layers._merge_sums``).  The logits, the written slots and the
share of equal next tokens are held at the script's limits.
"""
import contextlib
import os
import sys

import pytest
import torch

from repro_torch.launch.mesh import spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)  # chip_smoke.py, which imports nothing of the port at its top

import chip_smoke as cs  # noqa: E402

SEQ = 1024
WIDTHS = {
    "frames": dict(d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
                   d_ff=512),
    "zero3": dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                  d_ff=512, vocab=4096),
}
SPAWN_TIMEOUT = 600


def _run(name):
    """(config, rows, shard mode, the script's loss and g^0 limits) of a
    wide run at the reduced width."""
    from repro_torch.configs import get_config

    if name == "frames":
        return (get_config(cs.FRAMES_ARCH, **cs.FRAMES_WIDE,
                           **WIDTHS["frames"]), (1, SEQ), "tp",
                cs.FRAMES_LOSS_RTOL, cs.FRAMES_G0_REL)
    return (get_config("minitron_8b", **cs.FSDP_WIDE, **WIDTHS["zero3"]),
            (2, SEQ), "zero3", cs.FSDP_WIDE_LOSS_RTOL, cs.TP_WIDE_G0_REL)


@contextlib.contextmanager
def _fault(name):
    """The planted fault of the run ``name``."""
    from repro_torch.models import tp
    from repro_torch.sharding.constraints import DataAxis

    if name == "frames":
        sound, tp.gather_replicated = tp.gather_replicated, \
            tp.gather_from_model
        try:
            yield
        finally:
            tp.gather_replicated = sound
        return
    sound = DataAxis.grad
    DataAxis.grad = property(lambda self: "keep" if self.worker
                             else "narrow")
    try:
        yield
    finally:
        DataAxis.grad = sound


def _job(rank, paths):
    """Both runs' split starts, sound and faulty: their readings."""
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    out = {}
    for name, path in paths.items():
        cfg, rows, mode, _, _ = _run(name)
        for fault in (False, True):
            with _fault(name) if fault else contextlib.nullcontext():
                out[(name, fault)] = cs._tp_wide_start(
                    path, cfg, mesh_shape=(1, 2), shard_mode=mode, rows=rows,
                    device="cpu")[0]
    return out


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    """Each run's whole loss and, per rank, its split readings."""
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.train import worker_grads
    from repro_torch.models import apply_train, init_params

    tmp = tmp_path_factory.mktemp("wide_limits")
    paths, losses = {}, {}
    for name in WIDTHS:
        cfg, rows, _, _, _ = _run(name)
        # the whole run, as the script's _wide_whole
        batches = [synthetic_batch(cs.MODEL_SEED + 1 + k, cfg, *rows,
                                   device="cpu") for k in range(2)]
        params = init_params(cs.MODEL_SEED, cfg, device="cpu")
        with torch.no_grad():
            losses[name] = float(apply_train(params, cfg, batches[1])[0])
        paths[name] = str(tmp / f"{name}_g0.pt")
        torch.save(list(worker_grads(params, cfg, batches[0])), paths[name])
    return losses, spawn(_job, 2, (paths,), timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("name", list(WIDTHS))
def test_wide_limits_pass_the_sound_split_and_fail_the_fault(readings, name):
    losses, ranks = readings
    _, _, _, loss_rtol, g0_rel = _run(name)
    for rank, out in enumerate(ranks):
        for fault in (False, True):
            rep = out[(name, fault)]
            assert rep["held"]["params"] == rep["want"], (rank, name)
            loss = abs(rep["loss0"] - losses[name]) / abs(losses[name])
            g0 = max(rep["g0_errs"])
            passes = loss <= loss_rtol and g0 <= g0_rel
            assert passes != fault, (rank, name, fault, loss, g0)


SERVE_SEQ = 1024
SERVE_WIDTHS = {
    "serve-tp-wide": dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                          d_ff=512, vocab=4096),
    "serve-v3-wide": dict(d_model=256, n_heads=4, head_dim=32,
                          q_lora_rank=96, kv_lora_rank=64, qk_rope_dim=16,
                          d_ff=64, first_dense_ff=256, vocab=4096),
}


def _serve_args(name):
    return dict(cfg=cs._serve_wide_cfg(name, **SERVE_WIDTHS[name]),
                seq=SERVE_SEQ, length=SERVE_SEQ, start=SERVE_SEQ // 2 - 4,
                device="cpu")


def _serve_job(rank, paths):
    """Both serve runs' splits, sound and with the merge left out."""
    from test_torch_serve_split import fault

    # one thread a rank: the runs are small, and beside the suite's other
    # workers more threads only contend for the cores
    torch.set_num_threads(1)
    out = {}
    for name, path in paths.items():
        for bad in (False, True):
            with fault("merge" if bad else None):
                out[(name, bad)] = cs._serve_wide_split(name, path,
                                                        **_serve_args(name))
    return out


@pytest.fixture(scope="module")
def serve_readings(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_limits")
    paths = {}
    for name in SERVE_WIDTHS:
        paths[name] = str(tmp / f"{name}.pt")
        cs._serve_wide_whole(name, paths[name], **_serve_args(name))
    return spawn(_serve_job, 2, (paths,), timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("name", list(SERVE_WIDTHS))
def test_serve_wide_limits_pass_the_sound_split_and_fail_the_fault(
        serve_readings, name):
    for fault in (False, True):
        worst, agree = 0.0, 1.0
        for out in serve_readings:
            rep = out[(name, fault)]
            worst = max(worst, *rep["errs"], rep.get("prefill_err", 0.0),
                        rep["slot_err"])
            agree = min(agree, rep["agree"])
        passes = worst <= cs.SERVE_WIDE_REL and agree >= cs.SERVE_WIDE_AGREE
        assert passes != fault, (name, fault, worst, agree)
