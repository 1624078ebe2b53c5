"""Three faults of the port against the reference, each held by a test:

1. a NamedTuple tree checkpoints as the reference writes it: fields named
   ``.name`` (JAX's ``GetAttrKey``), so each package restores the other's
   file, and the port restores its own;
2. ``import repro_torch`` exports the reference's top-level surface
   (``__version__`` and, lazily, the ServerPlan names);
3. server snapshots read across the packages: the metrics vector holds
   the reference's 15 counters in its order, and the port's
   ``chunks_ingested`` has a key of its own, read as 0 from a reference
   snapshot.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro
import repro.api as rapi
import repro_torch
import repro_torch.api as tapi
from repro import checkpoint as rckpt
from repro.serve import AggregationServer as RServer
from repro.serve import ServeConfig as RConfig
from repro.serve import restore_server as r_restore
from repro.serve import save_server as r_save
from repro_torch import checkpoint as tckpt
from repro_torch.serve import AggregationServer as TServer
from repro_torch.serve import ServeConfig as TConfig
from repro_torch.serve import restore_server as t_restore
from repro_torch.serve import save_server as t_save
from repro_torch.serve.recovery import _METRIC_FIELDS


class State(NamedTuple):
    params: dict
    step: object
    opt: tuple


def _values(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(3, 4).astype(np.float32),
            rng.randn(5).astype(np.float32),
            rng.randint(-2 ** 62, 2 ** 62, size=(6,), dtype=np.int64),
            np.int64(2 ** 40 + seed))


def _ref_state(seed):
    w, b16, i64, step = _values(seed)
    return State({"w": jnp.asarray(w), "b": jnp.asarray(b16, jnp.bfloat16)},
                 step, (i64, jnp.asarray(w[0])))


def _port_state(seed):
    w, b16, i64, step = _values(seed)
    return State({"w": torch.from_numpy(w),
                  "b": torch.from_numpy(b16).to(torch.bfloat16)},
                 step, (i64, torch.from_numpy(w[0].copy())))


def _port_leaves(s):
    return [s.params["b"].float().numpy(), s.params["w"].numpy(),
            np.asarray(s.step), s.opt[0], s.opt[1].numpy()]


def _ref_leaves(s):
    return [np.asarray(s.params["b"]).astype(np.float32),
            np.asarray(s.params["w"]), np.asarray(s.step),
            np.asarray(s.opt[0]), np.asarray(s.opt[1])]


def test_namedtuple_reference_file_restores_through_the_port(tmp_path):
    rckpt.save(str(tmp_path), 1, _ref_state(1))
    with np.load(tmp_path / "step_1.npz") as data:
        assert ".params%%['w']" in data.files and ".opt%%[0]" in data.files
    got = tckpt.restore(str(tmp_path), 1, _port_state(2))
    assert type(got) is State
    assert got.params["b"].dtype == torch.bfloat16
    assert got.opt[0].dtype == np.int64
    for a, b in zip(_port_leaves(got), _ref_leaves(_ref_state(1))):
        np.testing.assert_array_equal(a, b)


def test_namedtuple_port_file_restores_through_the_reference(tmp_path):
    tckpt.save(str(tmp_path), 2, _port_state(3))
    template = jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, np.ndarray) else x,
        _ref_state(4))
    got = rckpt.restore(str(tmp_path), 2, template)
    assert type(got) is State
    assert np.asarray(got.params["b"]).dtype == ml_dtypes.bfloat16
    for a, b in zip(_ref_leaves(got), _port_leaves(_port_state(3))):
        np.testing.assert_array_equal(a, b)


def test_namedtuple_port_round_trip(tmp_path):
    tckpt.save(str(tmp_path), 5, _port_state(5))
    got = tckpt.restore(str(tmp_path), 5, _port_state(6))
    assert type(got) is State and isinstance(got.opt, tuple)
    assert got.params["b"].dtype == torch.bfloat16
    assert got.opt[0].dtype == np.int64
    for a, b in zip(_port_leaves(got), _port_leaves(_port_state(5))):
        np.testing.assert_array_equal(a, b)


def test_package_surface_is_the_references():
    assert set(repro_torch.__all__) == set(repro.__all__)
    assert repro_torch.__version__ == repro.__version__
    for name in repro_torch.__all__:
        if name == "__version__":
            continue
        assert getattr(repro_torch, name) is getattr(tapi, name)
        assert getattr(rapi, name) is not None
    assert set(repro_torch.__all__) <= set(dir(repro_torch))
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        repro_torch.nope


def _plan(api):
    return api.ServerPlan(aggregate=api.AggregatorSpec("krum", byz_bound=1),
                          clip=api.ClipSpec(radius=5.0),
                          schedule=api.ScheduleSpec(backend="jnp"))


def _drive(server, rows):
    """One closed round and a second one parked at fill 2 of 5."""
    for i in range(5):
        server.submit(i, rows[i])
    assert len(server.pump()) == 1
    server.submit(0, rows[5])
    server.submit(3, rows[6])
    assert server.pump() == []


def _geometry():
    return dict(n_slots=6, dim=16, cohort_size=5, seed=3)


def test_metrics_vector_is_the_references_layout():
    from repro.serve.recovery import _METRIC_FIELDS as REF_FIELDS

    assert _METRIC_FIELDS == REF_FIELDS and len(REF_FIELDS) == 15


def test_port_snapshot_restores_through_the_reference(tmp_path):
    rows = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    live = TServer(_plan(tapi), TConfig(**_geometry()), device="cpu")
    _drive(live, rows)
    t_save(live, str(tmp_path))
    clone = RServer(_plan(rapi), RConfig(**_geometry()))
    assert r_restore(clone, str(tmp_path))[0] == 1
    assert clone.round_id == 1
    want = live.metrics.snapshot()
    assert want["chunks_ingested"] > 0
    del want["chunks_ingested"]
    assert clone.metrics.snapshot() == want
    for mine, theirs in zip(clone._builder.state(), live._builder.state()):
        np.testing.assert_array_equal(np.asarray(mine), theirs.numpy())


def test_reference_snapshot_restores_through_the_port(tmp_path):
    rows = np.random.RandomState(1).randn(8, 16).astype(np.float32)
    live = RServer(_plan(rapi), RConfig(**_geometry()))
    _drive(live, rows)
    r_save(live, str(tmp_path))
    clone = TServer(_plan(tapi), TConfig(**_geometry()), device="cpu")
    clone.metrics.chunks_ingested = 7  # a reference file resets it to 0
    assert t_restore(clone, str(tmp_path))[0] == 1
    got = clone.metrics.snapshot()
    assert got.pop("chunks_ingested") == 0
    assert got == live.metrics.snapshot()
    for mine, theirs in zip(clone._builder.state(), live._builder.state()):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
