"""The port's tree checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): one on-disk format, so each package
restores the other's files bit for bit, bf16 and int64 leaves included,
and a step a writer left truncated is skipped or refused."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as rckpt
from repro.checkpoint.checkpoint import \
    _flatten_with_paths as _ref_flatten_with_paths
from repro_torch import checkpoint as tckpt
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.serve import AggregationServer, ServeConfig, restore_server
from repro_torch.api import AggregatorSpec, ScheduleSpec, ServerPlan


def _values(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "f32": rng.randn(3, 5).astype(np.float32),
        "bf16": rng.randn(4, 6).astype(np.float32),  # rounded to bf16 below
        "i64": rng.randint(-2 ** 62, 2 ** 62, size=(7,), dtype=np.int64),
        "flag": rng.rand(9) > 0.5,
        "cursor": np.int64(2 ** 40 + 3),
    }


def _bits(x) -> np.ndarray:
    """The raw bytes of a leaf as a uint8 array (bf16 included)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().view(np.uint8).ravel()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).ravel()


def _ref_tree(v):
    return {"buffer": jnp.asarray(v["f32"]),
            "half": [jnp.asarray(v["bf16"], jnp.bfloat16)],
            "extra": {"cursor": v["cursor"], "ids": (v["i64"], v["flag"])}}


def _port_tree(v):
    return {"buffer": torch.from_numpy(v["f32"]),
            "half": [torch.from_numpy(v["bf16"]).to(torch.bfloat16)],
            "extra": {"cursor": v["cursor"],
                      "ids": (torch.from_numpy(v["i64"]),
                              torch.from_numpy(v["flag"]))}}


def test_path_strings_are_the_references():
    tree = {"b": [1.0, (2, 3)], "a": {"x": np.int64(1)}, "none": None,
            "c": np.zeros(2)}
    assert list(_flatten_with_paths(tree)) == \
        list(_ref_flatten_with_paths(tree))
    ints = {1: 1.0, 0: [2.0]}
    assert list(_flatten_with_paths(ints)) == \
        list(_ref_flatten_with_paths(ints)) == ["[0]%%[0]", "[1]"]


def test_reference_file_restores_bitwise_through_the_port(tmp_path):
    v = _values(1)
    ref = _ref_tree(v)
    rckpt.save(str(tmp_path), 3, ref)
    template = _port_tree(_values(2))  # other values, same dtypes/shapes
    got = tckpt.restore(str(tmp_path), 3, template)
    assert tckpt.latest_step(str(tmp_path)) == 3
    assert got["buffer"].dtype == torch.float32
    assert got["half"][0].dtype == torch.bfloat16
    assert got["extra"]["ids"][0].dtype == torch.int64
    assert got["extra"]["ids"][1].dtype == torch.bool
    assert isinstance(got["extra"]["ids"], tuple)
    assert isinstance(got["extra"]["cursor"], np.ndarray)
    assert got["extra"]["cursor"].dtype == np.int64
    want = [ref["buffer"], ref["half"][0], v["cursor"], v["i64"], v["flag"]]
    have = [got["buffer"], got["half"][0], got["extra"]["cursor"],
            got["extra"]["ids"][0], got["extra"]["ids"][1]]
    for w, h in zip(want, have):
        np.testing.assert_array_equal(_bits(h), _bits(w))


def test_port_file_restores_bitwise_through_the_reference(tmp_path):
    v = _values(3)
    port = _port_tree(v)
    tckpt.save(str(tmp_path), 5, port)
    assert rckpt.latest_step(str(tmp_path)) == 5
    other = _values(4)
    # int64 template leaves stay numpy on the reference side (x64 is off)
    template = {"buffer": jnp.asarray(other["f32"]),
                "half": [jnp.asarray(other["bf16"], jnp.bfloat16)],
                "extra": {"cursor": other["cursor"],
                          "ids": (other["i64"], jnp.asarray(other["flag"]))}}
    got = rckpt.restore(str(tmp_path), 5, template)
    assert got["half"][0].dtype == jnp.bfloat16
    assert got["extra"]["ids"][0].dtype == np.int64
    want = [port["buffer"], port["half"][0], v["cursor"],
            port["extra"]["ids"][0], port["extra"]["ids"][1]]
    have = [got["buffer"], got["half"][0], got["extra"]["cursor"],
            got["extra"]["ids"][0], got["extra"]["ids"][1]]
    for w, h in zip(want, have):
        np.testing.assert_array_equal(_bits(h), _bits(w))


def test_port_round_trip_keeps_numpy_and_tensor_leaves(tmp_path):
    tree = {"cursor": np.int64(41), "blob": np.arange(5, dtype=np.uint32),
            "w": torch.arange(6, dtype=torch.float64).reshape(2, 3),
            "h": torch.linspace(-3, 3, 7).to(torch.bfloat16),
            "none": None}
    tckpt.save(str(tmp_path), 0, tree)
    template = {"cursor": np.int64(0), "blob": np.zeros(5, np.uint32),
                "w": torch.zeros(2, 3, dtype=torch.float64),
                "h": torch.zeros(7, dtype=torch.bfloat16), "none": None}
    got = tckpt.restore(str(tmp_path), 0, template)
    assert got["none"] is None
    assert got["cursor"].dtype == np.int64 and int(got["cursor"]) == 41
    assert got["blob"].dtype == np.uint32
    assert got["w"].dtype == torch.float64
    for k in ("blob", "w", "h"):
        np.testing.assert_array_equal(_bits(got[k]), _bits(tree[k]))
    # a bf16 file leaf into a float32 numpy template: the exact values
    f32 = tckpt.restore(str(tmp_path), 0, dict(template, h=np.zeros(
        7, np.float32)))["h"]
    np.testing.assert_array_equal(f32, tree["h"].float().numpy())


def test_latest_step_skips_a_truncated_npz(tmp_path):
    d = str(tmp_path)
    tree = {"x": np.arange(4, dtype=np.float32)}
    tckpt.save(d, 1, tree)
    tckpt.save(d, 2, tree)
    path = os.path.join(d, "step_2.npz")
    with open(path, "rb") as f:
        head = f.read(40)
    with open(path, "wb") as f:  # a writer killed mid-write left this
        f.write(head)
    assert not tckpt.verify_step(d, 2)
    assert tckpt.latest_step(d) == 1
    assert tckpt.latest_step(d, verify=False) == 2
    assert tckpt.latest_step(str(tmp_path / "absent")) is None


def _server():
    plan = ServerPlan(aggregate=AggregatorSpec("cm", byz_bound=1),
                      schedule=ScheduleSpec(placement="naive",
                                            backend="torch"))
    return AggregationServer(plan, ServeConfig(n_slots=4, dim=8),
                             device="cpu")


@pytest.mark.parametrize("damage", ["missing", "truncated", "no_manifest"])
def test_restore_server_refuses_a_missing_or_damaged_step(tmp_path, damage):
    from repro_torch.serve import save_server

    d = str(tmp_path)
    save_server(_server(), d, step=0)
    if damage == "truncated":
        with open(os.path.join(d, "step_0.npz"), "wb") as f:
            f.write(b"PK\x03\x04")
    elif damage == "no_manifest":
        os.remove(os.path.join(d, "step_0.json"))
    step = 7 if damage == "missing" else 0
    with pytest.raises(ValueError, match="missing or damaged"):
        restore_server(_server(), d, step=step)
    if damage != "missing":
        assert restore_server(_server(), d) is None  # nothing usable left
