"""The port's partition rules (``repro_torch.sharding.rules``) against the
reference's (``repro.sharding.rules``), entry for entry: ``param_specs``
in the three modes, ``batch_specs`` and ``cache_specs`` on every shape of
``configs/shapes.py`` an architecture runs, and ``needs_fsdp``, for the
ten full configurations on the (16, 16) and the (2, 16, 16) production
meshes.  Shapes only: the reference's from ``jax.eval_shape`` on JAX's
``AbstractMesh``, the port's from meta tensors on its own
``AbstractMesh``.  A ``PartitionSpec`` is read as a tuple."""
from functools import partial

import jax
import pytest
from jax.sharding import AbstractMesh as RMesh
from jax.sharding import PartitionSpec

from repro.configs import get_config as ref_config
from repro.configs import shapes as ref_shapes
from repro.models.model import init_params as ref_init
from repro.sharding import rules as R
from repro_torch.configs import get_config, list_archs
from repro_torch.configs import shapes as port_shapes
from repro_torch.core.tree_utils import tree_flatten
from repro_torch.launch.mesh import P
from repro_torch.models import init_params
from repro_torch.sharding import rules as T
from repro_torch.sharding.constraints import AbstractMesh

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}
MODES = ("tp", "fsdp_tp", "zero3")


def _ref_specs(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))]


def _port_specs(tree):
    return [tuple(s) for s in tree_flatten(
        tree, is_leaf=lambda x: isinstance(x, P))[0]]


@pytest.fixture(scope="module")
def shapes():
    """arch -> (the reference's params shapes, the port's on meta)."""
    out = {}
    for arch in list_archs():
        rc = ref_config(arch)
        out[arch] = (jax.eval_shape(partial(ref_init, cfg=rc),
                                    jax.random.PRNGKey(0)),
                     init_params(0, get_config(arch), device="meta"))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_the_reference(shapes, arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    rmesh, tmesh = RMesh(sizes, names), AbstractMesh(sizes, names)
    rshape, tshape = shapes[arch]
    for mode in MODES:
        want = _ref_specs(R.param_specs(rmesh, ref_config(arch), rshape,
                                        mode=mode))
        got = _port_specs(T.param_specs(tmesh, get_config(arch), tshape,
                                        mode=mode))
        assert got == want, (arch, mesh_name, mode)
    assert T.needs_fsdp(get_config(arch)) == R.needs_fsdp(ref_config(arch))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_batch_and_cache_specs_match_the_reference(arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    rmesh, tmesh = RMesh(sizes, names), AbstractMesh(sizes, names)
    rc, tc = ref_config(arch), get_config(arch)
    ran = 0
    for name in sorted(port_shapes.SHAPES):
        rs, ts = ref_shapes.shape_for(name), port_shapes.shape_for(name)
        if port_shapes.mode_for(tc, ts) is None:
            assert ref_shapes.mode_for(rc, rs) is None
            continue
        rin = ref_shapes.input_specs(rc, rs)
        tin = port_shapes.input_specs(tc, ts)
        if ts.kind == "decode":
            got = _port_specs(T.cache_specs(tmesh, tc, tin["cache"]))
            want = _ref_specs(R.cache_specs(rmesh, rc, rin["cache"]))
            assert got == want, (arch, name)
            rin, tin = rin["batch"], tin["batch"]
        for waxes in (("data",), ("pod", "data")):
            got = _port_specs(T.batch_specs(tmesh, tin, worker_axes=waxes))
            want = _ref_specs(R.batch_specs(rmesh, rin, worker_axes=waxes))
            assert got == want, (arch, name, waxes)
        ran += 1
    assert ran >= 2


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_fsdp_held_specs_are_the_reference_state_specs(shapes, arch,
                                                       mesh_name):
    """Under fsdp_tp a rank of every family holds the reference's state
    pieces (its ``state_specs`` are ``param_specs``): the "data" and the
    "model" entries (the cross-attention decoder's and the audio
    encoder's too); under "tp" the "model" entries alone."""
    sizes, names = MESHES[mesh_name]
    rmesh, tmesh = RMesh(sizes, names), AbstractMesh(sizes, names)
    rshape, tshape = shapes[arch]
    cfg = get_config(arch)
    want = _ref_specs(R.param_specs(rmesh, ref_config(arch), rshape,
                                    mode="fsdp_tp"))
    got = _port_specs(T.held_specs(tmesh, cfg, tshape, "fsdp_tp"))
    assert T.model_split(cfg, "fsdp_tp") == "tp", arch
    assert got == want, (arch, mesh_name)
    assert any("data" in sp for sp in got), arch
    tp = _port_specs(T.held_specs(tmesh, cfg, tshape, "tp"))
    assert all("data" not in sp for sp in tp), arch
