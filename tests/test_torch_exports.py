"""The port's packages export the reference's names.

For each package of ``repro`` (and ``repro.kernels.ops``), every name it
exports, its ``__all__`` or, where it has none (``repro.kernels``,
``repro.core``, ...), the public names bound in it that are not
submodules, must be importable from the port's counterpart.  Where the
reference binds a function, the port's object must be callable and not a
module (``repro.kernels`` binds the functions ``krum``,
``centered_clip``, ``clipped_diff``, ``geometric_median`` under their
modules' names); where it binds a class, the port's must be a class.
"""
import importlib
import inspect
import pkgutil
import types

import pytest

import repro

PACKAGES = (["repro"]
            + sorted(f"repro.{m.name}" for m in pkgutil.iter_modules(
                repro.__path__) if m.ispkg)
            + ["repro.kernels.ops"])


def _exported(mod):
    names = getattr(mod, "__all__", None)
    if names is not None:
        return list(names)
    return [n for n, v in vars(mod).items()
            if not n.startswith("_") and n != "annotations"
            and not isinstance(v, types.ModuleType)]


@pytest.mark.parametrize("name", PACKAGES)
def test_port_exports_the_reference_names(name):
    ref = importlib.import_module(name)
    port = importlib.import_module(name.replace("repro", "repro_torch", 1))
    names = _exported(ref)
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, (name, missing)
    for n in names:
        want, got = getattr(ref, n), getattr(port, n)
        if inspect.isfunction(want):
            assert callable(got) and not isinstance(got, types.ModuleType), \
                (name, n, got)
        elif inspect.isclass(want):
            assert inspect.isclass(got), (name, n, got)


def test_kernels_from_import_binds_the_functions():
    from repro_torch.kernels import (RowSelection, krum, multi_krum,
                                     select_row)
    from repro_torch.kernels.ops import ref
    from repro_torch.scenarios import jnp_shadow_plan, torch_shadow_plan

    for fn in (krum, multi_krum, select_row):
        assert inspect.isfunction(fn), fn
    assert inspect.isclass(RowSelection)
    assert isinstance(ref, types.ModuleType)
    assert jnp_shadow_plan is torch_shadow_plan
    # the modules stay reachable by their full names
    mod = importlib.import_module("repro_torch.kernels.krum")
    assert isinstance(mod, types.ModuleType) and mod.krum is krum
