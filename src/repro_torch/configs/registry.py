"""Architecture registry: ``get_config(arch_id)`` and ``get_smoke_config``,
the counterpart of ``repro.configs.registry``.

Each <arch>.py module defines ``full()`` (the exact assigned configuration,
source cited) and ``smoke()`` (a reduced same-family variant: <=2..4 layers,
d_model<=512, <=4 experts) used by the CPU smoke tests.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "minitron_8b",
    "stablelm_12b",
    "mamba2_780m",
    "jamba_v01_52b",
    "hubert_xlarge",
    "deepseek_v3_671b",
    "llama32_vision_90b",
    "deepseek_7b",
    "yi_34b",
    "arctic_480b",
]

# canonical ids (with dashes) -> module names
_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({a: a for a in ARCHS})
_ALIASES.update(
    {
        "minitron-8b": "minitron_8b",
        "stablelm-12b": "stablelm_12b",
        "mamba2-780m": "mamba2_780m",
        "jamba-v0.1-52b": "jamba_v01_52b",
        "hubert-xlarge": "hubert_xlarge",
        "deepseek-v3-671b": "deepseek_v3_671b",
        "llama-3.2-vision-90b": "llama32_vision_90b",
        "deepseek-7b": "deepseek_7b",
        "yi-34b": "yi_34b",
        "arctic-480b": "arctic_480b",
    }
)


def _module(arch: str):
    if arch not in _ALIASES:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(set(_ALIASES))}")
    return importlib.import_module(f"repro_torch.configs.{_ALIASES[arch]}")


def get_config(arch: str, **overrides):
    cfg = _module(arch).full()
    return cfg.replace(**overrides) if overrides else cfg


def get_smoke_config(arch: str, **overrides):
    cfg = _module(arch).smoke()
    return cfg.replace(**overrides) if overrides else cfg


def list_archs():
    return list(ARCHS)
