"""Assigned input shapes and abstract inputs, the counterpart of
``repro.configs.shapes``.

  train_4k     seq_len=4,096    global_batch=256   (training)
  prefill_32k  seq_len=32,768   global_batch=32    (inference-prefill)
  decode_32k   seq_len=32,768   global_batch=128   (inference-decode: ONE new
                                                    token, cache of seq_len)
  long_500k    seq_len=524,288  global_batch=1     (long-context decode; needs
                                                    sub-quadratic attention)

``input_specs(cfg, shape)`` returns tensors on ``device="meta"`` with the
shape and dtype of every model input: no memory is allocated.
``mode_for(cfg, shape)`` tells the launcher whether the pair runs
train_step / prefill / decode, or must be skipped (encoder-only decode).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models.model import ModelConfig, init_cache

__all__ = ["Shape", "SHAPES", "shape_for", "input_specs", "mode_for", "decode_variant"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

# sliding window applied to attention layers for the long-context decode
LONG_CONTEXT_WINDOW = 8192


def shape_for(name: str) -> Shape:
    if name not in SHAPES:
        raise ValueError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]


def mode_for(cfg: ModelConfig, shape: Shape) -> Optional[str]:
    """'train' | 'prefill' | 'decode' | None (skip: no decode step for an
    encoder-only model)."""
    if shape.kind == "decode" and not cfg.causal:
        return None  # encoder-only (hubert): no decode step
    return shape.kind


def decode_variant(cfg: ModelConfig, shape: Shape) -> ModelConfig:
    """Config actually run for a decode shape.  For long_500k, dense/MoE
    attention switches to the sliding-window variant (sub-quadratic + bounded
    cache); SSM-only archs are already O(1)/token."""
    if shape.name == "long_500k" and "attn" in cfg.mixer_pattern:
        return cfg.replace(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: Shape) -> Dict:
    """Abstract inputs (meta tensors) for the given (arch, shape) pair.

    train/prefill: the full batch dict.
    decode: {"batch": one-token batch, "cache": cache tree,
             "cache_index": scalar} — cache length = seq_len (or the sliding
    window for long-context variants, matching init_cache semantics).
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.input_kind == "frames":
            batch = {
                "frames": _meta((B, S, cfg.frame_dim), cfg.jdtype),
                "targets": _meta((B, S), torch.int32),
                "mask": _meta((B, S), torch.bool),
            }
        elif cfg.input_kind == "tokens+vision":
            batch = {
                "tokens": _meta((B, S), torch.int32),
                "vision": _meta((B, cfg.n_vision_tokens, cfg.d_model), cfg.jdtype),
            }
        else:
            batch = {"tokens": _meta((B, S), torch.int32)}
        return batch

    # decode
    dcfg = decode_variant(cfg, shape)
    batch = {"tokens": _meta((B, 1), torch.int32)}
    if cfg.input_kind == "tokens+vision":
        batch["vision"] = _meta((B, cfg.n_vision_tokens, cfg.d_model), cfg.jdtype)
    return {
        "batch": batch,
        "cache": init_cache(dcfg, B, S, device="meta"),
        "cache_index": _meta((), torch.int32),
    }
