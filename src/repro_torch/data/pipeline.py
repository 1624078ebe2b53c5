"""Synthetic data pipeline for the model zoo, the counterpart of
``repro.data.pipeline``.

``synthetic_batch`` fabricates a batch matching a ModelConfig's
input_kind (tokens / audio frames / tokens+vision) from a
``torch.Generator``; ``TokenStream`` is an infinite, seeded, shard-aware
iterator, the interface a real corpus loader would expose (per-host
sharding, step bookkeeping).  Batches land on the card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models.model import ModelConfig

__all__ = ["synthetic_batch", "TokenStream", "make_batch_iterator"]


def synthetic_batch(seed, cfg: ModelConfig, batch: int, seq: int, *,
                    device=None) -> Dict:
    """One fabricated batch for the given architecture; ``seed`` is an int
    or a ``torch.Generator`` on the target device."""
    if isinstance(seed, torch.Generator):
        g = seed
        dev = g.device
    else:
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(int(seed))
    if cfg.input_kind == "frames":
        return {
            "frames": torch.randn((batch, seq, cfg.frame_dim), generator=g,
                                  device=dev).to(cfg.jdtype),
            "targets": torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                                     dtype=torch.int32, device=dev),
            "mask": torch.rand((batch, seq), generator=g, device=dev) < 0.65,
        }

    def tokens():
        return torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                             dtype=torch.int32, device=dev)

    # Zipf-ish marginal so the CE landscape is not flat-random
    out = {"tokens": torch.minimum(tokens(), tokens())}
    if cfg.input_kind == "tokens+vision":
        out["vision"] = torch.randn(
            (batch, cfg.n_vision_tokens, cfg.d_model), generator=g,
            device=dev).to(cfg.jdtype)
    return out


def _step_seed(seed: int, step: int, shard_id: int, num_shards: int) -> int:
    """A generator seed for one (step, shard) of a stream."""
    ss = np.random.SeedSequence([seed, step, shard_id, num_shards])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> 1)


@dataclasses.dataclass
class TokenStream:
    """Infinite seeded stream, shardable by (shard_id, num_shards): step
    k of shard s draws from a generator seeded by (seed, k, s,
    num_shards)."""

    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    device: Optional[str] = None

    def __iter__(self) -> Iterator[Dict]:
        dev = resolve_device(self.device)
        step = 0
        while True:
            g = torch.Generator(device=dev).manual_seed(
                _step_seed(self.seed, step, self.shard_id, self.num_shards))
            yield synthetic_batch(g, self.cfg, self.batch, self.seq)
            step += 1


def make_batch_iterator(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                        *, device=None):
    return iter(TokenStream(cfg, batch, seq, seed=seed, device=device))
