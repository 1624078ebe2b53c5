"""Byzantine attacks (Section 5 / Appendix F).

An attack maps an ``AttackContext`` to the (n, d) payloads the Byzantine
workers send (rows of good workers are ignored by the caller).  The
context holds what a colluding adversary sees: the honest messages, the
good and sampled masks, the iterates, the server estimate g^k, whether
the byzantines are a majority of the sampled cohort, and ``key``.

``key`` is a ``torch.Generator`` that ``gauss`` draws its noise from, or,
in parity mode, an (n, d) tensor of standard normal noise that it uses
as given (so that a test can hand both packages the same numbers).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

__all__ = ["AttackContext", "Attack", "make_attack", "ATTACKS",
           "ATTACK_PARAMS"]


@dataclasses.dataclass(frozen=True)
class AttackContext:
    honest: torch.Tensor
    good_mask: torch.Tensor
    sampled: torch.Tensor
    x_now: torch.Tensor
    x_prev: torch.Tensor
    x0: torch.Tensor
    g_prev: torch.Tensor
    byz_majority: torch.Tensor
    key: object = None

    def replace(self, **kw) -> "AttackContext":
        return dataclasses.replace(self, **kw)


def _good_sampled_stats(ctx: AttackContext):
    """Mean/std of the sampled good workers' honest messages."""
    w = (ctx.good_mask & ctx.sampled).float()
    denom = w.sum().clamp(min=1.0)
    mu = (ctx.honest * w[:, None]).sum(dim=0) / denom
    var = (((ctx.honest - mu[None]) ** 2) * w[:, None]).sum(dim=0) / denom
    return mu, torch.sqrt(var + 1e-12)


def bit_flip(ctx: AttackContext) -> torch.Tensor:
    """BF/SF: send the negated honest message ("bf" and "sf" alias it)."""
    return -ctx.honest


def label_flip_proxy(ctx: AttackContext) -> torch.Tensor:
    """Message-level proxy of the data-level LF attack."""
    return -0.5 * ctx.honest


def a_little_is_enough(ctx: AttackContext, z_max: float = 1.5) -> torch.Tensor:
    """ALIE (Baruch et al., 2019): mu - z_max * sigma of the good cohort."""
    mu, sigma = _good_sampled_stats(ctx)
    return (mu - z_max * sigma)[None].expand_as(ctx.honest)


def inner_product_manipulation(ctx: AttackContext,
                               eps: float = 1.1) -> torch.Tensor:
    """IPM (Xie et al., 2020): -eps * mean of the good messages."""
    mu, _ = _good_sampled_stats(ctx)
    return (-eps * mu)[None].expand_as(ctx.honest)


def shift_back(ctx: AttackContext) -> torch.Tensor:
    """SHB (this paper): with a sampled byzantine majority send x^0 - x^k,
    undoing the trajectory; otherwise behave honestly."""
    rows = (ctx.x0 - ctx.x_now)[None].expand_as(ctx.honest)
    return torch.where(ctx.byz_majority, rows, ctx.honest)


def random_gauss(ctx: AttackContext, scale: float = 10.0) -> torch.Tensor:
    if isinstance(ctx.key, torch.Tensor):
        noise = ctx.key.to(device=ctx.honest.device, dtype=torch.float32)
    else:
        gen = ctx.key
        noise = torch.randn(ctx.honest.shape, generator=gen,
                            device=gen.device if gen is not None else "cpu")
        noise = noise.to(ctx.honest.device)
    return (scale * noise).to(ctx.honest.dtype)


def no_attack(ctx: AttackContext) -> torch.Tensor:
    return ctx.honest


@dataclasses.dataclass(frozen=True)
class Attack:
    name: str
    fn: Callable[[AttackContext], torch.Tensor]
    data_level: bool = False  # LF flips labels in the pipeline instead
    omniscient: bool = False  # payload reads the sampled good cohort
    needs_iterates: bool = False  # payload reads x0/x_now (SHB)
    adaptive: bool = False  # inner optimization loop vs the aggregator

    def __call__(self, ctx: AttackContext) -> torch.Tensor:
        return self.fn(ctx)


ATTACKS = {
    "none": Attack("none", no_attack),
    "bf": Attack("bf", bit_flip),
    "lf": Attack("lf", label_flip_proxy, data_level=True),
    "alie": Attack("alie", a_little_is_enough, omniscient=True),
    "ipm": Attack("ipm", inner_product_manipulation, omniscient=True),
    "shb": Attack("shb", shift_back, omniscient=True, needs_iterates=True),
    "sf": Attack("sf", bit_flip),
    "gauss": Attack("gauss", random_gauss),
}

# per-attack tunables accepted by make_attack(name, **params)
ATTACK_PARAMS = {"alie": ("z_max",), "ipm": ("eps",), "gauss": ("scale",)}


def make_attack(name, **params) -> Attack:
    """Registry lookup; ``params`` (see ``ATTACK_PARAMS``) bind tunables."""
    if isinstance(name, Attack):
        return name
    if name not in ATTACKS:
        raise ValueError(f"unknown attack {name!r}; have {sorted(ATTACKS)}")
    base = ATTACKS[name]
    if not params:
        return base
    allowed = ATTACK_PARAMS.get(name, ())
    bad = sorted(set(params) - set(allowed))
    if bad:
        raise ValueError(f"attack {name!r} takes no parameter(s) {bad}; "
                         f"allowed: {sorted(allowed)}")
    return dataclasses.replace(base, fn=functools.partial(base.fn, **params))
