"""The attack stage: ``make_context`` builds one round's
``AttackContext`` (the one place that computes the sampled-cohort
byzantine-majority bit), ``AttackStage`` corrupts the engine's (n, d)
message matrix, ``TreeAttackStage`` corrupts a worker-stacked message
tree leaf by leaf (the mesh trainer's form), and ``SyntheticCohort`` is
the host-side form that gives the streaming server's synthetic clients
their wire rows."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.attacks import Attack, AttackContext, make_attack
from ..core.tree_utils import tree_flatten, tree_unflatten

__all__ = ["AttackStage", "TreeAttackStage", "SyntheticCohort",
           "make_context"]


def make_context(honest, *, good_mask, sampled, x_now=None, x_prev=None,
                 x0=None, g_prev=None, key=None) -> AttackContext:
    """One round's context; iterate fields default to zeros of the
    message width.  ``byz_majority`` stays a device tensor."""
    zeros = torch.zeros(honest.shape[-1], device=honest.device)
    n_good_s = (good_mask & sampled).sum()
    n_byz_s = (~good_mask & sampled).sum()
    return AttackContext(
        honest=honest,
        good_mask=good_mask,
        sampled=sampled,
        x_now=zeros if x_now is None else x_now,
        x_prev=zeros if x_prev is None else x_prev,
        x0=zeros if x0 is None else x0,
        g_prev=zeros if g_prev is None else g_prev,
        byz_majority=n_byz_s > n_good_s,
        key=key,
    )


class AttackStage:
    """``corrupt(ctx)`` returns the wire message: honest rows untouched,
    byzantine rows replaced by the attack payload."""

    def __init__(self, attack):
        self.attack: Attack = make_attack(attack)

    def corrupt(self, ctx: AttackContext) -> torch.Tensor:
        payload = self.attack(ctx)
        return torch.where(ctx.good_mask[:, None], ctx.honest,
                           payload.to(ctx.honest.dtype))


class TreeAttackStage:
    """Pytree form for the mesh trainer: leaves are (W, ...)
    worker-stacked messages; the attack runs once per leaf on the (W,
    leaf_size) f32 view with the shared cohort masks.  Omniscient
    statistics (ALIE's mu and sigma, IPM's mean) are per coordinate, so
    per leaf they equal those of the flattened message.  Adaptive attacks
    optimise one whole-message payload and do not decompose by leaf: they
    raise here; iterate-reading attacks (shb) raise in :meth:`corrupt_tree`
    (the mesh trainer tracks no x0: run them through the simulation
    engines).

    ``key`` of :meth:`corrupt_tree` is where gauss's noise comes from: a
    ``torch.Generator`` that draws each leaf's (W, leaf_size) block in
    leaf order (the reference folds its key per leaf instead), or a
    sequence with one noise tensor a leaf (the reference's draws, as
    ``core.attacks`` takes a noise tensor)."""

    def __init__(self, attack):
        self.attack: Attack = make_attack(attack)
        if self.attack.adaptive:
            raise ValueError(
                f"attack {self.attack.name!r} is adaptive (whole-message "
                "inner optimization); the mesh stage applies attacks "
                "leafwise — run adaptive attacks through the simulation "
                "engines (repro_torch.core) or a ScenarioSpec there")

    def corrupt_tree(self, honest_tree, *, good_mask, sampled, key):
        if self.attack.name == "none":
            return honest_tree
        if self.attack.needs_iterates:
            raise ValueError(
                f"attack {self.attack.name!r} reads the iterates (x0, "
                "x_now), which the worker-stacked stage does not take — "
                "pick a message-level attack, or run it through the "
                "simulation engines (repro_torch.core)")
        leaves, treedef = tree_flatten(honest_tree)
        out = []
        for i, leaf in enumerate(leaves):
            flat = leaf.reshape(leaf.shape[0], -1).float()
            ctx = make_context(
                flat, good_mask=good_mask, sampled=sampled,
                key=(key if key is None or isinstance(key, torch.Generator)
                     else key[i].reshape(flat.shape)))
            payload = self.attack(ctx)
            wire = torch.where(good_mask[:, None], flat,
                               payload.to(flat.dtype))
            out.append(wire.reshape(leaf.shape).to(leaf.dtype))
        return tree_unflatten(treedef, out)


class SyntheticCohort:
    """Host-side synthetic client cohort for the streaming server.

    One call is one round: draw the honest rows of the given slots from
    the caller's ``np.random.RandomState`` (one ``randn`` block and one int,
    exactly as the reference draws them, so both packages see the same
    honest rows), run the registry attack with the trailing ``n_byz`` of
    ``n_slots`` slots as the colluding byzantines, and return the rows each
    slot puts on the wire.  The attack's own randomness (gauss) comes from
    a ``torch.Generator`` seeded with the drawn int."""

    def __init__(self, attack, *, n_slots: int, dim: int, n_byz: int,
                 z_max: Optional[float] = None):
        kw = {}
        if z_max is not None and (
                attack == "alie" or getattr(attack, "name", "") == "alie"):
            kw["z_max"] = float(z_max)
        self.attack: Attack = make_attack(attack, **kw)
        self.n_slots = int(n_slots)
        self.dim = int(dim)
        self.n_byz = int(n_byz)

    def round_rows(self, rng, slots=None) -> np.ndarray:
        """Wire rows (k, dim) f32 for ``slots`` (default: every slot in
        order); ``rng`` advances by one (k, dim) normal block and one int."""
        slots = np.arange(self.n_slots) if slots is None \
            else np.asarray(slots)
        honest = rng.randn(len(slots), self.dim).astype(np.float32)
        seed = int(rng.randint(0, 2**31 - 1))
        good = slots < (self.n_slots - self.n_byz)
        if self.n_byz == 0 or self.attack.name == "none" or good.all():
            return honest
        ctx = make_context(
            torch.from_numpy(honest), good_mask=torch.from_numpy(good),
            sampled=torch.ones(len(slots), dtype=torch.bool),
            key=torch.Generator().manual_seed(seed))
        payload = self.attack(ctx).numpy().astype(np.float32)
        return np.where(good[:, None], honest, payload)
