"""Unbiased compression operators (Definition 2.2), the counterpart of
``repro.core.compressors``.

Each compressor is a stochastic map Q with E[Q(x)] = x and
E||Q(x) - x||^2 <= omega ||x||^2.  The registry records ``omega`` (the
relative variance), ``zeta`` (the expected density) and ``dq`` (the bound
of Assumption 2.4, ||Q(x)|| <= D_Q ||x||; None when unbounded), as the
reference does.

``Q(key, x)`` maps one tensor, flattened to one vector of d values.  Its
randomness ``key`` is either a ``torch.Generator`` (the compressor draws
d uniforms on the generator's device) or a recorded draw passed in:

  rand_k           the (d,) keep mask (bool), or the (d,) uniform scores
                   whose top k the reference keeps: scores >= top_k(k)[-1];
  l2_quantization  the (d,) uniforms u, with xi_i = u_i < |x_i| / ||x||,
                   which is how ``jax.random.bernoulli`` draws.

So the uniforms ``jax.random.uniform(key, (d,))`` of the reference's key
reproduce its output for both kinds.  ``Q.rows(key, xs)`` compresses an
(n, d) matrix row by row (each row is one client's message): ``key`` is a
generator (one (n, d) draw) or the (n, d) recorded draws.  The identity
draws nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

__all__ = ["Compressor", "identity", "rand_k", "rand_fraction",
           "l2_quantization", "make_compressor"]

_EPS = 1e-30


@dataclasses.dataclass(frozen=True)
class Compressor:
    """An unbiased compressor with its theoretical constants.

    ``rows_fn(draw, xs)`` compresses each row of (n, d) ``xs`` with its
    row of the (n, d) ``draw`` (uniforms, or keep masks for RandK);
    ``fn`` of the identity is the whole map."""

    name: str
    rows_fn: Optional[Callable]  # (draw (n, d), xs (n, d)) -> (n, d)
    omega_fn: Callable[[int], float]  # d -> omega
    zeta_fn: Callable[[int], float]  # d -> expected density
    dq_fn: Optional[Callable[[int], float]]  # d -> D_Q (Assumption 2.4)

    def _draw(self, key, shape, device) -> torch.Tensor:
        if isinstance(key, torch.Generator):
            return torch.rand(shape, generator=key,
                              device=key.device).to(device)
        if not isinstance(key, torch.Tensor) or key.shape != shape:
            raise ValueError(
                f"compressor {self.name!r} needs a torch.Generator or a "
                f"recorded draw of shape {tuple(shape)}, got "
                f"{getattr(key, 'shape', type(key).__name__)}")
        return key.to(device)

    def __call__(self, key, x):
        """Q(x) of one tensor (flattened to one vector)."""
        if self.rows_fn is None:
            return x
        flat = x.reshape(1, -1)
        draw = self._draw(key, flat.shape[1:], x.device)
        return self.rows_fn(draw[None], flat).reshape(x.shape)

    def rows(self, key, xs):
        """Q applied to each row of an (n, d) matrix, each with its own
        draw; ``key`` a generator or the (n, d) recorded draws."""
        if self.rows_fn is None:
            return xs
        return self.rows_fn(self._draw(key, xs.shape, xs.device), xs)

    def omega(self, d: int) -> float:
        return float(self.omega_fn(d))

    def zeta(self, d: int) -> float:
        return float(self.zeta_fn(d))

    def dq(self, d: int) -> Optional[float]:
        return None if self.dq_fn is None else float(self.dq_fn(d))


def identity() -> Compressor:
    return Compressor(
        name="identity",
        rows_fn=None,
        omega_fn=lambda d: 0.0,
        zeta_fn=lambda d: d,
        dq_fn=lambda d: 1.0,
    )


def _rand_k_rows(k_of: Callable[[int], int]):
    """RandK over the rows: keep k_of(d) coordinates of each row, scaled
    by d/k.  A float draw holds uniform scores (the top k are kept, as the
    reference thresholds them), a bool draw the keep masks."""

    def rows_fn(draw, xs):
        d = xs.shape[1]
        kk = min(k_of(d), d)
        if draw.dtype == torch.bool:
            mask = draw
        else:
            thresh = torch.topk(draw, kk, dim=1).values[:, -1:]
            mask = draw >= thresh
        scale = torch.tensor(d / kk, dtype=xs.dtype)
        return xs * mask.to(xs.dtype) * scale.to(xs.device)

    return rows_fn


def rand_k(k: int) -> Compressor:
    """RandK: keep k uniformly random coordinates, scale by d/k.

    omega = d/k - 1, zeta = k, D_Q = d/k  (Beznosikov et al., 2020).
    """
    return Compressor(
        name=f"rand{k}",
        rows_fn=_rand_k_rows(lambda d: k),
        omega_fn=lambda d: d / min(k, d) - 1.0,
        zeta_fn=lambda d: float(min(k, d)),
        dq_fn=lambda d: d / min(k, d),
    )


def rand_fraction(frac: float) -> Compressor:
    """RandK with k = max(1, ceil(frac*d)), resolved per input size."""
    return Compressor(
        name=f"randp{frac}",
        rows_fn=_rand_k_rows(lambda d: max(1, int(-(-d * frac // 1)))),
        omega_fn=lambda d: 1.0 / frac - 1.0,
        zeta_fn=lambda d: frac * d,
        dq_fn=lambda d: 1.0 / frac,
    )


def _l2_quant_rows(u, xs):
    flat = xs.float()
    norm = torch.linalg.vector_norm(flat, dim=1, keepdim=True)
    prob = flat.abs() / torch.clamp(norm, min=_EPS)
    xi = u < torch.clamp(prob, 0.0, 1.0)
    return (norm * torch.sign(flat) * xi.float()).to(xs.dtype)


def l2_quantization() -> Compressor:
    """1-level l2 quantization (Alistarh et al., 2017):

      Q(x)_i = ||x|| * sign(x_i) * xi_i,  xi_i ~ Bernoulli(|x_i|/||x||).

    omega = sqrt(d) - 1 (for dense x), zeta = sqrt(d), D_Q = sqrt(d).
    """
    return Compressor(
        name="l2quant",
        rows_fn=_l2_quant_rows,
        omega_fn=lambda d: math.sqrt(d) - 1.0,
        zeta_fn=lambda d: math.sqrt(d),
        dq_fn=lambda d: math.sqrt(d),
    )


_REGISTRY = {
    "identity": lambda **kw: identity(),
    "none": lambda **kw: identity(),
    "rand_k": lambda **kw: rand_k(int(kw.get("k", 1))),
    "rand_fraction": lambda **kw: rand_fraction(float(kw.get("frac", 0.01))),
    "l2_quantization": lambda **kw: l2_quantization(),
}


def make_compressor(name: str, **kwargs) -> Compressor:
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown compressor {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
