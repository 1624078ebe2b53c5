"""Unbiased compression operators (Definition 2.2): the slice's part.

Only ``identity`` is ported; the Fig. 1 plans compress nothing.  RandK,
rand_fraction and l2 quantization raise until ROADMAP queue 1 item 4.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

__all__ = ["Compressor", "identity", "make_compressor"]


@dataclasses.dataclass(frozen=True)
class Compressor:
    """An unbiased compressor with its theoretical constants."""

    name: str
    fn: Callable  # (key, x) -> Q(x), same shape as x
    omega_fn: Callable[[int], float]  # d -> omega
    zeta_fn: Callable[[int], float]  # d -> expected density
    dq_fn: Optional[Callable[[int], float]]  # d -> D_Q (Assumption 2.4)

    def __call__(self, key, x):
        return self.fn(key, x)

    def omega(self, d: int) -> float:
        return float(self.omega_fn(d))

    def zeta(self, d: int) -> float:
        return float(self.zeta_fn(d))

    def dq(self, d: int) -> Optional[float]:
        return None if self.dq_fn is None else float(self.dq_fn(d))


def identity() -> Compressor:
    return Compressor(
        name="identity",
        fn=lambda key, x: x,
        omega_fn=lambda d: 0.0,
        zeta_fn=lambda d: d,
        dq_fn=lambda d: 1.0,
    )


_UNPORTED = ("rand_k", "rand_fraction", "l2_quantization")


def make_compressor(name: str, **kwargs) -> Compressor:
    if name in ("identity", "none"):
        return identity()
    if name in _UNPORTED:
        raise NotImplementedError(
            f"compressor {name!r} is not ported yet (ROADMAP queue 1 item 4)")
    raise ValueError(
        f"unknown compressor {name!r}; have "
        f"{sorted(('identity', 'none') + _UNPORTED)}")
