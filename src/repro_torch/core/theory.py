"""Theory-side constants of the paper, used to set stepsizes/clip radii:
the port's own copy of ``repro.core.theory`` (pure ``math``), so that the
port imports nothing of the reference package.

Implements the cohort probabilities

  p_G        = P{ G_C^k >= (1-delta) C }        (sampled cohort has enough good)
  P_{G_C^k}  = P{ i in G_C^k | G_C^k >= (1-delta) C }

(hypergeometric sums from Section 4), the constants A of Theorems 4.1/4.2,
and the resulting maximal stepsizes gamma <= 1/(L(1+sqrt(A))).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = [
    "cohort_probabilities",
    "theorem41_A",
    "theorem42_A",
    "stepsize",
    "MarinaTheory",
]


def _comb(n: int, k: int) -> int:
    if k < 0 or k > n:
        return 0
    return math.comb(n, k)


def cohort_probabilities(n: int, G: int, C: int, delta: float):
    """Return (p_G, P_good) for uniform sampling of C clients out of n with
    G good ones, threshold ceil((1-delta)C) good sampled."""
    if C <= 0:
        raise ValueError("C must be positive")
    t_min = math.ceil((1.0 - delta) * C)
    denom = _comb(n, C)
    p_g = sum(
        _comb(G, t) * _comb(n - G, C - t) for t in range(t_min, C + 1)
    ) / denom
    if p_g == 0.0:
        return 0.0, 0.0
    denom1 = _comb(n - 1, C - 1)
    # P{i in G_C | event} = C/(n p_G) * sum comb(G-1,t-1)comb(n-G,C-t)/comb(n-1,C-1)
    p_i = (
        (C / (n * p_g))
        * sum(_comb(G - 1, t - 1) * _comb(n - G, C - t) for t in range(t_min, C + 1))
        / denom1
    )
    return float(p_g), float(min(p_i, 1.0))


def theorem41_A(
    *,
    n: int,
    G: int,
    C: int,
    C_hat: int,
    delta: float,
    p: float,
    omega: float,
    c_const: float,
    f_a: float,
) -> float:
    """Constant A of Theorem 4.1 (general unbiased compressors), eq. (4)."""
    p_g, p_i = cohort_probabilities(n, G, C, delta)
    term1 = (
        32.0 * p_g * G * p_i / (p * p * (1.0 - delta) * C)
    ) * (30.0 * omega + 11.0) * (1.0 + 2.0 * c_const * delta)
    term2 = 16.0 * (1.0 - p_g) * (1.0 + 4.0 * f_a * f_a) / (p * p)
    return term1 + term2


def theorem42_A(
    *,
    n: int,
    G: int,
    C: int,
    C_hat: int,
    delta: float,
    p: float,
    omega: float,
    c_const: float,
    f_a: float,
    d_q: float,
) -> float:
    """Constant A of Theorem 4.2 (bounded compressors, Assumption 2.4), eq. (7)."""
    p_g, p_i = cohort_probabilities(n, G, C, delta)
    term1 = (4.0 * p_g * G * p_i / (p * (1.0 - delta) * C)) * (
        (3.0 * omega + 2.0) / ((1.0 - delta) * C)
        + 8.0 * (5.0 * omega + 4.0) * c_const * delta / p
    )
    term2 = 8.0 * (1.0 - p_g) * (2.0 + f_a * f_a * d_q * d_q) / (p * p)
    return term1 + term2


def stepsize(L: float, A: float, pl: bool = False) -> float:
    """gamma <= 1/(L(1+sqrt(A)))  (or 1/(L(1+sqrt(2A))) for the PL result)."""
    a = 2.0 * A if pl else A
    return 1.0 / (L * (1.0 + math.sqrt(max(a, 0.0))))


@dataclass(frozen=True)
class MarinaTheory:
    """Bundle of theory-derived hyperparameters for a given setup."""

    n: int
    G: int
    C: int
    C_hat: int
    delta: float
    p: float
    L: float
    omega: float = 0.0
    c_const: float = 1.0
    f_a: float = 1.0
    d_q: float = 1.0

    @property
    def p_g(self) -> float:
        return cohort_probabilities(self.n, self.G, self.C, self.delta)[0]

    def gamma(self, theorem: str = "4.1", pl: bool = False) -> float:
        kw = dict(
            n=self.n,
            G=self.G,
            C=self.C,
            C_hat=self.C_hat,
            delta=self.delta,
            p=self.p,
            omega=self.omega,
            c_const=self.c_const,
            f_a=self.f_a,
        )
        if theorem == "4.2":
            A = theorem42_A(d_q=self.d_q, **kw)
        else:
            A = theorem41_A(**kw)
        return stepsize(self.L, A, pl=pl)

    def clip_alpha(self, theorem: str = "4.1") -> float:
        return 2.0 * self.L if theorem == "4.1" else self.d_q * self.L
