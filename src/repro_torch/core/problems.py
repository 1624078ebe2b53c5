"""Federated finite-sum problems (eq. 1) for the simulation engines: the
counterpart of ``repro.core.problems`` (logistic regression and the
two-layer MLP).

A problem holds the stacked per-client data on one device and batched
oracles over a flat parameter vector, with no Python loop over clients:

  all_full_grads(x)                 (n, d)  grad f_i(x), one row per client
  all_minibatch_grads(idx, x)       (n, d)  grad on the (n, batch) samples idx
  all_minibatch_diffs(idx, x+, x)   (n, d)  Dhat_i(x+, x) on minibatch idx
  loss(x), grad(x)                  f(x) over the good clients only

Clients 0..G-1 are good, G..n-1 byzantine.  The gradients are the closed
form of l2-regularized logistic regression,
grad f_i(x) = A_i^T (dl/dz(A_i x, y_i)) / m + l2 * x, with
dl/dz = sigmoid(z) - y: what the reference's autodiff computes up to
rounding, except at a logit of exactly 0.  There the reference
differentiates its stable form max(z, 0) - z*y + log1p(exp(-|z|)) with
d|z|/dz = 1 and dmax(z, 0)/dz = 1/2, which gives -y instead of
sigmoid(0) - y.  The start x^0 = 0 puts every logit at 0, so g^0 and the
first difference round depend on it; ``_dloss_dz`` takes the reference's
value there, so that both packages run the same trajectory.  With
homogeneous data ``features`` and ``labels`` are broadcast views of one
client's data.

``MLPProblem`` is the Fig.-2 problem: a tanh hidden layer and softmax
cross-entropy over ``n_classes``, the flat x packing w1 (in_dim, hidden),
b1, w2 (hidden, n_classes), b2 in that order.  Its gradients are written
out by hand (backpropagation batched over clients with ``torch.bmm``);
labels are stored as f32 and read as class ids.  It has the oracles the
Fig.-2 engine calls (no ``all_minibatch_diffs``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["FedProblem", "MLPProblem", "logistic_problem",
           "problem_from_numpy", "mlp_problem", "mlp_problem_from_numpy"]


def _logistic_loss(z, y):
    """Numerically stable BCE with logits."""
    return torch.clamp(z, min=0.0) - z * y + torch.log1p(torch.exp(-z.abs()))


def _dloss_dz(z, y):
    """d(loss)/dz: sigmoid(z) - y, and the reference's -y at z = 0."""
    return torch.where(z == 0, -y, torch.sigmoid(z) - y)


@dataclasses.dataclass
class FedProblem:
    name: str
    dim: int
    n_clients: int
    n_good: int
    m: int  # samples per client
    features: torch.Tensor  # (n, m, d), a broadcast view when homogeneous
    labels: torch.Tensor  # (n, m)
    x0: torch.Tensor  # (d,)
    l2: float = 0.0

    @property
    def device(self) -> torch.device:
        return self.x0.device

    @property
    def homogeneous(self) -> bool:
        return self.features.stride(0) == 0

    def _logits(self, x):
        if self.homogeneous:  # one product, shared by every client
            return (self.features[0] @ x).expand(self.n_clients, self.m)
        return torch.einsum("nmd,d->nm", self.features, x)

    def _grad_rows(self, feats, resid, x, count):
        """sum_j resid[i, j] * feats[i, j] / count + l2 * x, per row i."""
        if feats.stride(0) == 0:
            g = resid @ feats[0]
        else:
            g = torch.einsum("nm,nmd->nd", resid, feats)
        return g / count + self.l2 * x

    # ---- oracles ---------------------------------------------------------
    def all_full_grads(self, x):
        """(n, d) full local gradients, one row per client."""
        resid = _dloss_dz(self._logits(x), self.labels)
        return self._grad_rows(self.features, resid, x, self.m)

    def _batch_grads(self, feats, labs, x):
        resid = _dloss_dz(torch.einsum("nbd,d->nb", feats, x), labs)
        return self._grad_rows(feats, resid, x, feats.shape[1])

    def all_minibatch_grads(self, idx, x):
        """(n, d) gradients of each client's loss on its (batch,) sample
        indices, the rows of ``idx``."""
        feats, labs = _gather_batch(self.features, self.labels, idx)
        return self._batch_grads(feats, labs, x)

    def all_minibatch_diffs(self, idx, x_new, x_old):
        """Dhat_i(x_new, x_old) on the (n, batch) sample indices ``idx``
        (SARAH/PAGE style: the same samples at both points)."""
        feats, labs = _gather_batch(self.features, self.labels, idx)
        return (self._batch_grads(feats, labs, x_new)
                - self._batch_grads(feats, labs, x_old))

    def loss(self, x):
        """Global objective f(x): the average over the GOOD clients."""
        per = _logistic_loss(self._logits(x)[: self.n_good],
                             self.labels[: self.n_good])
        return (per.mean(dim=1) + 0.5 * self.l2 * (x * x).sum()).mean()

    def grad(self, x):
        return self.all_full_grads(x)[: self.n_good].mean(dim=0)

    def smoothness(self) -> float:
        """An upper bound on L: 0.25 max_j ||a_j||^2 + l2 over every
        client's samples, in f32 as the reference computes it."""
        feats = self.features[:1] if self.homogeneous else self.features
        row_sq = (feats * feats).sum(dim=-1)
        return float(0.25 * row_sq.max() + self.l2)


def _gather_batch(features, labels, idx):
    """The (n, b, ...) features and (n, b) labels of the samples ``idx``."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return features[rows, idx], labels[rows, idx]


@dataclasses.dataclass
class MLPProblem:
    """Two-layer tanh MLP classification over per-client data (module
    docstring); the oracles are those of ``FedProblem``."""

    name: str
    dim: int
    n_clients: int
    n_good: int
    m: int  # samples per client
    in_dim: int
    hidden: int
    n_classes: int
    features: torch.Tensor  # (n, m, in_dim)
    labels: torch.Tensor  # (n, m) f32 class ids
    x0: torch.Tensor  # (dim,)
    l2: float = 0.0

    @property
    def device(self) -> torch.device:
        return self.x0.device

    def _unpack(self, x):
        i, h, c = self.in_dim, self.hidden, self.n_classes
        w1, b1, w2, b2 = torch.split(x, [i * h, h, h * c, c])
        return w1.view(i, h), b1, w2.view(h, c), b2

    def _forward(self, feats, x):
        w1, b1, w2, b2 = self._unpack(x)
        h = torch.tanh(torch.matmul(feats, w1) + b1)  # (n, b, hidden)
        return h, torch.matmul(h, w2) + b2  # logits (n, b, n_classes)

    def _batch_grads(self, feats, labs, x):
        """(n, dim) gradients of each client's mean loss over its b
        samples: backpropagation batched over the clients."""
        _, _, w2, _ = self._unpack(x)
        n, b, _ = feats.shape
        h, z = self._forward(feats, x)
        onehot = torch.nn.functional.one_hot(labs.long(), self.n_classes)
        dz = (torch.softmax(z, dim=-1) - onehot) / b  # (n, b, c)
        gw2 = torch.bmm(h.transpose(1, 2), dz)  # (n, hidden, c)
        dpre = torch.matmul(dz, w2.t()) * (1.0 - h * h)  # tanh' = 1 - h^2
        gw1 = torch.bmm(feats.transpose(1, 2), dpre)  # (n, in_dim, hidden)
        g = torch.cat([gw1.reshape(n, -1), dpre.sum(dim=1),
                       gw2.reshape(n, -1), dz.sum(dim=1)], dim=1)
        return g + self.l2 * x

    def all_full_grads(self, x):
        """(n, dim) full local gradients, one row per client."""
        return self._batch_grads(self.features, self.labels, x)

    def all_minibatch_grads(self, idx, x):
        """(n, dim) gradients on the (n, batch) sample indices ``idx``."""
        feats, labs = _gather_batch(self.features, self.labels, idx)
        return self._batch_grads(feats, labs, x)

    def loss(self, x):
        """f(x): the mean cross-entropy over the GOOD clients."""
        _, z = self._forward(self.features[: self.n_good], x)
        logp = torch.log_softmax(z, dim=-1)
        y = self.labels[: self.n_good].long()[..., None]
        per = -logp.gather(-1, y)[..., 0].mean(dim=1)
        return (per + 0.5 * self.l2 * (x * x).sum()).mean()

    def grad(self, x):
        return self._batch_grads(self.features[: self.n_good],
                                 self.labels[: self.n_good], x).mean(dim=0)


def _generator(seed_or_gen) -> torch.Generator:
    if isinstance(seed_or_gen, torch.Generator):
        return seed_or_gen
    return torch.Generator().manual_seed(int(seed_or_gen))


def logistic_problem(seed=0, *, n_clients: int = 20, n_good: int = 15,
                     m: int = 500, dim: int = 50, l2: float = 0.01,
                     homogeneous: bool = True, label_flip_byz: bool = False,
                     device=None) -> FedProblem:
    """Synthetic a9a-like l2-regularized logistic regression, drawn from
    ``seed`` (an int or a CPU ``torch.Generator``) and placed on
    ``device`` (None = "cuda").

    ``homogeneous=True`` is the paper's Fig.-1 setting: every worker
    holds the full dataset (zeta = 0)."""
    dev = resolve_device(device)
    gen = _generator(seed)
    if homogeneous:
        feats = torch.randn(m, dim, generator=gen) / dim ** 0.5
        w_true = torch.randn(dim, generator=gen)
        prob = torch.sigmoid(feats @ w_true)
        labels = (torch.rand(m, generator=gen) < prob).float()
        feats = feats[None].expand(n_clients, m, dim)
        labels = labels[None].expand(n_clients, m)
    else:
        feats = torch.randn(n_clients, m, dim, generator=gen) / dim ** 0.5
        w_true = torch.randn(dim, generator=gen)
        shifts = 0.5 * torch.randn(n_clients, dim, generator=gen)
        logits = torch.einsum("nmd,nd->nm", feats, w_true[None] + shifts)
        labels = (logits > 0).float()
    if label_flip_byz:
        byz = torch.arange(n_clients) >= n_good
        labels = torch.where(byz[:, None], 1.0 - labels, labels)
    return _on_device(feats, labels, torch.zeros(dim), n_good, l2, dev)


def _on_device(feats, labels, x0, n_good, l2, dev) -> FedProblem:
    if feats.stride(0) == 0:  # keep the broadcast view on the device
        feats = feats[0].to(dev)[None].expand(feats.shape)
    else:
        feats = feats.to(dev)
    if labels.stride(0) == 0:
        labels = labels[0].to(dev)[None].expand(labels.shape)
    else:
        labels = labels.to(dev)
    n, m, d = feats.shape
    return FedProblem(name="logreg", dim=d, n_clients=n, n_good=n_good, m=m,
                      features=feats, labels=labels,
                      x0=x0.to(dev, torch.float32), l2=l2)


def problem_from_numpy(features, labels, x0, *, n_good: int, l2: float,
                       n_clients: int = 0, device=None) -> FedProblem:
    """A logistic ``FedProblem`` from numpy arrays, e.g. the reference
    package's data, so that both packages compute on the same numbers.

    ``features`` is (n, m, d) per client, or (m, d) with ``labels`` (m,)
    and ``n_clients`` for homogeneous data (kept a broadcast view)."""
    dev = resolve_device(device)
    feats = torch.from_numpy(np.array(features, np.float32))
    labs = torch.from_numpy(np.array(labels, np.float32))
    if feats.ndim == 2:
        if n_clients < 1:
            raise ValueError("homogeneous (m, d) features need n_clients >= 1")
        feats = feats[None].expand(n_clients, *feats.shape)
        labs = labs[None].expand(n_clients, *labs.shape)
    if feats.ndim != 3 or labs.shape != feats.shape[:2]:
        raise ValueError(f"need features (n, m, d) and labels (n, m); got "
                         f"{tuple(feats.shape)} and {tuple(labs.shape)}")
    x0 = torch.from_numpy(np.asarray(x0, np.float32).copy())
    return _on_device(feats, labs, x0, n_good, l2, dev)


def _mlp_on_device(feats, labels, x0, *, n_good, hidden, n_classes,
                   dev) -> MLPProblem:
    n, m, in_dim = feats.shape
    dim = in_dim * hidden + hidden + hidden * n_classes + n_classes
    if labels.shape != (n, m) or x0.shape != (dim,):
        raise ValueError(
            f"need labels ({n}, {m}) and x0 ({dim},) for features "
            f"{tuple(feats.shape)}, hidden={hidden}, n_classes={n_classes}; "
            f"got {tuple(labels.shape)} and {tuple(x0.shape)}")
    return MLPProblem(
        name="mlp", dim=dim, n_clients=n, n_good=n_good, m=m, in_dim=in_dim,
        hidden=hidden, n_classes=n_classes,
        features=feats.to(dev, torch.float32).contiguous(),
        labels=labels.to(dev, torch.float32).contiguous(),
        x0=x0.to(dev, torch.float32))


def mlp_problem(seed=0, *, n_clients: int = 20, n_good: int = 15,
                m: int = 256, in_dim: int = 64, hidden: int = 32,
                n_classes: int = 10, heterogeneous: bool = True,
                label_flip_byz: bool = False, device=None) -> MLPProblem:
    """MNIST-like two-layer MLP classification drawn from ``seed`` (an int
    or a CPU ``torch.Generator``) on ``device`` (None = "cuda"), with
    (``heterogeneous``) each client relabelling the first half of its
    samples to a "home" class, as in Karimireddy et al., 2021, and
    (``label_flip_byz``) the byzantine clients' labels flipped."""
    dev = resolve_device(device)
    gen = _generator(seed)
    feats = torch.randn(n_clients, m, in_dim, generator=gen)
    w_star = torch.randn(in_dim, n_classes, generator=gen)
    logits = torch.einsum("nmd,dc->nmc", feats, w_star)
    labels = torch.argmax(
        logits + 0.5 * torch.randn(logits.shape, generator=gen), dim=-1)
    if heterogeneous:
        home = (torch.arange(n_clients) * 2) % n_classes
        labels[:, : m // 2] = home[:, None]
    if label_flip_byz:
        byz = torch.arange(n_clients) >= n_good
        labels = torch.where(byz[:, None], (n_classes - 1) - labels, labels)
    dim = in_dim * hidden + hidden + hidden * n_classes + n_classes
    x0 = 0.1 * torch.randn(dim, generator=gen)
    return _mlp_on_device(feats, labels.float(), x0, n_good=n_good,
                          hidden=hidden, n_classes=n_classes, dev=dev)


def mlp_problem_from_numpy(features, labels, x0, *, n_good: int, hidden: int,
                           n_classes: int = 10, device=None) -> MLPProblem:
    """An ``MLPProblem`` from numpy arrays (features (n, m, in_dim),
    labels (n, m), x0 (dim,)), e.g. the reference package's data, so that
    both packages compute on the same numbers."""
    dev = resolve_device(device)
    feats = torch.from_numpy(np.array(features, np.float32))
    if feats.ndim != 3:
        raise ValueError(f"need features (n, m, in_dim), got "
                         f"{tuple(feats.shape)}")
    return _mlp_on_device(
        feats, torch.from_numpy(np.array(labels, np.float32)),
        torch.from_numpy(np.array(x0, np.float32)), n_good=n_good,
        hidden=hidden, n_classes=n_classes, dev=dev)
