"""Shared harness of the model-zoo parity tests (``test_torch_models_*``):
one smoke architecture run through the reference (``repro.models``, its
functions jitted once) and the port (``repro_torch.models``) on the
reference's ``init_params`` weights, carried across as numpy, and one
numpy batch.  Both run in f32 with ``remat=False``.

Tolerances (stated once, used by every file):
- losses and aux losses: rtol 1e-5;
- a gradient leaf, prefill or decode logits: max |port - ref| within
  1e-4 of the reference's max |ref| (the leaf's scale);
- the port against itself (remat on vs off): 1e-6 of the scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import model as rm
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.core.tree_utils import tree_flatten, tree_unflatten
from repro_torch.models import model as tm

LOSS_RTOL = 1e-5
LEAF_REL = 1e-4
SELF_REL = 1e-6
B, S = 2, 32
DECODE_STEPS = 12
DECODABLE = ("minitron_8b", "yi_34b", "mamba2_780m", "jamba_v01_52b",
             "deepseek_v3_671b", "llama32_vision_90b", "arctic_480b")
GATE = 0.5  # the VLM's cross-attention gate, opened in the carried weights


def configs(arch, **kw):
    kw = dict(dtype="float32", remat=False, **kw)
    return ref_smoke(arch).replace(**kw), port_smoke(arch).replace(**kw)


def numpy_batch(cfg, batch=B, seq=S, seed=1):
    """A batch of the config's input kind, made with numpy."""
    rng = np.random.RandomState(seed)
    if cfg.input_kind == "frames":
        return {
            "frames": rng.randn(batch, seq, cfg.frame_dim).astype(np.float32),
            "targets": rng.randint(0, cfg.vocab, (batch, seq)).astype(np.int32),
            "mask": rng.rand(batch, seq) < 0.65,
        }
    out = {"tokens": rng.randint(0, cfg.vocab, (batch, seq)).astype(np.int32)}
    if cfg.input_kind == "tokens+vision":
        out["vision"] = rng.randn(batch, cfg.n_vision_tokens,
                                  cfg.d_model).astype(np.float32)
    return out


def open_gates(tree, value=GATE):
    """The numpy params tree with every "gate" leaf set to ``value``."""
    return jax.tree_util.tree_map_with_path(
        lambda p, l: np.full_like(l, value) if any(
            getattr(e, "key", None) == "gate" for e in p) else l, tree)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def port_value_and_grad(params, cfg, batch):
    """(loss, aux, grads in flatten order) by ``torch.autograd.grad``."""
    leaves, treedef = tree_flatten(params)
    leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
    loss, aux = tm.apply_train(tree_unflatten(treedef, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def assert_scaled_close(got, want, rel, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.all(np.isfinite(got)), what
    scale = max(np.max(np.abs(want)) if want.size else 0.0, 1e-30)
    err = np.max(np.abs(got - want)) if want.size else 0.0
    assert err <= rel * scale, f"{what}: max err {err:.3e} > {rel:g} x {scale:.3e}"


class Pair:
    """One architecture through both packages, computed lazily and kept
    (a module-scoped fixture holds one a parametrised architecture)."""

    def __init__(self, arch, **overrides):
        self.arch = arch
        self.rcfg, self.tcfg = configs(arch, **overrides)
        ref_params = jax.jit(lambda k: rm.init_params(k, self.rcfg))(
            jax.random.PRNGKey(0))
        self.np_params = jax.tree_util.tree_map(np.asarray, ref_params)
        if self.rcfg.input_kind == "tokens+vision":
            self.np_params = open_gates(self.np_params)
        self.ref_params = to_jax(self.np_params)
        self.params = tm.params_from_numpy(self.np_params, device="cpu")
        self.batch = numpy_batch(self.rcfg)
        self._cache = {}

    def _memo(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    def ref_train(self):
        def run():
            cfg = self.rcfg
            f = jax.jit(jax.value_and_grad(
                lambda p, b: rm.apply_train(p, cfg, b), has_aux=True))
            (loss, aux), grads = f(self.ref_params, to_jax(self.batch))
            return (float(loss), {k: float(v) for k, v in aux.items()},
                    [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])
        return self._memo("ref_train", run)

    def port_train(self, remat=False):
        def run():
            cfg = self.tcfg.replace(remat=remat)
            loss, aux, grads = port_value_and_grad(self.params, cfg,
                                                   to_torch(self.batch))
            return (float(loss), {k: float(v) for k, v in aux.items()},
                    [g.numpy() for g in grads])
        return self._memo(("port_train", remat), run)

    def ref_prefill_of(self, batch):
        fn = self._memo("ref_prefill_fn", lambda: jax.jit(
            lambda p, b: rm.apply_prefill(p, self.rcfg, b)))
        return np.asarray(fn(self.ref_params, to_jax(batch)))

    def ref_prefill(self):
        return self._memo("ref_prefill",
                          lambda: self.ref_prefill_of(self.batch))

    def port_prefill(self):
        def run():
            with torch.no_grad():
                return tm.apply_prefill(self.params, self.tcfg,
                                        to_torch(self.batch)).numpy()
        return self._memo("port_prefill", run)

    def _steps(self):
        for t in range(DECODE_STEPS):
            yield t, {k: (v[:, t:t + 1] if k == "tokens" else v)
                      for k, v in self.batch.items()}

    def ref_decode(self):
        def run():
            cfg = self.rcfg
            step = jax.jit(lambda p, b, c, t: rm.apply_decode(p, cfg, b, c, t))
            cache = rm.init_cache(cfg, B, DECODE_STEPS)
            out = []
            for t, b in self._steps():
                logits, cache = step(self.ref_params, to_jax(b), cache, t)
                out.append(np.asarray(logits))
            return out
        return self._memo("ref_decode", run)

    def port_decode(self, cfg=None):
        cfg = cfg or self.tcfg
        cache = tm.init_cache(cfg, B, DECODE_STEPS, device="cpu")
        out = []
        with torch.no_grad():
            for t, b in self._steps():
                logits, cache = tm.apply_decode(self.params, cfg, to_torch(b),
                                                cache, t)
                out.append(logits.numpy())
        return out

    def port_prefill_at(self, cfg, seq):
        batch = {k: (v[:, :seq] if k == "tokens" else v)
                 for k, v in self.batch.items()}
        with torch.no_grad():
            return tm.apply_prefill(self.params, cfg, to_torch(batch)).numpy()


# ---------------------------------------------------------------------------
# the checks every architecture file runs
# ---------------------------------------------------------------------------

def check_train_loss(pair):
    rl, raux, _ = pair.ref_train()
    tl, taux, _ = pair.port_train()
    np.testing.assert_allclose(tl, rl, rtol=LOSS_RTOL, atol=0)
    assert set(taux) == set(raux) == {"lb_loss", "z_loss"}
    for k in raux:
        np.testing.assert_allclose(taux[k], raux[k], rtol=LOSS_RTOL, atol=0,
                                   err_msg=k)


def check_train_grads(pair):
    _, _, rg = pair.ref_train()
    _, _, tg = pair.port_train()
    assert len(tg) == len(rg)
    for i, (a, b) in enumerate(zip(tg, rg)):
        assert_scaled_close(a, b, LEAF_REL, f"{pair.arch} grad leaf {i}")


def check_remat_grads(pair):
    """remat=True (torch.utils.checkpoint) gives the same gradients."""
    _, _, plain = pair.port_train(remat=False)
    tl, _, remat = pair.port_train(remat=True)
    np.testing.assert_allclose(tl, pair.port_train()[0], rtol=SELF_REL)
    for i, (a, b) in enumerate(zip(remat, plain)):
        assert_scaled_close(a, b, SELF_REL, f"{pair.arch} remat leaf {i}")


def check_prefill(pair):
    assert_scaled_close(pair.port_prefill(), pair.ref_prefill(), LEAF_REL,
                        f"{pair.arch} prefill")


def check_decode(pair):
    for t, (a, b) in enumerate(zip(pair.port_decode(), pair.ref_decode())):
        assert_scaled_close(a, b, LEAF_REL, f"{pair.arch} decode step {t}")


def check_decode_matches_prefill(pair):
    """The port's 12 decode steps reproduce its own prefill's last logits
    (test_decode_matches_prefill's capacity 8.0 and tolerance)."""
    cfg = pair.tcfg.replace(capacity_factor=8.0)
    dec = pair.port_decode(cfg)[-1]
    np.testing.assert_allclose(dec, pair.port_prefill_at(cfg, DECODE_STEPS),
                               atol=2e-3, rtol=2e-2)
