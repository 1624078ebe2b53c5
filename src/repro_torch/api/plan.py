"""The declarative ``ServerPlan``: one validated specification of the
paper's server step (clip -> compress -> bucket -> aggregate, run under a
schedule), the counterpart of ``repro.api.plan``.

The specs validate exactly as the reference's do (``PlanError``, a
``ValueError``), and ``to_json``/``from_json`` read and write the same
canonical document (``PLAN_VERSION`` 1), so one document drives both
packages.  ``ScheduleSpec.backend`` takes "torch", "cuda" and "auto"
besides the reference's "jnp" and "pallas", which this package reads as
"torch" and "cuda"; the name is kept as given so that a document
round-trips byte for byte.

``plan.build()`` compiles the plan into the engine form of
:class:`ServerStep`; ``plan.build(mesh)`` into its mesh form, which runs
the naive or the sharded placement over a ``torch.distributed`` device
mesh (``repro_torch.api.mesh_exec``).  ``estimate`` is not ported (it
waits for the benchmarks, ROADMAP).
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Optional

from ..core.aggregators import RULE_ALIASES as _CORE_ALIASES
from ..core.aggregators import Aggregator, make_aggregator
from ..core.compressors import Compressor, make_compressor

__all__ = ["PlanError", "PlanWarning", "ClipSpec", "CompressSpec",
           "BucketSpec", "AggregatorSpec", "ScheduleSpec", "ServerPlan",
           "ServerStep", "PLAN_VERSION"]

PLAN_VERSION = 1


class PlanError(ValueError):
    """A ServerPlan (or one of its specs) failed validation."""


class PlanWarning(UserWarning):
    """A ServerPlan combination is valid but changes semantics subtly."""


_RULES = ("mean", "cm", "trimmed_mean", "rfa", "krum", "multi_krum",
          "centered_clip")
_RULE_ALIASES = dict(_CORE_ALIASES, geometric_median="rfa")
_ITERATIVE_RULES = ("centered_clip", "rfa")
_SELECTION_RULES = ("krum", "multi_krum")
_COMPRESSOR_KINDS = ("identity", "rand_k", "rand_fraction",
                     "l2_quantization")
_PLACEMENTS = ("naive", "sharded")
_BLOCKS = ("sequential", "pipelined")
_BACKENDS = ("torch", "cuda", "auto", "jnp", "pallas")


def _set(obj, **kw):
    for k, v in kw.items():
        object.__setattr__(obj, k, v)


@dataclasses.dataclass(frozen=True)
class ClipSpec:
    """Server-side re-clip of every received message (Alg. 1 line 10):
    exactly one of ``alpha`` (lambda_k = alpha * ||x^k - x^{k-1}||,
    computed per step by :meth:`ServerStep.radius`) or a fixed
    ``radius``."""

    alpha: Optional[float] = None
    radius: Optional[float] = None

    def __post_init__(self):
        if (self.alpha is None) == (self.radius is None):
            raise PlanError(
                "ClipSpec needs exactly one of alpha (data-dependent "
                "lambda_k = alpha * ||x^k - x^{k-1}||) or radius (fixed); "
                f"got alpha={self.alpha!r}, radius={self.radius!r}")
        val = self.alpha if self.alpha is not None else self.radius
        if not (val > 0):
            raise PlanError(f"ClipSpec value must be > 0, got {val!r}")


@dataclasses.dataclass(frozen=True)
class CompressSpec:
    """Unbiased worker-side compression (Definition 2.2)."""

    kind: str = "rand_k"
    k: int = 0
    frac: float = 0.0

    def __post_init__(self):
        if self.kind not in _COMPRESSOR_KINDS:
            raise PlanError(f"unknown compressor kind {self.kind!r}; have "
                            f"{sorted(_COMPRESSOR_KINDS)}")
        if self.kind == "rand_k" and self.k < 1:
            raise PlanError(
                f"CompressSpec(kind='rand_k') needs k >= 1, got {self.k}")
        if self.kind == "rand_fraction" and not (0.0 < self.frac <= 1.0):
            raise PlanError("CompressSpec(kind='rand_fraction') needs "
                            f"0 < frac <= 1, got {self.frac}")


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Bucketing (Algorithm 2, Karimireddy et al., 2022)."""

    s: int = 2

    def __post_init__(self):
        if self.s < 2:
            raise PlanError(f"Bucketing needs bucket size s >= 2, got {self.s}")


@dataclasses.dataclass(frozen=True)
class AggregatorSpec:
    """The robust aggregation rule and its per-rule parameters."""

    rule: str
    trim_ratio: float = 0.1
    byz_bound: Optional[int] = None
    m_select: int = 0
    tau: float = 10.0
    iters: int = 0

    def __post_init__(self):
        rule = _RULE_ALIASES.get(self.rule, self.rule)
        if rule not in _RULES:
            raise PlanError(
                f"unknown aggregator rule {self.rule!r}; have "
                f"{sorted(_RULES)} (aliases {sorted(_RULE_ALIASES)})")
        _set(self, rule=rule)
        if rule == "trimmed_mean" and not (0.0 <= self.trim_ratio < 0.5):
            raise PlanError(
                f"trim_ratio must be in [0, 0.5) — trimming removes "
                f"2*ceil(trim_ratio*n) rows, so 0.5 would drop everything; "
                f"got {self.trim_ratio}")
        if self.byz_bound is not None and self.byz_bound < 0:
            raise PlanError(f"byz_bound must be >= 0, got {self.byz_bound}")
        if self.m_select < 0:
            raise PlanError(f"m_select must be >= 0, got {self.m_select}")
        if self.m_select > 0 and rule != "multi_krum":
            raise PlanError(
                f"m_select is a multi_krum parameter (how many best-scored "
                f"rows to average); rule {rule!r} selects exactly one row — "
                "use rule='multi_krum' or drop m_select")
        if self.tau <= 0:
            raise PlanError(f"tau must be > 0, got {self.tau}")
        if self.iters < 0:
            raise PlanError(f"iters must be >= 0, got {self.iters}")


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """How the built step places and orders the aggregation work: the
    placement (naive or sharded) and block order (sequential or
    pipelined) of a mesh build, the superleaf chunk size, the backend and
    the mesh axes that enumerate the workers (empty: "pod" and "data")."""

    placement: str = "naive"
    blocks: str = "sequential"
    superleaf_elems: int = 0
    backend: str = "auto"
    worker_axes: tuple = ()

    def __post_init__(self):
        if self.placement not in _PLACEMENTS:
            raise PlanError(f"unknown placement {self.placement!r}; have "
                            f"{sorted(_PLACEMENTS)}")
        if self.blocks not in _BLOCKS:
            raise PlanError(f"unknown schedule {self.blocks!r}; have "
                            "'sequential', 'pipelined'")
        if self.superleaf_elems < 0:
            raise PlanError(
                f"superleaf_elems must be >= 0, got {self.superleaf_elems}")
        if self.backend not in _BACKENDS:
            raise PlanError(f"unknown backend {self.backend!r}; have "
                            "'torch', 'cuda', 'auto' (and 'jnp', 'pallas')")
        _set(self, worker_axes=tuple(self.worker_axes))


_SPEC_FIELDS = {
    "clip": ClipSpec,
    "compress": CompressSpec,
    "bucket": BucketSpec,
    "aggregate": AggregatorSpec,
    "schedule": ScheduleSpec,
}


@dataclasses.dataclass(frozen=True)
class ServerPlan:
    """Declarative, validated server-step specification.  Stages compose
    in protocol order: clip -> compress -> bucket -> aggregate."""

    aggregate: AggregatorSpec
    clip: Optional[ClipSpec] = None
    compress: Optional[CompressSpec] = None
    bucket: Optional[BucketSpec] = None
    schedule: ScheduleSpec = ScheduleSpec()
    cohort: Optional[int] = None

    def __post_init__(self):
        if isinstance(self.aggregate, str):
            _set(self, aggregate=AggregatorSpec(self.aggregate))
        for field, klass in _SPEC_FIELDS.items():
            v = getattr(self, field)
            if v is not None and not isinstance(v, klass):
                raise PlanError(
                    f"ServerPlan.{field} must be a {klass.__name__} or "
                    f"None, got {type(v).__name__}")
        if self.cohort is not None and self.cohort < 1:
            raise PlanError(f"cohort must be >= 1, got {self.cohort}")
        if (self.schedule.blocks == "pipelined"
                and self.schedule.placement != "sharded"):
            raise PlanError(
                "blocks='pipelined' requires placement='sharded': the "
                "naive placement gathers the whole message at once and has "
                "no per-block collectives to overlap — use "
                "blocks='sequential' or placement='sharded'")
        if (self.schedule.superleaf_elems > 0
                and self.aggregate.rule in _ITERATIVE_RULES):
            warnings.warn(
                f"superleaf_elems={self.schedule.superleaf_elems} with the "
                f"iterative rule {self.aggregate.rule!r}: uniform chunks "
                "REPLACE per-tensor leaves as the robust-aggregation block "
                "partition (block-robust, not whole-message, semantics); "
                "set superleaf_elems=0 to keep tensor-boundary blocks",
                PlanWarning, stacklevel=3)

    # -- worker-count validation -------------------------------------------

    def validate_workers(self, n_workers: int) -> None:
        """Raise PlanError when the plan cannot run over ``n_workers``."""
        if self.cohort is not None and self.cohort > n_workers:
            raise PlanError(
                f"cohort C={self.cohort} exceeds the {n_workers} available "
                "workers: partial participation samples C of n workers, so "
                "C must be <= n")

    # -- compilation --------------------------------------------------------

    def build_aggregator(self) -> Aggregator:
        """The ``Aggregator`` this plan's bucket and aggregate stages
        resolve to, with the per-rule parameters the reference passes."""
        spec = self.aggregate
        kwargs = {}
        if spec.rule == "trimmed_mean":
            kwargs["trim_ratio"] = spec.trim_ratio
        if spec.rule in _SELECTION_RULES:
            kwargs["byz_bound"] = spec.byz_bound
            kwargs["m_select"] = spec.m_select
        if spec.rule == "centered_clip":
            kwargs["tau"] = spec.tau
        if spec.rule in _ITERATIVE_RULES and spec.iters:
            kwargs["iters"] = spec.iters
        return make_aggregator(
            spec.rule,
            bucket_s=self.bucket.s if self.bucket is not None else 0,
            backend=self.schedule.backend,
            **kwargs,
        )

    def build_compressor(self) -> Optional[Compressor]:
        if self.compress is None:
            return None
        c = self.compress
        kw = {"k": c.k} if c.kind == "rand_k" else \
            {"frac": c.frac} if c.kind == "rand_fraction" else {}
        return make_compressor(c.kind, **kw)

    def build(self, mesh=None) -> "ServerStep":
        """Compile the plan into one :class:`ServerStep` callable.

        ``mesh=None`` builds the whole-message engine form; a
        ``torch.distributed`` device mesh builds the distributed form
        under ``self.schedule``."""
        if mesh is None and self.schedule.placement == "sharded":
            raise PlanError(
                "placement='sharded' needs a mesh: build(mesh) runs the "
                "all_to_all schedule over the mesh's worker axes; use "
                "placement='naive' for the single-process engine form")
        if mesh is not None:
            from .mesh_exec import mesh_worker_count

            self.validate_workers(
                mesh_worker_count(mesh, self.schedule.worker_axes))
        return ServerStep(self, mesh=mesh)

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        d = {"version": PLAN_VERSION,
             "aggregate": dataclasses.asdict(self.aggregate)}
        for field in ("clip", "compress", "bucket"):
            v = getattr(self, field)
            if v is not None:
                d[field] = dataclasses.asdict(v)
        d["schedule"] = dict(dataclasses.asdict(self.schedule),
                             worker_axes=list(self.schedule.worker_axes))
        if self.cohort is not None:
            d["cohort"] = self.cohort
        return d

    def to_json(self) -> str:
        """Canonical JSON name of the plan (stable key order)."""
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "ServerPlan":
        if "aggregate" not in d:
            raise PlanError("plan dict needs an 'aggregate' stage")
        version = d.get("version", PLAN_VERSION)  # pre-versioning docs = v1
        if version != PLAN_VERSION:
            raise PlanError(
                f"unsupported plan document version {version!r}; this "
                f"reader understands version {PLAN_VERSION} (and "
                "version-less documents, which are v1)")
        unknown = set(d) - set(_SPEC_FIELDS) - {"cohort", "version"}
        if unknown:
            raise PlanError(f"unknown plan fields {sorted(unknown)}; have "
                            f"{sorted(_SPEC_FIELDS)} + ['cohort', 'version']")
        kw = {}
        for field, klass in _SPEC_FIELDS.items():
            if field in d and d[field] is not None:
                v = dict(d[field])
                if field == "schedule":
                    v["worker_axes"] = tuple(v.get("worker_axes", ()))
                kw[field] = klass(**v)
        if d.get("cohort") is not None:
            kw["cohort"] = int(d["cohort"])
        return cls(**kw)

    @classmethod
    def from_json(cls, s) -> "ServerPlan":
        try:
            d = json.loads(s) if isinstance(s, (str, bytes)) else dict(s)
        except (json.JSONDecodeError, TypeError) as e:
            raise PlanError(f"not a plan JSON document: {e}") from e
        return cls.from_dict(d)


class ServerStep:
    """A compiled ServerPlan: one callable running the whole composition.

    ``step(msgs, mask=None, key=None, radius=None, base_specs=None)``
    clips at ``radius`` (None: the plan's static ``ClipSpec(radius=)``,
    or no clip when the plan has none), then aggregates; ``key`` is
    Bucketing's row order source.  The engine form (``mesh=None``) takes
    an (n, d) matrix or a tree of worker-stacked tensors; the mesh form
    takes this rank's piece of the tree and ``base_specs`` (the ``P`` of
    each unstacked leaf) and runs the configured collective schedule
    (``repro_torch.api.mesh_exec``).

    ``step.compress(key, x)`` applies the compression stage (the identity
    when the plan has none), ``step.aggregate(...)`` forces the unclipped
    form and ``step.radius(x_new, x_old)`` evaluates the ClipSpec(alpha)
    radius.
    """

    def __init__(self, plan: ServerPlan, mesh=None):
        self.plan = plan
        self.mesh = mesh
        self.aggregator: Aggregator = plan.build_aggregator()
        self.compressor: Optional[Compressor] = plan.build_compressor()

    @property
    def clips(self) -> bool:
        return self.plan.clip is not None

    def radius(self, x_new, x_old):
        """lambda = alpha * ||x_new - x_old|| for a ClipSpec(alpha) plan;
        the static radius for ClipSpec(radius=); None when not clipping."""
        clip = self.plan.clip
        if clip is None:
            return None
        if clip.radius is not None:
            return float(clip.radius)
        from ..core.clipping import marina_radius

        return marina_radius(x_new, x_old, clip.alpha)

    def compress(self, key, x):
        """The worker-side compression stage (the identity when the plan
        has none)."""
        if self.compressor is None:
            return x
        return self.compressor(key, x)

    def aggregate(self, msgs, mask=None, key=None, base_specs=None):
        """The unclipped aggregation of the full-gradient rounds (it
        bypasses even a static ``ClipSpec(radius=)``)."""
        return self(msgs, mask=mask, key=key, radius=None,
                    base_specs=base_specs, _allow_static_clip=False)

    def __call__(self, msgs, mask=None, key=None, radius=None,
                 base_specs=None, _allow_static_clip=True):
        clip = self.plan.clip
        if (radius is None and _allow_static_clip and clip is not None
                and clip.radius is not None):
            radius = float(clip.radius)
        if self.mesh is not None:
            from .mesh_exec import run_mesh_aggregate

            return run_mesh_aggregate(
                msgs, mask, key, mesh=self.mesh, agg=self.aggregator,
                spec=self.plan.schedule, base_specs=base_specs,
                radius=radius)
        if base_specs is not None:
            raise PlanError(
                "base_specs is a mesh-build argument; this ServerStep was "
                "built with mesh=None")
        if radius is None:
            return self.aggregator(msgs, mask=mask, key=key)
        return self.aggregator.clip_then_aggregate(msgs, radius, mask=mask,
                                                   key=key)
