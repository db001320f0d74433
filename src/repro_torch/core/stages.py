"""Declarative Schur stage graph: plan many assembly stages JOINTLY
(counterpart of ``repro.core.stages``).

Preprocessing has two Schur pipelines — the dual operator
F̃ = (L⁻¹B̃ᵀ)ᵀ(L⁻¹B̃ᵀ) and the primal boundary S_b = K_bb − K_bi·K_ii⁻¹·K_ib
of the Dirichlet preconditioner. This module plans them as one unit:

  * a :class:`StageSpec` declares one stage symbolically: a builder
    producing its stepped metadata + factor fill mask at any candidate
    block size, a content fingerprint of its sparsity inputs, its storage
    restriction and dtype, the number of subdomains it assembles at once,
    and (optionally) which other stage's factor it shares
    (``share_factor_of`` — the interior-factor dedup);
  * a :class:`StageGraph` plans ALL stages under ONE cache key (the
    reference's key, in the port's cache root) and resolves each stage to
    concrete metadata + assembler;
  * execution stays with the caller (feti.assembly runs the resolved
    stages); the graph is symbolic/planning state.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.autotune import (
    SPACE_VERSION,
    Plan,
    TorchDevice,
    default_block_sizes,
    plan_cache_dir,
    plan_from_builder,
)
from repro_torch.core.precision import itemsize
from repro_torch.core.schur import SchurAssemblyConfig, make_assembler
from repro_torch.core.stepped import SteppedMeta
from repro_torch.device import resolve_device
from repro_torch.launch.roofline import DeviceModel, detect_device
from repro_torch.obs import metrics
from repro_torch.obs.trace import current_tracer

__all__ = [
    "StageSpec",
    "StageGraph",
    "GraphPlan",
    "ResolvedStage",
]

# (block_size, rhs_block_size) -> (stepped metadata, factor block fill mask)
StageBuilder = Callable[[int, int], Tuple[SteppedMeta, Optional[np.ndarray]]]


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One Schur assembly stage, declared symbolically.

    Attributes:
      name: unique stage name — the plan slot and part of the joint
        cache key ("dual" | "dirichlet" in
        :func:`repro_torch.feti.assembly.preprocess_cluster`).
      builder: ``(block_size, rhs_block_size) -> (meta, block_mask)`` —
        the stage's stepped metadata and symbolic factor fill mask at any
        candidate block size (the same contract as
        :func:`repro_torch.core.autotune.plan_from_builder`).
      fingerprint: content hash of the stage's sparsity inputs (pivots,
        factor structure, orderings) — what makes the joint cache key.
      n: factor dimension; drives the default block-size candidates.
      storage: restrict this stage's search to one factor layout
        ("dense" | "packed"); None searches both.
      dtype: storage dtype of the stage's arrays ("f64" | "f32" |
        "bf16") — the precision axis. Enters the cost model (per-dtype
        FLOP peaks, itemsize-scaled bytes), the measurement probes and
        the joint cache key; ``dtype_bytes`` stays available as a
        derived property for byte accounting.
      block_sizes: override the candidate block sizes (None = derived
        from ``n``).
      share_factor_of: name of an earlier stage whose factor's leading
        principal block this stage reuses instead of factorizing its own
        matrix (the interior-factor dedup). Planning still searches this
        stage's assembly space; only the factorization is elided — the
        caller wires the shared factor at execution time.
      measure: per-stage override of the graph-level measurement policy
        (e.g. "never" for a stage whose assembly is not executed, like
        the dual stage of an implicit solve); None inherits.
      batch: subdomains the stage assembles in one call; the measured
        step stacks its probes that deep. Not in the cache key (the
        reference's key): the dual stage's fingerprint holds every
        subdomain's pivots.
    """

    name: str
    builder: StageBuilder
    fingerprint: str
    n: int
    storage: Optional[str] = None
    dtype: str = "f64"
    block_sizes: Optional[Tuple[int, ...]] = None
    share_factor_of: Optional[str] = None
    measure: Optional[str] = None
    batch: int = 1

    @property
    def dtype_bytes(self) -> int:
        """Element size of the stage's stored arrays (byte accounting)."""
        return itemsize(self.dtype)

    def candidate_block_sizes(self) -> Tuple[int, ...]:
        return self.block_sizes or default_block_sizes(self.n)


@dataclasses.dataclass
class ResolvedStage:
    """A stage bound to a concrete config: metadata, mask and assembler."""

    spec: StageSpec
    cfg: SchurAssemblyConfig
    meta: SteppedMeta
    mask: Optional[np.ndarray]
    plan: Optional[Plan] = None

    def assembler(self):
        """``assemble(L, Bt) -> F`` for this stage (core.schur), batched
        over subdomains."""
        return make_assembler(self.meta, self.cfg, self.mask)


@dataclasses.dataclass
class GraphPlan:
    """The jointly-planned result: one cache entry covering every stage."""

    key: str
    device: str
    plans: dict  # stage name -> Plan
    from_cache: bool = False

    def __getitem__(self, name: str) -> Plan:
        return self.plans[name]

    def summary(self) -> str:
        lines = [f"graph[{self.device}] {len(self.plans)} stage(s), "
                 f"joint key {self.key[:12]}"
                 f"{' (cached)' if self.from_cache else ''}"]
        for name, plan in self.plans.items():
            lines.append(f"[{name}]")
            lines.extend("  " + ln for ln in plan.summary().splitlines())
        return "\n".join(lines)


def _graph_cache_path(key: str) -> str:
    return os.path.join(plan_cache_dir(), f"graph-{key}.json")


def _load_graph_cached(key: str) -> Optional[GraphPlan]:
    try:
        with open(_graph_cache_path(key)) as f:
            d = json.load(f)
        plans = {name: Plan.from_json(p) for name, p in d["stages"].items()}
        return GraphPlan(key=key, device=d["device"], plans=plans,
                         from_cache=True)
    except (OSError, ValueError, TypeError, KeyError):
        return None


def _store_graph(gp: GraphPlan) -> None:
    root = plan_cache_dir()
    try:
        os.makedirs(root, exist_ok=True)
        tmp = os.path.join(root, f".graph-{gp.key}.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump({"device": gp.device,
                       "stages": {n: p.to_json()
                                  for n, p in gp.plans.items()}}, f, indent=1)
        os.replace(tmp, _graph_cache_path(gp.key))
    except OSError:
        pass  # best-effort, like the single-plan cache


class StageGraph:
    """An ordered set of :class:`StageSpec` planned as ONE unit.

    The joint cache key hashes every stage's (name, fingerprint, storage,
    block sizes, factor-sharing edge) plus the device kind and
    ``SPACE_VERSION`` — any stage changing invalidates the whole graph
    entry, so the stages can never be served mutually-stale plans.
    """

    def __init__(self, stages: Sequence[StageSpec]):
        names = [s.name for s in stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names: {names}")
        by_name = {}
        for s in stages:
            if s.share_factor_of is not None \
                    and s.share_factor_of not in by_name:
                raise ValueError(
                    f"stage {s.name!r} shares the factor of "
                    f"{s.share_factor_of!r}, which is not an earlier stage")
            by_name[s.name] = s
        self.stages: Tuple[StageSpec, ...] = tuple(stages)
        self.by_name = by_name

    def __iter__(self):
        return iter(self.stages)

    def __getitem__(self, name: str) -> StageSpec:
        return self.by_name[name]

    # -- joint planning ----------------------------------------------------

    def joint_key(self, device: DeviceModel, measured: bool) -> str:
        h = hashlib.sha256()
        h.update(f"v{SPACE_VERSION}:graph:{device.kind}:"
                 f"{int(measured)}:".encode())
        for s in self.stages:
            bss = ",".join(str(b) for b in sorted(s.candidate_block_sizes()))
            h.update(f"|{s.name}:{s.fingerprint}:{s.storage or 'any'}:"
                     f"{s.dtype}:{bss}:"
                     f"{s.share_factor_of or '-'}:"
                     f"{s.measure or 'inherit'}".encode())
        return h.hexdigest()

    def plan(
        self,
        *,
        measure: str = "auto",
        device: Optional[DeviceModel] = None,
        cache: bool = True,
        top_k: int = 8,
        reps: int = 5,
        torch_device: TorchDevice = None,
    ) -> GraphPlan:
        """Plan every stage; hit or populate ONE joint cache entry.

        Per-stage searches reuse :func:`plan_from_builder` (same cost
        model, same two-stage measured refinement, same never-slower-than
        guards) with that function's own cache bypassed — the graph entry
        is the only cache at this level. ``torch_device`` is where the
        stages run (default ``cuda``); ``device`` defaults to its model.
        """
        if device is None:
            device = detect_device(resolve_device(torch_device))
        key = self.joint_key(device, measured=(measure == "auto"))
        if cache:
            hit = _load_graph_cached(key)
            if hit is not None and set(hit.plans) == set(self.by_name):
                metrics.inc("plan_cache.graph.hit", key=key[:12])
                return hit
        metrics.inc("plan_cache.graph.miss", key=key[:12])
        tr = current_tracer()
        with tr.span("plan:graph", key=key[:12], measure=measure) as sp:
            plans = {}
            for s in self.stages:
                plans[s.name] = plan_from_builder(
                    s.builder, s.fingerprint,
                    block_sizes=s.candidate_block_sizes(), n_hint=s.n,
                    measure=s.measure or measure, top_k=top_k,
                    device=device, cache=False, reps=reps,
                    storage=s.storage, stage=s.name, dtype=s.dtype,
                    torch_device=torch_device, batch=s.batch)
            sp.set(stages=list(plans))
        gp = GraphPlan(key=key, device=device.kind, plans=plans)
        if cache:
            _store_graph(gp)
        return gp

    # -- resolution --------------------------------------------------------

    def resolve(
        self,
        cfgs: Mapping[str, SchurAssemblyConfig],
        plans: Optional[Mapping[str, Plan]] = None,
    ) -> dict:
        """Bind every stage to a concrete config: build the stepped
        metadata + fill mask it will execute with. ``cfgs`` maps stage
        name -> config (e.g. ``{name: gplan[name].cfg}`` after
        :meth:`plan`, or explicit configs without planning)."""
        out = {}
        for s in self.stages:
            cfg = cfgs[s.name]
            meta, mask = s.builder(cfg.block_size, cfg.rhs_bs)
            out[s.name] = ResolvedStage(
                spec=s, cfg=cfg, meta=meta, mask=mask,
                plan=None if plans is None else plans.get(s.name))
        return out
