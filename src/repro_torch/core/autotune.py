"""Assembly autotuner: pick the SC-assembly plan the paper picks by hand
(counterpart of ``repro.core.autotune``).

The paper's central empirical result (Table 1, Figs. 5-6) is that the best
TRSM/SYRK splitting variant AND the best block size depend on the input
sparsity pattern and the machine. This module turns that choice into a
planner:

  1. **Enumerate** the ``SchurAssemblyConfig`` design space: 3 TRSM
     variants x 3 SYRK variants x candidate block sizes x pruning on/off x
     hand-written kernels on/off x factor storage, plus the fused
     TRSM→SYRK kernel, canonicalized as the reference does.
  2. **Score** every candidate with the FLOP model
     (:func:`repro_torch.core.schur.assembly_flops`) plus a byte-traffic and
     launch-count model (below), through the roofline constants of
     :mod:`repro_torch.launch.roofline` (``DeviceModel.time_s``).
  3. Optionally **measure** the model's best candidates (plus the dense
     baseline) with timed micro-runs on synthetic data carrying the exact
     sparsity pattern (``measure="auto"``), and pick the fastest.
  4. **Cache** the plan in a content-addressed on-disk cache keyed by a
     fingerprint of the sparsity pattern + device kind.

What differs from the reference: ``use_kernels`` takes ``use_pallas``'s
place. Kernel candidates are priced without the reference's interpret
penalty when the device model is a CUDA kind (``CUDA_KINDS``), and timed
only when, in addition, the stage runs on a CUDA device; the CUDA kernels
take every block size the space holds (8 to 256), so no candidate is left
out. The probes are the reference's, one
per subdomain, stacked ``batch`` deep: the stage assembles that many
subdomains at once, and a card's time depends on it. The cache is the
port's own (``$REPRO_TORCH_PLAN_CACHE_DIR``); its keys are the reference's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.precision import compute_dtype, itemsize
from repro_torch.core.schur import (
    SYRK_VARIANTS,
    TRSM_VARIANTS,
    SchurAssemblyConfig,
    assembly_flops,
    make_assembler,
    schur_dense_baseline,
)
from repro_torch.core.stepped import (
    SteppedMeta,
    build_stepped_meta,
    column_pivots,
)
from repro_torch.device import resolve_device
from repro_torch.launch.roofline import CUDA_KINDS, DeviceModel, detect_device
from repro_torch.obs import metrics
from repro_torch.obs.timing import min_time, synchronize
from repro_torch.obs.trace import current_tracer
from repro_torch.sparse import (
    block_pattern,
    block_symbolic_cholesky,
    pack_factor,
    packed_block_index_for,
)

__all__ = [
    "Plan",
    "plan_assembly",
    "plan_from_builder",
    "measure_configs",
    "enumerate_space",
    "assembly_cost",
    "assembly_bytes",
    "pattern_fingerprint",
    "default_block_sizes",
    "plan_cache_dir",
    "clear_plan_cache",
]

# Bump when the candidate space or the cost model changes shape. Equal to
# the reference's, so both packages key a pattern alike (each in its own
# cache root).
SPACE_VERSION = 5

# kernel candidates outside a CUDA device model run their plain torch
# versions, far slower than the library calls: the model multiplies their
# times by this so they are enumerated but never win there (the
# reference's interpret penalty)
_INTERPRET_PENALTY = 200.0

_F64 = 8  # assembly dtype bytes (the FETI substrate runs f64)

TorchDevice = Union[str, torch.device, None]


# --------------------------------------------------------------------------
# byte-traffic + launch-count model (complements SteppedMeta's FLOP model)
# --------------------------------------------------------------------------

def _packed_blocks(meta: SteppedMeta,
                   block_mask: Optional[np.ndarray]) -> int:
    """Stored factor blocks under packed storage: the fill mask's nnz, or
    the full lower triangle when no symbolic mask is available."""
    nb = meta.num_row_blocks
    if block_mask is None:
        return nb * (nb + 1) // 2
    return int(np.tril(np.asarray(block_mask)).sum())


def _trsm_bytes_ops(meta: SteppedMeta, cfg: SchurAssemblyConfig,
                    block_mask: Optional[np.ndarray], db: int
                    ) -> Tuple[float, int]:
    n, m = meta.n, meta.m
    packed = cfg.storage == "packed"
    if cfg.use_kernels and cfg.trsm_variant != "dense":
        # one kernel launch; streams the factor (packed: only the stored
        # blocks + the block index), Linv and B/Y once
        bs = meta.block_size
        n_pad = meta.num_row_blocks * bs
        m_pad = meta.num_col_blocks * meta.rhs_block_size
        if packed:
            factor = _packed_blocks(meta, block_mask) * bs * bs
        else:
            factor = n_pad * n_pad / 2
        return db * (factor + n_pad * bs + 2 * n_pad * m_pad), 1
    if cfg.trsm_variant == "dense":
        extra = 0.0
        if packed:
            # transient densify of the packed factor before the library TRSM
            extra = _packed_blocks(meta, block_mask) * meta.block_size ** 2 \
                + n * n / 2
        return db * (n * n / 2 + 2 * n * m + extra), 1 + int(packed)
    if cfg.trsm_variant == "rhs_split":
        total, ops = 0.0, 0
        if packed:  # transient densify before the per-stripe solves
            total += db * (_packed_blocks(meta, block_mask)
                           * meta.block_size ** 2 + n * n / 2)
            ops += 1
        for c in range(meta.num_col_blocks):
            c0, c1 = meta.col_block(c)
            s = int(meta.col_starts[c])
            if s >= n:
                continue
            nn = n - s
            total += db * (nn * nn / 2 + 2 * nn * (c1 - c0))
            ops += 1
        return total, ops
    # factor_split: packed storage prunes structurally (absent blocks are
    # never addressed), so it always takes the masked accounting
    total, ops = 0.0, 0
    nb = meta.num_row_blocks
    mask = np.asarray(block_mask) \
        if ((cfg.prune or packed) and block_mask is not None) else None
    for k in range(nb):
        r0, r1 = meta.row_block(k)
        b = r1 - r0
        w = int(meta.widths[k])
        if w == 0:
            continue
        total += db * (b * b / 2 + 2 * b * w)  # diagonal TRSM
        ops += 1
        if r1 >= n:
            continue
        if mask is None:
            total += db * ((n - r1) * b + 2 * (n - r1) * w)
            ops += 1
        else:
            for i in range(k + 1, nb):
                if not mask[i, k]:
                    continue
                i0, i1 = meta.row_block(i)
                total += db * ((i1 - i0) * b + 2 * (i1 - i0) * w)
                ops += 1
    return total, ops


def _syrk_bytes_ops(meta: SteppedMeta, cfg: SchurAssemblyConfig,
                    db: int) -> Tuple[float, int]:
    n, m = meta.n, meta.m
    if cfg.use_kernels and cfg.syrk_variant != "dense":
        n_pad = meta.num_row_blocks * meta.block_size
        m_pad = meta.num_col_blocks * meta.rhs_block_size
        return db * (n_pad * m_pad + m_pad * m_pad), 1
    if cfg.syrk_variant == "dense":
        return db * (n * m + m * m), 1
    if cfg.syrk_variant == "input_split":
        total, ops = 0.0, 0
        for k in range(meta.num_row_blocks):
            r0, r1 = meta.row_block(k)
            w = int(meta.widths[k])
            if w == 0:
                continue
            # read the row block + read-modify-write the w x w accumulator:
            # this term is what penalizes small blocks for input_split
            total += db * ((r1 - r0) * w + 2 * w * w)
            ops += 1
        return total, ops
    # output_split
    total, ops = 0.0, 0
    for i in range(meta.num_col_blocks):
        i0, i1 = meta.col_block(i)
        s = int(meta.col_starts[i])
        if s >= n:
            continue
        ci = i1 - i0
        total += db * ((n - s) * ci + ci * ci)
        ops += 1
        if i0 > 0:
            total += db * ((n - s) * i0 + 2 * ci * i0)
            ops += 1
    return total, ops


def assembly_bytes(meta: SteppedMeta, cfg: SchurAssemblyConfig,
                   block_mask: Optional[np.ndarray] = None,
                   dtype_bytes: int = _F64) -> dict:
    """Estimated main-memory traffic (bytes) and dispatched-op counts."""
    if cfg.fused:
        # ONE kernel launch: factor + Linv + B in, F out — the Y panel
        # stays on chip (unfused pays ~2·n·m for the Y round-trip)
        db = dtype_bytes
        bs = meta.block_size
        n_pad = meta.num_row_blocks * bs
        m_pad = meta.num_col_blocks * meta.rhs_block_size
        if cfg.storage == "packed":
            factor = _packed_blocks(meta, block_mask) * bs * bs
        else:
            factor = n_pad * n_pad / 2
        total = db * (factor + n_pad * bs + n_pad * m_pad + m_pad * m_pad)
        # attribute it all to "trsm" so the roofline sums stay well-formed
        return {"trsm": total, "syrk": 0.0, "total": total,
                "trsm_ops": 1, "syrk_ops": 0, "ops": 1}
    tb, to = _trsm_bytes_ops(meta, cfg, block_mask, dtype_bytes)
    sb, so = _syrk_bytes_ops(meta, cfg, dtype_bytes)
    return {"trsm": tb, "syrk": sb, "total": tb + sb,
            "trsm_ops": to, "syrk_ops": so, "ops": to + so}


def assembly_cost(meta: SteppedMeta, cfg: SchurAssemblyConfig,
                  device: DeviceModel,
                  block_mask: Optional[np.ndarray] = None,
                  dtype: str = "f64") -> dict:
    """Roofline time estimate of one assembly under ``cfg`` on ``device``.

    FLOPs come from :func:`assembly_flops`, bytes and launch counts from
    :func:`assembly_bytes`; ``DeviceModel.time_s`` combines them.
    ``dtype`` is the stage's storage dtype name ("f64" | "f32" | "bf16"):
    it scales the byte model by itemsize and selects the per-dtype FLOP
    peak. Kernel candidates outside a CUDA device model get the interpret
    penalty (they are enumerated, but cannot win).
    """
    db = itemsize(dtype)
    fl = assembly_flops(meta, cfg)
    by = assembly_bytes(meta, cfg, block_mask, db)
    trsm_s = device.time_s(fl["trsm"], by["trsm"], by["trsm_ops"],
                           dtype=dtype)
    syrk_s = device.time_s(fl["syrk"], by["syrk"], by["syrk_ops"],
                           dtype=dtype)
    total = trsm_s + syrk_s
    if cfg.use_kernels and device.kind not in CUDA_KINDS:
        total *= _INTERPRET_PENALTY
    return {"trsm_s": trsm_s, "syrk_s": syrk_s, "total_s": total,
            "flops": fl["total"], "bytes": by["total"], "ops": by["ops"]}


# --------------------------------------------------------------------------
# candidate enumeration
# --------------------------------------------------------------------------

def default_block_sizes(n: int) -> Tuple[int, ...]:
    """Candidate factor block sizes for an n-row factor: powers of two in
    the paper's sweep range, clipped to the problem size."""
    cands = [b for b in (8, 16, 32, 64, 128, 256) if b <= n]
    return tuple(cands) if cands else (max(1, n),)


def enumerate_space(block_sizes: Sequence[int],
                    storage: Optional[str] = None
                    ) -> list[SchurAssemblyConfig]:
    """The full Table-1 design space, canonicalized, in the reference's
    order.

    3 TRSM x 3 SYRK x |block_sizes| x prune on/off x kernels on/off x
    storage, minus structural duplicates: ``prune`` only affects plain
    ``factor_split`` TRSM, ``use_kernels`` is an identity when both
    variants are "dense" (the kernels only cover split variants), and
    packed storage is only enumerated where it is native (``factor_split``
    TRSM and the kernels). ``storage`` restricts the space to one layout
    ("dense"/"packed"); ``None`` enumerates both. The fused TRSM→SYRK kernel
    adds one candidate per (block size, storage), its own family in the
    measured refinement.
    """
    if storage not in (None, "dense", "packed"):
        raise ValueError(f"storage must be None|dense|packed, got {storage!r}")
    want = ("dense", "packed") if storage is None else (storage,)
    out = []
    for bs in block_sizes:
        for tv in TRSM_VARIANTS:
            for sv in SYRK_VARIANTS:
                if "dense" in want:
                    prunes = (False, True) if tv == "factor_split" \
                        else (False,)
                    for prune in prunes:
                        out.append(SchurAssemblyConfig(
                            trsm_variant=tv, syrk_variant=sv, block_size=bs,
                            prune=prune, use_kernels=False, storage="dense"))
                if "packed" in want and tv == "factor_split":
                    out.append(SchurAssemblyConfig(
                        trsm_variant=tv, syrk_variant=sv, block_size=bs,
                        prune=True, use_kernels=False, storage="packed"))
                if tv == "dense" and sv == "dense":
                    continue
                if "dense" in want:
                    out.append(SchurAssemblyConfig(
                        trsm_variant=tv, syrk_variant=sv, block_size=bs,
                        prune=False, use_kernels=True, storage="dense"))
                if "packed" in want and tv == "factor_split":
                    out.append(SchurAssemblyConfig(
                        trsm_variant=tv, syrk_variant=sv, block_size=bs,
                        prune=False, use_kernels=True, storage="packed"))
        if "dense" in want:
            out.append(SchurAssemblyConfig(
                trsm_variant="rhs_split", syrk_variant="output_split",
                block_size=bs, prune=False, use_kernels=True, fused=True,
                storage="dense"))
        if "packed" in want:
            out.append(SchurAssemblyConfig(
                trsm_variant="factor_split", syrk_variant="output_split",
                block_size=bs, prune=False, use_kernels=True, fused=True,
                storage="packed"))
    return out


# --------------------------------------------------------------------------
# content-addressed plan cache
# --------------------------------------------------------------------------

def plan_cache_dir() -> str:
    """Cache root: ``$REPRO_TORCH_PLAN_CACHE_DIR``, else
    ``~/.cache/repro_torch/plans``. Never the reference's root (its plans
    carry ``use_pallas``). Read at every access, so tests can point the
    planner at a temp dir."""
    root = os.environ.get("REPRO_TORCH_PLAN_CACHE_DIR")
    if not root:
        root = os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                            "plans")
    return root


def clear_plan_cache() -> int:
    """Delete every cached plan; returns the number removed."""
    root = plan_cache_dir()
    if not os.path.isdir(root):
        return 0
    removed = 0
    for fn in os.listdir(root):
        if fn.endswith(".json"):
            os.remove(os.path.join(root, fn))
            removed += 1
    return removed


def pattern_fingerprint(pivots: np.ndarray, n: int, m: int,
                        extra: Sequence[np.ndarray] = ()) -> str:
    """Content hash of what the cost model can see of a sparsity pattern:
    the column pivots (plus factor structure via ``extra``). Two B̃ᵀ
    patterns with identical pivots assemble identically and share a plan."""
    h = hashlib.sha256()
    h.update(f"{n}:{m}:".encode())
    h.update(np.ascontiguousarray(pivots, dtype=np.int64).tobytes())
    for a in extra:
        h.update(b"|")
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _cache_key(fingerprint: str, device: DeviceModel,
               block_sizes: Sequence[int], measured: bool,
               storage: Optional[str] = None,
               stage: str = "dual",
               dtype: str = "f64") -> str:
    # `measured`, the storage restriction, the stage and the dtype each
    # search a different space or rank it differently (as in the reference)
    h = hashlib.sha256()
    h.update(f"v{SPACE_VERSION}:{device.kind}:{stage}:{fingerprint}:"
             f"{int(measured)}:{storage or 'any'}:{dtype}:".encode())
    h.update(",".join(str(b) for b in sorted(block_sizes)).encode())
    return h.hexdigest()


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Plan:
    """A chosen assembly configuration plus its cost accounting.

    ``predicted_s`` is the roofline-model estimate, ``measured_s`` the
    min-of-reps timed micro-run (None when ``measure="never"``).
    ``baseline_*`` are the same numbers for the dense baseline. ``timed``
    counts the candidates measured.
    """

    cfg: SchurAssemblyConfig
    predicted_s: float
    measured_s: Optional[float]
    baseline_predicted_s: float
    baseline_measured_s: Optional[float]
    device: str
    key: str
    candidates: int
    dtype: str = "f64"
    timed: int = 0
    from_cache: bool = False

    @property
    def predicted_speedup(self) -> float:
        return self.baseline_predicted_s / max(self.predicted_s, 1e-30)

    @property
    def measured_speedup(self) -> Optional[float]:
        if self.measured_s is None or self.baseline_measured_s is None:
            return None
        return self.baseline_measured_s / max(self.measured_s, 1e-30)

    def summary(self) -> str:
        c = self.cfg
        lines = [
            f"plan[{self.device}] trsm={c.trsm_variant} "
            f"syrk={c.syrk_variant} block={c.block_size} "
            f"rhs_block={c.rhs_bs} prune={c.prune} kernels={c.use_kernels} "
            f"fused={c.fused} storage={c.storage} dtype={self.dtype}"
            f"{' (cached)' if self.from_cache else ''}",
            f"  predicted {self.predicted_s * 1e6:9.1f}us  "
            f"(dense baseline {self.baseline_predicted_s * 1e6:.1f}us, "
            f"{self.predicted_speedup:.2f}x) over "
            f"{self.candidates} candidates, {self.timed} timed",
        ]
        if self.measured_s is not None:
            base = ("" if self.baseline_measured_s is None else
                    f"  (dense baseline {self.baseline_measured_s * 1e6:.1f}"
                    f"us, {self.measured_speedup:.2f}x)")
            lines.append(
                f"  measured  {self.measured_s * 1e6:9.1f}us{base}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["cfg"] = dataclasses.asdict(self.cfg)
        d.pop("from_cache")
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Plan":
        d = dict(d)
        d["cfg"] = SchurAssemblyConfig(**d["cfg"])
        # entries written while the CUDA kernels refused bs > 128 carry
        # the count of candidates left out
        d.pop("refused", None)
        return cls(**d, from_cache=True)


def _load_cached(key: str) -> Optional[Plan]:
    path = os.path.join(plan_cache_dir(), key + ".json")
    try:
        with open(path) as f:
            return Plan.from_json(json.load(f))
    except (OSError, ValueError, TypeError, KeyError):
        return None


def _store(plan: Plan) -> None:
    root = plan_cache_dir()
    try:
        os.makedirs(root, exist_ok=True)
        tmp = os.path.join(root, f".{plan.key}.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(plan.to_json(), f, indent=1)
        os.replace(tmp, os.path.join(root, plan.key + ".json"))
    except OSError:
        pass  # cache is best-effort; planning correctness never depends on it


# --------------------------------------------------------------------------
# timed micro-runs
# --------------------------------------------------------------------------

def _synthesize_inputs(meta: SteppedMeta, seed: int = 0):
    """Timing probes with the exact sparsity pattern (the reference's, from
    the same generator); values are never consumed numerically, only their
    shapes/pattern drive the schedule."""
    rng = np.random.default_rng(seed)
    n, m = meta.n, meta.m
    L = np.tril(rng.standard_normal((n, n))) * 0.05
    np.fill_diagonal(L, 1.0 + rng.random(n))
    piv_orig = meta.pivots[meta.inv_perm]
    Bt = np.zeros((n, m))
    cols = np.flatnonzero(piv_orig < n)
    Bt[piv_orig[cols], cols] = rng.choice([-1.0, 1.0], size=len(cols))
    return L, Bt


class _Bench:
    """The measured step's probes on the stage's device, and its timer.

    The probes are :func:`_synthesize_inputs`' pair stacked ``batch`` deep
    at the stage's compute dtype; the dense baseline is timed on creation.
    A packed candidate's factor is packed outside the timed region, as
    preprocessing packs once."""

    def __init__(self, meta: SteppedMeta, dtype: str, batch: int,
                 device: torch.device, reps: int):
        self.reps = reps
        cd = compute_dtype(dtype)
        Lh, Bth = _synthesize_inputs(meta)
        self.L = torch.as_tensor(Lh, dtype=cd, device=device).expand(
            batch, -1, -1).contiguous()
        self.Bt = torch.as_tensor(Bth, dtype=cd, device=device).expand(
            batch, -1, -1).contiguous()
        # a throwaway run first: BLAS threads, clocks, library handles
        synchronize(schur_dense_baseline(self.L, self.Bt))
        self.baseline_s = min_time(schur_dense_baseline, self.L, self.Bt,
                                   reps=reps)

    def __call__(self, cfg: SchurAssemblyConfig, meta: SteppedMeta,
                 mask: Optional[np.ndarray]) -> float:
        if cfg.is_dense_baseline and cfg.storage == "dense":
            # the same program as schur_dense_baseline: reuse its time
            return self.baseline_s
        L = self.L
        if cfg.storage == "packed":
            L = pack_factor(L, packed_block_index_for(mask, meta.n,
                                                      cfg.block_size))
            synchronize(L)
        return min_time(make_assembler(meta, cfg, mask), L, self.Bt,
                        reps=self.reps)


# --------------------------------------------------------------------------
# the planner
# --------------------------------------------------------------------------

MetaBuilder = Callable[
    [int, int], Tuple[SteppedMeta, Optional[np.ndarray]]
]  # (block_size, rhs_block_size) -> (meta, block_mask)


def measure_configs(
    meta_builder: MetaBuilder,
    cfgs: Sequence[SchurAssemblyConfig],
    *,
    dtype: str = "f64",
    batch: int = 1,
    torch_device: TorchDevice = None,
    reps: int = 5,
) -> Tuple[list, float]:
    """``(seconds of each config, seconds of the dense baseline)``: the
    measured step's timer on its probes, for configs chosen by the caller
    (e.g. a plan against a hand-picked config). Kernel configs run their
    kernels on a CUDA device, their plain versions on the CPU."""
    dev = resolve_device(torch_device)
    bench = None
    out = []
    for cfg in cfgs:
        meta, mask = meta_builder(cfg.block_size, cfg.rhs_bs)
        if bench is None:
            bench = _Bench(meta, dtype, batch, dev, reps)
        out.append(bench(cfg, meta, mask))
    return out, (bench.baseline_s if bench is not None else None)


def plan_from_builder(
    meta_builder: MetaBuilder,
    fingerprint: str,
    *,
    block_sizes: Optional[Sequence[int]] = None,
    n_hint: Optional[int] = None,
    measure: str = "auto",
    top_k: int = 8,
    device: Optional[DeviceModel] = None,
    cache: bool = True,
    reps: int = 5,
    storage: Optional[str] = None,
    stage: str = "dual",
    dtype: str = "f64",
    torch_device: TorchDevice = None,
    batch: int = 1,
) -> Plan:
    """Core search, builder-parameterized so the cluster path scores the
    envelope metadata it will execute with (see feti.assembly).

    ``measure``: "auto" refines the model's top candidates with timed
    micro-runs ("never"/"model" skips them: pure roofline ranking).
    ``device`` is the :class:`DeviceModel` that prices candidates (default:
    the model of ``torch_device``); ``torch_device`` is where the measured
    step runs (default ``cuda``); ``batch`` how many subdomains its probes
    stack. Kernel candidates are timed only under a CUDA device model on a
    CUDA device.

    ``storage`` restricts the search to one factor layout ("dense" |
    "packed"); ``None`` searches both. ``stage`` names the assembly
    ("dual" | "dirichlet"; it enters the cache key only). ``dtype`` is the
    stage's storage dtype ("f64" | "f32" | "bf16"): it prices candidates,
    sets the probes' compute dtype and joins the cache key.
    """
    if measure not in ("auto", "never", "model"):
        raise ValueError(f"measure must be auto|never|model, got {measure!r}")
    if device is None:
        device = detect_device(resolve_device(torch_device))

    probe_meta, _ = meta_builder(8, 8) if n_hint is None else (None, None)
    n = n_hint if n_hint is not None else probe_meta.n
    if block_sizes is None:
        block_sizes = default_block_sizes(n)

    key = _cache_key(fingerprint, device, block_sizes,
                     measured=(measure == "auto"), storage=storage,
                     stage=stage, dtype=dtype)
    if cache:
        hit = _load_cached(key)
        if hit is not None:
            metrics.inc("plan_cache.stage.hit", stage=stage, dtype=dtype)
            return hit
    # counted also when the graph planner bypasses the per-stage cache
    # (cache=False): a "miss" is a search actually performed
    metrics.inc("plan_cache.stage.miss", stage=stage, dtype=dtype)
    tr = current_tracer()

    candidates = enumerate_space(block_sizes, storage=storage)
    cuda_model = device.kind in CUDA_KINDS

    # score every candidate with the roofline model; metas/masks are shared
    # per (block_size, rhs_block_size) so the builder runs once per size
    built: dict[tuple, tuple] = {}
    scored = []
    with tr.span("plan:score", stage=stage, dtype=dtype) as sp:
        for cfg in candidates:
            bk = (cfg.block_size, cfg.rhs_bs)
            if bk not in built:
                built[bk] = meta_builder(*bk)
            meta, mask = built[bk]
            cost = assembly_cost(meta, cfg, device, block_mask=mask,
                                 dtype=dtype)
            scored.append((cost["total_s"], cfg, meta, mask))
        scored.sort(key=lambda t: t[0])
        sp.set(candidates=len(scored))

    dense_cfg = SchurAssemblyConfig(
        trsm_variant="dense", syrk_variant="dense",
        block_size=min(block_sizes), prune=False, storage="dense")
    bk = (dense_cfg.block_size, dense_cfg.rhs_bs)
    if bk not in built:
        built[bk] = meta_builder(*bk)
    dense_meta, dense_mask = built[bk]
    baseline_pred = assembly_cost(
        dense_meta, dense_cfg, device, block_mask=dense_mask,
        dtype=dtype)["total_s"]

    best_s, best_cfg, best_meta, best_mask = scored[0]
    measured_s = baseline_meas = None
    timed = 0

    if measure == "auto":
        run_dev = resolve_device(torch_device)
        with tr.span("plan:measure", stage=stage, dtype=dtype) as sp_meas:
            bench = _Bench(dense_meta, dtype, batch, run_dev, reps)
            baseline_meas = bench.baseline_s

            # Two-stage measured refinement (as the reference). The model
            # is only trusted to rank candidates WITHIN a variant family:
            #   stage 1 — time the model-best candidate of every family;
            #             dense/dense is one of them, so the chosen plan
            #             is never slower than the baseline it reports;
            #   stage 2 — sweep the winning family across its remaining
            #             block sizes / prune / kernel toggles, bounded by
            #             top_k.
            # The fused kernel is its own family, so whenever kernel
            # candidates run, fused is timed against unfused.
            def _family(cfg):
                return (cfg.trsm_variant, cfg.syrk_variant, cfg.storage,
                        cfg.fused)

            kernels_run = cuda_model and run_dev.type == "cuda"
            runnable = [t for t in scored
                        if kernels_run or not t[1].use_kernels]
            stage1: dict = {}
            for t in runnable:  # runnable is model-score sorted
                stage1.setdefault(_family(t[1]), t)
            results = [(bench(*t[1:]), t) for t in stage1.values()]
            _, win = min(results, key=lambda r: r[0])
            win_pair = _family(win[1])
            stage2 = [t for t in runnable
                      if _family(t[1]) == win_pair
                      and t is not stage1[win_pair]][:top_k]
            results += [(bench(*t[1:]), t) for t in stage2]

            best_meas, (best_s, best_cfg, best_meta, best_mask) = \
                min(results, key=lambda r: r[0])
            measured_s = best_meas
            if baseline_meas < best_meas and storage != "packed":
                # noise guard: never ship a plan measured slower than
                # dense (unless the caller pinned packed storage — then the
                # layout is a requirement, not a candidate)
                best_s, best_cfg = baseline_pred, dense_cfg
                measured_s = baseline_meas
            timed = len(results)
            sp_meas.set(timed=timed)
            del bench

    plan = Plan(
        cfg=best_cfg,
        predicted_s=float(best_s),
        measured_s=measured_s,
        baseline_predicted_s=float(baseline_pred),
        baseline_measured_s=baseline_meas,
        device=device.kind,
        key=key,
        candidates=len(candidates),
        dtype=dtype,
        timed=timed,
    )
    if cache:
        _store(plan)
    return plan


def plan_assembly(
    pattern: np.ndarray,
    *,
    factor_pattern: Optional[np.ndarray] = None,
    block_sizes: Optional[Sequence[int]] = None,
    measure: str = "auto",
    top_k: int = 8,
    device: Optional[DeviceModel] = None,
    cache: bool = True,
    storage: Optional[str] = None,
    dtype: str = "f64",
    torch_device: TorchDevice = None,
) -> Plan:
    """Plan the SC assembly for one B-transpose sparsity ``pattern``.

    Args:
      pattern: (n, m) boolean-ish sparsity pattern of B-transpose in factor
        row order / original column order (what :func:`build_stepped_meta`
        takes).
      factor_pattern: optional (n, n) sparsity pattern of the (permuted)
        stiffness matrix; enables scoring of the pruning toggle via the
        symbolic block fill mask at each candidate block size.
      block_sizes / measure / top_k / device / cache / storage / dtype /
        torch_device: see :func:`plan_from_builder`.
    """
    pattern = np.asarray(pattern) != 0
    n, m = pattern.shape

    def builder(bs: int, rbs: int):
        meta = build_stepped_meta(pattern, block_size=bs, rhs_block_size=rbs)
        mask = None
        if factor_pattern is not None:
            mask = block_symbolic_cholesky(
                block_pattern(factor_pattern, bs))
        return meta, mask

    extra = []
    if factor_pattern is not None:
        # cheap factor-structure summary: per-row nonzero counts
        extra.append(np.asarray(factor_pattern != 0).sum(axis=1)
                     .astype(np.int64))
    fp = pattern_fingerprint(column_pivots(pattern), n, m, extra=extra)
    return plan_from_builder(
        builder, fp, block_sizes=block_sizes, n_hint=n, measure=measure,
        top_k=top_k, device=device, cache=cache, storage=storage,
        dtype=dtype, torch_device=torch_device)
