"""The dry-run's cells: does each (architecture × input shape × mesh) cell
fit, and what are its analytic counts (counterpart of
``repro.launch.dryrun``).

For every cell the row holds the analytic FLOP / byte / residency counts
(:mod:`repro_torch.launch.analytic`, :func:`feti_cell_counts`), whether the
residency fits one device's memory (``HW["hbm_bytes"]``, the H100's 80 GB)
and the roofline terms at the card's data-sheet rates
(:mod:`repro_torch.launch.roofline`). The reference lowers and compiles
each cell for its mesh; here the rows of the reference's two meshes
(data=16, model=16) and (pod=2, data=16, model=16) are host arithmetic
over their shapes (:func:`~repro_torch.launch.mesh.make_production_mesh`).
Their collectives are the port's own schedule on that mesh
(:func:`~repro_torch.launch.analytic.lm_collectives` for the placed LM
steps, :func:`~repro_torch.launch.analytic.feti_collectives` for the
sharded FETI operator), priced at ``HW["net_bw"]``: every group of those
meshes spans more than one 8-GPU NVLink domain. The LM rows' ``analytic``
notes say what the placed steps leave out (no tensor-parallel split over
'model', caches per batch shard). One card sends nothing: its rows carry
no collectives.

``--devices 1`` asks the question of one card (the mesh label
:data:`DEVICE_MESH`): a row also gives the largest global batch whose
analytic residency fits :data:`FIT_FRACTION` of the card at full depth, or,
where even batch 1 does not, the deepest layer count that fits, and lists
what was cut under ``reduced``. The analytic residency leaves out
activations and temporaries (as the reference's does), which the
headroom of FIT_FRACTION is for.

``--run`` (with ``--devices 1``) executes the cell's step on the card at
the size its row says fits, the counterpart of the reference's
``.lower().compile()`` and ``memory_analysis()``: the row records
``measured_s`` (the median of ``--steps`` steps after the first, each
ended by a device synchronize; the first one apart as ``first_step_s``)
and ``peak_device_bytes`` (``torch.cuda.max_memory_allocated``) beside the
analytic residency. Executors exist for decode and prefill cells (the
model's own seeded weights; a decode cell's cache is filled from a seeded
generator with every slot before the last written, and each step decodes
at the last slot, which is not a prefill of that length), for the FETI
``assembly`` (seeded SPD stiffness stacks with the decomposition's
pattern, the block Cholesky, then the assembly through the hand-written
kernels), ``dirichlet`` (seeded SPD stacks with the Dirichlet split's
pattern: the interior factorization, the stage through the hand-written
kernels, then ``restrict_own_boundary``) and ``solve_iter`` /
``solve_iter_multi`` cells (one explicit dual-operator application on a
seeded F̃ stack). Train cells have none (``run_skipped`` says so): the
training launcher runs them. A cell whose run fails is ``"status":
"error"`` with the reason; nothing falls back to the CPU or a smaller
size.

Usage::

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
        --out dryrun.jsonl
    python -m repro_torch.launch.dryrun --arch granite-3-8b \\
        --shape decode_32k --devices 1 --run --out dryrun_card.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
import traceback
from typing import Optional

import numpy as np

from repro_torch.configs import (FetiArchConfig, get_config,
                                 get_smoke_config, list_archs)
from repro_torch.distributed.tensor_parallel import split_plan
from repro_torch.launch.analytic import (CellCounts, feti_collectives,
                                        lm_cell_counts, lm_collectives)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import HW, no_collectives, roofline_terms
from repro_torch.launch.shapes import SHAPES, ShapeCase, applicable_shapes
from repro_torch.models.config import ModelConfig
from repro_torch.train import OptimizerConfig, TrainConfig

__all__ = ["FETI_SHAPES", "BIG_PARAMS", "ATTN_ARGS", "OPT_FETI_GRIDS",
           "MESHES", "DEVICE_MESH", "FIT_FRACTION", "feti_cell_counts",
           "lm_counts", "fit_one_device", "run_cell", "iter_cells",
           "feti_rank_collectives", "placement_notes", "main"]

FETI_SHAPES = ("assembly", "solve_iter", "solve_iter_multi", "dirichlet")
BIG_PARAMS = 100e9  # >= this: bf16 moments + gradient accumulation
ATTN_ARGS = {"q_chunk": 1024, "kv_chunk": 512}
OPT_FETI_GRIDS = {2: (16, 32), 3: (8, 8, 8)}  # 512 subdomains each
MESHES = {"16x16": False, "2x16x16": True}  # label -> multi_pod
DEVICE_MESH = "1xH100"  # the label of --devices 1's rows
FIT_FRACTION = 0.9  # of HW["hbm_bytes"]: headroom for activations
RUN_STEPS = 3
SCHEMA_VERSION = 1


def placement_notes(cfg: ModelConfig, tp: int) -> dict:
    """What the placed LM steps behind an LM row's collectives compute
    tensor-parallel over a 'model' axis of ``tp`` ranks
    (:func:`~repro_torch.distributed.tensor_parallel.split_plan`), what
    they still gather whole along it, the serving cache they hold, and
    where they run sequence-parallel and how training takes its loss."""
    plan = split_plan(cfg, tp)
    kinds = set(cfg.layer_kinds)
    split, whole = [], []
    if "attn" in kinds:
        if cfg.attn_kind == "mla" and plan.mla:
            split.append(f"MLA by heads ({cfg.num_heads} heads)")
            whole.append("MLA's latent projections")
        elif cfg.attn_kind == "mla":
            whole.append("MLA attention")
        else:
            heads = f"attention ({cfg.num_heads} heads, {cfg.num_kv_heads} KV)"
            (split if plan.attention else whole).append(
                heads + (", KV heads replicated" if plan.kv_replicated
                         else ""))
    if "rglru" in kinds:
        w = cfg.lru_width
        if plan.rglru:
            split.append(f"RG-LRU by width ({w}, {w // tp} a rank)")
        else:
            whole.append(f"RG-LRU (width {w})")
    if "rwkv6" in kinds:
        H = cfg.d_model // cfg.rwkv_head_dim
        if plan.rwkv:
            split.append(f"RWKV-6 by heads ({H} heads, {H // tp} a rank) "
                         f"and its channel mix by d_ff ({cfg.d_ff}, "
                         f"{cfg.d_ff // tp} a rank)")
        else:
            whole.append(f"RWKV-6 ({H} heads, d_ff {cfg.d_ff})")
    if cfg.is_moe:
        how = dict(plan.moe).get(cfg.first_dense_layers)
        E = cfg.num_experts
        if how == "expert":
            split.append(f"MoE by experts ({E} experts, {E // tp} a rank)")
        elif how == "ff":
            split.append(f"MoE by each expert's ff columns ({E} experts, "
                         f"e_ff {cfg.moe_d_ff or cfg.d_ff})")
        if cfg.num_shared_experts:
            (split if plan.moe_shared else whole).append("the shared expert")
        whole.append("the MoE router" + ("" if how else " and experts"))
    if any(k != "rwkv6" for k in kinds) and (
            not cfg.is_moe or cfg.first_dense_layers):
        (split if plan.mlp else whole).append(f"dense MLP (d_ff {cfg.d_ff})")
    (split if plan.vocab else whole).append(f"vocab {cfg.vocab_size}")
    return {
        "placement_model_axis":
            f"tensor-parallel over 'model' ({tp} ranks): "
            f"{', '.join(split) or 'nothing'}; gathered whole along "
            f"'model' and computed alike on its ranks: "
            f"{', '.join(whole) or 'nothing'}",
        "placement_cache": "a serving cache holds the rank's batch rows"
                           + (", its KV heads" if plan.attention else "")
                           + (", its RG-LRU channels of h and conv"
                              if plan.rglru else "")
                           + (", its RWKV-6 heads of S"
                              if plan.rwkv else "")
                           + _slots_note(cfg, plan),
        "placement_sequence": _sequence_note(cfg, tp, plan),
    }


def _slots_note(cfg: ModelConfig, plan) -> str:
    """The attention cache along its slots: each layer's slot group."""
    if "attn" not in cfg.layer_kinds:
        return ""
    g = plan.slot_group
    if g == 1:
        return ("; every slot of its attention layers (slot groups of one "
                "rank: each rank computes its own KV heads' entries)")
    who = ("every head's compressed MLA entries, which every rank computes"
           if cfg.attn_kind == "mla" else
           f"a KV head replicated on {g} ranks" if plan.kv_replicated else
           "the whole attention's KV heads, which every rank computes")
    return (f"; along its slots over 'model', the reference's "
            f"cache_shardings: each attention layer's slot group of {g} "
            f"ranks ({who}) holds 1/{g} of the slots a rank, decode "
            f"merging the group's partial softmaxes (flash-decoding); a "
            f"cache whose slots do not divide {g} stays whole")


def _sequence_note(cfg: ModelConfig, tp: int, plan) -> str:
    if tp <= 1:
        return "no sequence parallelism: one 'model' rank"
    loss = (f"vocab-parallel loss (the rank's {cfg.vocab_size // tp} of "
            f"{cfg.vocab_size} vocab columns, no logits gathered)"
            if plan.vocab else
            f"vocab {cfg.vocab_size} whole: looked up and projected on "
            f"every position by every rank")
    return (f"sequence on 'model' in train and prefill where S divides "
            f"{tp} (S/{tp} positions a rank between blocks: each block "
            f"part all-gathers its normed input and reduce-scatters its "
            f"sum; decode at S = 1 all-reduces); {loss}")


def _train_settings(cfg: ModelConfig, opt: bool = False) -> TrainConfig:
    n = cfg.param_count()
    big = n >= BIG_PARAMS
    return TrainConfig(
        optimizer=OptimizerConfig(
            moment_dtype="bfloat16" if big else "float32"
        ),
        remat=True,
        grad_accum=8 if big else 1,
        accum_dtype="bfloat16" if big else "float32",
        z_loss_coef=1e-4,
        attn_args=_opt_attn_args(opt),
    )


def _opt_attn_args(opt: bool) -> dict:
    # skip causally-masked KV chunks entirely (≈2x prefill/train attention
    # flops) — exact, the mask envelope is static
    return {**ATTN_ARGS, "skip_masked_blocks": True} if opt else ATTN_ARGS


def lm_counts(cfg: ModelConfig, shape: ShapeCase, chips: int, tp: int,
              opt: bool = False) -> CellCounts:
    """:func:`lm_cell_counts` at the dry-run's training settings."""
    tcfg = _train_settings(cfg, opt)
    return lm_cell_counts(
        cfg, shape, chips=chips, tp=tp,
        grad_accum=tcfg.grad_accum, remat=tcfg.remat,
        moment_bytes=2 if tcfg.optimizer.moment_dtype == "bfloat16" else 4,
        accum_bytes=2 if tcfg.accum_dtype == "bfloat16" else 4,
        q_chunk=ATTN_ARGS["q_chunk"], kv_chunk=ATTN_ARGS["kv_chunk"],
        skip_masked=opt,
    )


# ----------------------------------------------------------- FETI cells ----
@dataclasses.dataclass(frozen=True)
class FetiSetup:
    """Static metadata of a production-sized FETI cell (pattern only)."""

    prob: object  # FetiProblem, topology only
    cfg: object  # SchurAssemblyConfig
    mask: np.ndarray  # the factor's block fill mask
    env: object  # SteppedMeta: the subdomains' shared envelope
    cps: np.ndarray  # (S, m) column permutations
    icps: np.ndarray
    n: int
    m: int  # multipliers a subdomain, padded to 64
    kpat: np.ndarray  # (n, n) bool: K's pattern in fill-reducing order
    pivots: np.ndarray  # (S, m) each column's row in that order; n: empty


_FETI_SETUP_CACHE: dict = {}


def _feti_setup(fc: FetiArchConfig) -> FetiSetup:
    """Memoized: the topology build is host-side work shared by every
    shape and mesh of one config."""
    key = (fc.dim, fc.sub_grid, fc.elems_per_sub, fc.block_size,
           fc.rhs_block_size, fc.trsm_variant, fc.syrk_variant, fc.problem)
    if key not in _FETI_SETUP_CACHE:
        _FETI_SETUP_CACHE[key] = _feti_setup_impl(fc)
    return _FETI_SETUP_CACHE[key]


def _feti_setup_impl(fc: FetiArchConfig) -> FetiSetup:
    from repro_torch.core import SchurAssemblyConfig, shared_envelope
    from repro_torch.core.stepped import build_stepped_meta_from_pivots
    from repro_torch.fem.decomposition import decompose_problem
    from repro_torch.fem.meshgen import structured_mesh
    from repro_torch.feti.assembly import expand_node_pattern, expand_node_perm
    from repro_torch.sparse import (block_pattern, block_symbolic_cholesky,
                                    matrix_pattern_from_elems,
                                    nested_dissection_order)

    prob = decompose_problem(fc.problem, fc.dim, fc.sub_grid,
                             fc.elems_per_sub, assemble_values=False)
    ndpn = prob.ndof_per_node
    node_shape = tuple(e + 1 for e in fc.elems_per_sub)
    n_nodes = int(np.prod(node_shape))
    n = n_nodes * ndpn
    nperm = nested_dissection_order(node_shape)
    npat = matrix_pattern_from_elems(
        n_nodes, structured_mesh(fc.elems_per_sub).elems)[nperm][:, nperm]
    # vector problems: node-blocked DOF expansion of the perm + pattern
    dof_perm = expand_node_perm(nperm, ndpn)
    kpat = expand_node_pattern(npat, ndpn)
    inv_dof = np.empty_like(dof_perm)
    inv_dof[dof_perm] = np.arange(n)
    cfg = SchurAssemblyConfig(
        trsm_variant=fc.trsm_variant, syrk_variant=fc.syrk_variant,
        block_size=fc.block_size, rhs_block_size=fc.rhs_block_size,
    )
    mask = block_symbolic_cholesky(block_pattern(kpat, cfg.block_size))

    metas, pivots = [], []
    # pad the multiplier dim to a multiple of 64 (the padded columns are
    # structurally empty: pivot = n)
    m_pad = -(-prob.m_max // 64) * 64
    for sd in prob.subdomains:
        piv = np.full((m_pad,), n, np.int64)
        piv[: sd.m] = inv_dof[sd.b_rows[: sd.m]]
        metas.append(build_stepped_meta_from_pivots(piv, n, cfg.block_size,
                                                    cfg.rhs_bs))
        pivots.append(piv)
    env = shared_envelope(metas)
    return FetiSetup(prob=prob, cfg=cfg, mask=mask, env=env,
                     cps=np.stack([me.perm for me in metas]),
                     icps=np.stack([me.inv_perm for me in metas]),
                     n=n, m=m_pad, kpat=kpat, pivots=np.stack(pivots))


_FETI_DIRICHLET_CACHE: dict = {}


def _feti_dirichlet_setup(fc: FetiArchConfig):
    """Symbolic products of the dirichlet (primal boundary Schur) cell:
    the shared boundary/interior split, the K_ib stepped metadata and the
    interior fill mask — pattern-only, production-sized (memoized like
    :func:`_feti_setup`)."""
    key = (fc.dim, fc.sub_grid, fc.elems_per_sub, fc.block_size,
           fc.rhs_block_size, fc.problem)
    if key in _FETI_DIRICHLET_CACHE:
        return _FETI_DIRICHLET_CACHE[key]
    from repro_torch.feti.dirichlet import (boundary_interior_split,
                                            dirichlet_symbolic,
                                            own_boundary_masks)

    st = _feti_setup(fc)
    split = boundary_interior_split(st.prob)
    meta_ib, mask_ii = dirichlet_symbolic(st.prob, split, st.cfg.block_size,
                                          st.cfg.rhs_bs)
    Zb = own_boundary_masks(st.prob, split)
    out = (st.prob, st.cfg, split, meta_ib, mask_ii, Zb, st.n)
    _FETI_DIRICHLET_CACHE[key] = out
    return out


def feti_cell_counts(fc: FetiArchConfig, shape_name: str,
                     chips: int) -> CellCounts:
    """Analytic counts for the FETI cells (mirrors the LM analytic model).

    Executed flops = the stepped (sparsity-utilizing) schedule's own flop
    model — the very quantity the paper optimizes; the dense §3.1 baseline
    flops are recorded in notes so the stepped speedup is visible per cell.
    """
    from repro_torch.core import assembly_flops
    from repro_torch.sparse.cholesky import block_cholesky_flops

    st = _feti_setup(fc)
    prob, cfg, mask, env, n, m = st.prob, st.cfg, st.mask, st.env, st.n, st.m
    S = prob.n_subdomains
    fb = 4  # f32
    if shape_name == "assembly":
        stepped = assembly_flops(env, cfg)["total"]
        dense = (env.flops_trsm_dense() + env.flops_syrk_dense())
        chol = block_cholesky_flops(n, cfg.block_size, mask)
        chol_dense = block_cholesky_flops(n, cfg.block_size)
        flops_global = float(S * (stepped + chol))
        # traffic: read K, write L, stream L against the RHS stripe (factor
        # split reads each factor block once per active stripe), write Y+F
        bytes_global = float(S * (2 * n * n + 3 * n * m + m * m) * fb)
        resident = float(S * (2 * n * n + n * m + m * m) * fb)
        notes = {
            "stepped_assembly_flops": stepped,
            "dense_baseline_flops": dense,
            "stepped_speedup_vs_dense": dense / max(stepped, 1),
            "cholesky_flops_masked": chol,
            "cholesky_flops_dense": chol_dense,
        }
    elif shape_name == "dirichlet":
        _, _, split, meta_ib, mask_ii, _, _ = _feti_dirichlet_setup(fc)
        ni, nb = split.n_i, split.n_b
        stepped = assembly_flops(meta_ib, cfg)["total"]
        chol_ii = block_cholesky_flops(ni, cfg.block_size, mask_ii)
        # own-boundary restriction epilogue: dense chol of E (n_b³/3),
        # two triangular solves with n_b RHS (2·n_b³) and the rank-update
        # GEMM (2·n_b³) — all dense n_b-sized, batched
        restrict = nb ** 3 // 3 + 4 * nb ** 3
        flops_global = float(S * (stepped + chol_ii + restrict))
        # read Kd once, write S_b; the interior factor is transient
        bytes_global = float(S * (n * n + 2 * nb * nb) * fb)
        resident = float(S * nb * nb * fb)  # only S_b persists
        notes = {
            "boundary_dofs": nb,
            "interior_dofs": ni,
            "stepped_assembly_flops": stepped,
            "cholesky_ii_flops_masked": chol_ii,
            "restriction_flops": restrict,
            # when the dual stage orders DOFs interior-first and the
            # fixing DOFs are all boundary, the stage graph reuses the dual
            # factor's leading block — the K_ii factorization drops out,
            # and the stage streams K_bb instead of the full permuted K
            "cholesky_ii_flops_saved_if_shared": chol_ii,
            "bytes_saved_if_shared": float(S * (n * n - nb * nb) * fb),
            # the fused TRSM→SYRK kernel additionally skips the round trip
            # of the TRSM result panel Y = L_ii⁻¹ K_ib through memory
            "fused_intermediate_bytes_skipped": float(S * ni * nb * fb),
        }
    else:  # solve_iter / solve_iter_multi
        from repro_torch.launch.analytic import (FETI_SOLVE_N_RHS,
                                                 feti_solve_iter_counts)

        n_rhs = FETI_SOLVE_N_RHS if shape_name == "solve_iter_multi" else 1
        iter_counts = feti_solve_iter_counts(S, m, n_rhs=n_rhs, fb=fb)
        flops_global = iter_counts["flops"]
        bytes_global = iter_counts["bytes"]
        # the SC stack persists across iterations; multiplier stacks ride
        # along (tiny for any realistic n_rhs)
        resident = float(S * m * m * fb + 2 * prob.n_lambda * n_rhs * fb)
        notes = {
            "explicit_gemm_per_subdomain": 2 * m * m * n_rhs,
            **{f"solve_iter_{k}": v for k, v in iter_counts.items()},
        }
    return CellCounts(
        flops_global=flops_global,
        flops_per_dev=flops_global / chips,
        hbm_bytes_per_dev=bytes_global / chips,
        hbm_resident_per_dev=resident / chips,
        model_flops=flops_global,
        notes=notes,
    )


# --------------------------------------------------- one card: the fit ----
def fit_one_device(cfg: ModelConfig, shape: ShapeCase, opt: bool = False):
    """The largest global batch whose residency fits FIT_FRACTION of one
    card at full depth; where batch 1 does not fit, the deepest layer
    count at batch 1. Returns ``(cfg, shape, counts, reduced)``: the cut
    config and shape, their counts at one device, and the cuts made
    (empty: none)."""
    budget = FIT_FRACTION * HW["hbm_bytes"]

    def resid(c, b):
        s = dataclasses.replace(shape, global_batch=b)
        return lm_counts(c, s, chips=1, tp=1, opt=opt).hbm_resident_per_dev

    def largest(lo, hi, fits):  # the largest v in [lo, hi] with fits(v)
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
        return lo

    reduced = []
    B = shape.global_batch
    if resid(cfg, 1) <= budget:
        b = largest(1, B, lambda v: resid(cfg, v) <= budget)
        if b < B:
            reduced.append(f"global_batch {B} -> {b} (the largest whose "
                           f"residency fits {FIT_FRACTION:g} x hbm_bytes)")
    else:
        b = 1
        if B > 1:
            reduced.append(f"global_batch {B} -> 1")
        L = cfg.num_layers

        def fits(v):
            return resid(dataclasses.replace(cfg, num_layers=v), 1) <= budget

        depth = largest(1, L, fits)
        if fits(depth):
            reduced.append(f"num_layers {L} -> {depth} at global_batch 1 "
                           f"(the deepest whose residency fits "
                           f"{FIT_FRACTION:g} x hbm_bytes)")
        else:
            reduced.append("does not fit one card at one layer and batch 1")
        cfg = dataclasses.replace(cfg, num_layers=depth)
    shape = dataclasses.replace(shape, global_batch=b)
    return cfg, shape, lm_counts(cfg, shape, chips=1, tp=1, opt=opt), reduced


# ------------------------------------------------------------ executors ----
def _timed(step, steps: int, device):
    """``step()`` 1 + ``steps`` times, each ended by a device synchronize:
    (first step s, median of the rest, the last step's output)."""
    import torch

    times, out = [], None
    for _ in range(1 + steps):
        t0 = time.perf_counter()
        out = step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return times[0], statistics.median(times[1:]), out


def _fill_cache(cache: list, index: int, gen) -> None:
    """Fill a fresh cache from ``gen`` as if ``index`` tokens had been
    written: every slot of positions ``index - size .. index - 1`` (a ring
    buffer holds position p at slot p % size), states drawn at 0.1."""
    import torch

    for layer in cache:
        for name, t in layer.items():
            if name == "pos":
                size = t.shape[1]
                p = torch.arange(max(index - size, 0), index, device=t.device,
                                 dtype=torch.int32)
                t.fill_(-1)
                t[:, p % size] = p
                continue
            scale = 1.0 if name in ("k", "v", "ckv", "krope") else 0.1
            for row in t:  # one batch row at a time: a small f32 draw
                draw = torch.randn(row.shape, generator=gen, device=t.device,
                                   dtype=torch.float32) * scale
                if row.element_size() == 1 and row.is_floating_point():
                    row.view(torch.uint8).copy_(
                        draw.to(row.dtype).view(torch.uint8))
                else:
                    row.copy_(draw)


def _cache_slots(cache: list) -> int:
    """Slots of the first attention layer's cache (0 without one)."""
    for layer in cache:
        if "pos" in layer:
            return int(layer["pos"].shape[1])
    return 0


def _run_lm(cfg: ModelConfig, shape: ShapeCase, device, steps: int) -> dict:
    import torch

    from repro_torch.models import LanguageModel, init_cache
    from repro_torch.train import make_decode_step, make_prefill_step

    gen = torch.Generator(device=device).manual_seed(0)
    model = LanguageModel(cfg, device=device, generator=gen)
    B, S = shape.global_batch, shape.seq_len
    cache = init_cache(cfg, B, S, device)
    if shape.kind == "decode":
        index = S - 1
        _fill_cache(cache, index, gen)
        tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                            device=device, dtype=torch.int32)
        decode = make_decode_step(model)
        first, med, (logits, _) = _timed(lambda: decode(tok, cache, index),
                                         steps, device)
        size = _cache_slots(cache) or S
        note = (f"decode steps at cache_index {index} on a cache filled "
                f"from a seeded generator (positions {max(index - size, 0)}"
                f"..{index - 1} in its {size} slots), not a prefill of "
                f"{S}; every step writes slot {index % size} again")
    else:
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device=device, dtype=torch.int32)
        prefill = make_prefill_step(model)
        first, med, (logits, _) = _timed(
            lambda: prefill({"tokens": tokens}, cache), steps, device)
        note = (f"prefill of {S} seeded tokens a row into a fresh cache, "
                f"every step over the same cache")
    finite = bool(torch.isfinite(logits).all())
    if logits.shape != (B, cfg.vocab_size) or not finite:
        raise RuntimeError(f"logits {tuple(logits.shape)}, finite: {finite}")
    return {"first_step_s": first, "measured_s": med, "note": note}


def _spd_stack(kpat: np.ndarray, S: int, gen, device):
    """(S, n, n) f32 SPD stacks with ``kpat``'s pattern, from ``gen``:
    off-diagonal entries -U(0, 1) symmetrized, the diagonal their absolute
    row sum + 1."""
    import torch

    n = kpat.shape[0]
    pat = torch.as_tensor(kpat, device=device)
    pat.fill_diagonal_(False)
    K0 = torch.rand((S, n, n), generator=gen, device=device,
                    dtype=torch.float32)
    K0.mul_(pat)
    K0.add_(K0.mT.clone()).mul_(-0.5)
    K0.diagonal(dim1=1, dim2=2).copy_(K0.abs().sum(-1) + 1.0)
    return K0


def _run_dirichlet(fc: FetiArchConfig, device, steps: int) -> dict:
    import torch

    from repro_torch import kernels
    from repro_torch.feti.dirichlet import (_local_dof_pattern,
                                            make_dirichlet_assembler,
                                            restrict_own_boundary)

    prob, cfg, split, meta_ib, mask_ii, Zb, _ = _feti_dirichlet_setup(fc)
    S, nb = prob.n_subdomains, split.n_b
    gen = torch.Generator(device=device).manual_seed(0)
    K0 = _spd_stack(_local_dof_pattern(prob), S, gen, device)
    P = torch.as_tensor(split.interior, device=device)
    B = torch.as_tensor(split.boundary, device=device)
    rows = K0[:, P]
    Kii0, Kib = rows[:, :, P], rows[:, :, B]
    del rows
    Kbb = K0[:, B][:, :, B]
    del K0
    z = torch.as_tensor(Zb, device=device, dtype=torch.float32)
    assemble = make_dirichlet_assembler(
        split, meta_ib, mask_ii, dataclasses.replace(cfg, use_kernels=True))
    A = torch.empty_like(Kii0)
    launches = []

    def step():
        kernels.reset_launch_counts()
        A.copy_(Kii0)  # factorized in place
        Sb = restrict_own_boundary(assemble(A, Kib, Kbb), z)
        launches.append(kernels.launch_counts())
        return Sb

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    first, med, Sb = _timed(step, steps, device)
    if Sb.shape != (S, nb, nb) or not bool(torch.isfinite(Sb).all()):
        raise RuntimeError(f"S_b {tuple(Sb.shape)} not finite")
    return {"first_step_s": first, "measured_s": med,
            "launches_per_step": launches,
            "note": (f"{S} seeded SPD f32 stacks with the Dirichlet split's "
                     f"pattern (n_i {split.n_i}, n_b {nb}); the interior "
                     f"block Cholesky at bs {cfg.block_size}, the stage "
                     f"through the kernels (use_kernels=True), then "
                     f"restrict_own_boundary, every step from the same K")}


def _run_feti(fc: FetiArchConfig, shape_name: str, device,
              steps: int) -> dict:
    import torch

    from repro_torch import kernels
    from repro_torch.feti.assembly import batched_assemble
    from repro_torch.sparse.cholesky import block_cholesky

    if shape_name == "dirichlet":
        return _run_dirichlet(fc, device, steps)
    st = _feti_setup(fc)
    S, n, m = st.prob.n_subdomains, st.n, st.m
    gen = torch.Generator(device=device).manual_seed(0)
    f32 = torch.float32
    if shape_name == "assembly":
        K0 = _spd_stack(st.kpat, S, gen, device)
        Bt = torch.zeros((S, n, m), device=device, dtype=f32)
        piv = torch.as_tensor(st.pivots, device=device)
        vals = torch.as_tensor(np.stack(
            [np.resize(sd.b_vals, m) for sd in st.prob.subdomains]),
            device=device, dtype=f32)
        real = piv < n
        s_idx, c_idx = torch.nonzero(real, as_tuple=True)
        Bt[s_idx, piv[real], c_idx] = vals[real]
        cp = torch.as_tensor(st.cps, device=device)
        icp = torch.as_tensor(st.icps, device=device)
        cfg = dataclasses.replace(st.cfg, use_kernels=True)
        L = torch.empty_like(K0)
        launches = []

        def step():
            kernels.reset_launch_counts()
            L.copy_(K0)
            block_cholesky(L, st.cfg.block_size, mask=st.mask)
            F = batched_assemble(L, Bt, cp, icp, st.env, cfg, st.mask)
            launches.append(kernels.launch_counts())
            return F

        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        first, med, F = _timed(step, steps, device)
        if F.shape != (S, m, m) or not bool(torch.isfinite(F).all()):
            raise RuntimeError(f"F {tuple(F.shape)} not finite")
        return {"first_step_s": first, "measured_s": med,
                "launches_per_step": launches,
                "note": (f"{S} seeded SPD f32 stacks with the decomposition's "
                         f"pattern (fill-reducing order); block Cholesky at bs "
                         f"{st.cfg.block_size}, then the assembly through the "
                         f"kernels (use_kernels=True), every step from the "
                         f"same K")}
    # solve_iter / solve_iter_multi: one explicit dual-operator application
    from repro_torch.feti.operator import explicit_dual_apply

    dm, F, lam = _solve_inputs(st, shape_name, gen, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    first, med, q = _timed(lambda: explicit_dual_apply(F, dm, lam), steps,
                           device)
    if q.shape != lam.shape or not bool(torch.isfinite(q).all()):
        raise RuntimeError(f"q {tuple(q.shape)} not finite")
    return {"first_step_s": first, "measured_s": med,
            "note": "a seeded F̃ stack and multiplier stack"}


def _solve_inputs(st: FetiSetup, shape_name: str, gen, device,
                  owned: Optional[range] = None):
    """The dual map, a seeded (S, m, m) f32 F̃ stack and a seeded f32
    multiplier stack (n_λ, or n_λ × FETI_SOLVE_N_RHS for
    ``solve_iter_multi``) of a solve cell; with ``owned`` (one rank's
    subdomains) the map and the stack of that slice alone."""
    import torch

    from repro_torch.feti.operator import dual_map
    from repro_torch.launch.analytic import FETI_SOLVE_N_RHS

    S, m, nl = st.prob.n_subdomains, st.m, st.prob.n_lambda
    ids = np.full((S, m), nl, np.int64)
    for i, sd in enumerate(st.prob.subdomains):
        ids[i, : sd.lambda_ids.shape[0]] = sd.lambda_ids
    F = torch.randn((S, m, m), generator=gen, device=device,
                    dtype=torch.float32)
    cols = (FETI_SOLVE_N_RHS,) if shape_name == "solve_iter_multi" else ()
    lam = torch.randn((nl,) + cols, generator=gen, device=device,
                      dtype=torch.float32)
    if owned is None:
        return dual_map(ids, nl, device), F, lam
    sl = slice(owned.start, owned.stop)
    return dual_map(ids[sl], nl, device, sliced=True), F[sl], lam


def feti_rank_collectives(rank, arch: str, shape_name: str,
                          smoke: bool = True) -> dict:
    """One rank of the sharded form of a solve cell's step: the rank's
    slice of the cell's seeded F̃ stack (``FetiMesh.owned``), one explicit
    dual-operator application through ``feti.sharded.reduce_sum`` under
    :func:`~repro_torch.launch.roofline.record_collectives`. Returns the
    collectives and the all-reduced result (numpy), which equals the
    one-device application of the whole stack."""
    import torch

    from repro_torch.feti.operator import explicit_dual_apply
    from repro_torch.feti.sharded import reduce_sum
    from repro_torch.launch.roofline import record_collectives

    st = _feti_setup((get_smoke_config if smoke else get_config)(arch))
    gen = torch.Generator(device=rank.device).manual_seed(0)
    dm, F, lam = _solve_inputs(st, shape_name, gen, rank.device,
                               rank.owned(st.prob.n_subdomains))
    with record_collectives() as coll:
        q = reduce_sum(rank, explicit_dual_apply)(F, dm, lam)
    return {"collectives": coll, "q": q.cpu().numpy()}


def _execute(cfg, shape_name: str, shape: Optional[ShapeCase], device,
             steps: int) -> dict:
    """Run the cell's step on ``device``; returns the row's run fields."""
    import torch

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    if isinstance(cfg, FetiArchConfig):
        out = _run_feti(cfg, shape_name, device, steps)
    else:
        out = _run_lm(cfg, shape, device, steps)
    out["steps"] = steps
    out["peak_device_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if cuda else None)
    out["device_name"] = (torch.cuda.get_device_name(device) if cuda
                          else str(device))
    return out


def _run_reason(cfg, shape_name: str) -> Optional[str]:
    """Why ``--run`` has no executor for this cell (None: it has one)."""
    if isinstance(cfg, FetiArchConfig):
        return None
    if SHAPES[shape_name].kind == "train":
        return ("no executor for train cells (python -m "
                "repro_torch.launch.train runs the step)")
    return None


# ------------------------------------------------- rows and the command ----
def run_cell(arch: str, shape_name: str, mesh: str = "16x16",
             skip_masked: bool = False, run: bool = False,
             steps: int = RUN_STEPS, device=None,
             smoke: bool = False) -> dict:
    """One row. ``mesh``: a key of :data:`MESHES` or :data:`DEVICE_MESH`.
    ``run`` (one device only) executes the cell on ``device`` (``None``:
    ``cuda``, which must exist). ``smoke`` takes the arch's smoke config
    (the CPU tests' size)."""
    one = mesh == DEVICE_MESH
    if not one and mesh not in MESHES:
        raise ValueError(f"mesh must be one of {list(MESHES)} or "
                         f"{DEVICE_MESH!r}, got {mesh!r}")
    if run and not one:
        raise ValueError("--run executes a cell on one card: pass "
                         "--devices 1")
    if one:
        chips, tp = 1, 1
    else:
        pm = make_production_mesh(multi_pod=MESHES[mesh])
        chips, tp = pm.size, pm.shape["model"]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh, "chips": chips}
    cfg = (get_smoke_config if smoke else get_config)(arch)
    opt = skip_masked  # one flag drives every optimization
    rec["optimized"] = opt
    try:
        shape = None
        coll = None  # one card sends nothing
        if isinstance(cfg, FetiArchConfig):
            if opt:
                # one independent subdomain stream per device: the cluster
                # count matches the fleet
                cfg = dataclasses.replace(cfg,
                                          sub_grid=OPT_FETI_GRIDS[cfg.dim])
            counts = feti_cell_counts(cfg, shape_name, chips)
            if one:
                rec["reduced"] = []
            else:
                coll = feti_collectives(cfg, shape_name, chips)
        else:
            # moe_impl="sort" removes the 4·E·C·d dispatch flops, but under
            # the reference's GSPMD placement the expert buffer lost EP
            # locality and gathered the expert weights each layer (a net
            # loss), so the optimized grid keeps GShard
            shape = SHAPES[shape_name]
            if one:
                cfg, shape, counts, reduced = fit_one_device(cfg, shape, opt)
                rec.update(global_batch=shape.global_batch,
                           num_layers=cfg.num_layers, reduced=reduced)
            else:
                counts = lm_counts(cfg, shape, chips, tp, opt)
                coll = lm_collectives(cfg, shape, pm,
                                      _train_settings(cfg, opt), opt)
                counts.notes.update(placement_notes(cfg, tp))
        roof = roofline_terms(
            {"flops": counts.flops_per_dev,
             "bytes accessed": counts.hbm_bytes_per_dev},
            coll or no_collectives(), chips, counts.model_flops,
            link_bw=HW["net_bw"])
        rec.update({
            "analytic_resident_bytes_per_dev":
                int(counts.hbm_resident_per_dev),
            "fits_hbm": bool(counts.hbm_resident_per_dev <= HW["hbm_bytes"]),
            "collectives": None if coll is None else {
                "bytes": coll.bytes_by_op, "count": coll.count_by_op},
            "analytic": counts.notes,
            "roofline": roof.as_dict(),
        })
        if one:
            rec["fit_budget_bytes"] = int(FIT_FRACTION * HW["hbm_bytes"])
        if run:
            reason = _run_reason(cfg, shape_name)
            if reason is not None:
                rec["run_skipped"] = reason
            elif not rec["fits_hbm"] or (
                    counts.hbm_resident_per_dev > rec["fit_budget_bytes"]):
                raise RuntimeError("the cell does not fit one card at any "
                                   "cut: nothing to run")
            else:
                from repro_torch.device import resolve_device

                rec.update(_execute(cfg, shape_name, shape,
                                    resolve_device(device), steps))
        rec["status"] = "ok"
    except Exception as e:  # a failing cell is a bug; record it loudly
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def iter_cells(arch_sel: str, shape_sel: str, meshes):
    """(arch, shape, mesh label, skipped) of every cell: every config, the
    FETI shapes or the applicable LM shapes on each mesh, then the LM
    shapes the skip rules leave out."""
    archs = list_archs() if arch_sel == "all" else [arch_sel]
    for arch in archs:
        cfg = get_config(arch)
        feti = isinstance(cfg, FetiArchConfig)
        shapes = list(FETI_SHAPES) if feti else applicable_shapes(cfg)
        skipped = [] if feti else [s for s in SHAPES if s not in shapes]
        if shape_sel != "all":
            shapes = [s for s in shapes if s == shape_sel]
            skipped = [s for s in skipped if s == shape_sel]
        for shape in shapes:
            for mesh in meshes:
                yield arch, shape, mesh, False
        for shape in skipped:
            yield arch, shape, "-", True


def skip_reason(cfg: ModelConfig) -> str:
    return ("encoder-only: no decode step" if cfg.is_encoder_only
            else "full attention: long_500k needs sub-quadratic")


def _print_row(rec: dict, dt: float) -> None:
    if rec["status"] != "ok":
        print(f"[dryrun] ERROR {rec['arch']:22s} {rec['shape']:16s} "
              f"{rec['mesh']:8s}: {rec['error']}", flush=True)
        return
    r = rec["roofline"]
    res_gib = rec["analytic_resident_bytes_per_dev"] / 2**30
    useful = r["useful_ratio"]
    line = (f"[dryrun] OK    {rec['arch']:22s} {rec['shape']:16s} "
            f"{rec['mesh']:8s} {dt:6.1f}s res/dev={res_gib:8.2f}GiB "
            f"fits={rec['fits_hbm']} dom={r['dominant']:8s} "
            f"useful={None if useful is None else round(useful, 3)}")
    if rec.get("reduced"):
        line += f" reduced={rec['reduced']}"
    if "measured_s" in rec:
        line += (f" measured_s={rec['measured_s']:.6f} peak="
                 f"{rec['peak_device_bytes']}")
    print(line, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Analytic dry-run of every (arch x shape x mesh) cell; "
                    "with --devices 1 --run, each cell on the card.")
    p.add_argument("--arch", default="all")
    p.add_argument("--shape", default="all")
    p.add_argument("--mesh", choices=("single", "multi", "both"),
                   default="both", help="the production meshes: 16x16, "
                   "2x16x16 or both (without --devices)")
    p.add_argument("--devices", type=int, default=0,
                   help="1: the cells on one card (the fit, the cuts)")
    p.add_argument("--run", action="store_true",
                   help="execute each cell on the card (needs --devices 1)")
    p.add_argument("--steps", type=int, default=RUN_STEPS,
                   help="timed steps of --run after the first")
    p.add_argument("--opt", action="store_true",
                   help="the optimizations: causal block skipping, "
                        "fleet-matched FETI decomposition")
    p.add_argument("--out", required=True, help="JSONL file to append to")
    args = p.parse_args(argv)
    if args.devices not in (0, 1):
        p.error("--devices takes 1 (one card); the production meshes are "
                "--mesh's")
    if args.run and args.devices != 1:
        p.error("--run needs --devices 1")
    meshes = ([DEVICE_MESH] if args.devices == 1 else
              {"single": ["16x16"], "multi": ["2x16x16"],
               "both": list(MESHES)}[args.mesh])

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_ok = n_err = 0
    with open(args.out, "a") as f:
        for arch, shape, mesh, skip in iter_cells(args.arch, args.shape,
                                                  meshes):
            if skip:
                reason = skip_reason(get_config(arch))
                rec = {"arch": arch, "shape": shape, "mesh": "-",
                       "status": "skipped", "reason": reason}
                print(f"[dryrun] SKIP  {arch:22s} {shape:16s} ({reason})")
            else:
                t0 = time.perf_counter()
                rec = run_cell(arch, shape, mesh, skip_masked=args.opt,
                               run=args.run, steps=args.steps)
                _print_row(rec, time.perf_counter() - t0)
                if rec["status"] == "ok":
                    n_ok += 1
                else:
                    n_err += 1
                    if n_err <= 3:
                        print(rec["traceback"][-800:])
            rec.pop("traceback", None)
            rec.setdefault("schema_version", SCHEMA_VERSION)
            f.write(json.dumps(rec) + "\n")
            f.flush()
    print(f"[dryrun] done: {n_ok} ok, {n_err} errors -> {args.out}")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
