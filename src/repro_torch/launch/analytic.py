"""Exact analytic FLOP / byte counts (counterpart of
``repro.launch.analytic``): the LM cells (:func:`lm_cell_counts`) and the
FETI solve phase (:func:`feti_solve_iter_counts`); and the collective
schedule of a cell on a mesh (:func:`lm_collectives`,
:func:`feti_collectives`).

The counts are EXECUTED work of the loop structure the program runs
(chunked attention with or without causal block skipping, MoE capacity,
the remat pass), not idealized-model work; ``model_flops`` (6·N·D for
training, 2·N·D for serving) is reported beside them so their ratio shows
the waste. The arithmetic is the reference's, term for term and in the
same order, so both packages give the same numbers bit for bit.
``FetiSolver.amortization_report`` attaches :func:`feti_solve_iter_counts`
per ``n_rhs``, so the reference's and the port's reports agree by
construction.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

from repro_torch.launch.shapes import ShapeCase
from repro_torch.models.config import ModelConfig

__all__ = ["CellCounts", "lm_cell_counts", "feti_solve_iter_counts",
           "FETI_SOLVE_N_RHS", "lm_collectives", "feti_collectives"]

# default multi-RHS width of the reference's ``solve_iter_multi`` dry-run
# cell (the middle of its n_rhs sweep 1, 4, 16, 64)
FETI_SOLVE_N_RHS = 16


def feti_solve_iter_counts(S: int, m: int, n_rhs: int = 1,
                           fb: int = 4) -> dict:
    """Executed flops / device bytes of ONE explicit dual-operator
    application (paper eq. 12) on an (n_lambda, n_rhs) multiplier stack.

    Flops: one (m×m)·(m×n_rhs) GEMM per subdomain = ``2·S·m²·n_rhs`` —
    linear in n_rhs. Bytes: the (S, m, m) SC stack streams from memory
    ONCE per block application regardless of n_rhs (that is the whole
    multi-RHS amortization), plus the in/out multiplier stacks — so
    arithmetic intensity grows ≈linearly with n_rhs until the GEMM turns
    compute-bound. ``fb`` is the stack's bytes an element.
    """
    if n_rhs < 1:
        raise ValueError(f"n_rhs must be >= 1, got {n_rhs}")
    flops = 2.0 * S * m * m * n_rhs
    bytes_ = float(S * (m * m + 2 * m * n_rhs) * fb)
    return {
        "flops": float(flops),
        "bytes": bytes_,
        "flops_per_rhs": float(flops / n_rhs),
        "bytes_per_rhs": bytes_ / n_rhs,
        "arithmetic_intensity": flops / bytes_,
        "n_rhs": int(n_rhs),
    }


@dataclasses.dataclass
class CellCounts:
    flops_global: float  # executed flops per step, whole fleet
    flops_per_dev: float
    hbm_bytes_per_dev: float  # HBM traffic per step per device
    hbm_resident_per_dev: float  # steady-state residency (fit check)
    model_flops: float  # 6·N_active·D (train) / 2·N_active·D (serve)
    notes: dict

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _bytes_of(dtype_str: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4,
            "float8_e4m3fn": 1}[dtype_str]


def _fit_chunk(chunk, total):
    chunk = min(chunk, total)
    while total % chunk:
        chunk -= 1
    return chunk


def _attn_sched_flops(cfg: ModelConfig, Sq: int, Skv: int, B: int,
                      q_chunk: int, kv_chunk: int, window: int,
                      skip_masked: bool, n_layers: int) -> float:
    """Executed score+PV flops of the chunked attention across layers.

    The reference's chunk schedule: baseline visits every (q_chunk,
    kv_chunk) pair (masked blocks still compute); with skip_masked only
    causally-live kv chunks run; a window bounds live kv chunks to
    ceil(W/ck)+1 per q chunk. The port's ``flash_attention`` keeps the
    first two; under a window it visits every kv chunk, so there the count
    is below what the port executes.
    """
    if n_layers == 0 or cfg.num_heads == 0:
        return 0.0
    cq = _fit_chunk(q_chunk, Sq)
    ck = _fit_chunk(kv_chunk, Skv)
    nq, nkv = Sq // cq, Skv // ck
    if cfg.attn_kind == "mla":
        d_qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        d_v = cfg.v_head_dim
    else:
        d_qk = d_v = cfg.head_dim
    H = cfg.num_heads
    pairs = 0
    for qi in range(nq):
        if window > 0:
            live = min(nkv, math.ceil(window / ck) + 1)
        elif skip_masked and cfg.causal and Sq > 1:
            hi = (qi + 1) * cq
            live = min((hi + ck - 1) // ck, nkv)
        else:
            live = nkv
        pairs += live
    # per (q,kv) chunk pair: scores 2·cq·ck·H·d_qk + PV 2·cq·ck·H·d_v
    per_pair = 2.0 * cq * ck * H * (d_qk + d_v)
    return float(B * n_layers * pairs * per_pair)


def _rwkv_flops(cfg: ModelConfig, tokens: float, n_layers: int,
                chunk: int = 64) -> float:
    """Chunked WKV evaluation: per token per head ≈ 4·D² (state in/out) +
    4·c·D (intra-chunk attention)."""
    if n_layers == 0:
        return 0.0
    D = cfg.rwkv_head_dim
    H = cfg.d_model // D
    per_tok_head = 4.0 * D * D + 4.0 * chunk * D
    return tokens * n_layers * H * per_tok_head


def lm_cell_counts(cfg: ModelConfig, shape: ShapeCase, *, chips: int,
                   tp: int, grad_accum: int, remat: bool,
                   moment_bytes: int, accum_bytes: int,
                   q_chunk: int = 1024, kv_chunk: int = 512,
                   skip_masked: bool = False) -> CellCounts:
    V, d = cfg.vocab_size, cfg.d_model
    n_active = cfg.active_param_count()
    embed_params = V * d
    # matmul params: everything except the embedding gather; the logits
    # matmul always runs (tied adds it back)
    matmul_params = n_active - embed_params
    kinds = cfg.layer_kinds
    n_attn = sum(1 for k in kinds if k == "attn")
    n_rwkv = sum(1 for k in kinds if k == "rwkv6")
    n_moe_layers = (cfg.num_layers - cfg.first_dense_layers) if cfg.is_moe else 0

    if shape.kind == "train":
        B, S = shape.global_batch, shape.seq_len
        tokens = float(B * S)
        Sq = Skv = S
        fwd_passes = 3.0 + (1.0 if remat else 0.0)  # fwd + bwd(2x) + remat
        logits_positions = tokens
        model_flops = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        B, S = shape.global_batch, shape.seq_len
        tokens = float(B * S)
        Sq = Skv = S
        fwd_passes = 1.0
        logits_positions = float(B)  # last_only
        model_flops = 2.0 * n_active * tokens
    else:  # decode
        B = shape.global_batch
        tokens = float(B)
        Sq, Skv = 1, shape.seq_len
        fwd_passes = 1.0
        logits_positions = float(B)
        model_flops = 2.0 * n_active * tokens

    mm = 2.0 * matmul_params * tokens  # includes lm_head if untied
    if cfg.tie_embeddings and cfg.has_lm_head:
        mm += 2.0 * V * d * logits_positions
    elif cfg.has_lm_head and not cfg.tie_embeddings:
        # lm_head already in matmul_params for `tokens`; correct to the
        # actual number of projected positions
        mm -= 2.0 * V * d * (tokens - logits_positions)

    attn = _attn_sched_flops(cfg, Sq, Skv, B, q_chunk, kv_chunk,
                             cfg.local_window, skip_masked, n_attn)
    rwkv = _rwkv_flops(cfg, tokens, n_rwkv)
    # MoE dispatch/combine einsums: each is 2·T·E·C·d flops per layer, so
    # 4·E·C·d per token — the GShard one-hot-matmul tax (a sort/gather
    # dispatch, ``moe_impl="sort"``, removes it entirely)
    moe = 0.0
    if cfg.is_moe and n_moe_layers:
        S_group = shape.seq_len if shape.kind != "decode" else 1
        C = max(int(S_group * cfg.top_k / cfg.num_experts
                    * cfg.capacity_factor), 1)
        if cfg.moe_impl == "sort":
            # sort/gather dispatch: only the router matmul survives
            moe = tokens * n_moe_layers * 2.0 * cfg.num_experts * d
        else:
            moe = tokens * n_moe_layers * (
                4.0 * cfg.num_experts * C * d
                + 2.0 * cfg.num_experts * d  # router
            )

    fwd_flops = mm + attn + rwkv + moe
    flops_global = fwd_flops * fwd_passes
    flops_per_dev = flops_global / chips

    # ---- HBM traffic per device ----
    pb = _bytes_of(cfg.param_dtype)
    P_total = cfg.param_count()
    # weights stream: gathered weights are still TP-sharded -> /tp; read
    # once per pass per microbatch
    weight_stream = P_total * pb / tp * fwd_passes * (
        grad_accum if shape.kind == "train" else 1
    )
    act_bytes = _bytes_of(cfg.dtype)
    tokens_dev = tokens / chips * tp  # activations sharded dp×sp
    act_stream = tokens_dev / tp * d * act_bytes * cfg.num_layers * 12.0
    cache_stream = 0.0
    cache_resident = 0.0
    if shape.kind == "decode":
        cb = _bytes_of(cfg.cache_dtype or cfg.dtype)
        if cfg.attn_kind == "mla":
            per_tok = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        else:
            per_tok = 2 * cfg.num_kv_heads * cfg.head_dim
        eff_len = min(cfg.local_window or shape.seq_len, shape.seq_len)
        cache_global = B * eff_len * per_tok * cb * n_attn
        # rwkv/rglru states are tiny by comparison; add them anyway
        state = 0.0
        for k in kinds:
            if k == "rwkv6":
                state += B * (cfg.d_model // cfg.rwkv_head_dim) * \
                    cfg.rwkv_head_dim ** 2 * 4
            elif k == "rglru":
                state += B * cfg.lru_width * 4
        cache_global += state
        cache_stream = cache_global / chips  # read once per decode step
        cache_resident = cache_global / chips
    opt_stream = 0.0
    opt_resident = 0.0
    if shape.kind == "train":
        # p, g, m, v resident; update reads p,m,v,g and writes p,m,v
        opt_resident = P_total * (pb + accum_bytes + 2 * moment_bytes) / chips
        opt_stream = P_total * (4 * pb + 6 * moment_bytes) / chips
    hbm_stream = weight_stream + act_stream + cache_stream + opt_stream

    resid = P_total * pb / chips + opt_resident + cache_resident
    if shape.kind == "train":
        # residual carries for backward: one (B,S,d) per layer per
        # microbatch, sharded dp×sp
        resid += (tokens / grad_accum) / chips * d * act_bytes * cfg.num_layers

    return CellCounts(
        flops_global=flops_global,
        flops_per_dev=flops_per_dev,
        hbm_bytes_per_dev=hbm_stream,
        hbm_resident_per_dev=resid,
        model_flops=model_flops,
        notes={
            "matmul": mm, "attention": attn, "rwkv": rwkv, "moe": moe,
            "fwd_passes": fwd_passes,
            "weight_stream_dev": weight_stream,
            "act_stream_dev": act_stream,
            "cache_stream_dev": cache_stream,
            "opt_stream_dev": opt_stream,
        },
    )


# ------------------------------------------------ the collective schedule ----
# The port's own schedule: what its placed LM steps
# (repro_torch.distributed.sharding) and its sharded FETI operator
# (repro_torch.feti.sharded) send, call by call, in record_collectives'
# convention (each call's result bytes, every call counted). It is not
# XLA's: the reference's rows read GSPMD's collectives from the compiled
# HLO, which may differ. Where both run, the two are equal exactly
# (tests/test_torch_collectives.py, chip_smoke.py's placed phase).
@functools.lru_cache(maxsize=None)
def _param_meta(cfg: ModelConfig) -> dict:
    """``{name: meta tensor}`` of the model's parameters (shapes and
    dtypes, no storage)."""
    from repro_torch.models import LanguageModel

    return dict(LanguageModel(cfg, device="meta").named_parameters())


def lm_collectives(cfg: ModelConfig, shape: ShapeCase, mesh, tcfg=None,
                   opt: bool = False, cache_len: Optional[int] = None,
                   cache_index: int = 0):
    """The c10d collectives one rank of the port's placed step of ``cfg``
    at ``shape`` issues on ``mesh`` (a ``MeshShape`` or ``DeviceMesh``
    with axes among pod / data / model), as a
    :class:`~repro_torch.launch.roofline.CollectiveStats`.

    Parameters are placed by ``param_shardings`` (serving under ``opt``
    drops FSDP where the TP-sharded bf16 weights fit 4 GiB, as the
    reference's dry-run does). A unit's forward gathers each of its
    parameters: one all-gather a mesh dimension that shards it over more
    than one rank, the innermost first, but none along 'model' for a part
    that computes tensor-parallel
    (:func:`~repro_torch.distributed.tensor_parallel.split_plan`). Such a
    part sends activations over 'model' instead, each of (rows, S, d) at
    the activation dtype (rows: the rank's batch rows, a microbatch's in
    training; a "shard": (rows, S/tp, d)) unless said otherwise.

    A forward whose length S divides a 'model' axis of more than one rank
    (training, prefill; decode's S is 1) is sequence-parallel (SP). Its
    forward sends, in every layer, two all-gathers (each block part's
    normed input along S), and one reduce-scatter to a shard after each
    row-parallel projection (a split attention's, MLA's, MLP's or RWKV-6
    time mix's ``wo``, a split RG-LRU's ``w_out``, a split RWKV-6 channel
    mix's ``cm_r`` and ``cm_v``: two), after a split MoE layer's combine
    (its shared expert's part in the same sum) and after a split
    embedding's lookup; a split RG-LRU one all-gather of its conv output
    (rows, S, lru_width). Prefill: one all-gather of each rank's last
    position (rows, tp, d), then a split head's (rows, 1, V) logits
    all-gathered along V. Training: one all-gather of the final norm's
    output into the head (computed whole by every rank where the vocab
    does not split); no logits are gathered. Its backward, per
    microbatch: one reduce-scatter to a shard for each of the block parts'
    all-gathers of the input (two a layer) and for a split head's, one
    all-gather for each reduce-scatter and for the lookup (whole where the
    vocab does not split, then cut to the rank's positions), a split
    RG-LRU's conv output gradient all-reduced, and one all-reduce over
    'model' of the gradient of every parameter used whole
    (``SplitPlan.mode`` "whole": the norm scales, the final norm, whatever
    does not divide, MLA's latent projections and norms, the router; not
    an unsplit embedding or head, whose gradient each rank holds whole)
    and of each row-parallel projection's bias (added on the rank's
    positions), besides those of "head", "channels" and "summed".

    Without SP (decode, an S that does not divide, a 'model' axis of
    one): one all-reduce of (rows, S, d) in each forward where SP has a
    reduce-scatter, and no all-gather of the input; serving's split head
    one all-gather of its (rows, 1, V) logits (the last position); in
    backward one all-reduce of (rows, S, d) for each split attention,
    split MLP, split MoE layer, split RG-LRU, split head and each of a
    split RWKV-6's time and channel mix (the gradient of their input), for
    a split RG-LRU also one of the gathered conv output's gradient (rows,
    S, lru_width), for a split MoE layer one of its (rows, S, top_k) f32
    gate values, for a split MLA one of each latent that enters its heads
    (the normed query latent, or the input without a query rank; ``ckv``;
    ``krope``), and one all-reduce over 'model' of each whole tensor a
    split part uses whole or narrows (``SplitPlan.mode`` "head",
    "channels" or "summed").

    Serving's cache along its slots
    (:mod:`repro_torch.distributed.tensor_parallel`): where an attention
    layer's slot group has g > 1 ranks and its cache's slots (``cache_len``,
    default a decode's ``seq_len`` or a prefill's ``cache_index + S``; a
    ring's ``min(window, cache_len)``) divide g, a step whose queries
    attend the cache (decode; a prefill at ``cache_index > 0``, not a
    ring's prefill of S > 1, which attends in context) merges the group's
    partial softmaxes in each such layer: where the group's ranks hold
    other query heads (MLA by heads, replicated KV heads), one all-gather
    of the group's queries (rows, S, g·H/tp, Dq) at the activation dtype
    (Dq: head_dim, or MLA's kv_lora_rank + qk_rope_head_dim), one
    all-reduce (MAX) of their (rows, S, g·H/tp) f32 maxima and one
    reduce-scatter to the rank's (rows, S, H/tp, Dv + 1) f64 numerators
    and sums (Dv: head_dim, or kv_lora_rank); where every rank holds every
    head (an attention that does not split), two all-reduces, of (rows,
    S, H) f32 and (rows, S, H, Dv + 1) f64. A prefill into a fresh cache
    sends none of these.

    Serving (prefill, decode): one forward. Training (``tcfg``:
    ``grad_accum`` k, ``remat``), per microbatch: a forward, under
    ``remat`` every layer's gathers and forward collectives again in
    backward, and the backward above. The loss: with a split vocab (the
    vocab-parallel cross-entropy) one all-reduce (MAX) of a (rows, S) f32
    max and one of the (2, rows, S) f32 exp-sums and gold logits over
    'model'; then one all-reduce of the three sums and, in every MoE layer
    and pass, one of its load-balancing sums (2E + 1 f32) over each
    data-parallel dimension; each parameter's gradient, cut to the rank's
    'model' shard, all-reduced over each data-parallel dimension. Per step,
    the gradient norm: one all-reduce of a partial sum per set of sharding
    mesh dimensions, over each such dimension. Dimensions of one rank send
    nothing. The batch must divide the data-parallel ranks (k times) in
    training; in serving a batch that does not rides whole on every
    rank."""
    from repro_torch.distributed.sharding import (data_parallel_dims,
                                                  mesh_axes, param_shardings,
                                                  placements)
    from repro_torch.distributed.tensor_parallel import split_plan
    from repro_torch.launch.roofline import CollectiveStats

    axes = mesh_axes(mesh)
    sizes = list(axes.values())
    params = _param_meta(cfg)
    tp = axes.get("model", 1)
    serving = shape.kind in ("decode", "prefill")
    fsdp = not (opt and serving and cfg.param_count() * 2 / tp <= 4 * 2**30)
    specs = param_shardings(mesh, params, fsdp=fsdp)
    dp = data_parallel_dims(mesh)
    plan = split_plan(cfg, tp)
    stats = CollectiveStats(bytes_by_op={}, count_by_op={})

    def add(op: str, nbytes: int, times: int = 1) -> None:
        if times:
            stats.bytes_by_op[op] = stats.bytes_by_op.get(op, 0) + \
                nbytes * times
            stats.count_by_op[op] = stats.count_by_op.get(op, 0) + times

    cuts = {n: [(d, p.dim) for d, p in enumerate(placements(mesh, specs[n]))
                if p.is_shard() and sizes[d] > 1] for n in params}
    model_dims = {d for d, a in enumerate(axes) if a == "model"}
    gathered = {n: [c for c in cuts[n] if not (
        plan.mode(n) == "shard" and c[0] in model_dims)] for n in params}
    layers = [n for n in params if n.startswith("blocks.")]
    rest = [n for n in params if not n.startswith("blocks.")]

    def gathers(names, times: int) -> None:
        for n in names:
            local = list(params[n].shape)
            for d, tdim in cuts[n]:
                local[tdim] //= sizes[d]
            for d, tdim in reversed(gathered[n]):
                local[tdim] *= sizes[d]
                add("all-gather", math.prod(local) * params[n].element_size(),
                    times)

    # the activations a split part sends over 'model'
    dpn = math.prod(sizes[d] for d in dp)
    B = shape.global_batch
    k = 1 if serving else tcfg.grad_accum
    if serving:
        rows = B // dpn if B % dpn == 0 else B
        S = shape.seq_len if shape.kind == "prefill" else 1
    else:
        rows, S = B // (k * dpn), shape.seq_len
    sp = tp > 1 and S % tp == 0
    act = _bytes_of(cfg.dtype)
    hidden = rows * S * cfg.d_model * act
    shard = hidden // tp
    lru = rows * S * cfg.lru_width * act  # a split RG-LRU's conv output
    n_mla, n_moe = len(plan.mla), len(plan.moe)
    n_rglru, n_rwkv = len(plan.rglru), len(plan.rwkv)
    # each forward's row-parallel sums
    fwd = (len(plan.attention) + len(plan.mlp) + n_mla + n_moe + n_rglru
           + 3 * n_rwkv)
    audio = cfg.frontend_stub and cfg.family == "audio"  # no lookup
    lookup = plan.vocab and not audio
    head = plan.vocab and cfg.has_lm_head
    # without SP, each backward's input gradients
    bwd = (len(plan.attention) + len(plan.mlp) + n_moe + n_rglru
           + 2 * n_rwkv + head)
    n_layers = cfg.num_layers

    if serving:
        gathers(rest + layers, 1)
        add("all-gather", lru, n_rglru)
        if sp:
            add("all-gather", hidden, 2 * n_layers)
            add("reduce-scatter", shard, fwd + lookup)
            add("all-gather", rows * tp * cfg.d_model * act)  # last position
        else:
            add("all-reduce", hidden, fwd + lookup)
        add("all-gather", rows * cfg.vocab_size * act, head)
        if cache_len is None:
            cache_len = (shape.seq_len if shape.kind == "decode"
                         else cache_index + S)
        size = min(cfg.local_window, cache_len) if cfg.local_window \
            else cache_len
        g = plan.slot_group
        merges = (shape.kind == "decode" or cache_index > 0 and not (
            cfg.local_window and S > 1))
        if g > 1 and size % g == 0 and merges:
            mla = cfg.attn_kind == "mla"
            dq = cfg.kv_lora_rank + cfg.qk_rope_head_dim if mla \
                else cfg.head_dim
            dv = cfg.kv_lora_rank if mla else cfg.head_dim
            n = len(plan.slots)
            if plan.mla or plan.attention:  # the rank's H/tp query heads
                heads = cfg.num_heads // tp
                add("all-gather", rows * S * g * heads * dq * act, n)
                add("all-reduce", rows * S * g * heads * 4, n)
                add("reduce-scatter", rows * S * heads * (dv + 1) * 8, n)
            else:
                add("all-reduce", rows * S * cfg.num_heads * 4, n)
                add("all-reduce", rows * S * cfg.num_heads * (dv + 1) * 8, n)
        return stats
    passes = 2 if tcfg.remat else 1
    gathers(rest, k)
    gathers(layers, k * passes)
    add("all-gather", lru, k * passes * n_rglru)
    if sp:  # the head's input gathered once; the lookup's gradient
        add("all-gather", hidden, k * (2 * n_layers * passes + 1))
        add("reduce-scatter", shard, k * (fwd * passes + lookup))
        add("reduce-scatter", shard, k * (2 * n_layers + head))
        add("all-gather", hidden, k * (fwd + (not audio)))
    else:
        add("all-reduce", hidden, k * (fwd * passes + lookup + bwd))
        add("all-reduce", rows * S * cfg.top_k * 4, k * n_moe)  # gates
        q_in = cfg.q_lora_rank or cfg.d_model  # MLA's latents
        for width in (q_in, cfg.kv_lora_rank, cfg.qk_rope_head_dim):
            add("all-reduce", rows * S * width * act, k * n_mla)
    add("all-reduce", lru, k * n_rglru)
    if head:  # the vocab-parallel cross-entropy
        add("all-reduce", rows * S * 4, k)
        add("all-reduce", 2 * rows * S * 4, k)
    summed = ("head", "channels", "summed") + (("whole",) if sp else ())
    for n, p in params.items():
        unused = (n == "embed" and audio and not cfg.tie_embeddings
                  or n in ("embed", "lm_head") and not plan.vocab)
        row_bias = plan.mode(n) == "shard" and not any(
            d in model_dims for d, _ in cuts[n])
        if (plan.mode(n) in summed or sp and row_bias) and not unused:
            add("all-reduce", p.numel() * p.element_size(), k)
    moe_layers = sum(n.endswith(".mlp.router") for n in params)
    add("all-reduce", 3 * 4, k * len(dp))
    add("all-reduce", (2 * cfg.num_experts + 1) * 4,
        k * passes * moe_layers * len(dp))
    for n, p in params.items():
        cut = math.prod(sizes[d] for d, _ in cuts[n] if d not in dp)
        add("all-reduce", p.numel() // cut * p.element_size(), k * len(dp))
    keys = {tuple(d for d, _ in cuts[n]) for n in params}
    for d in range(len(sizes)):
        shared = sum(d in key for key in keys)
        add("all-reduce", 4 * shared, 1 if shared else 0)
    return stats


@functools.lru_cache(maxsize=None)
def _n_lambda(problem: str, dim: int, sub_grid: tuple,
              elems_per_sub: tuple) -> int:
    from repro_torch.fem.decomposition import decompose_problem

    return decompose_problem(problem, dim, sub_grid, elems_per_sub,
                             assemble_values=False).n_lambda


def feti_collectives(fc, shape_name: str, chips: int):
    """The c10d collectives one rank of the port's sharded FETI operator
    issues in the cell ``shape_name`` of ``fc`` over ``chips`` ranks: the
    assembly and the Dirichlet stage run rank by rank and send nothing;
    ``solve_iter`` is one explicit dual-operator application, whose
    λ-space sum (``feti.sharded.reduce_sum``) is one all-reduce of n_λ f32
    (``FetiMesh.all_reduce``), and ``solve_iter_multi`` one of n_λ ×
    FETI_SOLVE_N_RHS. One rank sends nothing. The payload does not depend
    on the rank count; the port's split needs a subdomain a rank
    (``launch.mesh.split_sizes``), so on more ranks than subdomains it is
    the schedule of a deployment the port cannot yet run."""
    from repro_torch.launch.roofline import CollectiveStats

    stats = CollectiveStats(bytes_by_op={}, count_by_op={})
    if chips == 1 or shape_name not in ("solve_iter", "solve_iter_multi"):
        return stats
    n_rhs = FETI_SOLVE_N_RHS if shape_name == "solve_iter_multi" else 1
    nl = _n_lambda(fc.problem, fc.dim, tuple(fc.sub_grid),
                   tuple(fc.elems_per_sub))
    stats.bytes_by_op["all-reduce"] = nl * n_rhs * 4
    stats.count_by_op["all-reduce"] = 1
    return stats
