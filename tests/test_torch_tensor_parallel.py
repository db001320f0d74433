"""Tensor parallelism over 'model' as pure functions, with no ranks: which
blocks split on the production meshes (``split_plan``), that the plan
agrees with the sharding rules, that a rank's query heads are those whose
KV heads it holds, the head-sharded cache's shapes, the schedule of a
placed step on (data=1, model=2) and the dry-run's placement notes. An
unplaced model sees no 'model' group and computes as before.

The placed runs themselves (against one process and the reference) are in
``tests/test_torch_placed_train.py``, ``tests/test_torch_sharding.py`` and
``tests/test_torch_collectives.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.tensor_parallel import (  # noqa: E402
    SplitPlan, copy_to_tp, gather_from_tp, local_kv_heads, reduce_from_tp,
    split_plan)
from repro_torch.launch.mesh import MeshShape, make_production_mesh  # noqa
from repro_torch.models import LanguageModel, init_cache  # noqa: E402

pytestmark = pytest.mark.torch_port

LM_ARCHS = ("deepseek-v2-236b", "granite-3-8b", "grok-1-314b",
            "hubert-xlarge", "mistral-large-123b", "nemotron-4-340b",
            "qwen1.5-32b", "qwen2-vl-2b", "recurrentgemma-2b", "rwkv6-1.6b")
TPS = (2, 4, 8, 16)


def test_which_blocks_split():
    granite = get_config("granite-3-8b")
    layers = tuple(range(granite.num_layers))
    for tp in (2, 16):  # 32 heads, 8 KV heads: replicated on 16
        plan = split_plan(granite, tp)
        assert plan.attention == plan.mlp == layers
        assert plan.kv_replicated == (tp == 16)
        assert not plan.vocab  # 49,155 does not divide
        assert plan.mode("embed") == "whole"
        assert plan.mode("blocks.3.inner.wk.w") == (
            "head" if tp == 16 else "shard")
        assert plan.mode("blocks.3.inner.wo.w") == "shard"
    assert split_plan(granite, 1) == SplitPlan((), (), False, False)

    rg = get_config("recurrentgemma-2b")  # 10 heads, 1 KV head
    plan = split_plan(rg, 2)
    attn = tuple(i for i, k in enumerate(rg.layer_kinds) if k == "attn")
    assert plan.attention == attn and plan.kv_replicated and plan.vocab
    assert plan.mlp == tuple(range(rg.num_layers))
    assert plan.mode(f"blocks.{attn[0]}.inner.wk.w") == "head"
    assert plan.mode(f"blocks.{attn[0]}.inner.wq.w") == "shard"
    assert plan.mode("blocks.0.inner.w_in.w") == "shard"  # RG-LRU
    assert split_plan(rg, 4).attention == ()  # 10 heads do not divide 4

    qwen = get_config("qwen1.5-32b")  # 40 heads
    plan = split_plan(qwen, 16)
    assert plan.attention == () and plan.mlp == tuple(range(qwen.num_layers))
    assert split_plan(qwen, 8).attention == tuple(range(qwen.num_layers))

    assert split_plan(get_config("rwkv6-1.6b"), 16).mlp == ()


def test_mla_and_moe_split_on_the_production_axis():
    """deepseek-v2-236b at 16: MLA by heads in all 60 layers (128 heads, 8
    a rank), its 160 experts by expert in the 59 MoE layers (10 a rank),
    the shared expert (width 3,072) by columns; the latent projections,
    their norms and the router whole. grok-1-314b: its 8 experts by expert
    at 8 and 2, by each expert's ff columns at 16 (the reference's
    fallback)."""
    ds = get_config("deepseek-v2-236b")  # MLA, MoE past layer 0
    plan = split_plan(ds, 16)
    assert plan.attention == () and plan.mlp == (0,)
    assert plan.mla == tuple(range(60))
    assert plan.moe == tuple((i, "expert") for i in range(1, 60))
    assert plan.moe_shared
    for name in ("inner.wq_b.w", "inner.wk_b.w", "inner.wv_b.w",
                 "inner.wo.w", "mlp.wi", "mlp.wg", "mlp.wo",
                 "mlp.shared.wi.w", "mlp.shared.wg.w", "mlp.shared.wo.w"):
        assert plan.mode(f"blocks.1.{name}") == "shard", name
    for name in ("inner.wq_a.w", "inner.q_norm_scale", "inner.wkv_a.w",
                 "inner.kv_norm_scale", "mlp.router", "norm1.scale"):
        assert plan.mode(f"blocks.1.{name}") == "whole", name
    assert plan.mode("blocks.0.mlp.wi.w") == "shard"  # the dense layer
    assert split_plan(ds, 7).mla == () and split_plan(ds, 7).moe == ()

    grok = get_config("grok-1-314b")  # 8 experts, e_ff 32,768
    for tp, how in ((2, "expert"), (8, "expert"), (16, "ff")):
        plan = split_plan(grok, tp)
        assert plan.moe == tuple((i, how) for i in range(64)), tp
        assert plan.mlp == () and not plan.moe_shared
        assert plan.mode("blocks.5.mlp.wo") == "shard"
        assert plan.mode("blocks.5.mlp.router") == "whole"
    three = dataclasses.replace(get_smoke_config("grok-1-314b"),
                                num_experts=3)
    assert split_plan(three, 2).moe == ((0, "ff"), (1, "ff"))
    narrow = dataclasses.replace(get_smoke_config("deepseek-v2-236b"),
                                 moe_d_ff=33, num_shared_experts=1)
    plan = split_plan(narrow, 2)  # 8 experts split, a shared width of 33
    assert plan.moe == ((1, "expert"), (2, "expert"))
    assert not plan.moe_shared
    assert plan.mode("blocks.1.mlp.shared.wi.w") == "whole"
    odd = dataclasses.replace(three, moe_d_ff=33)  # nothing divides
    assert split_plan(odd, 2).moe == ()
    assert split_plan(odd, 2).mode("blocks.0.mlp.wi") == "whole"


def _model_dim(cfg, tp, name):
    """The dimension of ``name`` whose 'model' cut is the rank's slice:
    an expert stack's expert dim (by experts) or ff dim (by ff columns),
    a row-parallel ``wo``'s, ``w_out``'s, ``cm_v``'s and ``cm_r``'s and
    the embedding's rows, else the output."""
    if name.endswith(("mlp.wi", "mlp.wg", "mlp.wo")):  # (E, d, ff) stacks
        if dict(split_plan(cfg, tp).moe)[int(name.split(".")[1])] == \
                "expert":
            return 0
        return 1 if name.endswith("wo") else 2
    rows = (".wo.w", ".w_out.w", ".cm_v.w", ".cm_r.w")
    return 0 if name == "embed" or name.endswith(rows) else -1


def _unit(cfg, name):
    """The width of the contiguous block one head, expert or column owns
    along ``name``'s 'model' dimension."""
    parts = name.split(".")
    kind = cfg.layer_kinds[int(parts[1])] if parts[0] == "blocks" else None
    if ".inner." in name and kind == "rwkv6":  # heads; the channel mix's
        return (cfg.rwkv_head_dim if parts[3] in ("wr", "wk", "wv", "wg",
                                                  "wo") else 1)
    if ".inner." in name and kind == "rglru":  # channels
        return 1
    if ".inner." in name and cfg.attn_kind == "mla":
        dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        return {"wq_b": dn + dr, "wk_b": dn, "wv_b": cfg.v_head_dim,
                "wo": cfg.v_head_dim}[name.split(".")[3]]
    if ".inner." in name:
        return cfg.head_dim
    return 1  # an expert of a stack, an FFN column, a vocab row


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_split_parts_are_sharded_on_model(arch):
    """On both production meshes every part that splits has its weights
    cut along 'model' where its rank's slice lies: column-parallel on the
    output (heads major: MLA's ``wq_b`` H·(dn+dr), ``wk_b`` H·dn, ``wv_b``
    H·dv), row-parallel and the embedding on the input rows, an expert
    stack on its experts or, in the fallback, each expert's ff columns.
    The contiguous shard a rank keeps holds exactly its own heads (or
    experts, or columns): those of ``[r·n/tp, (r+1)·n/tp)``."""
    cfg = get_config(arch)
    meta = dict(LanguageModel(cfg, device="meta").named_parameters())
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        tp = mesh.shape["model"]
        specs = sharding.param_shardings(mesh, meta)
        plan = split_plan(cfg, tp)
        for name, p in meta.items():
            if plan.mode(name) != "shard" or p.dim() < 2:
                continue
            dim = _model_dim(cfg, tp, name) % p.dim()
            assert specs[name][dim] == "model", name
            # each index along the dim labelled by the head it belongs to
            n = p.shape[dim] // _unit(cfg, name)
            label = torch.arange(n).repeat_interleave(_unit(cfg, name))
            for r in (0, tp - 1):
                spec = tuple(a if a == "model" else None
                             for a in specs[name])
                full = label.reshape([-1 if i == dim else 1
                                      for i in range(p.dim())]).expand(
                    [p.shape[i] if i == dim else 1 for i in range(p.dim())])
                mine = sharding.shard_of(full, mesh, spec, {"model": r})
                assert torch.equal(mine.flatten().unique(), torch.arange(
                    r * n // tp, (r + 1) * n // tp)), (name, r)
        for i in plan.attention:
            for w in ("wk", "wv"):
                spec = specs[f"blocks.{i}.inner.{w}.w"]
                assert (spec[-1] == "model") or plan.kv_replicated


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_query_heads_use_the_rank_kv_heads(arch):
    """The column cut of ``wq`` gives rank r the contiguous heads [r·H/tp,
    (r+1)·H/tp); each uses a KV head (h // (H / Hkv)) that the rank holds:
    its contiguous slice of ``wk`` / ``wv``, or the one replicated head it
    slices out."""
    cfg = get_config(arch)
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    for tp in TPS:
        plan = split_plan(cfg, tp)
        if not plan.attention:
            continue
        n = local_kv_heads(cfg, tp)
        for r in range(tp):
            held = ({r // (tp // Hkv)} if plan.kv_replicated
                    else set(range(r * n, (r + 1) * n)))
            heads = range(r * H // tp, (r + 1) * H // tp)
            assert {h // (H // Hkv) for h in heads} == held, (tp, r)


def test_unplaced_models_see_no_group():
    cfg = get_smoke_config("granite-3-8b")
    model = LanguageModel(cfg, device="cpu")
    assert model.tp is None
    assert all(b.inner.tp is None and b.mlp.tp is None for b in model.blocks)
    x = torch.randn(2, 3, 4)
    assert copy_to_tp(x, None) is x and reduce_from_tp(x, None) is x
    assert gather_from_tp(x, None) is x


def test_head_sharded_cache():
    """``init_cache(tp=)``: a split attention's KV heads a rank, a split
    RG-LRU's channels of ``h`` and ``conv``, a split RWKV-6's heads of
    ``S``, the attention's block of the slots where its slot group has
    more than one rank (a replicated KV head, MLA: half of them at 2;
    ``tests/test_torch_slot_sharded_cache.py``), the rest as at ``tp``
    1."""
    cfg = get_smoke_config("granite-3-8b")  # 2 KV heads
    one, two = (init_cache(cfg, 2, 8, "cpu", tp=t) for t in (1, 2))
    for a, b in zip(one, two):
        assert a["k"].shape[2] == 2 and b["k"].shape[2] == 1
        assert a["pos"].shape == b["pos"].shape
    rg = get_smoke_config("recurrentgemma-2b")  # 1 KV head: replicated
    for a, b, kind in zip(init_cache(rg, 2, 8, "cpu"),
                          init_cache(rg, 2, 8, "cpu", tp=2), rg.layer_kinds):
        if kind == "attn":  # its one KV head, half the slots
            assert {k: v.shape[:1] + (v.shape[1] // 2,) + v.shape[2:]
                    for k, v in a.items()} == {
                k: v.shape for k, v in b.items()}
        else:  # RG-LRU by width: the rank's channels
            assert b["h"].shape == (2, rg.lru_width // 2)
            assert b["conv"].shape == (2, rg.conv_width - 1,
                                       rg.lru_width // 2)
            assert a["h"].shape == (2, rg.lru_width)
    rwkv = get_smoke_config("rwkv6-1.6b")  # 4 heads of 16
    for a, b in zip(init_cache(rwkv, 2, 8, "cpu"),
                    init_cache(rwkv, 2, 8, "cpu", tp=2)):
        assert a["S"].shape == (2, 4, 16, 16)
        assert b["S"].shape == (2, 2, 16, 16)
        assert a["shift_tm"].shape == b["shift_cm"].shape == (2, 64)
    ds = get_smoke_config("deepseek-v2-236b")  # MLA: half the slots
    assert [{k: v.shape for k, v in a.items()}
            for a in init_cache(ds, 2, 8, "cpu", tp=2)] == [
        {k: v.shape[:1] + (4,) + v.shape[2:] for k, v in a.items()}
        for a in init_cache(ds, 2, 8, "cpu")]


def test_schedule_on_model_ranks():
    """granite-3-8b at full width, 2 layers, f32, remat, (data=1,
    model=2), global batch 4 x 512, sequence-parallel (512 divides 2): no
    weight is gathered (the tied vocab of 49,155 stays whole, and nothing
    is cut along 'data'). Each layer all-gathers its two parts' inputs,
    (4, 512, 4096) f32, and reduce-scatters its attention's and MLP's sums
    to (4, 256, 4096), in the forward and again in the recomputation; in
    backward each part's gather's gradient is reduce-scattered and each
    reduce-scatter's all-gathered. The unsplit embedding is looked up
    whole and projected on every position by every rank: the final norm's
    output is all-gathered into the head (its gradient narrowed), and the
    lookup's gradient all-gathered in backward, so that each rank holds
    the embedding's whole gradient and nothing sums it. All-reduces: the
    five norm scales' gradients and the norm's 4 B. Decode (S = 1) keeps
    the all-reduces: four (4, 1, 4096), one a split part."""
    from repro_torch.launch.analytic import lm_collectives
    from repro_torch.launch.shapes import ShapeCase
    from repro_torch.train import TrainConfig

    cfg = dataclasses.replace(get_config("granite-3-8b"), num_layers=2,
                              dtype="float32", param_dtype="float32")
    mesh = MeshShape({"data": 1, "model": 2})
    got = lm_collectives(cfg, ShapeCase("placed", 512, 4, "train"), mesh,
                         TrainConfig(remat=True))
    act, shard = 4 * 512 * 4096 * 4, 4 * 256 * 4096 * 4
    assert act == 33_554_432
    norm = 4096 * 4
    summed = 5 * norm + 4
    assert got.count_by_op == {"all-gather": 14, "reduce-scatter": 12,
                               "all-reduce": 6}
    assert got.bytes_by_op == {"all-gather": 14 * act,
                               "reduce-scatter": 12 * shard,
                               "all-reduce": summed}
    assert summed == 81_924
    # without remat the recomputation's four and four go; serving: one
    # forward, and prefill's last position from each rank
    got = lm_collectives(cfg, ShapeCase("placed", 512, 4, "train"), mesh,
                         TrainConfig(remat=False))
    assert got.bytes_by_op == {"all-gather": 10 * act,
                               "reduce-scatter": 8 * shard,
                               "all-reduce": summed}
    got = lm_collectives(cfg, ShapeCase("prefill", 512, 4, "prefill"), mesh)
    assert got.bytes_by_op == {"all-gather": 4 * act + 4 * 2 * 4096 * 4,
                               "reduce-scatter": 4 * shard}
    got = lm_collectives(cfg, ShapeCase("decode", 512, 4, "decode"), mesh)
    assert got.bytes_by_op == {"all-reduce": 4 * 4 * 4096 * 4}


def test_schedule_of_mla_and_experts_on_model_ranks():
    """deepseek-v2-236b at full width, 2 layers (the dense layer 0, then
    MLA + MoE), f32, remat, (data=1, model=2), global batch 4 x 512,
    sequence-parallel. Per step, (4, 512, 5120) f32 all-gathers: the four
    part inputs in each pass and the split head's input (9), one in
    backward for each of the forward's reduce-scatters (5); reduce-scatters
    to (4, 256, 5120): the two MLA ``wo``, the dense MLP's and the MoE
    combine in each pass and the lookup's (9), and in backward each
    gather's (5). In each pass the weights computed whole that the specs
    cut along 'model' (``wq_a``, ``wkv_a``, the router) are gathered, but
    no MLA head weight and no expert. All-reduces: the vocab-parallel
    loss's (4, 512) f32 max and (2, 4, 512) f32 sums; the gradients of
    the parameters used whole (the five norm scales, each MLA layer's
    ``wq_a``, ``wkv_a`` and latent norms, the router), no latent and no
    gate value any more; the norm's 4 B. Decode keeps its path, and each
    MLA layer merges its slot group's (both ranks') partial softmaxes: the
    (4, 1, 128, 576) f32 absorbed queries all-gathered, their f32 maxima
    all-reduced, the rank's (4, 1, 64, 513) f64 numerators and sums
    reduce-scattered."""
    from repro_torch.launch.analytic import lm_collectives
    from repro_torch.launch.shapes import ShapeCase
    from repro_torch.train import TrainConfig

    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), num_layers=2,
                              dtype="float32", param_dtype="float32")
    mesh = MeshShape({"data": 1, "model": 2})
    got = lm_collectives(cfg, ShapeCase("placed", 512, 4, "train"), mesh,
                         TrainConfig(remat=True))
    act, shard = 4 * 512 * 5120 * 4, 4 * 256 * 5120 * 4
    latent_w = (5120 * 1536 + 5120 * 576) * 4
    whole = 2 * latent_w + 5120 * 160 * 4  # gathered in each pass
    used = (5 * 5120 + 2 * (1536 + 512)) * 4 + whole  # gradients summed
    loss = 4 * 512 * 4 + 2 * 4 * 512 * 4
    assert got.count_by_op == {"all-gather": 14 + 2 * 5,
                               "reduce-scatter": 14,
                               "all-reduce": 2 + 14 + 1}
    assert got.bytes_by_op == {"all-gather": 14 * act + 2 * whole,
                               "reduce-scatter": 14 * shard,
                               "all-reduce": loss + used + 4}
    assert got.bytes_by_op["all-reduce"] == 89_927_684
    logits = 4 * 102400 * 4
    got = lm_collectives(cfg, ShapeCase("prefill", 512, 4, "prefill"), mesh)
    assert got.bytes_by_op == {
        "all-gather": 4 * act + 4 * 2 * 5120 * 4 + logits + whole,
        "reduce-scatter": 5 * shard}
    got = lm_collectives(cfg, ShapeCase("decode", 512, 4, "decode"), mesh)
    merge = {"all-gather": 4 * 128 * 576 * 4, "all-reduce": 4 * 128 * 4,
             "reduce-scatter": 4 * 64 * 513 * 8}
    assert got.bytes_by_op == {
        "all-reduce": 5 * 4 * 5120 * 4 + 2 * merge["all-reduce"],
        "all-gather": logits + whole + 2 * merge["all-gather"],
        "reduce-scatter": 2 * merge["reduce-scatter"]}
    assert got.count_by_op["reduce-scatter"] == 2


def test_placement_notes_name_what_stays_whole():
    from repro_torch.launch.dryrun import placement_notes

    granite = placement_notes(get_config("granite-3-8b"), 16)
    split, whole = granite["placement_model_axis"].split("; ")
    assert "attention" in split and "MLP" in split
    assert "vocab 49155" in whole
    ds = placement_notes(get_config("deepseek-v2-236b"), 16)
    split, whole = ds["placement_model_axis"].split("; ")
    assert "MLA by heads" in split and "MoE by experts" in split
    assert "10 a rank" in split and "shared expert" in split
    assert "latent projections" in whole and "router" in whole
    assert "experts" not in whole
    assert "KV heads" not in ds["placement_cache"]
    assert "compressed MLA" in ds["placement_cache"]
    assert "KV heads" in granite["placement_cache"]
    split, _ = placement_notes(get_config("grok-1-314b"),
                               16)["placement_model_axis"].split("; ")
    assert "ff columns" in split


def test_placement_notes_name_sequence_parallelism():
    """Every LM row on 16 names sequence on 'model'; the vocab-parallel
    loss where the vocab splits (deepseek's 102,400: 6,400 a rank), every
    position on every rank where it does not (granite's 49,155)."""
    from repro_torch.launch.dryrun import placement_notes

    ds = placement_notes(get_config("deepseek-v2-236b"), 16)
    assert "sequence on 'model'" in ds["placement_sequence"]
    assert "vocab-parallel loss (the rank's 6400 of 102400" in \
        ds["placement_sequence"]
    granite = placement_notes(get_config("granite-3-8b"), 16)
    assert "sequence on 'model'" in granite["placement_sequence"]
    assert "vocab-parallel" not in granite["placement_sequence"]
    assert "vocab 49155 whole" in granite["placement_sequence"]
    assert "every position" in granite["placement_sequence"]
    one = placement_notes(get_config("granite-3-8b"), 1)
    assert "no sequence parallelism" in one["placement_sequence"]


RGLRU_PARAMS = {"w_in.w": "shard", "w_gate_in.w": "shard", "wa.w": "shard",
                "wx.w": "shard", "w_out.w": "shard", "conv_w": "channels",
                "conv_b": "channels", "lam": "channels"}
RWKV_PARAMS = {"wr.w": "shard", "wk.w": "shard", "wv.w": "shard",
               "wg.w": "shard", "wo.w": "shard", "cm_k.w": "shard",
               "cm_v.w": "shard", "cm_r.w": "shard", "w0": "channels",
               "u": "channels", "w_lora_b.w": "channels", "mix_r": "summed",
               "mix_k": "summed", "mix_v": "summed", "mix_w": "summed",
               "cm_mix": "summed", "w_lora_a.w": "summed"}


@pytest.mark.parametrize("tp", [2, 16])
def test_recurrent_blocks_split(tp):
    """recurrentgemma-2b's RG-LRU layers by width (2,560 channels) and
    rwkv6-1.6b's RWKV-6 layers by heads (32 heads, d_ff 7,168) at 2 and
    16: every parameter of the block in its mode, and each agrees with the
    production spec: a ``"shard"`` weight is cut along 'model' on the
    dimension the rank computes with, the ``"channels"`` and ``"summed"``
    ones are not cut along it (gathered whole, then narrowed or used
    alike)."""
    mesh = MeshShape({"data": 1, "model": tp})
    for arch, table, kind in (("recurrentgemma-2b", RGLRU_PARAMS, "rglru"),
                              ("rwkv6-1.6b", RWKV_PARAMS, "rwkv6")):
        cfg = get_config(arch)
        plan = split_plan(cfg, tp)
        mine = tuple(i for i, k in enumerate(cfg.layer_kinds) if k == kind)
        assert (plan.rglru if kind == "rglru" else plan.rwkv) == mine
        meta = dict(LanguageModel(cfg, device="meta").named_parameters())
        specs = sharding.param_shardings(mesh, meta)
        names = {n.split(".", 3)[3] for n in meta
                 if n.startswith(f"blocks.{mine[0]}.inner.")}
        assert names == set(table), arch
        for layer in mine:
            for leaf, mode in table.items():
                name = f"blocks.{layer}.inner.{leaf}"
                assert plan.mode(name) == mode, (arch, name)
                cut = "model" in specs[name]
                assert cut == (mode == "shard"), (arch, name, specs[name])
                if mode == "shard":
                    dim = _model_dim(cfg, tp, name) % meta[name].dim()
                    assert specs[name][dim] == "model", name
        norm = f"blocks.{mine[0]}.norm1.scale"
        assert plan.mode(norm) == "whole"
    rwkv = split_plan(get_config("rwkv6-1.6b"), tp)
    assert rwkv.mlp == () and rwkv.attention == () and rwkv.vocab


def test_recurrent_blocks_stay_whole_where_they_do_not_divide():
    """An RG-LRU width of 66 at 4 ranks (it splits at 2), RWKV-6 with 3
    heads at 2, and RWKV-6 whose d_ff of 65 does not divide 2: the block
    stays whole, every parameter of it ``"whole"``, its state whole."""
    from repro_torch.distributed.tensor_parallel import (rglru_splits,
                                                         rwkv_splits)

    rg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                             lru_width=66)
    assert rglru_splits(rg, 2) and not rglru_splits(rg, 4)
    assert split_plan(rg, 4).rglru == () and split_plan(rg, 2).rglru == (0,
                                                                         1)
    for leaf in RGLRU_PARAMS:
        assert split_plan(rg, 4).mode(f"blocks.0.inner.{leaf}") == "whole"
    assert init_cache(rg, 2, 8, "cpu", tp=4)[0]["h"].shape == (2, 66)
    three = dataclasses.replace(get_smoke_config("rwkv6-1.6b"), d_model=48)
    odd = dataclasses.replace(get_smoke_config("rwkv6-1.6b"), d_ff=65)
    for cfg in (three, odd):
        assert not rwkv_splits(cfg, 2) and split_plan(cfg, 2).rwkv == ()
        for leaf in RWKV_PARAMS:
            assert split_plan(cfg, 2).mode(f"blocks.1.inner.{leaf}") == \
                "whole"
    assert init_cache(three, 2, 8, "cpu", tp=2)[0]["S"].shape == (
        2, 3, 16, 16)
    assert rwkv_splits(get_smoke_config("rwkv6-1.6b"), 4)
    assert not rglru_splits(get_smoke_config("rwkv6-1.6b"), 2)
    assert not rwkv_splits(get_smoke_config("granite-3-8b"), 2)


def test_schedule_of_recurrent_layers_on_model_ranks():
    """The smoke models at f32, remat, (data=1, model=2), global batch 4 x
    16, sequence-parallel, worked out by hand (rows 4, d 64, lru_width 64,
    an activation (4, 16, 64) f32 of 16,384 B, its shard (4, 8, 64) of
    8,192 B, the vocab of 128 split).

    recurrentgemma-2b (rglru, rglru, attn; one KV head, replicated): its
    all-gathers are the three layers' two part inputs in each of the two
    passes and the head's input (13), one in backward for each forward
    reduce-scatter (7), ``wk`` and ``wv`` (64, 16) gathered whole in each
    pass (4) and each RG-LRU's conv output in each pass (4). Its
    reduce-scatters: in each pass the attention's, three MLPs' and two
    RG-LRUs' sums (6), the lookup's, and in backward each of the 7 input
    gathers' gradients. All-reduces: the two gathered conv outputs'
    gradients, the loss's (4, 16) max and (2, 4, 16) sums, ``wk`` and
    ``wv`` whole (4,096 B each), each RG-LRU's ``conv_w`` (4, 64),
    ``conv_b`` and ``lam`` (64), the six norm scales and the final norm
    (64), the norm's 4 B.

    rwkv6-1.6b (2 layers, 4 heads, d_ff 128, layernorm): all-gathers of
    the two layers' two part inputs in each pass and the head's input
    (9) and one for each forward reduce-scatter (7); reduce-scatters: each
    layer's ``wo``, ``cm_r`` and ``cm_v`` in each pass (12), the lookup's,
    and the 5 gathers' gradients. All-reduces: the loss's two; its ``w0``,
    ``u`` (64), ``w_lora_b`` (32, 64), four mixes and ``cm_mix`` (64) and
    ``w_lora_a`` (64, 32) whole; the five norms' scales and biases (10 x
    64); the norm's 4 B. Prefill sends one forward's, the rank's last
    position and the logits; decode (S = 1) keeps the all-reduces."""
    from repro_torch.launch.analytic import lm_collectives
    from repro_torch.launch.shapes import ShapeCase
    from repro_torch.train import TrainConfig

    mesh = MeshShape({"data": 1, "model": 2})
    train = ShapeCase("placed", 16, 4, "train")
    act, shard, logits = 4 * 16 * 64 * 4, 4 * 8 * 64 * 4, 4 * 16 * 128 * 4
    assert act == 16_384
    loss, norm, last = 4 * 16 * 4 * 3, 64 * 4, 4 * 2 * 64 * 4

    rg = get_smoke_config("recurrentgemma-2b")
    got = lm_collectives(rg, train, mesh, TrainConfig(remat=True))
    kv = 64 * 16 * 4
    per_lru = (4 * 64 + 64 + 64) * 4
    assert got.count_by_op == {"all-gather": 13 + 7 + 4 + 4,
                               "reduce-scatter": 13 + 7,
                               "all-reduce": 2 + 2 + 2 + 6 + 7 + 1}
    assert got.bytes_by_op == {
        "all-gather": 20 * act + 4 * kv + 4 * act,
        "reduce-scatter": 20 * shard,
        "all-reduce": 2 * act + loss + 2 * kv + 2 * per_lru + 7 * norm + 4}
    assert got.bytes_by_op == {"all-gather": 409_600,
                               "reduce-scatter": 163_840,
                               "all-reduce": 46_596}
    prefill = lm_collectives(rg, ShapeCase("prefill", 16, 4, "prefill"),
                             mesh)
    assert prefill.bytes_by_op == {
        "all-gather": 6 * act + last + 4 * 128 * 4 + 2 * kv + 2 * act,
        "reduce-scatter": 7 * shard}
    # decode: the attention layer (its one KV head replicated, a slot
    # group of both ranks) merges the ranks' halves of its 16 slots: the
    # group's 4 query heads (4, 1, 4, 16) gathered, their maxima
    # all-reduced, the rank's (4, 1, 2, 17) f64 numerators and sums
    # reduce-scattered
    decode = lm_collectives(rg, ShapeCase("decode", 16, 4, "decode"), mesh)
    assert decode.bytes_by_op == {"all-gather": 4 * 128 * 4 + 2 * kv
                                  + 2 * 4 * 64 * 4 + 4 * 4 * 16 * 4,
                                  "all-reduce": 7 * 4 * 64 * 4 + 4 * 4 * 4,
                                  "reduce-scatter": 4 * 2 * 17 * 8}

    rwkv = get_smoke_config("rwkv6-1.6b")
    got = lm_collectives(rwkv, train, mesh, TrainConfig(remat=True))
    whole = ((64 + 64 + 32 * 64) + (5 * 64 + 64 * 32)) * 4
    assert got.count_by_op == {"all-gather": 9 + 7,
                               "reduce-scatter": 13 + 5,
                               "all-reduce": 2 + 2 * 9 + 10 + 1}
    assert got.bytes_by_op == {"all-gather": 16 * act,
                               "reduce-scatter": 18 * shard,
                               "all-reduce": loss + 2 * whole + 10 * norm
                               + 4}
    assert got.bytes_by_op["all-reduce"] == 39_684
    assert logits == 32_768  # gathered by no training step
    prefill = lm_collectives(rwkv, ShapeCase("prefill", 16, 4, "prefill"),
                             mesh)
    assert prefill.bytes_by_op == {"all-gather": 4 * act + last
                                   + 4 * 128 * 4,
                                   "reduce-scatter": 7 * shard}
    odd = lm_collectives(rwkv, ShapeCase("prefill", 15, 4, "prefill"), mesh)
    assert odd.bytes_by_op == {"all-gather": 4 * 128 * 4,
                               "all-reduce": 7 * 4 * 15 * 64 * 4}


def test_schedule_of_granite_smoke_on_model_ranks():
    """granite-3-8b's smoke model (2 layers, d 64, a tied vocab of 128,
    split) at f32, no remat, (data=1, model=2), global batch 4 x 16, by
    hand: all-gathers of (4, 16, 64) f32, the four part inputs and the
    head's input, then in backward one for each of the attention's and
    MLP's reduce-scatters and the lookup's (5); reduce-scatters to (4, 8,
    64): those five, and in backward each gather's gradient (5). No
    logits. All-reduces: the loss's max (4, 16) and sums (2, 4, 16), the
    five norm scales (64), the norm's 4 B. With grad_accum 2 each
    microbatch sends its own at half the rows; a prompt of 15 runs
    without SP (one all-reduce a split part and the lookup), and so does a
    training step at 15: an all-reduce after each of the four parts and
    the lookup, one of each part's and the head's input gradient, the
    loss's max and sums at (4, 15), and the norm's 4 B; nothing
    gathered."""
    from repro_torch.launch.analytic import lm_collectives
    from repro_torch.launch.shapes import ShapeCase
    from repro_torch.train import TrainConfig

    cfg = get_smoke_config("granite-3-8b")
    mesh = MeshShape({"data": 1, "model": 2})
    act, shard = 4 * 16 * 64 * 4, 4 * 8 * 64 * 4
    got = lm_collectives(cfg, ShapeCase("placed", 16, 4, "train"), mesh,
                         TrainConfig(remat=False))
    loss = 4 * 16 * 4 * 3
    assert got.count_by_op == {"all-gather": 10, "reduce-scatter": 10,
                               "all-reduce": 8}
    assert got.bytes_by_op == {"all-gather": 10 * act,
                               "reduce-scatter": 10 * shard,
                               "all-reduce": loss + 5 * 64 * 4 + 4}
    two = lm_collectives(cfg, ShapeCase("placed", 16, 4, "train"), mesh,
                         TrainConfig(remat=False, grad_accum=2))
    assert two.count_by_op == {"all-gather": 20, "reduce-scatter": 20,
                               "all-reduce": 15}
    assert two.bytes_by_op["all-gather"] == 10 * act
    odd = lm_collectives(cfg, ShapeCase("prefill", 15, 4, "prefill"), mesh)
    assert odd.bytes_by_op == {"all-gather": 4 * 128 * 4,
                               "all-reduce": 5 * 4 * 15 * 64 * 4}
    odd = lm_collectives(cfg, ShapeCase("placed", 15, 4, "train"), mesh,
                         TrainConfig(remat=False))
    assert odd.count_by_op == {"all-reduce": 13}
    assert odd.bytes_by_op == {"all-reduce": 10 * 4 * 15 * 64 * 4
                               + 3 * 4 * 15 * 4 + 4}


def test_placement_notes_name_the_recurrent_splits():
    from repro_torch.launch.dryrun import placement_notes

    rg = placement_notes(get_config("recurrentgemma-2b"), 16)
    split, whole = rg["placement_model_axis"].split("; ")
    assert "RG-LRU by width (2560, 160 a rank)" in split
    assert "RG-LRU" not in whole and "attention" in whole
    assert "RG-LRU channels" in rg["placement_cache"]
    rwkv = placement_notes(get_config("rwkv6-1.6b"), 16)
    split, whole = rwkv["placement_model_axis"].split("; ")
    assert "RWKV-6 by heads (32 heads, 2 a rank)" in split
    assert "448 a rank" in split and "RWKV-6" not in whole
    assert "RWKV-6 heads" in rwkv["placement_cache"]
    split, whole = placement_notes(get_config("rwkv6-1.6b"),
                                   3)["placement_model_axis"].split("; ")
    assert "RWKV-6" in whole and "RWKV-6" not in split
    _, whole = placement_notes(get_config("recurrentgemma-2b"),
                               3)["placement_model_axis"].split("; ")
    assert "RG-LRU (width 2560)" in whole
