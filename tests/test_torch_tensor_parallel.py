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
    assert plan.mode("blocks.0.inner.w_in.w") == "whole"  # RG-LRU
    assert split_plan(rg, 4).attention == ()  # 10 heads do not divide 4

    qwen = get_config("qwen1.5-32b")  # 40 heads
    plan = split_plan(qwen, 16)
    assert plan.attention == () and plan.mlp == tuple(range(qwen.num_layers))
    assert split_plan(qwen, 8).attention == tuple(range(qwen.num_layers))

    ds = get_config("deepseek-v2-236b")  # MLA, MoE past layer 0
    plan = split_plan(ds, 16)
    assert plan.attention == () and plan.mlp == (0,)
    assert plan.mode("blocks.1.mlp.wi") == "whole"
    assert split_plan(get_config("rwkv6-1.6b"), 16).mlp == ()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_split_parts_are_sharded_on_model(arch):
    """On both production meshes every part that splits has its weights
    cut along 'model' where its rank's slice lies: column-parallel on the
    output, row-parallel and the embedding on the input rows."""
    cfg = get_config(arch)
    meta = dict(LanguageModel(cfg, device="meta").named_parameters())
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        specs = sharding.param_shardings(mesh, meta)
        plan = split_plan(cfg, mesh.shape["model"])
        for name, p in meta.items():
            if plan.mode(name) != "shard" or p.dim() < 2:
                continue
            row = name == "embed" or name.endswith(".wo.w")
            assert specs[name][0 if row else -1] == "model", name
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
    """``init_cache(tp=)``: a split attention's KV heads a rank, the rest
    as at ``tp`` 1."""
    cfg = get_smoke_config("granite-3-8b")  # 2 KV heads
    one, two = (init_cache(cfg, 2, 8, "cpu", tp=t) for t in (1, 2))
    for a, b in zip(one, two):
        assert a["k"].shape[2] == 2 and b["k"].shape[2] == 1
        assert a["pos"].shape == b["pos"].shape
    rg = get_smoke_config("recurrentgemma-2b")  # 1 KV head: replicated
    for a, b in zip(init_cache(rg, 2, 8, "cpu"),
                    init_cache(rg, 2, 8, "cpu", tp=2)):
        assert {k: v.shape for k, v in a.items()} == {
            k: v.shape for k, v in b.items()}
    ds = get_smoke_config("deepseek-v2-236b")  # MLA: whole
    assert [{k: v.shape for k, v in a.items()}
            for a in init_cache(ds, 2, 8, "cpu", tp=2)] == [
        {k: v.shape for k, v in a.items()}
        for a in init_cache(ds, 2, 8, "cpu")]


def test_schedule_on_model_ranks():
    """granite-3-8b at full width, 2 layers, f32, remat, (data=1,
    model=2), global batch 4 x 512: no weight is gathered (the vocab of
    49,155 stays whole, and nothing is cut along 'data'); each layer
    all-reduces (4, 512, 4096) f32 twice forward, twice again in the
    recomputation and twice in backward; the norm adds its 4 B."""
    from repro_torch.launch.analytic import lm_collectives
    from repro_torch.launch.shapes import ShapeCase
    from repro_torch.train import TrainConfig

    cfg = dataclasses.replace(get_config("granite-3-8b"), num_layers=2,
                              dtype="float32", param_dtype="float32")
    mesh = MeshShape({"data": 1, "model": 2})
    got = lm_collectives(cfg, ShapeCase("placed", 512, 4, "train"), mesh,
                         TrainConfig(remat=True))
    act = 4 * 512 * 4096 * 4
    assert act == 33_554_432
    assert got.count_by_op == {"all-reduce": 13}
    assert got.bytes_by_op == {"all-reduce": 12 * act + 4}
    # without remat the recomputation's four go; serving: one forward
    got = lm_collectives(cfg, ShapeCase("placed", 512, 4, "train"), mesh,
                         TrainConfig(remat=False))
    assert got.bytes_by_op == {"all-reduce": 8 * act + 4}
    got = lm_collectives(cfg, ShapeCase("decode", 512, 4, "decode"), mesh)
    assert got.bytes_by_op == {"all-reduce": 4 * 4 * 4096 * 4}


def test_placement_notes_name_what_stays_whole():
    from repro_torch.launch.dryrun import placement_notes

    granite = placement_notes(get_config("granite-3-8b"), 16)
    split, whole = granite["placement_model_axis"].split("; ")
    assert "attention" in split and "MLP" in split
    assert "vocab 49155" in whole
    ds = placement_notes(get_config("deepseek-v2-236b"), 16)
    _, whole = ds["placement_model_axis"].split("; ")
    assert "MLA attention" in whole and "MoE" in whole
    assert "KV heads" not in ds["placement_cache"]
    assert "KV heads" in granite["placement_cache"]
