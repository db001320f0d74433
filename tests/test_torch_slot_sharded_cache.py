"""The serving cache sharded along its slots over 'model', with no process
group: the slot groups (``tensor_parallel.slot_group_size``,
``split_plan``'s ``slots``), the blocks a rank holds (``slot_block``,
``init_cache(tp=, rank=)``), the writes into them, the flash-decoding
merge of the blocks' partial softmaxes, and the dry-run's residency
against the placed program's cache.

The merge: a smoke cache filled by one process's prefill (granite-3-8b's
GQA, deepseek-v2-236b's MLA in its absorbed form, recurrentgemma-2b's ring
of 16 slots past its wrap) at f32 and bf16, cut into g in {2, 4} blocks of
its slots; each block's ``flash_attention(partial=True)`` (KV chunks of 4,
so that a block runs several), then ``merge_slot_partials``, against
``flash_attention`` over the whole cache within 1e-6 relative (over the
largest; at bf16 before the final cast, and after it within one bf16
step). A prompt of 5 tokens leaves the last blocks with no valid slot:
their max stays at ``NEG_INF`` and they weigh nothing, with no NaN.

The placed runs themselves (gloo ranks, against one process and the
reference) are in ``tests/test_torch_placed_train.py``."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed.tensor_parallel import (  # noqa: E402
    merge_slot_partials, slot_block, slot_group_size, split_plan)
from repro_torch.models import LanguageModel, init_cache  # noqa: E402
from repro_torch.models.attention import (NEG_INF, CacheBlock,  # noqa: E402
                                          _cache_write, flash_attention)

pytestmark = pytest.mark.torch_port

TOL = 1e-6
BATCH = 2
# case -> (arch, config changes, prompt length, cache length)
FILLS = {"gqa": ("granite-3-8b", {}, 13, 16),
         "mla": ("deepseek-v2-236b", {}, 13, 16),
         "ring": ("recurrentgemma-2b", {}, 20, 24),  # 16 slots, wrapped
         "gqa empty": ("granite-3-8b", {}, 5, 16),
         "mla empty": ("deepseek-v2-236b", {}, 5, 16),
         "ring empty": ("recurrentgemma-2b", {}, 5, 24)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _filled(case, dtype):
    """The attention layer's cache of one process's prefill of ``case``'s
    prompt (seeded tokens) and the config."""
    from repro_torch.train import make_prefill_step

    arch, changes, prompt, cache_len = FILLS[case]
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                              param_dtype=dtype, **changes)
    model = LanguageModel(cfg, device="cpu")
    cache = init_cache(cfg, BATCH, cache_len, "cpu")
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (BATCH, prompt)).astype(np.int32)
    make_prefill_step(model)({"tokens": torch.as_tensor(tokens)}, cache)
    return cfg, cache[cfg.layer_kinds.index("attn")]


def _attention_inputs(cfg, layer, sq, dtype):
    """Queries of ``sq`` positions after the prompt (seeded), the cache's
    K and V as the attention reads them, and the keyword arguments."""
    rng = np.random.default_rng(7)
    pos = layer["pos"]
    first = int(pos.max()) + 1
    q_pos = torch.arange(first, first + sq, dtype=torch.int32)[None].expand(
        BATCH, sq)
    if cfg.attn_kind == "mla":
        width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        q = rng.standard_normal((BATCH, sq, cfg.num_heads, width))
        k = torch.cat([layer["ckv"], layer["krope"]], dim=-1)[:, :, None]
        v = layer["ckv"][:, :, None]
        kw = dict(scale=1.0 / math.sqrt(cfg.qk_nope_head_dim
                                        + cfg.qk_rope_head_dim))
    else:
        q = rng.standard_normal((BATCH, sq, cfg.num_heads, cfg.head_dim))
        k, v, kw = layer["k"], layer["v"], dict(window=cfg.local_window)
    q = torch.from_numpy(q).to(dtype)
    return q, k, v, q_pos, dict(causal=True, kv_chunk=4, **kw)


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("sq", [1, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(FILLS))
def test_merged_blocks_are_the_whole_cache(case, dtype, sq, g):
    """Each of g slot blocks attended alone, then merged: the attention
    over the whole cache."""
    cfg, layer = _filled(case, dtype)
    q, k, v, q_pos, kw = _attention_inputs(cfg, layer, sq, DTYPES[dtype])
    pos = layer["pos"]
    size = pos.shape[1]
    parts, empty = [], []
    for j in range(g):
        first, n = slot_block(size, g, j)
        assert n == size // g
        cut = slice(first, first + n)
        parts.append(flash_attention(
            q, k[:, cut], v[:, cut], q_pos, pos[:, cut],
            kv_valid=pos[:, cut] >= 0, partial=True, **kw))
        empty.append(not (pos[:, cut] >= 0).any())
        if empty[-1]:  # a block with no valid slot
            assert (parts[-1][1] == NEG_INF).all(), (case, j)
    assert any(empty) == ("empty" in case), case
    got = merge_slot_partials(parts)
    assert torch.isfinite(got).all()
    whole = flash_attention(q, k, v, q_pos, pos, kv_valid=pos >= 0, **kw)
    acc, m, l = flash_attention(q, k, v, q_pos, pos, kv_valid=pos >= 0,
                                partial=True, **kw)
    assert got.shape == whole.shape
    if dtype == "float32":
        assert _rel(got, whole) <= TOL, case
    else:  # before the cast to bf16, and after it within one bf16 step
        assert _rel(got, acc / l[..., None]) <= TOL, case
        assert _rel(got.to(whole.dtype), whole) <= 2.0 ** -8, case


def test_partial_state_is_the_attention_before_its_division():
    """``partial=True`` returns the f32 numerator, max and sum whose
    quotient, cast, is the plain call's output bit for bit."""
    cfg, layer = _filled("gqa", "float32")
    q, k, v, q_pos, kw = _attention_inputs(cfg, layer, 3, torch.float32)
    out = flash_attention(q, k, v, q_pos, layer["pos"],
                          kv_valid=layer["pos"] >= 0, **kw)
    acc, m, l = flash_attention(q, k, v, q_pos, layer["pos"],
                                kv_valid=layer["pos"] >= 0, partial=True,
                                **kw)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    assert acc.shape == out.shape and m.shape == l.shape == out.shape[:3]
    assert torch.equal(acc / torch.clamp_min(l, 1e-30)[..., None], out)


def test_slot_groups():
    """g = tp for MLA and for an attention that does not split, tp /
    num_kv_heads for replicated KV heads, 1 where each rank computes its
    own KV heads; consecutive ranks."""
    cases = {("deepseek-v2-236b", 16): 16,  # MLA
             ("qwen1.5-32b", 16): 16,  # 40 heads: whole at 16
             ("qwen1.5-32b", 8): 1,  # 40 KV heads, 5 a rank
             ("qwen2-vl-2b", 16): 16,  # 12 heads: whole
             ("recurrentgemma-2b", 16): 16,  # 10 heads: whole
             ("recurrentgemma-2b", 2): 2,  # its 1 KV head replicated
             ("granite-3-8b", 16): 2,  # 8 KV heads on 16 ranks
             ("granite-3-8b", 8): 1,
             ("grok-1-314b", 16): 2, ("mistral-large-123b", 16): 2,
             ("nemotron-4-340b", 16): 2,
             ("rwkv6-1.6b", 16): 1,  # no attention
             ("granite-3-8b", 1): 1}
    for (arch, tp), g in cases.items():
        cfg = get_config(arch)
        assert slot_group_size(cfg, tp) == g, (arch, tp)
        plan = split_plan(cfg, tp)
        assert plan.slot_group == g
        attn = tuple(i for i, k in enumerate(cfg.layer_kinds) if k == "attn")
        assert plan.slots == (attn if g > 1 else ()), (arch, tp)
        # consecutive ranks: rank r's index in its group is r % g
        assert [slot_block(16 * g, g, r)[0] for r in range(tp)] == [
            r % g * 16 for r in range(tp)]
    assert split_plan(get_config("granite-3-8b"), 16).kv_replicated


def test_blocks_of_the_slots():
    """A rank holds ``[j·size/g, (j+1)·size/g)``; a size that does not
    divide g stays whole on every rank of the group, as a plain cache."""
    assert [slot_block(16, 4, j) for j in range(4)] == [
        (0, 4), (4, 4), (8, 4), (12, 4)]
    assert all(slot_block(18, 4, j) == (0, 18) for j in range(4))
    assert slot_block(16, 1, 0) == (0, 16)
    ds = get_smoke_config("deepseek-v2-236b")  # MLA: g = tp
    for rank in range(4):
        layer = init_cache(ds, 2, 16, "cpu", tp=4, rank=rank)[0]
        assert isinstance(layer, CacheBlock)
        assert (layer.first, layer.size) == (4 * rank, 16)
        assert {k: tuple(v.shape) for k, v in layer.items()} == {
            "ckv": (2, 4, 16), "krope": (2, 4, 8), "pos": (2, 4)}
        whole = init_cache(ds, 2, 18, "cpu", tp=4, rank=rank)[0]
        assert not isinstance(whole, CacheBlock)
        assert whole["ckv"].shape == (2, 18, 16)
    # tp 1 and a group of one rank: the plain cache, bit for bit as before
    granite = get_smoke_config("granite-3-8b")
    for tp in (1, 2):
        layer = init_cache(granite, 2, 16, "cpu", tp=tp, rank=tp - 1)[0]
        assert type(layer) is dict and layer["k"].shape == (2, 16,
                                                             2 // tp, 16)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch,changes", [
    ("deepseek-v2-236b", {}),  # MLA
    ("recurrentgemma-2b", {}),  # a ring of 16 slots, one KV head
    ("granite-3-8b", {"num_heads": 3, "num_kv_heads": 1}),  # whole
])
def test_block_writes_are_the_whole_cache_blocks(arch, changes, tp):
    """A prefill's entries (a ring keeps its last 16), then decode steps
    that wrap the ring, written into each rank's block: its slots of the
    one-process cache, the positions exactly."""
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    assert slot_group_size(cfg, tp) == tp
    ring = cfg.local_window > 0
    L, S = 24, 20 if ring else 13
    rng = np.random.default_rng(11)
    names = ("ckv", "krope") if cfg.attn_kind == "mla" else ("k", "v")
    whole = init_cache(cfg, BATCH, L, "cpu")[cfg.layer_kinds.index("attn")]
    blocks = [init_cache(cfg, BATCH, L, "cpu", tp=tp, rank=r)[
        cfg.layer_kinds.index("attn")] for r in range(tp)]

    def write(n, index):
        vals = [torch.from_numpy(rng.standard_normal(
            (BATCH, n) + tuple(whole[k].shape[2:])).astype(np.float32))
            for k in names]
        pos = torch.arange(index, index + n, dtype=torch.int32)[None]
        pos = pos.expand(BATCH, n)
        if ring and n > 1:  # as the prefill keeps them
            wl = min(whole["pos"].shape[1], n)
            vals, pos, index = ([x[:, n - wl:] for x in vals],
                                pos[:, n - wl:], index + n - wl)
        for cache in [whole] + blocks:
            _cache_write(cache, names, vals, pos, index, ring)

    write(S, 0)
    for t in range(6 if ring else 3):
        write(1, S + t)
    n = whole["pos"].shape[1] // tp
    for r, block in enumerate(blocks):
        assert (block.first, block.size) == (r * n, whole["pos"].shape[1])
        for k in names + ("pos",):
            assert torch.equal(block[k], whole[k][:, r * n:(r + 1) * n]), (
                arch, r, k)
    if ring:  # every slot written, the last ones twice
        assert (whole["pos"] >= 0).all()


def _decode_rows():
    from repro_torch.configs.registry import list_archs
    from repro_torch.launch.dryrun import MESHES
    from repro_torch.launch.shapes import SHAPES, applicable_shapes
    from repro_torch.models.config import ModelConfig

    rows = []
    for arch in list_archs():
        cfg = get_config(arch)
        if not isinstance(cfg, ModelConfig):
            continue
        for name in applicable_shapes(cfg):
            if SHAPES[name].kind == "decode":
                rows += [(arch, name, mesh) for mesh in MESHES]
    return rows


def test_dry_run_residency_is_the_placed_cache():
    """Every decode row of the 16x16 and 2x16x16 meshes: the attention
    cache one rank of the placed program holds (``init_cache`` on the meta
    device for the rank's batch rows, ``tp`` 16, rank 0) holds, leaf by
    leaf (``k``, ``v``, ``ckv``, ``krope``), exactly the bytes of
    ``local_shape`` under the reference's ``cache_shardings``, which the
    dry-run's residency prices. ``pos`` is held for the group's ``size /
    g`` slots, where the reference cuts it to ``size / 16``: the two
    differ where g < 16 (a KV head replicated on g ranks). qwen1.5-32b's
    decode_32k on 16x16 holds 10,741,612,544 B of attention cache a rank
    (``pos`` included), where the rank held every slot of every head
    (171,865,800,704 B) before."""
    from repro_torch.distributed.sharding import (_dp_axes, axis_size,
                                                  cache_shardings,
                                                  local_shape)
    from repro_torch.launch.dryrun import MESHES
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import SHAPES, cache_specs

    rows = _decode_rows()
    assert len(rows) == 22
    held = {}
    for arch, name, mesh_name in rows:
        cfg, shape = get_config(arch), SHAPES[name]
        mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
        tp, dp = axis_size(mesh, "model"), axis_size(mesh, _dp_axes(mesh))
        B = shape.global_batch
        rows_a_rank = B // dp if B % dp == 0 else B
        whole = cache_specs(cfg, shape)
        specs = cache_shardings(mesh, whole)
        mine = init_cache(cfg, rows_a_rank, shape.seq_len, "meta", tp=tp)
        g = slot_group_size(cfg, tp)
        total = 0
        for kind, lw, spec, lm in zip(cfg.layer_kinds, whole, specs, mine):
            if kind != "attn":
                continue
            for leaf, x in lw.items():
                local = local_shape(mesh, spec[leaf], tuple(x.shape))
                want = math.prod(local) * x.element_size()
                got = lm[leaf].numel() * lm[leaf].element_size()
                total += got
                if leaf == "pos":
                    assert tuple(lm[leaf].shape) == (
                        rows_a_rank, x.shape[1] // g), (arch, name, mesh_name)
                else:
                    assert got == want, (arch, name, mesh_name, leaf)
        held[(arch, name, mesh_name)] = total
    print(f"qwen1.5-32b decode_32k 16x16: "
          f"{held[('qwen1.5-32b', 'decode_32k', '16x16')]:,} B of attention "
          f"cache a rank")
    assert held[("qwen1.5-32b", "decode_32k", "16x16")] == 10_741_612_544
    assert held[("deepseek-v2-236b", "decode_32k", "16x16")] == 1_136_394_240
    assert held[("rwkv6-1.6b", "decode_32k", "16x16")] == 0


def test_placement_notes_name_the_slot_groups():
    """Each row's note names its slot groups; no note says the cache is
    not sharded along its slots."""
    from repro_torch.configs.registry import list_archs
    from repro_torch.launch.dryrun import placement_notes
    from repro_torch.models.config import ModelConfig

    notes = {a: placement_notes(get_config(a), 16)["placement_cache"]
             for a in ("deepseek-v2-236b", "qwen1.5-32b", "granite-3-8b",
                       "recurrentgemma-2b", "rwkv6-1.6b")}
    assert "slot group of 16 ranks (every head's compressed MLA entries" \
        in notes["deepseek-v2-236b"]
    assert "slot group of 16 ranks (the whole attention's KV heads" in \
        notes["qwen1.5-32b"]
    assert "slot group of 2 ranks (a KV head replicated on 2 ranks)" in \
        notes["granite-3-8b"]
    assert "1/16 of the slots a rank" in notes["recurrentgemma-2b"]
    assert "flash-decoding" in notes["granite-3-8b"]
    assert "slot" not in notes["rwkv6-1.6b"]
    one = placement_notes(get_config("granite-3-8b"), 8)["placement_cache"]
    assert "slot groups of one rank" in one
    for arch in list_archs():
        cfg = get_config(arch)
        if isinstance(cfg, ModelConfig):
            for tp in (1, 2, 16):
                assert "not sharded along seq" not in placement_notes(
                    cfg, tp)["placement_cache"]
