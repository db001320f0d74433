"""The LM sharding rules and activation constraints against the
reference's, and a forward with placed parameters over gloo ranks.

Held exactly: ``_spec_for_param`` of every parameter of every full-size
LM config (the port's model on the ``meta`` device; the reference's
abstract params, each ``body`` leaf unstacked: its stacked axis stripped
from the shape it is judged on, then checked for every layer it stands
for) on the reference tests' shape-only meshes 16x16 and 2x16x16, with
and without FSDP; ``batch_spec``; ``batch_shardings`` of every applicable
shape's inputs; ``cache_shardings`` of every serving shape's cache, with
``min_seq_to_shard`` 0 and 4096 (the reference's ``NamedSharding``
replaced by its spec, so its rules run on a mesh of shapes alone).
``shard_act`` returns its argument itself without a mesh. Gloo ranks on
the CPU place granite-3-8b's smoke model on a (data=1, model=2) and a
(data=2, model=2) ``DeviceMesh``: each rank's logits within 1e-6 of the
single-process forward, every local shard's shape the spec's arithmetic.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.distributed.sharding as ref_sharding  # noqa: E402
import repro.launch.shapes as ref_shapes  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import init_model as ref_init_model  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed import actsharding, sharding  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import shapes  # noqa: E402
from repro_torch.models import LanguageModel, forward  # noqa: E402
from repro_torch.models.transformer import StackLayout  # noqa: E402

pytestmark = pytest.mark.torch_port

LM_ARCHS = ("deepseek-v2-236b", "granite-3-8b", "grok-1-314b",
            "hubert-xlarge", "mistral-large-123b", "nemotron-4-340b",
            "qwen1.5-32b", "qwen2-vl-2b", "recurrentgemma-2b", "rwkv6-1.6b")
MESHES = {"16x16": meshlib.make_production_mesh(),
          "2x16x16": meshlib.make_production_mesh(multi_pod=True)}
PLACED_TOL = 1e-6


@pytest.fixture
def spec_only(monkeypatch):
    """The reference's rules with ``NamedSharding(mesh, spec)`` -> spec."""
    monkeypatch.setattr(ref_sharding, "NamedSharding",
                        lambda mesh, spec: tuple(spec))


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}/")
        else:
            yield prefix + key, val


def _reference_layers(cfg, stack):
    """{port name: (reference path, shape the reference judges)} of every
    layer parameter: prologue / epilogue leaves as they are, ``body[j]``'s
    unstacked for each cycle's layer."""
    lay = StackLayout.build(cfg)
    out = {}
    for part, layers in (("prologue", lay.prologue),
                         ("epilogue", lay.epilogue)):
        for i, li in enumerate(layers):
            for path, leaf in _leaves(stack[part][i]):
                out[f"blocks.{li}.{path.replace('/', '.')}"] = (
                    f"stack/{part}/{i}/{path}", tuple(leaf.shape))
    for j, body in enumerate(stack["body"]):
        for path, leaf in _leaves(body):
            assert leaf.shape[0] == lay.cycles
            for c in range(lay.cycles):
                out[f"blocks.{lay.layer(j, c)}.{path.replace('/', '.')}"] = (
                    f"stack/body/{j}/{path}", tuple(leaf.shape[1:]))
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_match_reference(arch, spec_only):
    cfg, rcfg = get_config(arch), ref_config(arch)
    params = jax.eval_shape(lambda: ref_init_model(jax.random.PRNGKey(0),
                                                   rcfg))
    ref = _reference_layers(cfg, params["stack"])
    for key in ("embed", "lm_head"):
        if key in params:
            ref[key] = (key, tuple(params[key].shape))
    for path, leaf in _leaves(params["final_norm"]):
        ref[f"final_norm.{path}"] = (f"final_norm/{path}", tuple(leaf.shape))
    model = LanguageModel(cfg, device="meta")
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    for label, mesh in MESHES.items():
        for fsdp in (True, False):
            got = sharding.param_shardings(mesh, model, fsdp=fsdp)
            abstract = {path: jax.ShapeDtypeStruct(shape, np.float32)
                        for path, shape in ref.values()}
            want = ref_sharding.param_shardings(mesh, abstract, fsdp=fsdp)
            for name, (path, shape) in ref.items():
                assert tuple(named[name].shape) == shape, name
                assert got[name] == want[path], (label, fsdp, name)
                if fsdp:
                    assert got[name] == tuple(ref_sharding._spec_for_param(
                        mesh, path, abstract[path]))
    # the rule the reference states for a stacked leaf, on the same leaf
    mesh = MESHES["16x16"]
    assert sharding._spec_for_param(mesh, "blocks.3.inner.wq.w",
                                    torch.empty((4096, 4096),
                                                device="meta")) == (
        "data", "model")


def test_batch_spec_matches_reference():
    for mesh in MESHES.values():
        assert sharding.batch_spec(mesh) == tuple(
            ref_sharding.batch_spec(mesh))
    assert sharding.batch_spec(MESHES["2x16x16"]) == (("pod", "data"),)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_batch_and_cache_shardings_match_reference(arch, spec_only):
    cfg, rcfg = get_config(arch), ref_config(arch)
    lay = StackLayout.build(cfg)
    for name in shapes.applicable_shapes(cfg):
        shape, rshape = shapes.SHAPES[name], ref_shapes.SHAPES[name]
        for mesh in MESHES.values():
            assert sharding.batch_shardings(
                mesh, shapes.input_specs(cfg, shape)) == \
                ref_sharding.batch_shardings(
                    mesh, ref_shapes.input_specs(rcfg, rshape))
        if shape.kind == "train":
            continue
        cache = shapes.cache_specs(cfg, shape)
        ref_cache = ref_shapes.cache_specs(rcfg, rshape)
        for mesh in MESHES.values():
            for min_seq in (0, 4096):
                got = sharding.cache_shardings(mesh, cache,
                                               min_seq_to_shard=min_seq)
                want = ref_sharding.cache_shardings(
                    mesh, ref_cache, min_seq_to_shard=min_seq)
                layers = [None] * cfg.num_layers
                for part, idx in (("prologue", lay.prologue),
                                  ("epilogue", lay.epilogue)):
                    for i, li in enumerate(idx):
                        layers[li] = want[part][i]
                for j, body in enumerate(want["body"]):
                    for c in range(lay.cycles):
                        # the stacked cycle axis leads and stays unsharded
                        assert all(s[0] is None for s in body.values())
                        layers[lay.layer(j, c)] = {
                            k: s[1:] for k, s in body.items()}
                assert got == layers, (name, min_seq)


def test_shard_act_is_a_no_op_without_a_mesh():
    x = torch.randn(2, 8, 4, 16)
    assert actsharding.current_mesh() is None
    assert actsharding.shard_act(x, "dp", None, "model", None) is x
    mesh = MESHES["2x16x16"]
    with actsharding.activation_sharding(mesh):
        assert actsharding.current_mesh() is mesh
        # a plain tensor (the placed models compute on gathered weights)
        assert actsharding.shard_act(x, "dp", None, "model", None) is x
        assert actsharding._resolve(mesh, True, (32, 64, 16),
                                    ("dp", "sp", "model")) == (
            ("pod", "data"), "model", "model")
        # indivisible axes degrade to replication
        assert actsharding._resolve(mesh, True, (3, 8, 5),
                                    ("dp", "sp", "model")) == (
            None, None, None)
        with actsharding.activation_sharding(mesh, sp=False):
            assert actsharding._resolve(mesh, False, (32, 64), ("dp", "sp")
                                        ) == (("pod", "data"), None)
        with actsharding.activation_sharding(None):
            assert actsharding.current_mesh() is None
    assert actsharding.current_mesh() is None


def test_models_unchanged_under_activation_sharding():
    """The shard_act points in attention, MoE and RWKV-6 leave plain
    tensors bit for bit as they are, with or without a mesh."""
    tokens = torch.as_tensor(
        np.random.default_rng(3).integers(0, 100, (2, 8)), dtype=torch.int32)
    for arch in ("deepseek-v2-236b", "rwkv6-1.6b", "granite-3-8b"):
        cfg = get_smoke_config(arch)
        model = LanguageModel(cfg, device="cpu")
        with torch.inference_mode():
            plain = forward(model, {"tokens": tokens})[0]
            with actsharding.activation_sharding(MESHES["16x16"]):
                placed = forward(model, {"tokens": tokens})[0]
        assert torch.equal(plain, placed)
    sort = dataclasses.replace(get_smoke_config("deepseek-v2-236b"),
                               moe_impl="sort")
    model = LanguageModel(sort, device="cpu")
    with torch.inference_mode():
        assert torch.isfinite(forward(model, {"tokens": tokens})[0]).all()


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_placed_forward_over_gloo_ranks(mesh_shape):
    """(1, 2): tensor parallelism alone; (2, 2): FSDP over 'data' too."""
    cfg = get_smoke_config("granite-3-8b")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    ranks = meshlib.spawn_ranks(sharding.placed_forward,
                                mesh_shape[0] * mesh_shape[1],
                                backend="gloo", device="cpu",
                                args=(cfg, mesh_shape, tokens))
    model = LanguageModel(cfg, device="cpu")
    with torch.inference_mode():
        want = forward(model, {"tokens": torch.as_tensor(tokens)})[0].numpy()
    shape = meshlib.MeshShape(dict(zip(("data", "model"), mesh_shape)))
    specs = sharding.param_shardings(shape, model)
    assert any("model" in s for s in specs.values())
    for r in ranks:
        err = np.abs(r["logits"] - want).max() / np.abs(want).max()
        assert err <= PLACED_TOL
        assert r["specs"] == specs
        for name, p in model.named_parameters():
            assert r["local_shapes"][name] == sharding.local_shape(
                shape, specs[name], tuple(p.shape)), name
    assert ranks[0]["local_shapes"]["blocks.0.inner.wq.w"] == (
        64 // mesh_shape[0], 32)
