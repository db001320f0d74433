"""The port stands alone: no module under ``src/repro_torch`` imports
``jax`` or the reference package ``repro`` (checked on the import
statements, with ``ast``), and its entry points insist on CUDA unless the
caller asks for the CPU."""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.torch_port

PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_imports_neither_jax_nor_reference():
    sources = sorted(PORT.rglob("*.py"))
    assert len(sources) > 20
    # the walk reaches every module, the elasticity, Dirichlet and sharded
    # ones too
    names = {str(p.relative_to(PORT)) for p in sources}
    assert {"feti/dirichlet.py", "fem/assembly.py",
            "configs/feti_elasticity_2d.py", "configs/feti_elasticity_3d.py",
            "configs/feti_heat_3d.py", "feti/sharded.py",
            "launch/mesh.py", "models/attention.py", "models/transformer.py",
            "launch/serve.py", "launch/train.py", "train/optimizer.py",
            "train/train_step.py", "data/synthetic.py", "data/tokens.py",
            "distributed/checkpoint.py", "distributed/compression.py",
            "distributed/elastic.py", "distributed/sharding.py",
            "distributed/actsharding.py", "launch/shapes.py",
            "launch/dryrun.py", "launch/report.py", "launch/finalize.py",
            "testing.py"} <= names
    bad = [f"{p.relative_to(PORT)}:{line} imports {root}"
           for p in sources for root, line in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, bad
    # the kernels are real sources, shipped beside the package
    assert sorted(p.name for p in (PORT / "kernels" / "csrc").glob("*.cu*")) == [
        "dmma_f64.cuh", "stepped_syrk.cu", "stepped_syrk.cuh",
        "stepped_trsm.cu", "stepped_trsm.cuh", "stepped_trsm_cluster.cuh",
        "stepped_trsm_syrk.cu", "tf32x3_f32.cuh"]


def test_entry_points_require_cuda_unless_cpu(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.fem import decompose_problem
    from repro_torch.feti import FetiConfig, FetiSolver, preprocess_cluster
    from repro_torch.launch import serve, solve_feti, train
    from repro_torch.models import LanguageModel, init_cache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fc = get_smoke_config("feti-heat-2d")
    prob = decompose_problem("heat", fc.dim, fc.sub_grid, fc.elems_per_sub)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preprocess_cluster(prob)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FetiSolver(prob).solve()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve_feti.main(["--smoke"])
    # the LM serving path (A18a): the model, its caches and the launcher
    lm = get_smoke_config("granite-3-8b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LanguageModel(lm)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(lm, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke"])
    # the LM training launcher (A18c)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "granite-3-8b", "--smoke", "--steps", "1"])
    assert LanguageModel(lm, device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    assert FetiSolver(prob, FetiConfig(device="cpu")).solve().converged


@pytest.mark.parametrize("kwargs,item", [
    (dict(schur="auto"), "resolves during preprocessing"),
])
def test_unported_options_name_their_roadmap_item(kwargs, item):
    """An option that raised until its slice was ported now builds: the
    autotuner's ``schur="auto"`` (A14) is a config whose Schur config
    resolves only during preprocessing, and ``resolved_schur()`` raises
    for it as the reference's does."""
    from repro_torch.feti import FetiConfig

    cfg = FetiConfig(**kwargs)
    assert cfg.auto and cfg.measure == "auto" and cfg.plan_cache
    with pytest.raises(ValueError, match=item):
        cfg.resolved_schur()


def test_unported_paths_name_their_roadmap_item():
    from repro_torch.core import SchurAssemblyConfig
    from repro_torch.fem import decompose_problem
    from repro_torch.feti import FetiSolver

    from repro_torch.feti import FetiConfig

    # packed storage (A9), the fused kernels (B4, B5), elasticity (A10),
    # the Dirichlet preconditioner (A11), multi-RHS solves (A12), the
    # autotuner with the stage graph (A14) and the solver's telemetry (A15)
    # are ported: no module of the port raises NotImplementedError any more
    assert SchurAssemblyConfig(storage="packed", use_kernels=True,
                               fused=True).fused
    assert decompose_problem("elasticity", 2, (2, 2), (2, 2)).kernel_dim == 3
    assert FetiConfig(preconditioner="dirichlet").dirichlet
    prob = decompose_problem("heat", 2, (2, 2), (2, 2))
    rep = FetiSolver(prob, FetiConfig(device="cpu")).report()
    assert rep["schema_version"] == 1 and rep["spans"] == []
    assert "device_bytes" not in rep  # nothing preprocessed yet
    assert not [p for p in PORT.rglob("*.py")
                if "NotImplementedError" in p.read_text()]


@pytest.mark.parametrize("changes", [
    dict(attn_kind="mla", q_lora_rank=16, kv_lora_rank=16,
         qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8),
    dict(num_experts=4, top_k=2, moe_d_ff=32),
])
def test_moe_and_mla_configs_build(changes):
    """MLA attention and MoE layers (ported in A18b) build: the model and
    ``init_cache``, whose layers have the reference's cache entries and
    shapes (MLA: the compressed ``ckv`` and ``krope``), and a cached
    forward runs."""
    import dataclasses

    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import init_cache as ref_init_cache
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import lm_layers_from_reference
    from repro_torch.models import LanguageModel, forward, init_cache

    cfg = dataclasses.replace(get_smoke_config("granite-3-8b"), **changes)
    rcfg = dataclasses.replace(ref_smoke("granite-3-8b"), **changes)
    model = LanguageModel(cfg, device="cpu")
    cache = init_cache(cfg, 1, 4, device="cpu")
    want = lm_layers_from_reference(cfg, ref_init_cache(rcfg, 1, 4))
    assert [{k: tuple(v.shape) for k, v in layer.items()} for layer in cache
            ] == [{k: v.shape for k, v in layer.items()} for layer in want]
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    logits, _ = forward(model, {"tokens": tokens}, cache)
    assert torch.isfinite(logits).all()
    assert (cache[0]["pos"] == torch.arange(4)).all()


def test_training_surface_is_the_reference_s():
    """The training path (A18c) and the LM meshes (A18d) export the
    reference's names: ``train`` its optimizer and step beside the serve
    steps, ``data``, and ``distributed`` with the sharding rules."""
    import repro.data
    import repro.distributed
    import repro.train
    import repro_torch.data
    import repro_torch.distributed
    import repro_torch.train

    assert set(repro.train.__all__) <= set(repro_torch.train.__all__)
    assert set(repro_torch.data.__all__) == set(repro.data.__all__)
    assert repro_torch.distributed.__all__ == repro.distributed.__all__
    for mod in (repro_torch.train, repro_torch.data,
                repro_torch.distributed):
        assert all(hasattr(mod, n) for n in mod.__all__)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduced_fused_and_multi_rhs_run(dtype):
    """f32 and bf16 storage with the fused kernels (A13b) and a multi-RHS
    batch (A12) run where they raised before."""
    from repro_torch.core import SchurAssemblyConfig
    from repro_torch.fem import decompose_problem
    from repro_torch.feti import FetiConfig, FetiSolver

    cfg = FetiConfig(schur=SchurAssemblyConfig(
        block_size=8, rhs_block_size=8, use_kernels=True, fused=True),
        dtype=dtype, device="cpu")
    assert cfg.reduced and cfg.resolved_schur().fused
    prob = decompose_problem("heat", 2, (2, 2), (2, 2))
    sol = FetiSolver(prob, cfg).solve_many(prob.load_cases(2), tol=1e-6)
    assert sol.n_rhs == 2 and np.all(np.isfinite(sol.u_global))
