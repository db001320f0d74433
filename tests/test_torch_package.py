"""The port stands alone: no module under ``src/repro_torch`` imports
``jax`` or the reference package ``repro`` (checked on the import
statements, with ``ast``), and its entry points insist on CUDA unless the
caller asks for the CPU."""
import ast
import pathlib

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
    bad = [f"{p.relative_to(PORT)}:{line} imports {root}"
           for p in sources for root, line in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, bad
    # the kernels are real sources, shipped beside the package
    assert sorted(p.name for p in (PORT / "kernels" / "csrc").glob("*.cu")) == [
        "stepped_syrk.cu", "stepped_trsm.cu"]


def test_entry_points_require_cuda_unless_cpu(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.fem import decompose_problem
    from repro_torch.feti import FetiConfig, FetiSolver, preprocess_cluster
    from repro_torch.launch import solve_feti

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
    assert resolve_device("cpu") == torch.device("cpu")
    assert FetiSolver(prob, FetiConfig(device="cpu")).solve().converged


@pytest.mark.parametrize("kwargs,item", [
    (dict(preconditioner="dirichlet"), "A11"),
    (dict(dtype=torch.float32), "A13"),
    (dict(schur="auto"), "A14"),
])
def test_unported_options_name_their_roadmap_item(kwargs, item):
    from repro_torch.feti import FetiConfig

    with pytest.raises(NotImplementedError, match=item):
        FetiConfig(**kwargs)


def test_unported_paths_name_their_roadmap_item():
    from repro_torch.core import SchurAssemblyConfig
    from repro_torch.fem import decompose_problem
    from repro_torch.feti import FetiSolver

    with pytest.raises(NotImplementedError, match="B4"):
        SchurAssemblyConfig(fused=True)
    with pytest.raises(NotImplementedError, match="A9"):
        SchurAssemblyConfig(storage="packed")
    with pytest.raises(NotImplementedError, match="A10"):
        decompose_problem("elasticity", 2, (2, 2), (2, 2))
    prob = decompose_problem("heat", 2, (2, 2), (2, 2))
    with pytest.raises(NotImplementedError, match="A12"):
        FetiSolver(prob).solve_many(None)
