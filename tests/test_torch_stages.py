"""The port's stage graph (``repro_torch.core.stages``) and its wiring into
preprocessing, against the reference's ``repro.core.stages``.

Both packages build the graph of the same decomposition (the reference's
host arrays carried over with ``repro_torch.interop``): the Dirichlet
fingerprint and the joint key must be the reference's digests, and the
plan-cache counters must follow the same sequence. A pinned graph plan
whose stages differ in block size and storage (written into each
package's cache under the shared key) must give F̃ and S_b within 1e-12
of the reference's under the same two configs, through a shared interior
factor (elasticity) and an unshared one (heat).
"""
import dataclasses
import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    GraphPlan,
    Plan,
    SchurAssemblyConfig,
    StageGraph,
    StageSpec,
)
from repro_torch.feti import FetiConfig, preprocess_cluster  # noqa: E402
from repro_torch.feti import dirichlet as dirlib  # noqa: E402
from repro_torch.feti.assembly import make_cluster_preprocessor  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    SUBDOMAIN_KEYS,
    from_reference_problem,
    plan_from_reference,
)
from repro_torch.launch.roofline import DEVICE_MODELS  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

pytestmark = pytest.mark.torch_port

TOL = 1e-12
# (decomposition, preconditioner): the Dirichlet stage shared (elasticity:
# the fixing DOFs lie on the boundary) and unshared (heat: the centre node)
PROBLEMS = {
    "ela2d": (("elasticity", 2, (2, 2), (4, 4)), "dirichlet"),
    "heat2d": (("heat", 2, (2, 2), (4, 4)), "dirichlet"),
    "heat2d-lumped": (("heat", 2, (2, 2), (4, 4)), "lumped"),
}
# pinned (dual, dirichlet) configs whose block sizes and storage differ
PINS = {
    "dual-dense8-dir-packed16": (dict(block_size=8, storage="dense"),
                                 dict(block_size=16, storage="packed")),
    "dual-packed16-dir-dense8": (dict(block_size=16, storage="packed"),
                                 dict(block_size=8, storage="dense")),
}


def _reference():
    """The reference modules, imported only here (the card's machine has
    no JAX)."""
    pytest.importorskip("jax")
    from repro.core import SchurAssemblyConfig as RefSchur
    from repro.core.autotune import Plan as RefPlan
    from repro.fem import decompose_problem
    from repro.feti import FetiConfig as RefConfig
    from repro.feti import dirichlet as ref_dirlib
    from repro.feti import preprocess_cluster as ref_preprocess
    from repro.feti.assembly import make_cluster_preprocessor as ref_mcp
    from repro.launch.roofline import DEVICE_MODELS as ref_models
    from repro.obs import metrics as ref_metrics

    return types.SimpleNamespace(
        Schur=RefSchur, Plan=RefPlan, decompose=decompose_problem,
        FetiConfig=RefConfig, dirlib=ref_dirlib, preprocess=ref_preprocess,
        mcp=ref_mcp, models=ref_models, metrics=ref_metrics)


def _carry(ref_prob):
    return from_reference_problem(dict(
        subdomains=[{k: getattr(sd, k)
                     for k in SUBDOMAIN_KEYS + ("node_gids", "fixing_node")}
                    for sd in ref_prob.subdomains],
        c=ref_prob.c, n_lambda=ref_prob.n_lambda,
        dirichlet_gids=ref_prob.dirichlet_gids,
        coords=ref_prob.global_mesh.coords, elems=ref_prob.global_mesh.elems,
        dim=ref_prob.dim, sub_grid=ref_prob.sub_grid,
        elems_per_sub=ref_prob.elems_per_sub, params=ref_prob.params,
        problem=ref_prob.problem, ndof_per_node=ref_prob.ndof_per_node))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.fixture()
def caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_PLAN_CACHE_DIR", str(tmp_path / "ref"))
    monkeypatch.delenv("REPRO_PLAN_CACHE", raising=False)
    return tmp_path


def _pair(name):
    args, precond = PROBLEMS[name]
    ref_prob = _reference().decompose(*args)
    return types.SimpleNamespace(name=name, prob=_carry(ref_prob),
                                 ref_prob=ref_prob, precond=precond)


@pytest.fixture(scope="module", params=list(PROBLEMS))
def pair(request):
    return _pair(request.param)


def test_fingerprints_and_joint_keys_match_reference(pair):
    ref = _reference()
    fc = FetiConfig(preconditioner=pair.precond, device="cpu")
    static, _ = make_cluster_preprocessor(pair.prob, fc)
    ref_static, _ = ref.mcp(pair.ref_prob,
                            ref.FetiConfig(preconditioner=pair.precond))
    graph, ref_graph = static["graph"], ref_static["graph"]
    assert [s.name for s in graph] == [s.name for s in ref_graph]
    for s in graph:
        r = ref_graph[s.name]
        assert (s.fingerprint, s.n, s.storage, s.dtype, s.share_factor_of,
                s.measure, s.candidate_block_sizes()) == (
            r.fingerprint, r.n, r.storage, r.dtype, r.share_factor_of,
            r.measure, r.candidate_block_sizes())
        assert s.batch == pair.prob.n_subdomains
    for kind in ("cpu", "gpu", "tpu"):
        for measured in (False, True):
            assert graph.joint_key(DEVICE_MODELS[kind], measured) == \
                ref_graph.joint_key(ref.models[kind], measured)
    if pair.precond == "dirichlet":
        split = dirlib.boundary_interior_split(pair.prob)
        assert dirlib.dirichlet_fingerprint(pair.prob, split) == \
            ref.dirlib.dirichlet_fingerprint(
                pair.ref_prob, ref.dirlib.boundary_interior_split(
                    pair.ref_prob))
        assert static["share"] == (pair.name == "ela2d")


def test_cache_counters_follow_the_reference(pair, caches):
    """Two model-only plannings of one decomposition: a joint miss then a
    hit, with the per-stage searches counted alike in both packages."""
    ref = _reference()
    fc = FetiConfig(schur="auto", measure="never",
                    preconditioner=pair.precond, device="cpu")
    ref_fc = ref.FetiConfig(schur="auto", measure="never",
                            preconditioner=pair.precond)
    metrics.reset()
    ref.metrics.reset()
    plans = []
    for _ in range(2):
        plans.append(make_cluster_preprocessor(pair.prob, fc)[0]
                     ["graph_plan"])
        ref.mcp(pair.ref_prob, ref_fc)
    got = metrics.get_matching("plan_cache")
    assert got == ref.metrics.get_matching("plan_cache")
    key = plans[0].key[:12]
    assert metrics.get("plan_cache.graph.miss", key=key) == 1
    assert metrics.get("plan_cache.graph.hit", key=key) == 1
    assert not plans[0].from_cache and plans[1].from_cache
    # the cached graph plan is the planned one, stage for stage
    for name, p in plans[0].plans.items():
        q = plans[1][name]
        assert q.from_cache and dataclasses.replace(q, from_cache=False) == p
    path = os.path.join(caches / "port", f"graph-{plans[0].key}.json")
    with open(path) as f:
        d = json.load(f)
    assert {n: Plan.from_json(p) for n, p in d["stages"].items()} == \
        plans[1].plans


def _pin(root, key, cfgs, plan_type, to_cfg):
    """Write a model-only graph plan with ``cfgs`` under ``key``."""
    stages = {name: plan_type(cfg=to_cfg(**fields), predicted_s=0.0,
                              measured_s=None, baseline_predicted_s=0.0,
                              baseline_measured_s=None, device="cpu",
                              key=key, candidates=1).to_json()
              for name, fields in cfgs.items()}
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, f"graph-{key}.json"), "w") as f:
        json.dump({"device": "cpu", "stages": stages}, f)


@pytest.mark.parametrize("pin", list(PINS))
@pytest.mark.parametrize("name", ["ela2d", "heat2d"])
def test_pinned_stages_of_their_own_match_reference(name, caches, pin):
    ref = _reference()
    pair = _pair(name)
    dual, dirichlet = PINS[pin]
    cfgs = {"dual": dual, "dirichlet": dirichlet}
    fc = FetiConfig(schur="auto", measure="never", preconditioner="dirichlet",
                    device="cpu")
    key = make_cluster_preprocessor(
        pair.prob, FetiConfig(preconditioner="dirichlet", device="cpu")
    )[0]["graph"].joint_key(DEVICE_MODELS["cpu"], measured=False)
    _pin(caches / "port", key, cfgs, Plan, SchurAssemblyConfig)
    _pin(caches / "ref", key, cfgs, ref.Plan, ref.Schur)
    st = preprocess_cluster(pair.prob, fc)
    want = ref.preprocess(pair.ref_prob, ref.FetiConfig(
        schur="auto", measure="never", preconditioner="dirichlet"))
    assert st.graph_plan.from_cache and want.graph_plan.from_cache
    for name in cfgs:
        assert st.stages[name].cfg == SchurAssemblyConfig(**cfgs[name])
        assert st.stages[name].cfg == plan_from_reference(
            want.graph_plan[name].to_json()).cfg
    assert st.storage == dual["storage"]
    assert st.dirichlet_cfg.block_size == dirichlet["block_size"]
    assert st.dirichlet_env.block_size == dirichlet["block_size"]
    assert st.shared_factor == want.shared_factor == (pair.name == "ela2d")
    _close(st.F, want.F)
    _close(st.Sb, want.Sb)


def test_graph_plan_roundtrip_and_summary():
    cfg = SchurAssemblyConfig(block_size=16, use_kernels=True, fused=True)
    p = Plan(cfg=cfg, predicted_s=1e-5, measured_s=2e-5,
             baseline_predicted_s=3e-5, baseline_measured_s=4e-5,
             device="h100", key="k" * 64, candidates=140, timed=17)
    q = Plan.from_json(json.loads(json.dumps(p.to_json())))
    assert q.from_cache and dataclasses.replace(q, from_cache=False) == p
    assert "refused" not in p.to_json()
    # an entry cached while bs > 128 kernel tiles were refused still loads
    old = dict(p.to_json(), refused=12)
    assert dataclasses.replace(Plan.from_json(old), from_cache=False) == p
    gp = GraphPlan(key="k" * 64, device="h100", plans={"dual": p})
    text = gp.summary()
    assert "graph[h100] 1 stage(s)" in text and "[dual]" in text
    assert "kernels=True fused=True" in text
    assert "140 candidates, 17 timed" in text and "left out" not in text


def test_stage_graph_validates_wiring():
    def builder(bs, rbs):  # never called
        raise AssertionError

    a = StageSpec(name="a", builder=builder, fingerprint="fa", n=8)
    with pytest.raises(ValueError, match="duplicate"):
        StageGraph([a, StageSpec(name="a", builder=builder,
                                 fingerprint="fb", n=8)])
    with pytest.raises(ValueError, match="earlier stage"):
        StageGraph([StageSpec(name="b", builder=builder, fingerprint="fb",
                              n=8, share_factor_of="zzz")])
