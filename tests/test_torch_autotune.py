"""The port's autotuner (``repro_torch.core.autotune``) against the
reference's ``repro.core.autotune``.

Both packages plan the same sparsity patterns: the candidate space
(mapped field for field: ``use_pallas`` is ``use_kernels``, ``interpret``
has no counterpart), the FLOP, byte and roofline models, the fingerprints
and cache keys, and the model-only plans under the ``"cpu"`` model must
agree; under the ``"gpu"`` model the port's kernel candidates drop the
reference's 200x interpret penalty. Each package caches in its own
``tmp_path`` root, and the port never touches the reference's. The
planner's CUDA rules are checked here through the ``"h100"`` model (the
CUDA kernels take every block size of the space, bs 256 included, so no
kernel candidate is left out; kernel candidates are timed only on a CUDA
device).

The ``cuda`` cases need the card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_autotune.py``.
"""
import dataclasses
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core import (  # noqa: E402
    SchurAssemblyConfig,
    build_stepped_meta,
    column_pivots,
    enumerate_space,
    plan,
    plan_assembly,
    schur_dense_baseline,
)
from repro_torch.core import autotune  # noqa: E402
from repro_torch.fem import decompose_problem  # noqa: E402
from repro_torch.feti import FetiConfig, preprocess_cluster  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    plan_from_reference,
    schur_config_from_reference,
)
from repro_torch.launch.roofline import DEVICE_MODELS, detect_device  # noqa: E402
from repro_torch.sparse import (  # noqa: E402
    PackedBlocks,
    block_pattern,
    block_symbolic_cholesky,
)

pytestmark = pytest.mark.torch_port

REL = 1e-12
N, M = 96, 40  # the random pattern's factor rows and multipliers
KERNELS = ("stepped_trsm", "stepped_trsm_packed", "stepped_syrk",
           "stepped_trsm_syrk", "stepped_trsm_syrk_packed")


def _reference():
    """The reference modules, imported only by the tests that compare
    with them (the card's machine has no JAX)."""
    pytest.importorskip("jax")
    from repro.core import autotune as ref_autotune
    from repro.core import build_stepped_meta as ref_meta
    from repro.launch.roofline import DEVICE_MODELS as ref_models
    from repro.testing import random_feti_like_bt

    return types.SimpleNamespace(autotune=ref_autotune, meta=ref_meta,
                                 models=ref_models,
                                 random_bt=random_feti_like_bt)


def _pattern(n=N, m=M, seed=0):
    """A FETI-like B̃ᵀ pattern (each column a few rows around an anchor)
    and a banded factor pattern, from a seed."""
    rng = np.random.default_rng(seed)
    bt = np.zeros((n, m), dtype=bool)
    anchors = rng.integers(0, n, size=m)
    for j, a in enumerate(anchors):
        bt[np.clip(a + rng.integers(0, 5, size=2), 0, n - 1), j] = True
    i = np.arange(n)
    return bt, np.abs(i[:, None] - i[None, :]) <= 10


@pytest.fixture()
def caches(tmp_path, monkeypatch):
    """A cache root of each package's own under ``tmp_path``."""
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_PLAN_CACHE_DIR", str(tmp_path / "ref"))
    monkeypatch.delenv("REPRO_PLAN_CACHE", raising=False)
    return tmp_path


def _ported(ref_cfgs):
    return [schur_config_from_reference(dataclasses.asdict(c))
            for c in ref_cfgs]


def _rel(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


# ---------------------------------------------------------------- space ----

@pytest.mark.parametrize("storage", [None, "dense", "packed"])
def test_block_sizes_and_space_match_reference(storage):
    ref = _reference().autotune
    for n in (5, 25, 100, 300):
        assert autotune.default_block_sizes(n) == ref.default_block_sizes(n)
        bss = autotune.default_block_sizes(n)
        assert enumerate_space(bss, storage=storage) == _ported(
            ref.enumerate_space(bss, storage=storage))


@pytest.mark.parametrize("model", ["cpu", "gpu"])
@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
def test_cost_model_matches_reference(model, dtype):
    """FLOPs, bytes and roofline time of every candidate equal the
    reference's; under "gpu" a kernel candidate costs the reference's
    score over its interpret penalty."""
    ref = _reference()
    bt, kpat = _pattern()
    dev, ref_dev = DEVICE_MODELS[model], ref.models[model]
    checked = 0
    for bs in (8, 16, 32, 64):
        meta = build_stepped_meta(bt, block_size=bs, rhs_block_size=bs)
        ref_meta = ref.meta(bt, block_size=bs, rhs_block_size=bs)
        mask = block_symbolic_cholesky(block_pattern(kpat, bs))
        ref_cfgs = ref.autotune.enumerate_space((bs,))
        for cfg, ref_cfg in zip(_ported(ref_cfgs), ref_cfgs):
            fl = autotune.assembly_flops(meta, cfg)
            assert fl == ref.autotune.assembly_flops(ref_meta, ref_cfg)
            by = autotune.assembly_bytes(meta, cfg, mask,
                                         autotune.itemsize(dtype))
            ref_by = ref.autotune.assembly_bytes(
                ref_meta, ref_cfg, mask, ref.autotune.itemsize(dtype))
            assert by.keys() == ref_by.keys()
            assert all(_rel(by[k], ref_by[k]) for k in by), (cfg, by, ref_by)
            cost = autotune.assembly_cost(meta, cfg, dev, mask, dtype)
            want = ref.autotune.assembly_cost(ref_meta, ref_cfg, ref_dev,
                                              mask, dtype)
            if cfg.use_kernels and model == "gpu":
                want = dict(want, total_s=want["total_s"]
                            / ref.autotune._INTERPRET_PENALTY)
            assert cost.keys() == want.keys()
            assert all(_rel(cost[k], want[k]) for k in cost), (cfg, cost)
            checked += 1
    assert checked == sum(len(enumerate_space((b,))) for b in (8, 16, 32, 64))


def test_fingerprint_matches_reference():
    ref = _reference().autotune
    bt, kpat = _pattern(seed=3)
    extra = [kpat.sum(axis=1).astype(np.int64), np.arange(N)]
    fp = autotune.pattern_fingerprint(column_pivots(bt), N, M, extra=extra)
    assert fp == ref.pattern_fingerprint(column_pivots(bt), N, M, extra=extra)
    assert fp != autotune.pattern_fingerprint(column_pivots(bt), N, M)
    for measured in (False, True):
        for stage, dtype, storage in (("dual", "f64", None),
                                      ("dirichlet", "f32", "packed")):
            key = autotune._cache_key(fp, DEVICE_MODELS["cpu"], (8, 16),
                                      measured, storage, stage, dtype)
            assert key == ref._cache_key(fp, _reference().models["cpu"],
                                         (8, 16), measured, storage, stage,
                                         dtype)


# ------------------------------------------------------------ planning ----

@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("storage", [None, "dense", "packed"])
def test_model_plan_matches_reference(caches, storage, dtype):
    """measure="never" under the "cpu" model: the reference's plan."""
    ref = _reference()
    bt, kpat = _pattern(seed=1)
    kw = dict(factor_pattern=kpat, measure="never", storage=storage,
              dtype=dtype)
    got = plan_assembly(bt, device=DEVICE_MODELS["cpu"], **kw)
    want = plan_from_reference(ref.autotune.plan_assembly(
        bt, device=ref.models["cpu"], **kw).to_json())
    assert got.cfg == want.cfg
    assert got.key == want.key and got.candidates == want.candidates
    assert _rel(got.predicted_s, want.predicted_s)
    assert _rel(got.baseline_predicted_s, want.baseline_predicted_s)
    assert got.measured_s is None and got.timed == 0


def test_plan_facade_and_cache_roundtrip(caches):
    assert plan is plan_assembly
    bt, kpat = _pattern(seed=7)
    p = plan_assembly(bt, factor_pattern=kpat, measure="never",
                      device=DEVICE_MODELS["cpu"])
    assert not p.from_cache
    files = os.listdir(caches / "port")
    assert files == [p.key + ".json"]
    q = plan_assembly(bt, factor_pattern=kpat, measure="never",
                      device=DEVICE_MODELS["cpu"])
    assert q.from_cache and q.cfg == p.cfg and q.key == p.key
    r = autotune.Plan.from_json(p.to_json())
    assert r.from_cache
    assert dataclasses.replace(r, from_cache=False) == p
    assert autotune.clear_plan_cache() == 1
    assert not plan_assembly(bt, factor_pattern=kpat, measure="never",
                             device=DEVICE_MODELS["cpu"]).from_cache


def test_refused_kernel_tiles_are_never_returned(caches):
    """No kernel tile is refused any more: under the "h100" model the
    kernel candidates at bs 256 are scored like any other and may be
    returned (the CUDA kernels take bs up to 256), and the plan records no
    count of candidates left out. On a CPU device no kernel candidate is
    timed; the CPU model never returns one."""
    bt, kpat = _pattern(n=300, m=64, seed=2)
    assert 256 in autotune.default_block_sizes(300)
    h100 = DEVICE_MODELS["h100"]
    for measure in ("never", "auto"):
        p = plan_assembly(bt, factor_pattern=kpat, measure=measure,
                          device=h100, torch_device="cpu", cache=False)
        assert p.candidates == len(enumerate_space(
            autotune.default_block_sizes(300)))
        assert not hasattr(p, "refused") and "left out" not in p.summary()
        if measure == "auto":
            assert not p.cfg.use_kernels and 0 < p.timed
            assert p.measured_s <= p.baseline_measured_s
    # restricted to bs 256 the model's best is a kernel candidate there
    p = plan_assembly(bt, factor_pattern=kpat, measure="never", device=h100,
                      block_sizes=(256,), cache=False)
    assert p.cfg.block_size == 256 and p.cfg.use_kernels
    p = plan_assembly(bt, factor_pattern=kpat, measure="never",
                      device=DEVICE_MODELS["cpu"], cache=False)
    assert not p.cfg.use_kernels


def test_measured_plan_no_slower_than_its_baseline(caches):
    bt, kpat = _pattern(seed=4)
    p = plan_assembly(bt, factor_pattern=kpat, measure="auto",
                      torch_device="cpu")
    assert p.device == "cpu" and p.timed > 0
    assert p.measured_s <= p.baseline_measured_s
    # a measured plan never serves a model-only caller, nor vice versa
    q = plan_assembly(bt, factor_pattern=kpat, measure="never",
                      torch_device="cpu")
    assert not q.from_cache and q.key != p.key
    assert plan_assembly(bt, factor_pattern=kpat, measure="auto",
                         torch_device="cpu").from_cache


def test_measure_configs_times_given_configs():
    bt, kpat = _pattern(seed=5)

    def builder(bs, rbs):
        return (build_stepped_meta(bt, block_size=bs, rhs_block_size=rbs),
                block_symbolic_cholesky(block_pattern(kpat, bs)))

    cfgs = [SchurAssemblyConfig(block_size=16),
            SchurAssemblyConfig(block_size=32, storage="packed"),
            SchurAssemblyConfig(trsm_variant="dense", syrk_variant="dense",
                                block_size=8, prune=False)]
    times, base = autotune.measure_configs(builder, cfgs, batch=3,
                                           torch_device="cpu", reps=2)
    assert len(times) == 3 and all(t > 0 for t in times)
    assert times[2] == base  # the dense baseline is timed once


def test_detect_device_and_h100_model():
    assert detect_device("cpu") is DEVICE_MODELS["cpu"]
    assert detect_device(torch.device("cpu")).kind == "cpu"
    h = DEVICE_MODELS["h100"]
    assert h.peak("f64") == h.peak("f32") == h.peak("bf16") == 67e12
    assert h.mem_bw == 3.35e12


# ------------------------------------------------ the cluster pipeline ----

def _carry(ref_prob):
    from repro_torch.interop import SUBDOMAIN_KEYS, from_reference_problem

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


def _close(got, want, tol=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


# (decomposition, preconditioner): heat-2d's and elasticity-3d's smoke
# configurations, the second with the Dirichlet stage planned jointly
AUTO_CASES = {
    "heat2d": (("heat", 2, (2, 2), (4, 4)), "lumped"),
    "ela3d-dirichlet": (("elasticity", 3, (2, 2, 1), (2, 2, 2)),
                        "dirichlet"),
}


@pytest.mark.parametrize("case", list(AUTO_CASES))
def test_auto_preprocess_matches_reference(caches, case):
    """schur="auto", measure="never" on the CPU: the reference's joint
    plan, and F̃ and S_b within 1e-12 of its auto run."""
    pytest.importorskip("jax")
    from repro.fem import decompose_problem as ref_decompose
    from repro.feti import FetiConfig as RefConfig
    from repro.feti import preprocess_cluster as ref_preprocess

    args, precond = AUTO_CASES[case]
    ref_prob = ref_decompose(*args)
    want = ref_preprocess(ref_prob, RefConfig(
        schur="auto", measure="never", preconditioner=precond))
    st = preprocess_cluster(_carry(ref_prob), FetiConfig(
        schur="auto", measure="never", preconditioner=precond,
        device="cpu"))
    assert st.graph_plan.key == want.graph_plan.key
    assert set(st.graph_plan.plans) == set(want.graph_plan.plans)
    for name, p in st.graph_plan.plans.items():
        assert p.cfg == plan_from_reference(
            want.graph_plan[name].to_json()).cfg, name
    assert st.cfg == st.plan.cfg == st.stages["dual"].cfg
    _close(st.F, want.F)
    if precond == "dirichlet":
        assert st.dirichlet_cfg == st.dirichlet_plan.cfg
        assert st.shared_factor == want.shared_factor
        _close(st.Sb, want.Sb)


def test_auto_measured_preprocess_on_the_cpu(caches):
    """measure="auto": each stage's plan is no slower than the baseline
    it reports, and F̃ matches the dense baseline."""
    prob = decompose_problem("heat", 2, (2, 2), (4, 4))
    st = preprocess_cluster(prob, FetiConfig(
        schur="auto", preconditioner="dirichlet", device="cpu"))
    for p in st.graph_plan.plans.values():
        assert p.timed > 0 and p.measured_s <= p.baseline_measured_s
    L = st.L.unpack() if isinstance(st.L, PackedBlocks) else st.L
    _close(st.F, schur_dense_baseline(L, st.Btp))


def test_port_never_touches_the_reference_cache(tmp_path, monkeypatch):
    ref_root = tmp_path / "ref"
    ref_root.mkdir()
    (ref_root / "sentinel.json").write_text("{}")
    before = {p.name: p.stat().st_mtime_ns for p in ref_root.iterdir()}
    monkeypatch.setenv("REPRO_PLAN_CACHE_DIR", str(ref_root))
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(ref_root))
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert autotune.plan_cache_dir() == str(
        tmp_path / "home" / ".cache" / "repro_torch" / "plans")
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path / "port"))
    bt, kpat = _pattern(seed=8)
    plan_assembly(bt, factor_pattern=kpat, measure="never",
                  device=DEVICE_MODELS["cpu"])
    preprocess_cluster(decompose_problem("heat", 2, (2, 2), (4, 4)),
                       FetiConfig(schur="auto", measure="never",
                                  preconditioner="dirichlet", device="cpu"))
    assert {p.name: p.stat().st_mtime_ns for p in ref_root.iterdir()} \
        == before
    assert len(list((tmp_path / "port").glob("*.json"))) == 2
    assert autotune.clear_plan_cache() == 2
    assert (ref_root / "sentinel.json").exists()


# ------------------------------------------------------------- the card ----

def _launches():
    return sum(getattr(kernels, f"{k}_kernel").launches for k in KERNELS)


@pytest.mark.cuda
def test_cuda_planner_times_kernels_and_caches(caches):
    """On the card the measured step times kernel candidates (the launch
    counters rise), leaves out no candidate (bs-256 kernel candidates
    included) under either measure setting, and a cached plan reruns with
    no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bt, kpat = _pattern(n=300, m=64, seed=2)
    for measure in ("never", "auto"):
        before = _launches()
        p = plan_assembly(bt, factor_pattern=kpat, measure=measure,
                          torch_device="cuda")
        assert p.device in ("gpu", "h100")
        assert p.candidates == len(enumerate_space(
            autotune.default_block_sizes(300)))
        assert (_launches() > before) == (measure == "auto")
        before = _launches()
        q = plan_assembly(bt, factor_pattern=kpat, measure=measure,
                          torch_device="cuda")
        assert q.from_cache and q.cfg == p.cfg and _launches() == before


@pytest.mark.cuda
def test_cuda_autotuned_smoke_assembly_matches_dense_baseline(caches):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prob = decompose_problem("heat", 2, (2, 2), (4, 4))
    before = _launches()
    st = preprocess_cluster(prob, FetiConfig(schur="auto", device="cuda"))
    assert _launches() > before  # planning timed the kernels
    L = st.L.unpack() if isinstance(st.L, PackedBlocks) else st.L
    want = schur_dense_baseline(L, st.Btp)
    err = (st.F - want).abs().max().item()
    assert err <= 1e-10 * want.abs().max().item()
