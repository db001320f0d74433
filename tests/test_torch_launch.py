"""The LM shape grid, the analytic counts, the dry-run, its report and
finalize, the pattern-only FETI metadata and the test fixtures against the
reference.

Held exactly (the arithmetic is the reference's, term for term): the
shape grid, the skip rules and the input stand-ins of all ten LM configs;
the caches of every (config, applicable serving shape), leaf by leaf in
shape and dtype against the reference's unstacked ``cache_specs``;
``lm_cell_counts`` in every field and note (bar 1e-12 relative) for every
config x applicable shape x {256 chips tp 16, 512 chips tp 16, 1 chip tp
1} x ``skip_masked``, and deepseek under ``moe_impl="sort"``;
``feti_cell_counts`` of the four FETI smoke configs x four shapes x three
chip counts; the full-size FETI rows against
``tests/data/torch_dryrun_golden.json`` (recomputed with the reference
here); ``build_stepped_meta_from_pivots`` on seeded pivots; the
``roofline_terms`` and ``finalize.fraction`` of the same records with the
H100's ``HW``; the ``testing`` fixtures' arrays for the same seed.
"""
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.launch.analytic as ref_analytic  # noqa: E402
import repro.launch.finalize as ref_finalize  # noqa: E402
import repro.launch.roofline as ref_roofline  # noqa: E402
import repro.launch.shapes as ref_shapes  # noqa: E402
import repro.testing as ref_testing  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.stepped import \
    build_stepped_meta_from_pivots as ref_from_pivots  # noqa: E402

from repro_torch import testing  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.stepped import build_stepped_meta_from_pivots  # noqa: E402
from repro_torch.launch import (analytic, dryrun, finalize, mesh,  # noqa: E402
                                report, roofline, shapes)
from repro_torch.models.transformer import StackLayout  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_dryrun_golden as golden  # noqa: E402

pytestmark = pytest.mark.torch_port

LM_ARCHS = ("deepseek-v2-236b", "granite-3-8b", "grok-1-314b",
            "hubert-xlarge", "mistral-large-123b", "nemotron-4-340b",
            "qwen1.5-32b", "qwen2-vl-2b", "recurrentgemma-2b", "rwkv6-1.6b")
FETI_ARCHS = golden.ARCHS
MESHES = ((256, 16), (512, 16), (1, 1))  # (chips, tp)
REL = 1e-12


@pytest.fixture(scope="module")
def ref_dryrun():
    return golden.import_reference_dryrun()


def _dtype_name(d) -> str:
    return str(d).removeprefix("torch.")


def test_every_reference_module_has_a_counterpart():
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    mods = sorted(p.relative_to(src / "repro")
                  for p in (src / "repro").rglob("*.py"))
    missing = [str(m) for m in mods if not (src / "repro_torch" / m).exists()]
    assert not missing


def test_shape_grid_and_skip_rules():
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in ref_shapes.SHAPES.items()}
    assert sorted(get_config(a).name for a in LM_ARCHS) == sorted(
        ref_config(a).name for a in LM_ARCHS)
    for arch in LM_ARCHS:
        assert shapes.applicable_shapes(get_config(arch)) == \
            ref_shapes.applicable_shapes(ref_config(arch))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_input_and_cache_specs_match_reference(arch):
    """Every applicable shape's inputs, and every serving shape's cache
    leaf by leaf: the reference's ``body`` leaves unstacked over their
    cycles, each layer's dict against the port's."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    lay = StackLayout.build(cfg)
    for name in shapes.applicable_shapes(cfg):
        got = shapes.input_specs(cfg, shapes.SHAPES[name])
        want = ref_shapes.input_specs(rcfg, ref_shapes.SHAPES[name])
        assert {k: (tuple(v.shape), _dtype_name(v.dtype))
                for k, v in got.items()} == {
            k: (tuple(v.shape), v.dtype.name) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())
        cache = shapes.cache_specs(cfg, shapes.SHAPES[name])
        ref = ref_shapes.cache_specs(rcfg, ref_shapes.SHAPES[name])
        if shapes.SHAPES[name].kind == "train":
            assert cache is None and ref is None
            continue
        layers = [None] * cfg.num_layers
        for i, li in enumerate(lay.prologue):
            layers[li] = {k: (tuple(v.shape), v.dtype.name)
                          for k, v in ref["prologue"][i].items()}
        for i, li in enumerate(lay.epilogue):
            layers[li] = {k: (tuple(v.shape), v.dtype.name)
                          for k, v in ref["epilogue"][i].items()}
        for j, body in enumerate(ref["body"]):
            for c in range(lay.cycles):
                assert all(v.shape[0] == lay.cycles for v in body.values())
                layers[lay.layer(j, c)] = {
                    k: (tuple(v.shape[1:]), v.dtype.name)
                    for k, v in body.items()}
        assert [{k: (tuple(v.shape), _dtype_name(v.dtype))
                 for k, v in layer.items()} for layer in cache] == layers
        assert all(t.device.type == "meta" for layer in cache
                   for t in layer.values())


def _close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
        return
    assert abs(got - want) <= REL * max(abs(want), 1e-300), (got, want)


def _cell_counts_match(cfg, rcfg, name, chips, tp, skip, **kw):
    args = dict(chips=chips, tp=tp, skip_masked=skip, **kw)
    got = analytic.lm_cell_counts(cfg, shapes.SHAPES[name], **args)
    want = ref_analytic.lm_cell_counts(rcfg, ref_shapes.SHAPES[name], **args)
    _close(got.as_dict(), want.as_dict())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_cell_counts_match_reference(arch, ref_dryrun):
    cfg, rcfg = get_config(arch), ref_config(arch)
    # the dry-run's training settings are the reference's
    t, rt = dryrun._train_settings(cfg), ref_dryrun._train_settings(rcfg)
    assert (t.grad_accum, t.remat, t.accum_dtype, t.optimizer.moment_dtype,
            t.z_loss_coef) == (rt.grad_accum, rt.remat, rt.accum_dtype,
                               rt.optimizer.moment_dtype, rt.z_loss_coef)
    kw = dict(grad_accum=t.grad_accum, remat=t.remat,
              moment_bytes=2 if t.optimizer.moment_dtype == "bfloat16" else 4,
              accum_bytes=2 if t.accum_dtype == "bfloat16" else 4,
              q_chunk=1024, kv_chunk=512)
    for name in shapes.applicable_shapes(cfg):
        for chips, tp in MESHES:
            for skip in (False, True):
                _cell_counts_match(cfg, rcfg, name, chips, tp, skip, **kw)
    if cfg.is_moe:
        sort = dataclasses.replace(cfg, moe_impl="sort")
        rsort = dataclasses.replace(rcfg, moe_impl="sort")
        for name in shapes.applicable_shapes(cfg):
            _cell_counts_match(sort, rsort, name, 256, 16, False, **kw)
        assert analytic.lm_cell_counts(
            sort, shapes.SHAPES["prefill_32k"], chips=1, tp=1, **kw
        ).notes["moe"] < analytic.lm_cell_counts(
            cfg, shapes.SHAPES["prefill_32k"], chips=1, tp=1, **kw
        ).notes["moe"]


@pytest.mark.parametrize("arch", FETI_ARCHS)
def test_feti_cell_counts_match_reference_smoke(arch, ref_dryrun):
    fc, rfc = get_smoke_config(arch), ref_smoke(arch)
    for name in dryrun.FETI_SHAPES:
        for chips in (256, 512, 1):
            got = dryrun.feti_cell_counts(fc, name, chips).as_dict()
            want = golden._plain(
                ref_dryrun.feti_cell_counts(rfc, name, chips).as_dict())
            assert got == want, (name, chips)


def test_full_size_feti_rows_meet_the_golden_file():
    """The port's dry-run rows of the full-size FETI configs against the
    stored reference counts, exactly (JSON round trip, as on the card)."""
    want = golden.load()
    assert len(want) == len(FETI_ARCHS) * 4 * 2
    for key, counts in want.items():
        arch, name, label = key.split("/")
        rec = json.loads(json.dumps(dryrun.run_cell(arch, name, label)))
        assert rec["status"] == "ok", rec.get("error")
        assert rec["chips"] == golden.MESHES[label]
        assert golden.mismatches(rec, counts) == [], key


def test_golden_file_is_the_reference_s():
    """The golden file recomputed with the reference (its full-size
    pattern-only set-up), so it cannot go stale."""
    assert golden.reference_counts() == golden.load()


def test_build_stepped_meta_from_pivots_matches_reference():
    rng = np.random.default_rng(7)
    for n, m, bs, cb in ((97, 40, 8, 8), (300, 130, 32, 16), (64, 64, 64, 8)):
        piv = rng.integers(0, n + 1, size=m)  # n: an empty column
        got = build_stepped_meta_from_pivots(piv, n, bs, cb)
        want = ref_from_pivots(piv, n, bs, cb)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
        assert got.flops_trsm_rhs_split() == want.flops_trsm_rhs_split()


def test_pattern_only_decomposition_keeps_the_topology():
    from repro.fem.decomposition import decompose_problem as ref_decompose

    from repro_torch.fem.decomposition import decompose_problem

    for problem, dim, grid, elems in (("heat", 2, (2, 3), (3, 2)),
                                      ("elasticity", 3, (2, 1, 2), (2, 2, 1))):
        full = decompose_problem(problem, dim, grid, elems)
        pat = decompose_problem(problem, dim, grid, elems,
                                assemble_values=False)
        ref = ref_decompose(problem, dim, grid, elems, assemble_values=False)
        assert pat.n_lambda == full.n_lambda == ref.n_lambda
        for a, b, r in zip(pat.subdomains, full.subdomains, ref.subdomains):
            assert a.K.shape == (1, 1) and a.Bt.shape == (1, full.m_max)
            assert a.n == b.n == r.n and a.m == b.m == r.m
            for f in ("b_rows", "b_vals", "lambda_ids", "dof_gids",
                      "fixing_dofs"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), f
                assert np.array_equal(getattr(a, f), getattr(r, f)), f


def test_fit_one_device():
    """granite-3-8b's decode_32k cache is 5.37 GB a sequence beside 16.34
    GB of weights: 11 sequences fit 0.9 x 80 GiB; nemotron-4-340b's
    weights need a layer cut; grok-1-314b's training state does not fit
    at one layer."""
    budget = dryrun.FIT_FRACTION * roofline.HW["hbm_bytes"]
    cfg, shape, counts, reduced = dryrun.fit_one_device(
        get_config("granite-3-8b"), shapes.SHAPES["decode_32k"])
    assert shape.global_batch == 11 and cfg.num_layers == 40
    assert counts.hbm_resident_per_dev <= budget
    more = dataclasses.replace(shape, global_batch=12)
    assert dryrun.lm_counts(cfg, more, 1, 1).hbm_resident_per_dev > budget
    assert reduced == [f"global_batch 128 -> 11 (the largest whose "
                       f"residency fits 0.9 x hbm_bytes)"]
    cfg, shape, counts, reduced = dryrun.fit_one_device(
        get_config("nemotron-4-340b"), shapes.SHAPES["decode_32k"])
    assert shape.global_batch == 1 and 1 <= cfg.num_layers < 96
    assert counts.hbm_resident_per_dev <= budget
    deeper = dataclasses.replace(cfg, num_layers=cfg.num_layers + 1)
    assert dryrun.lm_counts(deeper, shape, 1, 1).hbm_resident_per_dev > budget
    rec = dryrun.run_cell("grok-1-314b", "train_4k", dryrun.DEVICE_MESH)
    assert rec["status"] == "ok" and not rec["fits_hbm"]
    assert rec["reduced"][-1] == ("does not fit one card at one layer and "
                                  "batch 1")


def test_dryrun_run_executes_on_the_cpu_and_never_falls_back(monkeypatch):
    """``--run`` at smoke size on the CPU when asked for it (F̃ finite, the
    plain versions: no launch counted); without CUDA and without a device
    the cell is an error, not a CPU run."""
    rec = dryrun.run_cell("feti-heat-2d", "assembly", dryrun.DEVICE_MESH,
                          run=True, device="cpu", smoke=True, steps=1)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["launches_per_step"] == [{}, {}]
    assert rec["measured_s"] > 0 and rec["peak_device_bytes"] is None
    rec = dryrun.run_cell("feti-heat-2d", "solve_iter_multi",
                          dryrun.DEVICE_MESH, run=True, device="cpu",
                          smoke=True, steps=1)
    assert rec["status"] == "ok", rec.get("error")
    cut = {"decode_32k": dataclasses.replace(shapes.SHAPES["decode_32k"],
                                             seq_len=40, global_batch=2)}
    with monkeypatch.context() as m:
        m.setitem(dryrun.SHAPES, "decode_32k", cut["decode_32k"])
        rec = dryrun.run_cell("recurrentgemma-2b", "decode_32k",
                              dryrun.DEVICE_MESH, run=True, device="cpu",
                              smoke=True, steps=1)
    assert rec["status"] == "ok", rec.get("error")
    assert "cache_index 39" in rec["note"]
    rec = dryrun.run_cell("granite-3-8b", "train_4k", dryrun.DEVICE_MESH,
                          run=True, smoke=True)
    assert rec["status"] == "ok" and "run_skipped" in rec
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec = dryrun.run_cell("feti-heat-2d", "assembly", dryrun.DEVICE_MESH,
                          run=True, smoke=True)
    assert rec["status"] == "error"
    assert "CUDA is not available" in rec["error"]
    assert "measured_s" not in rec
    with pytest.raises(ValueError, match="--devices 1"):
        dryrun.run_cell("feti-heat-2d", "assembly", "16x16", run=True)


def test_dryrun_cli_report_and_finalize(tmp_path, capsys):
    base, opt = tmp_path / "base.jsonl", tmp_path / "opt.jsonl"
    args = ["--arch", "granite-3-8b", "--mesh", "single"]
    assert dryrun.main(args + ["--out", str(base)]) == 0
    assert dryrun.main(args + ["--opt", "--out", str(opt)]) == 0
    assert dryrun.main(["--arch", "feti-heat-2d", "--shape", "assembly",
                        "--devices", "1", "--out", str(base)]) == 0
    with pytest.raises(SystemExit):
        dryrun.main(["--run", "--out", str(base)])
    recs = report.load(str(base))
    assert {r["status"] for r in recs} == {"ok", "skipped"}
    table = report.dryrun_table(recs)
    assert "| granite-3-8b | decode_32k | 16x16 | ok |" in table
    assert "| — | — | — |" in table  # one card: no collectives, no run
    assert "SKIP: full attention" in table
    # the placed steps gather granite's weights whole over 50 GB/s links
    assert "**collective**" in report.roofline_table(recs, "16x16")
    capsys.readouterr()
    assert report.main([str(base)]) == 0
    out = capsys.readouterr().out
    assert "Dry-run census: 4 counted cells, 1 documented skips" in out
    assert finalize.main([str(base), str(opt), "--out-dir",
                          str(tmp_path / "md")]) == 0
    out = capsys.readouterr().out
    assert "| granite-3-8b × prefill_32k | 16x16 |" in out
    assert (tmp_path / "md" / "report_optimized.md").exists()


def test_roofline_and_fraction_match_the_reference_formulas(monkeypatch):
    """The same records through the reference's ``roofline_terms`` and
    ``finalize.fraction`` with the H100's figures patched in give the
    port's numbers."""
    monkeypatch.setattr(ref_roofline, "HW", roofline.HW)
    monkeypatch.setattr(ref_finalize, "HW", roofline.HW)
    coll = ref_roofline.CollectiveStats(bytes_by_op={"all-reduce": 3e6},
                                        count_by_op={"all-reduce": 2})
    port_coll = roofline.CollectiveStats(dict(coll.bytes_by_op),
                                         dict(coll.count_by_op))
    cost = {"flops": 3.5e12, "bytes accessed": 2.1e9}
    for chips, mf in ((256, 1e15), (1, None)):
        got = roofline.roofline_terms(cost, port_coll, chips, mf, 450e9)
        want = ref_roofline.roofline_terms(cost, coll, chips, mf, 450e9)
        assert got.as_dict() == want.as_dict()
    assert roofline.no_collectives().total_bytes == 0
    recs = [dryrun.run_cell(a, s, m) for a, s, m in (
        ("granite-3-8b", "decode_32k", "16x16"),
        ("deepseek-v2-236b", "train_4k", "2x16x16"),
        ("feti-heat-2d", "assembly", "16x16"),
        ("recurrentgemma-2b", "long_500k", dryrun.DEVICE_MESH))]
    for rec in recs:
        assert rec["status"] == "ok"
        assert finalize.fraction(rec) == ref_finalize.fraction(rec)
        assert finalize.measured_fraction(rec) is None
    rec = dict(recs[0], measured_s=0.5)
    assert finalize.measured_fraction(rec) == finalize.floor_s(rec) / 0.5


def test_production_meshes():
    single, multi = (mesh.make_production_mesh(),
                     mesh.make_production_mesh(multi_pod=True))
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512 and list(multi.shape) == ["pod", "data", "model"]
    with pytest.raises(RuntimeError, match="initialized process group"):
        mesh.make_local_mesh("cpu")


@pytest.mark.parametrize("name", ["random_banded_spd", "random_lower_banded",
                                  "random_feti_like_bt",
                                  "block_fill_mask_from_factor"])
def test_testing_fixtures_match_reference(name):
    def draw(mod):
        rng = np.random.default_rng(11)
        if name == "random_banded_spd":
            return mod.random_banded_spd(40, 3, rng)
        if name == "random_lower_banded":
            return mod.random_lower_banded(40, 5, rng, fill=0.6)
        if name == "random_feti_like_bt":
            return mod.random_feti_like_bt(40, 17, rng, nnz_per_col=3)
        L = mod.random_lower_banded(40, 5, rng)
        return mod.block_fill_mask_from_factor(L, 8)

    got, want = draw(testing), draw(ref_testing)
    assert got.dtype == want.dtype and np.array_equal(got, want)
