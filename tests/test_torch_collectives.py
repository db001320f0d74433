"""The collective schedule against what the port sends, and the dry-run's
collective columns and Dirichlet executor.

Held exactly, bytes and counts by operation: ``record_collectives()``
around a placed prefill, a placed decode step and a placed train step of
granite-3-8b's smoke model on (data=2, model=2) gloo ranks on the CPU
against ``lm_collectives`` for the cell (the prefill and the train step
sequence-parallel, with reduce-scatters); and around one sharded
``solve_iter`` and one ``solve_iter_multi`` application on two ranks
(smoke feti-heat-2d, f32) against ``feti_collectives``. The placed
serving logits within 1e-6 of one process's (relative to the largest),
the sharded applications' results equal to one device's. The dry-run on
both production meshes: every ``ok`` row carries collectives and a
finite ``collective_s`` at ``HW["net_bw"]``, ``report`` prints them, the
full-size FETI rows still equal ``tests/data/torch_dryrun_golden.json``.
``--run`` executes the Dirichlet cell (smoke, CPU: the plain versions,
no launch counted); only train cells have no executor."""
import dataclasses
import math
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_dryrun_golden as golden  # noqa: E402

pytestmark = pytest.mark.torch_port

ARCH, MESH, BATCH, SEQ = "granite-3-8b", (2, 2), 4, 8
SERVE_TOL = 1e-6


def _spawn(calls, n):
    from repro_torch.launch.mesh import run_each, spawn_ranks

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        return spawn_ranks(run_each, n, backend="gloo", device="cpu",
                           args=(calls,), timeout=300)


def _train_config():
    from repro_torch.train import OptimizerConfig, TrainConfig

    return TrainConfig(optimizer=OptimizerConfig(warmup_steps=1,
                                                 total_steps=1),
                       remat=True, grad_accum=2)


@pytest.fixture(scope="module")
def lm_ranks():
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.distributed.sharding import placed_serve, placed_train_step

    cfg = get_smoke_config(ARCH)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    batch = synthetic_batch(cfg, BATCH, SEQ, seed=17)
    return tokens, _spawn([
        (placed_serve, (cfg, MESH, tokens)),
        (placed_train_step, (cfg, MESH, [batch], _train_config(), None,
                             False))], MESH[0] * MESH[1])


def test_placed_lm_steps_send_the_schedule(lm_ranks):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.analytic import lm_collectives
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.shapes import ShapeCase

    cfg = get_smoke_config(ARCH)
    mesh = MeshShape({"data": MESH[0], "model": MESH[1]})
    want = {kind: lm_collectives(cfg, ShapeCase(kind, SEQ, BATCH, kind),
                                 mesh, _train_config())
            for kind in ("prefill", "decode", "train")}
    assert want["prefill"].count_by_op["all-gather"] > 0
    # train and prefill sequence-parallel (SEQ divides 'model'), decode not
    assert set(want["train"].count_by_op) == {"all-gather", "all-reduce",
                                              "reduce-scatter"}
    assert "reduce-scatter" in want["prefill"].count_by_op
    assert "reduce-scatter" not in want["decode"].count_by_op
    _, ranks = lm_ranks
    for serve, train in ranks:
        assert serve["collectives"]["prefill"] == want["prefill"]
        assert serve["collectives"]["decode"] == want["decode"]
        assert train["collectives"] == [want["train"]]


def test_placed_serving_is_one_process(lm_ranks):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LanguageModel, init_cache
    from repro_torch.train import make_decode_step, make_prefill_step

    tokens, ranks = lm_ranks
    cfg = get_smoke_config(ARCH)
    model = LanguageModel(cfg, device="cpu")
    cache = init_cache(cfg, BATCH, SEQ + 1, "cpu")
    prefill, _ = make_prefill_step(model)({"tokens": torch.as_tensor(tokens)},
                                          cache)
    tok = prefill.argmax(-1)[:, None].to(torch.int32)
    decode, _ = make_decode_step(model)(tok, cache, SEQ)
    for serve, _ in ranks:
        for key, want in (("prefill", prefill), ("decode", decode)):
            want = want.numpy()
            assert serve[key].shape == want.shape
            err = np.abs(serve[key] - want).max() / np.abs(want).max()
            assert err <= SERVE_TOL, (key, err)


def test_sharded_feti_application_sends_the_schedule():
    from repro_torch.configs import get_smoke_config
    from repro_torch.feti.operator import explicit_dual_apply
    from repro_torch.launch import dryrun
    from repro_torch.launch.analytic import FETI_SOLVE_N_RHS, feti_collectives

    fc = get_smoke_config("feti-heat-2d")
    shapes = ("solve_iter", "solve_iter_multi")
    ranks = _spawn([(dryrun.feti_rank_collectives, ("feti-heat-2d", s))
                    for s in shapes], 2)
    st = dryrun._feti_setup(fc)
    for i, shape in enumerate(shapes):
        want = feti_collectives(fc, shape, 2)
        n_rhs = FETI_SOLVE_N_RHS if shape == "solve_iter_multi" else 1
        assert want.bytes_by_op == {
            "all-reduce": st.prob.n_lambda * n_rhs * 4}
        assert feti_collectives(fc, shape, 1).total_count == 0
        gen = torch.Generator().manual_seed(0)
        dm, F, lam = dryrun._solve_inputs(st, shape, gen,
                                          torch.device("cpu"))
        one = explicit_dual_apply(F, dm, lam).numpy()
        for r in ranks:
            assert r[i]["collectives"] == want
            np.testing.assert_allclose(r[i]["q"], one, rtol=1e-6,
                                       atol=1e-6 * np.abs(one).max())
    for shape in ("assembly", "dirichlet"):
        assert feti_collectives(fc, shape, 256).total_count == 0


def test_production_rows_carry_collectives(tmp_path):
    from repro_torch.launch import dryrun, finalize, report
    from repro_torch.launch.roofline import HW

    path = str(tmp_path / "d.jsonl")
    assert dryrun.main(["--arch", "all", "--shape", "all", "--mesh", "both",
                        "--out", path]) == 0
    recs = report.load(path)
    ok = [r for r in recs if r["status"] == "ok"]
    assert len(ok) == 94
    for r in ok:
        coll, ro = r["collectives"], r["roofline"]
        assert coll is not None and set(coll) == {"bytes", "count"}
        assert math.isfinite(ro["collective_s"])
        assert ro["collective_s"] == sum(coll["bytes"].values()) / HW["net_bw"]
        assert finalize.fraction(r) <= 1.0
        if not r["arch"].startswith("feti"):
            assert coll["count"]["all-gather"] > 0
            assert "tensor-parallel" in r["analytic"]["placement_model_axis"]
    assert any(r["roofline"]["dominant"] == "collective" for r in ok)
    table = report.dryrun_table(recs)
    assert "| — | — | — |" not in table  # collectives on every row
    assert "—" not in report.roofline_table(recs, "2x16x16")
    want = golden.load()
    held = [r for r in ok if f"{r['arch']}/{r['shape']}/{r['mesh']}" in want]
    assert len(held) == len(want) == 32
    for r in held:
        assert not golden.mismatches(
            r, want[f"{r['arch']}/{r['shape']}/{r['mesh']}"])


def test_dirichlet_cell_runs_and_only_train_cells_skip():
    from repro_torch.launch import dryrun

    for arch in ("feti-heat-3d", "feti-elasticity-2d"):
        rec = dryrun.run_cell(arch, "dirichlet", dryrun.DEVICE_MESH,
                              run=True, device="cpu", smoke=True, steps=1)
        assert rec["status"] == "ok", rec.get("error")
        assert "run_skipped" not in rec
        assert rec["launches_per_step"] == [{}, {}]
        assert rec["measured_s"] > 0 and rec["peak_device_bytes"] is None
        assert "restrict_own_boundary" in rec["note"]
        assert rec["collectives"] is None
    from repro_torch.configs import get_smoke_config

    assert dryrun._run_reason(get_smoke_config("feti-heat-2d"),
                              "dirichlet") is None
    assert "train" in dryrun._run_reason(get_smoke_config(ARCH), "train_4k")
    for shape in ("prefill_32k", "decode_32k"):
        assert dryrun._run_reason(get_smoke_config(ARCH), shape) is None


def test_record_collectives_restores_c10d_and_nests():
    import torch.distributed as dist

    from repro_torch.launch.roofline import record_collectives

    before = dist.all_reduce
    with record_collectives() as outer:
        assert dist.all_reduce is not before
        with record_collectives() as inner:
            pass
        assert dist.all_reduce is not before
    assert dist.all_reduce is before
    assert outer.total_count == inner.total_count == 0
    assert dataclasses.asdict(outer) == {"bytes_by_op": {}, "count_by_op": {}}
