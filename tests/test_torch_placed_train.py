"""Placed LM training over gloo ranks on the CPU against one process on the
global batch, and against the reference: FSDP plus data parallelism
(``distributed.sharding.distribute_model``, ``make_train_step(cfg, tcfg,
mesh)``), the placed checkpoint and the elastic restore.

Every case runs three f32 AdamW steps (lr 1e-7, so that the parameters'
distance shows the gradients' and not AdamW's rounding near eps) of a
smoke config on ``synthetic_batch(cfg, 4, 16, seed=17, step=i)``, each
rank on its rows (``local_batch``), inside ``placed_train_step``, which
also runs one process's steps on the whole batches from the same weights
and returns the distances. Bars (PERF.md §2, as for accumulation): losses
and their parts, the gradient norm and the final parameters within 1e-5
relative, every step's shard gradients within 2e-5 relative L2 of their
slice of the one-process gradient. Meshes (data, model): (2, 1) for
granite-3-8b, deepseek-v2-236b (MoE aux loss, GShard), rwkv6-1.6b and
granite with grad_accum 2 and remat; (2, 2) for granite and deepseek with
grad_accum 2 and remat. One (2, 1) granite run starts from the
reference's weights (``interop.train_state_from_reference``) and meets
the reference's own ``make_train_step`` on the same batches.

The training launcher on two ranks (``launch.train.rank_main``): four
steps with a checkpoint every two, and a resume from the step-2
checkpoint, whose step-4 checkpoint equals the uninterrupted run's bit
for bit; the step-4 checkpoint (saved from the (2, 1) placement) restored
onto (1, 2) (``launch.train.restore_onto``): every leaf equal to its
slice of the saved array and placed as asked.

Each mesh's cases share one ``spawn_ranks`` group (``run_each``); the
ranks run one torch thread each."""
import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.torch_port

TOL, GRAD_TOL = 1e-5, 2e-5
LR, BATCH, SEQ, STEPS = 1e-7, 4, 16, 3
# case -> (arch, mesh (data, model), grad_accum, remat)
CASES = {
    "granite-3-8b (2,1)": ("granite-3-8b", (2, 1), 1, False),
    "deepseek-v2-236b (2,1)": ("deepseek-v2-236b", (2, 1), 1, False),
    "rwkv6-1.6b (2,1)": ("rwkv6-1.6b", (2, 1), 1, False),
    "granite-3-8b (2,1) accum2 remat": ("granite-3-8b", (2, 1), 2, True),
    "granite-3-8b (2,2)": ("granite-3-8b", (2, 2), 1, False),
    "deepseek-v2-236b (2,2) accum2 remat": ("deepseek-v2-236b", (2, 2), 2,
                                            True),
}
REFERENCE = "granite-3-8b (2,1) from the reference's weights"
LAUNCH = ["--arch", "granite-3-8b", "--smoke", "--batch", "4", "--seq", "16",
          "--steps", "4", "--ckpt-every", "2", "--log-every", "4"]


def _config(arch):
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               param_dtype="float32")


def _train_config(grad_accum=1, remat=False):
    from repro_torch.train import OptimizerConfig, TrainConfig

    return TrainConfig(optimizer=OptimizerConfig(
        learning_rate=LR, warmup_steps=1, total_steps=STEPS),
        remat=remat, grad_accum=grad_accum)


def _batches(cfg):
    from repro_torch.data import synthetic_batch

    return [synthetic_batch(cfg, BATCH, SEQ, seed=17, step=i)
            for i in range(STEPS)]


@pytest.fixture(scope="module")
def reference():
    """The reference's granite-3-8b smoke model from its own seeded
    initialization, carried to the port's state dict
    (``train_state_from_reference``), and the reference's
    ``make_train_step`` (jit) on the same batches: each step's metrics and
    the final parameters by the port's names (numpy)."""
    import jax

    from repro.configs import get_smoke_config as ref_smoke
    from repro.data import synthetic_batch as ref_batch
    from repro.models import init_model
    from repro.train import OptimizerConfig, TrainConfig
    from repro.train import adamw_init, make_train_step
    from repro_torch.interop import train_state_from_reference

    cfg = _config("granite-3-8b")
    rcfg = dataclasses.replace(ref_smoke("granite-3-8b"), dtype="float32",
                               param_dtype="float32")
    tcfg = TrainConfig(optimizer=OptimizerConfig(
        learning_rate=LR, warmup_steps=1, total_steps=STEPS), remat=False)
    params = init_model(jax.random.PRNGKey(0), rcfg)
    opt = adamw_init(params, tcfg.optimizer)

    def port(params, opt):
        return train_state_from_reference(
            cfg, jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, opt))[0]

    out = {"state": {k: v.numpy() for k, v in port(params, opt).items()}}
    step = jax.jit(make_train_step(rcfg, tcfg))
    metrics = []
    for i in range(STEPS):
        params, opt, m = step(params, opt,
                              ref_batch(rcfg, BATCH, SEQ, seed=17, step=i))
        metrics.append(m)
    for key in ("loss", "grad_norm", "ce", "z_loss"):
        out[key] = np.array([float(m[key]) for m in metrics])
    out["params"] = {k: v.numpy() for k, v in port(params, opt).items()}
    return out


def _spawn(calls, n):
    from repro_torch.launch.mesh import run_each, spawn_ranks

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        return spawn_ranks(run_each, n, backend="gloo", device="cpu",
                           args=(calls,), timeout=300)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, reference):
    """{case: [each rank's placed_train_step result]}, the launcher's
    checkpoints and the elastic restore's ranks."""
    from repro_torch.distributed.sharding import placed_train_step
    from repro_torch.launch.train import rank_main, restore_onto

    tmp = tmp_path_factory.mktemp("placed")
    straight, resumed = str(tmp / "straight"), str(tmp / "resumed")
    out = {"dirs": (straight, resumed)}
    for world, mesh in ((2, (2, 1)), (4, (2, 2))):
        names = [c for c, v in CASES.items() if v[1] == mesh]
        calls = []
        for name in names:
            arch, _, accum, remat = CASES[name]
            cfg = _config(arch)
            calls.append((placed_train_step, (
                cfg, mesh, _batches(cfg), _train_config(accum, remat))))
        if mesh == (2, 1):
            cfg = _config("granite-3-8b")
            calls.append((placed_train_step, (
                cfg, mesh, _batches(cfg), _train_config(), reference["state"],
                True, True)))
            names.append(REFERENCE)
            calls.append((rank_main, (LAUNCH + ["--ckpt-dir", straight],)))
        results = _spawn(calls, world)
        for i, name in enumerate(names):
            out[name] = [r[i] for r in results]
    os.makedirs(resumed)
    shutil.copytree(os.path.join(straight, "step_000000000002"),
                    os.path.join(resumed, "step_000000000002"))
    out["restore"] = _spawn([
        (rank_main, (LAUNCH + ["--ckpt-dir", resumed, "--resume"],)),
        (restore_onto, (straight, "granite-3-8b", (1, 2)))], 2)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_placed_steps_equal_one_process(runs, case):
    ranks = runs[case]
    mesh = CASES[case][1]
    assert len(ranks) == mesh[0] * mesh[1]
    for r in ranks:
        d = r["distances"]
        assert d["metrics"][0] <= TOL, d
        assert d["params"][0] <= TOL, d
        assert d["grads"][0] <= GRAD_TOL, d
        assert len(r["metrics"]) == STEPS
        assert all(np.isfinite(m["loss"]) for m in r["metrics"])
    # every rank reports the same global metrics
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    if "deepseek" in case and CASES[case][2] == 1:  # parts: no accumulation
        assert ranks[0]["metrics"][0]["moe_aux"] > 0


def test_placed_step_meets_the_reference(runs, reference):
    """The (2, 1) granite steps from the reference's weights against the
    reference's own ``make_train_step`` (jit, CPU) on the same batches:
    losses and their parts, gradient norms and every rank's parameter
    shards."""
    from repro_torch.distributed.sharding import shard_of
    from repro_torch.launch.mesh import MeshShape

    want = reference
    mesh = MeshShape({"data": 2, "model": 1})
    for r in runs[REFERENCE]:
        for key in ("loss", "grad_norm", "ce", "z_loss"):
            got = np.array([m[key] for m in r["metrics"]])
            err = np.abs(got - want[key]).max() / np.abs(want[key]).max()
            assert err <= TOL, (key, err)
        worst = 0.0
        for n, local in r["params"].items():
            full = torch.from_numpy(want["params"][n])
            ref = shard_of(full, mesh, r["specs"][n], r["coords"]).numpy()
            assert local.shape == ref.shape, n
            worst = max(worst, float(np.abs(local - ref).max()
                                     / np.abs(ref).max()))
        assert worst <= TOL
        assert r["distances"]["params"][0] <= TOL


def test_collectives_recorded_equal_the_schedule(runs):
    """Each placed step's recorded c10d calls equal ``lm_collectives`` for
    the cell: bytes and counts by operation."""
    from repro_torch.launch.analytic import lm_collectives
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.shapes import ShapeCase

    for case, (arch, mesh, accum, remat) in CASES.items():
        want = lm_collectives(
            _config(arch), ShapeCase("placed", SEQ, BATCH, "train"),
            MeshShape({"data": mesh[0], "model": mesh[1]}),
            _train_config(accum, remat))
        for r in runs[case]:
            for got in r["collectives"]:
                assert got == want, (case, got, want)


def test_placed_resume_equals_uninterrupted(runs):
    """The launcher on two ranks: the resumed run's step-4 checkpoint is
    the uninterrupted run's, bit for bit, written once in the reference's
    layout."""
    straight, resumed = runs["dirs"]
    assert runs["restore"][0][0] == runs["restore"][1][0] == 0
    a = os.path.join(straight, "step_000000000004")
    b = os.path.join(resumed, "step_000000000004")
    assert sorted(os.listdir(a)) == ["arrays.npz", "manifest.json"]
    with np.load(os.path.join(a, "arrays.npz")) as fa, \
            np.load(os.path.join(b, "arrays.npz")) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        assert any(k.startswith("opt::m::") for k in fa.files)
        for k in fa.files:
            assert np.array_equal(fa[k], fb[k]), k


def test_elastic_restore_onto_another_mesh(runs):
    """The step-4 checkpoint saved from the (2, 1) placement restored
    onto (1, 2): every leaf its slice of the saved array, placed as its
    spec says on the new mesh; the step counter whole."""
    from repro_torch.distributed.sharding import placements, shard_of
    from repro_torch.launch.mesh import MeshShape

    straight, _ = runs["dirs"]
    mesh = MeshShape({"data": 1, "model": 2})
    ranks = [r[1] for r in runs["restore"]]
    with np.load(os.path.join(straight, "step_000000000004",
                              "arrays.npz")) as f:
        saved = {k: f[k] for k in f.files}
    sharded = 0
    for r in ranks:
        assert r["step"] == 4
        assert sorted(r["leaves"]) == sorted(saved)
        specs = r["specs"]["params"]
        for key, (local, pl) in r["leaves"].items():
            if key == "opt::step":
                assert pl is None and int(local) == 4
                continue
            spec = specs[key.split("::")[-1]]
            assert list(pl) == placements(mesh, spec), key
            want = shard_of(torch.from_numpy(saved[key]), mesh, spec,
                            r["coords"]).numpy()
            assert np.array_equal(local, want), key
            sharded += local.shape != saved[key].shape
    assert sharded > 0  # 'model' cuts some leaves in two
    assert not np.array_equal(ranks[0]["leaves"]["params::embed"][0],
                              ranks[1]["leaves"]["params::embed"][0])
