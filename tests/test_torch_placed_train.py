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
grad_accum 2 and remat; (1, 2), tensor parallelism alone, for
recurrentgemma-2b with grad_accum 2 and remat (its one KV head
replicated, its RG-LRU blocks whole, its MLPs and vocab split). One (2, 1)
and one (1, 2) granite run start from the reference's weights
(``interop.train_state_from_reference``) and meet the reference's own
``make_train_step`` on the same batches. Placed serving on (1, 2) (a
prefill and a decode step with the head-sharded cache) meets one process
for granite and recurrentgemma.

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
    "recurrentgemma-2b (1,2) accum2 remat": ("recurrentgemma-2b", (1, 2), 2,
                                             True),
}
# mesh -> its run from the reference's weights
REFERENCE = {(2, 1): "granite-3-8b (2,1) from the reference's weights",
             (1, 2): "granite-3-8b (1,2) from the reference's weights"}
SERVE = ("granite-3-8b", "recurrentgemma-2b")  # placed serving on (1, 2)
SERVE_TOL = 1e-6
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


def _serve_tokens(arch):
    from repro_torch.configs import get_smoke_config

    return np.random.default_rng(5).integers(
        0, get_smoke_config(arch).vocab_size, (BATCH, SEQ)).astype(np.int32)


def _case_calls(mesh, reference):
    """The placed_train_step calls of ``mesh``'s cases and its run from the
    reference's weights, with their names."""
    from repro_torch.distributed.sharding import placed_train_step

    names = [c for c, v in CASES.items() if v[1] == mesh]
    calls = []
    for name in names:
        arch, _, accum, remat = CASES[name]
        cfg = _config(arch)
        calls.append((placed_train_step, (
            cfg, mesh, _batches(cfg), _train_config(accum, remat))))
    if mesh in REFERENCE:
        cfg = _config("granite-3-8b")
        calls.append((placed_train_step, (
            cfg, mesh, _batches(cfg), _train_config(), reference["state"],
            True, True)))
        names.append(REFERENCE[mesh])
    return names, calls


@pytest.fixture(scope="module")
def runs(tmp_path_factory, reference):
    """{case: [each rank's placed_train_step result]}, the launcher's
    checkpoints, the elastic restore's ranks, a placed forward on (2, 2)
    (``forward (2,2)``) and placed serving on (1, 2) (``serve``: {arch:
    [each rank's placed_serve result]})."""
    from repro_torch.distributed.sharding import placed_forward, placed_serve
    from repro_torch.launch.train import rank_main, restore_onto

    tmp = tmp_path_factory.mktemp("placed")
    straight, resumed = str(tmp / "straight"), str(tmp / "resumed")
    out = {"dirs": (straight, resumed)}
    for world, mesh in ((2, (2, 1)), (4, (2, 2))):
        names, calls = _case_calls(mesh, reference)
        if mesh == (2, 1):
            calls.append((rank_main, (LAUNCH + ["--ckpt-dir", straight],)))
        else:
            calls.append((placed_forward, (
                "granite-3-8b", mesh, _serve_tokens("granite-3-8b"))))
            names.append("forward (2,2)")
        results = _spawn(calls, world)
        for i, name in enumerate(names):
            out[name] = [r[i] for r in results]
    os.makedirs(resumed)
    shutil.copytree(os.path.join(straight, "step_000000000002"),
                    os.path.join(resumed, "step_000000000002"))
    names, calls = _case_calls((1, 2), reference)
    calls += [(placed_serve, (arch, (1, 2), _serve_tokens(arch)))
              for arch in SERVE]
    results = _spawn([
        (rank_main, (LAUNCH + ["--ckpt-dir", resumed, "--resume"],)),
        (restore_onto, (straight, "granite-3-8b", (1, 2)))] + calls, 2)
    out["restore"] = [r[:2] for r in results]
    for i, name in enumerate(names):
        out[name] = [r[2 + i] for r in results]
    out["serve"] = {arch: [r[2 + len(names) + i] for r in results]
                    for i, arch in enumerate(SERVE)}
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


def _meets_the_reference(ranks, reference, mesh_shape):
    """Each rank's steps from the reference's weights against the
    reference's own ``make_train_step`` (jit, CPU) on the same batches:
    losses and their parts, gradient norms and the rank's parameter
    shards."""
    from repro_torch.distributed.sharding import shard_of
    from repro_torch.launch.mesh import MeshShape

    want = reference
    mesh = MeshShape({"data": mesh_shape[0], "model": mesh_shape[1]})
    for r in ranks:
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


def test_placed_step_meets_the_reference(runs, reference):
    """The (2, 1) granite steps from the reference's weights against the
    reference's own steps."""
    _meets_the_reference(runs[REFERENCE[(2, 1)]], reference, (2, 1))


def test_tensor_parallel_step_meets_the_reference(runs, reference):
    """The (1, 2) granite steps from the reference's weights, each rank
    computing its half of the heads, of the FFN and of the vocab, against
    the reference's own steps; each step sends the schedule, in which no
    weight is gathered: the one all-gather is the split head's logits."""
    from repro_torch.launch.analytic import lm_collectives
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.shapes import ShapeCase

    ranks = runs[REFERENCE[(1, 2)]]
    _meets_the_reference(ranks, reference, (1, 2))
    cfg = _config("granite-3-8b")
    want = lm_collectives(cfg, ShapeCase("placed", SEQ, BATCH, "train"),
                          MeshShape({"data": 1, "model": 2}),
                          _train_config())
    logits = BATCH * SEQ * cfg.vocab_size * 4
    assert want.count_by_op["all-gather"] == 1
    assert want.bytes_by_op["all-gather"] == logits
    for r in ranks:
        assert r["collectives"] == [want] * STEPS


def test_split_ranks_compute_with_their_shards(runs):
    """A placed forward of granite-3-8b's smoke model (4 heads, 2 KV heads,
    d_ff 128) on (2, 2): each rank's projections give its own batch rows
    and its half of the heads, of the KV heads and of the FFN; the row-
    parallel ``wo`` outputs whole (summed) rows; the logits meet one
    process."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LanguageModel, forward

    cfg = get_smoke_config("granite-3-8b")
    rows, hd = BATCH // 2, cfg.head_dim
    want = {"inner.wq": cfg.num_heads // 2 * hd,
            "inner.wk": cfg.num_kv_heads // 2 * hd,
            "inner.wv": cfg.num_kv_heads // 2 * hd,
            "inner.wo": cfg.d_model,
            "mlp.wi": cfg.d_ff // 2, "mlp.wg": cfg.d_ff // 2,
            "mlp.wo": cfg.d_model}
    model = LanguageModel(cfg, device="cpu")
    with torch.inference_mode():
        logits = forward(model, {"tokens": torch.as_tensor(
            _serve_tokens("granite-3-8b"))})[0].numpy()
    for r in runs["forward (2,2)"]:
        for layer in range(cfg.num_layers):
            for name, width in want.items():
                assert r["out_shapes"][f"blocks.{layer}.{name}"] == (
                    rows, SEQ, width), name
        err = np.abs(r["logits"] - logits).max() / np.abs(logits).max()
        assert err <= SERVE_TOL


def test_placed_serving_on_model_ranks_is_one_process(runs):
    """Placed serving on (1, 2): a prefill and a decode step with the
    head-sharded cache (granite's two KV heads one a rank;
    recurrentgemma's one KV head replicated, its RG-LRU states whole)
    within SERVE_TOL of one process, each step's collectives the
    schedule's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.analytic import lm_collectives
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.shapes import ShapeCase
    from repro_torch.models import LanguageModel, init_cache
    from repro_torch.train import make_decode_step, make_prefill_step

    mesh = MeshShape({"data": 1, "model": 2})
    for arch in SERVE:
        cfg = get_smoke_config(arch)
        tokens = _serve_tokens(arch)
        model = LanguageModel(cfg, device="cpu")
        cache = init_cache(cfg, BATCH, SEQ + 1, "cpu")
        prefill, _ = make_prefill_step(model)(
            {"tokens": torch.as_tensor(tokens)}, cache)
        tok = prefill.argmax(-1)[:, None].to(torch.int32)
        decode, _ = make_decode_step(model)(tok, cache, SEQ)
        want = {"prefill": prefill.numpy(), "decode": decode.numpy()}
        heads = cfg.num_kv_heads // 2 or 1
        for r in runs["serve"][arch]:
            for key in ("prefill", "decode"):
                assert r[key].shape == want[key].shape
                err = (np.abs(r[key] - want[key]).max()
                       / np.abs(want[key]).max())
                assert err <= SERVE_TOL, (arch, key, err)
                assert r["collectives"][key] == lm_collectives(
                    cfg, ShapeCase(key, SEQ, BATCH, key), mesh)
            for layer, kind in zip(r["cache_shapes"], cfg.layer_kinds):
                if kind == "attn":
                    assert layer["k"][2] == layer["v"][2] == heads, arch


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
