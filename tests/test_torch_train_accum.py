"""The LM training path against the reference, continued from
``test_torch_train.py`` (which holds the tolerances' story): gradient
accumulation (``grad_accum`` 4 against the reference's), the sort
dispatch's backward, ``remat`` (equal to the plain step; blocks'
activations not kept), the golden file's accumulated entry and the
training launcher (``--smoke --device cpu``; its resume bit-equal to an
uninterrupted run; CUDA required without ``--device cpu``). Measured
here: parameters within 5.7e-6 of the reference's (deepseek with
grad_accum 4), bar 1e-5; ``remat`` bit-equal."""
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_train_golden as golden  # noqa: E402

pytestmark = pytest.mark.torch_port

TOL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]
_REF: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several workers a machine, whose thread pools would oversubscribe its
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(arch, grad_accum=1, remat=False, **changes):
    return golden.cached_reference(_REF, arch, grad_accum, remat, **changes)


# ------------------------------------------------------ accumulation ----
@pytest.mark.parametrize("arch", ["granite-3-8b", "deepseek-v2-236b"])
def test_grad_accum_matches_reference(arch):
    """grad_accum 4 (contiguous microbatches of one row, an f32
    accumulator, the loss their mean) against the reference's."""
    ref = _reference(arch, grad_accum=4)
    got, _, _ = golden.port_run(arch, "cpu", grad_accum=4)
    assert "ce" not in got  # the parts of a microbatched step are empty
    golden.assert_runs_close(got, ref, TOL)


def test_sort_dispatch_backward_matches_reference():
    """deepseek-v2's smoke config with ``moe_impl="sort"``: the sort
    dispatch's scatter into the slot buffer (the overflow slot taking
    duplicate writes of zeros) back-propagates as the reference's."""
    ref = _reference("deepseek-v2-236b", moe_impl="sort")
    got, _, _ = golden.port_run("deepseek-v2-236b", "cpu", moe_impl="sort")
    golden.assert_runs_close(got, ref, TOL)


@pytest.mark.parametrize("arch", ["granite-3-8b", "deepseek-v2-236b",
                                  "recurrentgemma-2b"])
def test_remat_is_the_plain_step(arch):
    """``remat`` recomputes each block in backward: the same numbers."""
    plain, _, _ = golden.port_run(arch, "cpu", grad_accum=2)
    remat, _, _ = golden.port_run(arch, "cpu", grad_accum=2, remat=True)
    for k in ("loss", "grad_norm"):
        np.testing.assert_array_equal(remat[k], plain[k])
    for n, v in plain["params"].items():
        np.testing.assert_array_equal(remat["params"][n], v)


def test_remat_checkpoints_blocks():
    """Under ``remat`` a block's activations are not kept for backward:
    fewer saved tensors than the plain forward's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.models import LanguageModel
    from repro_torch.train import loss_fn
    from repro_torch.train.train_step import trainable

    cfg = get_smoke_config("granite-3-8b")
    model = LanguageModel(cfg, device="cpu")
    trainable(model)
    batch = synthetic_batch(cfg, 2, 16, seed=1)
    counts = {}
    for remat in (False, True):
        n = [0]

        def pack(t):
            n[0] += 1
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss_fn(model, batch, golden.train_config(remat=remat))
        counts[remat] = n[0]
    assert counts[True] < counts[False] / 2, counts
    with pytest.raises(ValueError, match="no cache"):
        from repro_torch.models import init_cache

        model(batch, init_cache(cfg, 2, 16, "cpu"), remat=True)


def test_golden_accum_entry_is_the_reference_s():
    """The stored grad_accum 2 + remat entry is what the reference
    computes now."""
    name = "granite-3-8b:accum2-remat"
    arch, accum, remat = golden.ENTRIES[name]
    stored = golden.entry(golden.load(), name)
    ref = _reference(arch, accum, remat)
    golden.assert_runs_close(stored, ref, 1e-6)


# ---------------------------------------------------------- launcher ----
def _launch(*args, cwd=None):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})


def test_launcher_trains_and_resumes(tmp_path):
    """``--smoke --device cpu`` prints the reference's ``[train]`` lines;
    four steps straight equal two, a checkpoint, a restore and two more
    (the step-4 checkpoints bit-equal)."""
    flags = ["--arch", "granite-3-8b", "--smoke", "--steps", "4",
             "--device", "cpu", "--log-every", "1", "--ckpt-every", "2"]
    a, b = tmp_path / "a", tmp_path / "b"
    run = _launch(*flags, "--ckpt-dir", str(a))
    assert run.returncode == 0, run.stderr
    lines = [ln for ln in run.stdout.splitlines()
             if ln.startswith("[train] step=")]
    assert len(lines) == 4
    for ln in lines:
        for key in ("loss=", "lr=", "gnorm=", "dt=", "ms stragglers=[]"):
            assert key in ln, ln
    assert "tokens/s" in run.stdout and "peak device bytes" in run.stdout
    # resume: only the step-2 checkpoint of the first run
    b.mkdir()
    (a / "step_000000000002").rename(b / "step_000000000002")
    run = _launch(*flags, "--ckpt-dir", str(b), "--resume")
    assert run.returncode == 0, run.stderr
    assert "resumed from step 2" in run.stdout
    with np.load(a / "step_000000000004" / "arrays.npz") as fa, \
            np.load(b / "step_000000000004" / "arrays.npz") as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            np.testing.assert_array_equal(fa[k], fb[k])


def test_launcher_requires_cuda_without_device_cpu():
    run = _launch("--arch", "granite-3-8b", "--smoke", "--steps", "1")
    assert run.returncode != 0
    assert "CUDA is not available" in run.stderr
