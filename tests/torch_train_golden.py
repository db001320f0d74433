"""Golden training runs of the reference's LM smoke configs, for the port
to meet on the card, where there is no JAX.

    PYTHONPATH=src python tests/torch_train_golden.py   # rewrites the file

For every entry of :data:`ENTRIES` (the ten smoke configs, and granite-3-8b
again with ``grad_accum`` 2 and ``remat``) the reference (``repro``, on the
CPU, f32) takes :data:`STEPS` AdamW steps from the seeded numpy weights of
``repro_torch.interop.random_lm_state(cfg, SEED)`` on
``synthetic_batch(cfg, BATCH, SEQ, seed=DATA_SEED, step=i)``, and
``tests/data/torch_train_golden.npz`` keeps, under ``<entry>/<key>``: each
step's ``loss`` and ``grad_norm`` (and, without accumulation, ``ce``,
``z_loss`` and ``moe_aux``), and ``params/<name>``, every final parameter
by the port's state-dict name. ``tests/test_torch_train.py`` recomputes
entries with the reference and compares them with the file, so it cannot
go stale; it and ``chip_smoke.py`` hold the port to it.

The learning rate is :data:`LR` (1e-4): AdamW's first step divides a
gradient by its own magnitude plus eps, so an element whose clipped
gradient is near eps (1e-8) moves by a fraction of the learning rate that
f32 rounding noise decides (a 4.6e-8 element carrying 4% of noise between
two f32 implementations moves 0.7% of lr apart); the parameters' distance
between two implementations scales with the learning rate.

:func:`reference_run` (and :func:`cached_reference`) import JAX and the
reference; :func:`load`, :func:`entry`, :func:`train_config`,
:func:`port_run`, :func:`distances` and the comparisons do not.
"""
from __future__ import annotations

import os
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "torch_train_golden.npz"
ARCHS = ("granite-3-8b", "qwen2-vl-2b", "hubert-xlarge", "qwen1.5-32b",
         "mistral-large-123b", "nemotron-4-340b", "recurrentgemma-2b",
         "rwkv6-1.6b", "deepseek-v2-236b", "grok-1-314b")
# entry -> (arch, grad_accum, remat)
ENTRIES = {**{a: (a, 1, False) for a in ARCHS},
           "granite-3-8b:accum2-remat": ("granite-3-8b", 2, True)}
SEED, DATA_SEED, BATCH, SEQ, STEPS, LR = 0, 17, 4, 16, 3, 1e-4
PARTS = ("ce", "z_loss", "moe_aux")


def load(path=GOLDEN) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def optimizer_fields() -> dict:
    return dict(learning_rate=LR, warmup_steps=1, total_steps=STEPS)


def train_config(grad_accum: int = 1, remat: bool = False):
    """The port's ``TrainConfig`` of an entry."""
    from repro_torch.train import OptimizerConfig, TrainConfig

    return TrainConfig(optimizer=OptimizerConfig(**optimizer_fields()),
                       remat=remat, grad_accum=grad_accum)


def _record(out: dict, metrics: list, accum: int) -> None:
    keys = ("loss", "grad_norm") + (PARTS if accum == 1 else ())
    for k in keys:
        out[k] = np.array([float(m[k]) for m in metrics], np.float32)


def reference_run(arch: str, grad_accum: int = 1, remat: bool = False,
                  seed: int = SEED, keep_state: bool = False,
                  **changes) -> dict:
    """The reference's golden entry (numpy): per-step metrics and
    ``params`` (the port's names). With ``keep_state`` also ``start``
    (params and AdamW state after the first step, numpy pytrees in the
    reference's layout) and ``opt`` (the final moments by the port's
    names), which the file does not keep. ``changes`` replace config
    fields (e.g. ``moe_impl="sort"``)."""
    import dataclasses

    import jax

    from repro.configs import get_smoke_config
    from repro.data import synthetic_batch
    from repro.train import OptimizerConfig, TrainConfig, adamw_init
    from repro.train import make_train_step
    from repro_torch.interop import random_lm_state, train_state_from_reference
    from torch_lm_golden import reference_params

    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    params = reference_params(cfg, random_lm_state(cfg, seed))
    tcfg = TrainConfig(optimizer=OptimizerConfig(**optimizer_fields()),
                       remat=remat, grad_accum=grad_accum)
    opt = adamw_init(params, tcfg.optimizer)
    step = jax.jit(make_train_step(cfg, tcfg))
    metrics, out = [], {}
    for i in range(STEPS):
        batch = synthetic_batch(cfg, BATCH, SEQ, seed=DATA_SEED, step=i)
        params, opt, m = step(params, opt, batch)
        metrics.append(m)
        if i == 0 and keep_state:
            out["start"] = jax.tree.map(np.asarray, (params, opt))
    _record(out, metrics, grad_accum)
    state, moments = train_state_from_reference(
        cfg, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt))
    out["params"] = {k: v.numpy() for k, v in state.items()}
    if keep_state:
        out["opt"] = {k: {n: t.numpy() for n, t in moments[k].items()}
                      for k in ("m", "v")}
    return out


def port_run(arch: str, device, grad_accum: int = 1, remat: bool = False,
             seed: int = SEED, start=None, first: int = 0, **changes):
    """The port's run of an entry on ``device`` from ``random_lm_state``
    (or from ``start``: a ``(state_dict, opt_state)`` pair, taking the
    steps from ``first`` on). Returns ``(out, model, opt_state)``, ``out``
    shaped as :func:`reference_run`'s."""
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.interop import random_lm_state
    from repro_torch.models import LanguageModel
    from repro_torch.train import adamw_init, make_train_step

    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    tcfg = train_config(grad_accum, remat)
    model = LanguageModel(cfg, device=device)
    if start is None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               random_lm_state(cfg, seed).items()})
        opt = adamw_init(dict(model.named_parameters()), tcfg.optimizer)
    else:
        model.load_state_dict(start[0])
        opt = {"m": {k: v.to(device) for k, v in start[1]["m"].items()},
               "v": {k: v.to(device) for k, v in start[1]["v"].items()},
               "step": start[1]["step"].to(device)}
    step = make_train_step(cfg, tcfg)
    metrics = []
    for i in range(first, STEPS):
        batch = synthetic_batch(cfg, BATCH, SEQ, seed=DATA_SEED, step=i)
        model, opt, m = step(model, opt, batch)
        metrics.append(m)
    out = {}
    _record(out, metrics, grad_accum)
    out["params"] = {k: v.detach().cpu().numpy()
                     for k, v in model.state_dict().items()}
    return out, model, opt


def flat(entry: str, run: dict) -> dict:
    """A run as the file's arrays of ``entry``."""
    arrays = {f"{entry}/{k}": v for k, v in run.items()
              if isinstance(v, np.ndarray)}
    arrays.update({f"{entry}/params/{k}": v
                   for k, v in run["params"].items()})
    return arrays


def entry(stored: dict, name: str) -> dict:
    """The file's entry ``name`` shaped as a run."""
    pre = name + "/"
    out = {"params": {}}
    for k, v in stored.items():
        if k.startswith(pre + "params/"):
            out["params"][k[len(pre + "params/"):]] = v
        elif k.startswith(pre):
            out[k[len(pre):]] = v
    return out


def rel(got, want) -> float:
    """Max relative distance: over elements, over ``want``'s largest."""
    import torch

    if isinstance(got, torch.Tensor):
        got = got.detach().float().cpu().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def cached_reference(cache: dict, arch: str, grad_accum: int = 1,
                     remat: bool = False, **changes) -> dict:
    """:func:`reference_run` with its state after the first step kept,
    computed once per ``cache`` (a test module's)."""
    key = (arch, grad_accum, remat, tuple(sorted(changes.items())))
    if key not in cache:
        cache[key] = reference_run(arch, grad_accum, remat, keep_state=True,
                                   **changes)
    return cache[key]


def assert_runs_close(got: dict, want: dict, tol: float) -> None:
    """A port run against a reference run or entry: the same metrics and
    parameter names, each within ``tol`` (:func:`rel`)."""
    assert sorted(k for k in got if k != "params") == sorted(
        k for k in want if k not in ("params", "start", "opt"))
    for k, v in got.items():
        if k != "params":
            assert rel(v, want[k]) < tol, k
    assert sorted(got["params"]) == sorted(want["params"])
    worst = max((rel(v, want["params"][n]), n)
                for n, v in got["params"].items())
    assert worst[0] < tol, worst


def distances(device) -> dict:
    """Every entry of the file through the port on ``device``: {entry:
    {metric or "params": max relative distance (:func:`rel`)}}."""
    stored = load()
    out = {}
    for name, (arch, accum, remat) in ENTRIES.items():
        want = entry(stored, name)
        got, _, _ = port_run(arch, device, accum, remat)
        errs = {k: rel(v, want[k]) for k, v in got.items() if k != "params"}
        errs["params"] = max(rel(v, want["params"][n])
                             for n, v in got["params"].items())
        out[name] = errs
    return out


def main() -> int:
    import jax

    jax.config.update("jax_enable_x64", True)  # as the test suite runs it
    arrays = {}
    for name, (arch, accum, remat) in ENTRIES.items():
        arrays.update(flat(name, reference_run(arch, accum, remat)))
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **arrays)
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size:,} bytes, "
          f"{len(arrays)} arrays)")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    sys.exit(main())
