"""How far placed serving's logits lie from one process's, beside how far
one process's own f32 logits lie from the same weights at f64: the bar of
``tests/test_torch_placed_train.py``'s serving case is a distance that
plain f32 rounding shows too, not a fault of the split.

    PYTHONPATH=src python tests/torch_placed_drift.py [--arch deepseek-v2-236b ...]
        [--mesh DATA MODEL] [--cache-len L --more INDEX ...]
        [--split N] [--train [--grad-accum K] [--remat]]
        [--layers N --seq S --device cuda]

For each arch's smoke model (default: deepseek-v2-236b, grok-1-314b,
granite-3-8b) on the serving case's tokens (4 x 16, seed 5) it runs
``placed_serve`` on gloo ranks of a (data, model) mesh (default (1, 2)) on
the CPU, and one process's prefill and decode step at f32 and at f64 (the
f32 weights widened; the MoE router stays f32). It prints the max relative
distance (over the largest logit) of the placed logits from one process's,
and of each from the f64 ones. ``--cache-len L``: every cache holds L
slots (default: ``placed_serve``'s, S + 1 rounded up to a multiple of the
'model' axis); ``--more``: a further greedy decode step at each slot
given, each fed the step before's token. ``--split N``: the prompt
prefilled in two chunks instead, the second at ``cache_index`` N
(``tests/torch_placed_chunked_prefill.py``), each chunk's last logits
(the cache of ``--cache-len`` slots, default 40).

``--train``: the training cases instead (f32, lr 1e-7, three steps on
``synthetic_batch(cfg, 4, 16, seed=17, step=i)``, as the test runs them):
``placed_train_step`` on the ranks against one process at f32, and one
process at f64 from the same weights widened. It prints the worst
parameter tensor's distance (max relative over the largest, the test's
measure) of the placed shards from one process's, of one process's from
f64's, and of the placed shards from f64's, each with its tensor.

``--layers N``: the full-width config cut to N layers in place of the
smoke one (with ``--seq``, the training batches' length); ``--device
cuda``: the ranks share the card (gloo) and one process runs there, TF32
off (``chip_smoke.py``'s placed phase at full width, f32).
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

ARCHS = ("deepseek-v2-236b", "grok-1-314b", "granite-3-8b")
BATCH, SEQ = 4, 16


def one_process(cfg, tokens, cache_len=SEQ + 1, more=()):
    import torch

    from repro_torch.models import LanguageModel, init_cache
    from repro_torch.train import make_decode_step, make_prefill_step

    model = LanguageModel(cfg, device="cpu")
    cache = init_cache(cfg, BATCH, cache_len, "cpu")
    steps, _ = make_prefill_step(model)(
        {"tokens": torch.as_tensor(tokens)}, cache)
    steps = [steps]
    for index in (SEQ,) + tuple(more):
        tok = steps[-1].argmax(-1)[:, None].to(torch.int32)
        steps.append(make_decode_step(model)(tok, cache, index)[0])
    steps = [x.double().numpy() for x in steps]
    return {"prefill": steps[0], "decode": steps[1], "more": steps[2:]}


def chunked_one_process(cfg, tokens, split, cache_len):
    import torch

    from repro_torch.models import LanguageModel, init_cache

    model = LanguageModel(cfg, device="cpu")
    cache = init_cache(cfg, BATCH, cache_len, "cpu")
    tokens = torch.as_tensor(tokens)
    with torch.inference_mode():
        return [model({"tokens": t}, cache, i, last_only=True)[0][:, -1]
                .double().numpy()
                for t, i in ((tokens[:, :split], 0), (tokens[:, split:],
                                                      split))]


def chunked_drift(cfgs, tokens, mesh, split, cache_len):
    import sys

    from repro_torch.launch.mesh import run_each, spawn_ranks

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_placed_chunked_prefill import placed_chunked_prefill

    ranks = spawn_ranks(run_each, mesh[0] * mesh[1], backend="gloo",
                        device="cpu", args=(
        [(placed_chunked_prefill, (cfg, mesh, t, split, cache_len))
         for cfg, t in zip(cfgs, tokens)],))
    for i, (cfg, t) in enumerate(zip(cfgs, tokens)):
        f32 = chunked_one_process(cfg, t, split, cache_len)
        f64 = chunked_one_process(dataclasses.replace(
            cfg, dtype="float64", param_dtype="float64"), t, split,
            cache_len)
        for j, key in enumerate(("first", "second")):
            placed = ranks[0][i][key].astype(np.float64)
            print(f"{cfg.name} {key} chunk (split {split}, {cache_len} "
                  f"slots): placed {mesh} from one process "
                  f"{dist(placed, f32[j]):.3e}; one process f32 from f64 "
                  f"{dist(f32[j], f64[j]):.3e}; placed from f64 "
                  f"{dist(placed, f64[j]):.3e}")


def dist(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def train_one_process(cfg, batches, tcfg, device="cpu"):
    """One process's parameters after ``batches`` from the model's own
    seeded initialization (at f64: the f32 draws widened), in f64, on the
    host."""
    import torch

    from repro_torch.models import LanguageModel
    from repro_torch.train import adamw_init, make_train_step

    model = LanguageModel(cfg, device=device)
    step = make_train_step(cfg, tcfg)
    opt = adamw_init(dict(model.named_parameters()), tcfg.optimizer)
    for b in batches:
        model, opt, _ = step(model, opt, {k: torch.as_tensor(v)
                                          for k, v in b.items()})
    out = {n: p.detach().double().cpu() for n, p in model.named_parameters()}
    del model, opt, step
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def train_drift(cfgs, mesh, grad_accum, remat, seq=SEQ, device="cpu"):
    import torch

    from repro_torch.data import synthetic_batch
    from repro_torch.distributed.sharding import placed_train_step, shard_of
    from repro_torch.launch.mesh import MeshShape, run_each, spawn_ranks
    from repro_torch.train import OptimizerConfig, TrainConfig

    tcfg = TrainConfig(optimizer=OptimizerConfig(
        learning_rate=1e-7, warmup_steps=1, total_steps=3), remat=remat,
        grad_accum=grad_accum)
    cfgs = [dataclasses.replace(c, dtype="float32", param_dtype="float32")
            for c in cfgs]
    batches = [[synthetic_batch(c, BATCH, seq, seed=17, step=i)
                for i in range(3)] for c in cfgs]
    ranks = spawn_ranks(run_each, mesh[0] * mesh[1], backend="gloo",
                        device=device, args=(
        [(placed_train_step, (c, mesh, b, tcfg, None, True, True))
         for c, b in zip(cfgs, batches)],))
    shape = MeshShape({"data": mesh[0], "model": mesh[1]})

    def worst(got, want):
        return max((float((got[n] - want[n]).abs().max()
                          / want[n].abs().max().clamp_min(1e-30)), n)
                   for n in want)

    for i, (cfg, b) in enumerate(zip(cfgs, batches)):
        f32 = train_one_process(cfg, b, tcfg, device)
        f64 = train_one_process(dataclasses.replace(
            cfg, dtype="float64", param_dtype="float64"), b, tcfg, device)
        r = ranks[0][i]
        placed = {n: torch.from_numpy(v).double()
                  for n, v in r["params"].items()}

        def cut(full):
            return {n: shard_of(p, shape, r["specs"][n], r["coords"])
                    for n, p in full.items()}

        print(f"{cfg.name} ({cfg.num_layers} layers, seq {seq}, on "
              f"{device}) train {mesh} grad_accum {grad_accum} remat "
              f"{remat}: parameters, worst tensor: placed from one process "
              f"{r['distances']['params']}; one process f32 from f64 "
              f"{worst(f32, f64)}; placed from f64 "
              f"{worst(placed, cut(f64))}")


def main(argv=None):
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import placed_serve
    from repro_torch.launch.mesh import run_each, spawn_ranks
    from repro_torch.models import layers

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=list(ARCHS))
    ap.add_argument("--mesh", nargs=2, type=int, default=(1, 2))
    ap.add_argument("--cache-len", type=int, default=None)
    ap.add_argument("--more", nargs="*", type=int, default=[])
    ap.add_argument("--split", type=int, default=None)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    mesh = tuple(args.mesh)
    if args.layers is None:
        cfgs = [get_smoke_config(a) for a in args.arch]
    else:
        from repro_torch.configs import get_config

        cfgs = [dataclasses.replace(get_config(a), num_layers=args.layers)
                for a in args.arch]
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    layers.DTYPES.setdefault("float64", torch.float64)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.train:
        train_drift(cfgs, mesh, args.grad_accum, args.remat, args.seq,
                    args.device)
        return
    tokens = [np.random.default_rng(5).integers(
        0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32) for cfg in cfgs]
    if args.split is not None:
        chunked_drift(cfgs, tokens, mesh, args.split, args.cache_len or 40)
        return
    ranks = spawn_ranks(run_each, mesh[0] * mesh[1], backend="gloo",
                        device="cpu", args=(
        [(placed_serve, (cfg, mesh, t, None, args.cache_len,
                          tuple(args.more)))
         for cfg, t in zip(cfgs, tokens)],))
    for i, (cfg, t) in enumerate(zip(cfgs, tokens)):
        r = ranks[0][i]
        cut = (r["cache_len"], tuple(args.more))
        f32 = one_process(cfg, t, *cut)
        f64 = one_process(dataclasses.replace(
            cfg, dtype="float64", param_dtype="float64"), t, *cut)
        keys = [("prefill", lambda x: x["prefill"]),
                ("decode", lambda x: x["decode"])] + [
            (f"decode at {index}", lambda x, j=j: x["more"][j])
            for j, index in enumerate(args.more)]
        for key, of in keys:
            placed = of(r).astype(np.float64)
            print(f"{cfg.name} {key} ({r['cache_len']} slots): placed "
                  f"{mesh} from one process {dist(placed, of(f32)):.3e}; "
                  f"one process f32 from f64 {dist(of(f32), of(f64)):.3e}; "
                  f"placed from f64 {dist(placed, of(f64)):.3e}")


if __name__ == "__main__":
    main()
