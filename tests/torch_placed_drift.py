"""How far placed serving's logits lie from one process's, beside how far
one process's own f32 logits lie from the same weights at f64: the bar of
``tests/test_torch_placed_train.py``'s serving case is a distance that
plain f32 rounding shows too, not a fault of the split.

    PYTHONPATH=src python tests/torch_placed_drift.py [--arch deepseek-v2-236b ...]

For each arch's smoke model (default: deepseek-v2-236b, grok-1-314b,
granite-3-8b) on the serving case's tokens (4 x 16, seed 5) it runs
``placed_serve`` on two gloo ranks of a (data=1, model=2) mesh on the CPU,
and one process's prefill and decode step at f32 and at f64 (the f32
weights widened; the MoE router stays f32). It prints the max relative
distance (over the largest logit) of the placed logits from one process's,
and of each from the f64 ones.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

ARCHS = ("deepseek-v2-236b", "grok-1-314b", "granite-3-8b")
BATCH, SEQ = 4, 16


def one_process(cfg, tokens):
    import torch

    from repro_torch.models import LanguageModel, init_cache
    from repro_torch.train import make_decode_step, make_prefill_step

    model = LanguageModel(cfg, device="cpu")
    cache = init_cache(cfg, BATCH, SEQ + 1, "cpu")
    prefill, _ = make_prefill_step(model)(
        {"tokens": torch.as_tensor(tokens)}, cache)
    tok = prefill.argmax(-1)[:, None].to(torch.int32)
    decode, _ = make_decode_step(model)(tok, cache, SEQ)
    return {"prefill": prefill.double().numpy(),
            "decode": decode.double().numpy()}


def dist(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def main(argv=None):
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import placed_serve
    from repro_torch.launch.mesh import run_each, spawn_ranks
    from repro_torch.models import layers

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=list(ARCHS))
    args = ap.parse_args(argv)
    cfgs = [get_smoke_config(a) for a in args.arch]
    tokens = [np.random.default_rng(5).integers(
        0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32) for cfg in cfgs]
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    ranks = spawn_ranks(run_each, 2, backend="gloo", device="cpu", args=(
        [(placed_serve, (cfg, (1, 2), t)) for cfg, t in zip(cfgs, tokens)],))
    layers.DTYPES.setdefault("float64", torch.float64)
    for i, (cfg, t) in enumerate(zip(cfgs, tokens)):
        f32 = one_process(cfg, t)
        f64 = one_process(dataclasses.replace(
            cfg, dtype="float64", param_dtype="float64"), t)
        for key in ("prefill", "decode"):
            placed = ranks[0][i][key].astype(np.float64)
            print(f"{cfg.name} {key}: placed (1, 2) from one process "
                  f"{dist(placed, f32[key]):.3e}; one process f32 from f64 "
                  f"{dist(f32[key], f64[key]):.3e}; placed from f64 "
                  f"{dist(placed, f64[key]):.3e}")


if __name__ == "__main__":
    main()
