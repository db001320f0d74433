"""Placed serving's step times, peaks, cache and collectives on two gloo
ranks, for comparing two trees of the port in one call on one card.

    PYTHONPATH=<tree>/src python tests/torch_placed_serve_time.py
        [--label NAME] [--arch deepseek-v2-236b ...] [--layers 2 ...]
        [--batch 4] [--seq 512] [--repeat 3] [--device cuda] [--smoke]

For each arch (its full-width config cut to the matching ``--layers``,
bf16, as ``chip_smoke.py``'s placed phase serves it) it runs
``placed_serve`` ``--repeat`` times in one group of ranks on (1, 2): a
prefill of ``--batch`` x ``--seq`` seeded tokens and one greedy decode
step, each run building its model anew; the first run's clocks hold the
first calls. It prints one JSON line: the label, and for each arch and
run each rank's prefill and decode ms (host clock, ended by a device
synchronize), their peak device bytes, the collectives recorded in each
step (bytes and counts by operation), the bytes of the rank's attention
cache where the tree reports them, and the first row's logits' argmax.
``PYTHONPATH`` picks the tree measured (``placed_serve(rank, cfg, mesh,
tokens)`` is all it calls); run trees in the order A, B, B, A to see the
drift between calls. ``--smoke``: the smoke configs (with ``--device
cpu --seq 16``, a rehearsal on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

STEPS = ("prefill", "decode")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--arch", nargs="+",
                    default=["deepseek-v2-236b", "recurrentgemma-2b"])
    ap.add_argument("--layers", nargs="+", type=int, default=[2, 5])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    if len(args.layers) != len(args.arch):
        ap.error("one --layers a --arch")

    import numpy as np

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed.sharding import placed_serve
    from repro_torch.launch.mesh import run_each, spawn_ranks

    calls, cfgs = [], []
    for arch, layers in zip(args.arch, args.layers):
        full = (get_smoke_config if args.smoke else get_config)(arch)
        cfg = dataclasses.replace(full, num_layers=layers)
        tokens = np.random.default_rng(5).integers(
            0, cfg.vocab_size, (args.batch, args.seq)).astype(np.int32)
        cfgs.append(cfg)
        calls += [(placed_serve, (cfg, (1, 2), tokens))] * args.repeat
    if args.device == "cpu":
        os.environ.setdefault("OMP_NUM_THREADS", "1")
    ranks = spawn_ranks(run_each, 2, backend="gloo", device=args.device,
                        args=(calls,), timeout=600)
    out = {"label": args.label, "batch": args.batch, "seq": args.seq,
           "runs": []}
    for j, (fn, (cfg, mesh, _)) in enumerate(calls):
        run = {"arch": cfg.name, "layers": cfg.num_layers, "ranks": []}
        for rank in ranks:
            r = rank[j]
            run["ranks"].append({
                "ms": {k: r["step_s"][k] * 1e3 for k in STEPS},
                "peak_device_bytes": {k: r["peak_device_bytes"][k]
                                      for k in STEPS},
                "collective_bytes": {k: r["collectives"][k].bytes_by_op
                                     for k in STEPS},
                "collective_counts": {k: r["collectives"][k].count_by_op
                                      for k in STEPS},
                "attention_cache_bytes": r.get("attention_cache_bytes"),
                "cache_shapes": r["cache_shapes"][
                    cfg.layer_kinds.index("attn")],
                "argmax": {k: int(r[k][0].argmax()) for k in STEPS}})
        out["runs"].append(run)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
