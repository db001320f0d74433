"""Placed training's step time and peak on two gloo ranks, for comparing
two trees of the port in one call on one card.

    PYTHONPATH=<tree>/src python tests/torch_placed_step_time.py
        [--label NAME] [--arch granite-3-8b] [--layers 2] [--mesh 1 2]
        [--batch 4] [--seq 512] [--steps 4] [--device cuda] [--smoke]

It builds the full-width config cut to ``--layers`` (f32, remat, lr 1e-7,
as ``chip_smoke.py``'s placed phase runs it), runs ``placed_train_step``
without the one-process check on ``synthetic_batch(cfg, batch, seq,
seed=17, step=i)`` on the ranks of a (data, model) mesh, and prints one
JSON line: the label, each rank's step ms, its peak device bytes a step,
the collectives it recorded in the last step (bytes and counts by
operation) and the losses. ``PYTHONPATH`` picks the tree measured; run
trees in the order A, B, B, A to see the drift between calls.
``--smoke``: the smoke config (with ``--device cpu --seq 16``, a rehearsal
on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--mesh", nargs=2, type=int, default=(1, 2))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.distributed.sharding import placed_train_step
    from repro_torch.launch.mesh import run_each, spawn_ranks
    from repro_torch.train import OptimizerConfig, TrainConfig

    full = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = dataclasses.replace(full, num_layers=args.layers,
                              dtype="float32", param_dtype="float32")
    tcfg = TrainConfig(optimizer=OptimizerConfig(
        learning_rate=1e-7, warmup_steps=1, total_steps=args.steps),
        remat=True)
    batches = [synthetic_batch(cfg, args.batch, args.seq, seed=17, step=i)
               for i in range(args.steps)]
    mesh = tuple(args.mesh)
    if args.device == "cpu":
        os.environ.setdefault("OMP_NUM_THREADS", "1")
    ranks = spawn_ranks(run_each, mesh[0] * mesh[1], backend="gloo",
                        device=args.device,
                        args=([(placed_train_step, (cfg, mesh, batches, tcfg,
                                                    None, False))],),
                        timeout=600)
    out = {"label": args.label, "arch": cfg.name, "layers": args.layers,
           "mesh": mesh, "batch": args.batch, "seq": args.seq, "ranks": []}
    for (r,) in ranks:
        last = r["collectives"][-1]
        out["ranks"].append({
            "step_ms": [t * 1e3 for t in r["step_s"]],
            "peak_device_bytes": r["peak_device_bytes"],
            "collective_bytes": last.bytes_by_op,
            "collective_counts": last.count_by_op,
            "losses": [m["loss"] for m in r["metrics"]]})
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
