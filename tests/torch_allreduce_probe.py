"""Time one all-reduce of a dual (λ) vector between gloo ranks, as the
sharded FETI solve makes six a PCPG iteration (``repro_torch.feti.sharded``).

    PYTHONPATH=src python3 tests/torch_allreduce_probe.py [--ranks 2]
        [--n 7744] [--reps 300] [--device cuda|cpu]

Starts the ranks with :func:`repro_torch.launch.mesh.spawn_ranks` (gloo;
on one card every rank shares it) and times, on each rank, ``--reps``
all-reduces of an ``--n``-long f64 vector (7744: feti-heat-2d's
multipliers) through ``FetiMesh.all_reduce``, after 20 unmeasured ones,
three ways: the vector on the card, the same vector on the host, and on
the card with a small product on the card before each all-reduce (the
device work PCPG puts between two of them). Prints the median and mean
host microseconds of one call per rank and way, and the card's name and
power limit. It measures the exchange, not FETI: the solve's own numbers
come from the launcher (``--devices``).
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def probe(mesh, n, reps):
    """One rank's timings: {way: [seconds of each call]}."""
    import torch

    out = {}
    ways = [("host", torch.device("cpu"), False)]
    if mesh.device.type == "cuda":
        ways = [("card", mesh.device, False), *ways,
                ("card after a product", mesh.device, True)]
    for name, dev, work in ways:
        x = torch.ones(n, dtype=torch.float64, device=dev)
        A = torch.ones(256, 256, dtype=torch.float64, device=dev)
        times = []
        for i in range(20 + reps):
            if work:
                A = A @ A * (1.0 / 256)
            t0 = time.perf_counter()
            mesh.all_reduce(x)
            if i >= 20:
                times.append(time.perf_counter() - t0)
        out[name] = times
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--n", type=int, default=7744)
    p.add_argument("--reps", type=int, default=300)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    from repro_torch.launch import mesh as meshlib

    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(), flush=True)
    backend, devices = meshlib.rank_devices(args.ranks, "gloo", args.device)
    print(f"[probe] {meshlib.describe(backend, devices)}; {args.reps} "
          f"all-reduces of {args.n} f64 a way", flush=True)
    ranks = meshlib.spawn_ranks(probe, args.ranks, backend="gloo",
                                device=args.device, args=(args.n, args.reps))
    for rank, ways in enumerate(ranks):
        for way, times in ways.items():
            print(f"[probe] rank {rank} {way}: median "
                  f"{statistics.median(times) * 1e6:.1f} us, mean "
                  f"{statistics.fmean(times) * 1e6:.1f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
