"""Where the LM training step spends the card's time: one
``torch.profiler`` reading of a train step.

    PYTHONPATH=src python tests/torch_profile_train.py [--arch granite-3-8b]
        [--layers 4] [--seq 4096] [--batch 4] [--grad-accum 4]
        [--moments float32] [--no-remat] [--smoke] [--device cpu]
        [--out FILE.json]

Builds the arch's full config cut to ``--layers`` layers at full width
(``--smoke``: its smoke config), bf16, from the model's own seeded
initialization, takes one warm-up step of ``make_train_step`` (the
launcher's settings, remat unless ``--no-remat``), then reads one step on
``synthetic_batch(seed=17)`` under ``torch.profiler`` (CPU and CUDA
activities): its wall time (host clock, ended by a device synchronize),
the device's busy time (the union of its operations' intervals) and idle
share, its device operations (and the host microseconds per operation),
its ten longest device operations by total time, and the device time of
each region: ``forward`` (``loss_fn``), ``backward`` (the gradients of a
microbatch, the blocks' recompute included), ``recompute`` (the blocks
run inside ``backward``), ``update`` (``adamw_update``) and the rest of
the step (the accumulation). Each region is a ``record_function`` this
script opens around the port's function, with a device synchronize at
its start and end so that its operations start inside it: the reading
pays those synchronizes (one per block call under remat). Prints the
card's name and power limit and each number, and writes them as JSON to
``--out`` (default ``build/profile/train_profile.json``). On the CPU there
is no device time: the script says so and reports host times only.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

from torch_profile_feti import _inside, _kernels, _top, _union_us


@contextlib.contextmanager
def regions(sync):
    """``loss_fn``, ``_grads`` and ``adamw_update`` of
    ``repro_torch.train.train_step`` and ``Block.forward`` wrapped in
    ``record_function`` regions (forward, backward, update, block), each
    synchronized at its start and end."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.train import train_step

    targets = ((train_step, "loss_fn", "forward"),
               (train_step, "_grads", "backward"),
               (train_step, "adamw_update", "update"),
               (transformer.Block, "forward", "block"))
    saved = []

    def wrap(fn, label):
        @functools.wraps(fn)
        def region(*args, **kw):
            sync()
            with torch.profiler.record_function(f"region: {label}"):
                out = fn(*args, **kw)
                sync()
            return out
        return region

    for owner, name, label in targets:
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, wrap(getattr(owner, name), label))
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def region_device_s(prof, ops):
    """{region: device seconds}: the union of the operations that start in
    each region's host ranges; ``recompute`` is the blocks inside
    ``backward``, ``backward`` excludes it."""
    from torch.autograd import DeviceType

    spans = {}
    for e in prof.events():
        if e.name.startswith("region: ") and e.device_type == DeviceType.CPU:
            spans.setdefault(e.name.removeprefix("region: "), []).append(
                (e.time_range.start, e.time_range.end))

    def within(ranges):
        return [iv for a, b in ranges for iv in _inside(ops, a, b)]

    back = spans.get("backward", [])
    recompute = [(a, b) for a, b in spans.get("block", [])
                 if any(c <= a and b <= d for c, d in back)]
    out = {k: _union_us(within(spans.get(k, []))) / 1e6
           for k in ("forward", "backward", "update")}
    out["recompute"] = _union_us(within(recompute)) / 1e6
    out["backward_less_recompute"] = out["backward"] - out["recompute"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="granite-3-8b")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--layers", type=int, default=4,
                   help="cut the config to this many layers (0: its own)")
    p.add_argument("--seq", type=int, default=4096)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--grad-accum", type=int, default=4)
    p.add_argument("--moments", choices=("float32", "bfloat16"),
                   default="float32")
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=os.path.join("build", "profile",
                                                 "train_profile.json"))
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.device import resolve_device
    from repro_torch.models import LanguageModel
    from repro_torch.train import (OptimizerConfig, TrainConfig, adamw_init,
                                   make_train_step)

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    card = "cpu"
    if cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    print(f"[profile] {card}; torch {torch.__version__}", flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    tcfg = TrainConfig(
        optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                                  total_steps=2, moment_dtype=args.moments),
        remat=not args.no_remat, grad_accum=args.grad_accum,
        accum_dtype=args.moments)
    gen = torch.Generator(device=device).manual_seed(0)
    model = LanguageModel(cfg, device=device, generator=gen)
    opt = adamw_init(dict(model.named_parameters()), tcfg.optimizer)
    step = make_train_step(cfg, tcfg)
    batches = [{k: v.to(device) for k, v in synthetic_batch(
        cfg, args.batch, args.seq, seed=17, step=i).items()}
        for i in range(2)]
    model, opt, _ = step(model, opt, batches[0])  # warm-up
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with regions(sync), profile(activities=activities) as prof:
        t0 = time.perf_counter()
        model, opt, metrics = step(model, opt, batches[1])
        sync()
        wall = time.perf_counter() - t0
    ops = _kernels(prof)
    busy = _union_us([(k.time_range.start, k.time_range.end)
                      for k in ops]) / 1e6 if ops else None
    row = dict(card=card, arch=cfg.name, layers=cfg.num_layers,
               d_model=cfg.d_model, seq=args.seq, batch=args.batch,
               grad_accum=args.grad_accum, moments=args.moments,
               remat=tcfg.remat, loss=float(metrics["loss"]), wall_s=wall,
               device_busy_s=busy,
               device_idle_share=None if busy is None else 1 - busy / wall,
               device_ops=len(ops),
               host_us_per_device_op=wall * 1e6 / len(ops) if ops else None,
               device_s_by_region=region_device_s(prof, ops) if ops else None,
               peak_device_bytes=(torch.cuda.max_memory_allocated(device)
                                  if cuda else None),
               top=_top(ops))
    if row["device_s_by_region"] is not None:
        row["device_s_by_region"]["rest"] = busy - sum(
            row["device_s_by_region"][k]
            for k in ("forward", "backward", "update"))
    print(f"[profile] train step: {json.dumps(row)}", flush=True)
    if not ops:
        print("[profile] no device time in this reading (CPU run, or the "
              "profiler saw no CUDA kernel): device numbers not measured",
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(row, f, indent=1)
    print(f"[profile] -> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    sys.exit(main())
