"""Where the LM serving path spends the card's time: one ``torch.profiler``
reading of a prefill and of greedy decode steps.

    PYTHONPATH=src python tests/torch_profile_serve.py [--arch granite-3-8b]
        [--batch 8] [--prompt-len 512] [--steps 8] [--smoke] [--layers N]
        [--device cpu] [--out FILE.json]

Builds the arch's full config (``--smoke``: its smoke config; ``--layers``:
cut to N layers at full width, as ``chip_smoke.py`` serves the MoE models
whose full depth does not fit one card) from the model's own seeded
initialization, warms the path up with a short
generation, then reads, each under ``torch.profiler`` (CPU and CUDA
activities): one prefill of ``--batch`` prompts of ``--prompt-len``
tokens into a fresh cache, then ``--steps`` decode steps. For each: its
wall time (host clock, ended by a device synchronize), the device's busy
time (the union of its operations' intervals) and idle share, its device
operations (per step for decode, and the host microseconds per operation)
and its ten longest device operations by total time. Prints the card's
name and power limit and each number, and writes them as JSON to
``--out`` (default ``build/profile/serve_profile.json``). On the CPU there
is no device time: the script says so and reports host times only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

from torch_profile_feti import _kernels, _top, _union_us


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="granite-3-8b")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--layers", type=int, default=0,
                   help="cut the config to this many layers (0: its own)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=512)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=os.path.join("build", "profile",
                                                 "serve_profile.json"))
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import LanguageModel, init_cache
    from repro_torch.train import (greedy_generate, make_decode_step,
                                   make_prefill_step)

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    card = "cpu"
    if cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    print(f"[profile] {card}; torch {torch.__version__}", flush=True)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    gen = torch.Generator(device=device).manual_seed(0)
    model = LanguageModel(cfg, device=device, generator=gen)
    B, S = args.batch, args.prompt_len
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=device, dtype=torch.int32)
    greedy_generate(model, prompt[:, :16], 2)  # warm-up
    cache = init_cache(cfg, B, S + args.steps, device)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def reading(label, fn, steps=1):
        sync()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            out = fn()
            sync()
            wall = time.perf_counter() - t0
        ops = _kernels(prof)
        busy = _union_us([(k.time_range.start, k.time_range.end)
                          for k in ops]) / 1e6 if ops else None
        row = dict(wall_s=wall, steps=steps,
                   device_busy_s=busy,
                   device_idle_share=None if busy is None else 1 - busy / wall,
                   device_ops=len(ops), device_ops_per_step=len(ops) / steps,
                   host_us_per_device_op=(wall * 1e6 / len(ops)
                                          if ops else None),
                   top=_top(ops))
        print(f"[profile] {label}: {json.dumps(row)}", flush=True)
        return out, row

    (logits, cache), pre = reading("prefill", lambda: prefill(
        {"tokens": prompt}, cache))
    tok = logits.argmax(-1)[:, None].to(torch.int32)

    def steps():
        nonlocal tok
        for t in range(args.steps):
            step_logits, _ = decode(tok, cache, S + t)
            tok = step_logits.argmax(-1)[:, None].to(torch.int32)

    _, dec = reading("decode", steps, args.steps)
    if not cuda or pre["device_busy_s"] is None:
        print("[profile] no device time in this reading (CPU run, or the "
              "profiler saw no CUDA kernel): device numbers not measured",
              flush=True)
    result = dict(card=card, arch=cfg.name, batch=B, prompt=S,
                  steps=args.steps, prefill=pre, decode=dec)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"[profile] -> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    sys.exit(main())
