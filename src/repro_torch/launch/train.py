"""Training launcher (counterpart of ``repro.launch.train``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b --smoke --steps 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b --smoke --steps 4 --device cpu --ckpt-dir /tmp/ck --ckpt-every 2 [--resume]

The loop a production run needs, on one device: synthetic batches
(``synthetic_batch(cfg, batch, seq, seed=17, step=step)``), AdamW with a
cosine schedule (warm-up ``max(steps // 20, 1)``), ``--grad-accum``
microbatches, ``remat`` unless ``--smoke``, atomic checkpoints every
``--ckpt-every`` steps and ``--resume`` from the newest, a straggler
monitor over the ``torch.distributed`` world (one host unless a process
group is initialized), and bf16 gradient compression
(``--compress-grads``). The full config is trained unless ``--smoke``;
the model comes from its own seeded initialization. It runs on the card
unless ``--device cpu``.

Prints the reference's ``[train] step=... loss=... lr=... gnorm=...
dt=...ms stragglers=...`` lines (the step's host time, ended by a device
synchronize), then tokens/s over the steps after the first and the peak
device bytes.
"""
from __future__ import annotations

import argparse
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true",
                   help="reduced config (CPU-runnable)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=20)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--compress-grads", action="store_true",
                   help="bf16 round trip on the gradients (a bf16 "
                        "all-reduce)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to train (default cuda; no fallback)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.device import resolve_device
    from repro_torch.distributed import (StepTimer, StragglerMonitor,
                                         bf16_compress, latest_step,
                                         restore_checkpoint, save_checkpoint)
    from repro_torch.models import LanguageModel, ModelConfig
    from repro_torch.train import (OptimizerConfig, TrainConfig, adamw_init,
                                   make_train_step)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not isinstance(cfg, ModelConfig):
        raise SystemExit(f"{args.arch} is not a language model")
    tcfg = TrainConfig(
        optimizer=OptimizerConfig(learning_rate=args.lr,
                                  warmup_steps=max(args.steps // 20, 1),
                                  total_steps=args.steps),
        remat=not args.smoke, grad_accum=args.grad_accum,
        grad_transform=bf16_compress if args.compress_grads else None)

    gen = torch.Generator(device=device).manual_seed(0)
    model = LanguageModel(cfg, device=device, generator=gen)
    opt = adamw_init(dict(model.named_parameters()), tcfg.optimizer)
    start_step = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, start_step = restore_checkpoint(
            args.ckpt_dir, {"params": model.state_dict(), "opt": opt},
            device=device)
        model.load_state_dict(state["params"])
        opt = state["opt"]
        print(f"[train] resumed from step {start_step}")

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    step_fn = make_train_step(cfg, tcfg)
    distributed = dist.is_available() and dist.is_initialized()
    monitor = StragglerMonitor(
        num_hosts=dist.get_world_size() if distributed else 1)
    host = dist.get_rank() if distributed else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t_start = time.perf_counter()
    later = []  # the host seconds of every step after the first
    for step in range(start_step, args.steps):
        batch = synthetic_batch(cfg, args.batch, args.seq, seed=17, step=step)
        with StepTimer(monitor, host=host, sync=sync) as timer:
            model, opt, metrics = step_fn(model, opt, batch)
        if step > start_step:
            later.append(timer.last)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step={step} loss={float(metrics['loss']):.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"dt={timer.last * 1e3:.0f}ms "
                  f"stragglers={monitor.stragglers()}", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = save_checkpoint(args.ckpt_dir, step + 1,
                                   {"params": model.state_dict(),
                                    "opt": opt})
            print(f"[train] checkpoint -> {path}")
    dt = time.perf_counter() - t_start
    print(f"[train] done: {args.steps - start_step} steps in {dt:.1f}s")
    if later:
        rate = args.batch * args.seq * len(later) / sum(later)
        print(f"[train] tokens/s {rate:,.1f} (steps after the first)")
    peak = (f"{torch.cuda.max_memory_allocated(device):,}" if cuda
            else "not measured (cpu)")
    print(f"[train] peak device bytes: {peak}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
