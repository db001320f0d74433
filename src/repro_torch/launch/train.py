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

In an initialized ``torch.distributed`` group (e.g. the ranks of
:func:`~repro_torch.launch.mesh.spawn_ranks` running :func:`rank_main`)
the step is placed on :func:`~repro_torch.launch.mesh.make_local_mesh`
(data = the world, model = 1): the parameters and moments by
``param_shardings`` / ``opt_state_shardings``, each rank on its rows of
every batch, checkpoints gathered and written by rank 0, and ``--resume``
restores onto those placements whatever mesh saved them (the reference's
sharded resume). Alone, one process trains the whole model.

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
                                         opt_state_shardings, param_shardings,
                                         restore_checkpoint, save_checkpoint)
    from repro_torch.distributed.sharding import (distribute_model,
                                                  local_batch, local_tensor)
    from repro_torch.launch.mesh import make_local_mesh
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
    distributed = dist.is_available() and dist.is_initialized()
    mesh = make_local_mesh(device.type) if distributed else None
    if mesh is not None:
        psh = param_shardings(mesh, model)
        distribute_model(model, mesh, psh)
    opt = adamw_init(dict(model.named_parameters()), tcfg.optimizer)
    start_step = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        tree = {"params": model.state_dict(), "opt": opt}
        if mesh is None:
            state, start_step = restore_checkpoint(args.ckpt_dir, tree,
                                                   device=device)
        else:
            state, start_step = restore_checkpoint(
                args.ckpt_dir, tree, mesh=mesh,
                shardings={"params": psh,
                           "opt": opt_state_shardings(mesh, opt, psh)})
        with torch.no_grad():
            for name, p in model.named_parameters():
                local_tensor(p).copy_(local_tensor(state["params"][name]))
        opt = state["opt"]
        print(f"[train] resumed from step {start_step}")

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    step_fn = make_train_step(cfg, tcfg, mesh)
    monitor = StragglerMonitor(
        num_hosts=dist.get_world_size() if distributed else 1)
    host = dist.get_rank() if distributed else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t_start = time.perf_counter()
    later = []  # the host seconds of every step after the first
    for step in range(start_step, args.steps):
        batch = synthetic_batch(cfg, args.batch, args.seq, seed=17, step=step)
        if mesh is not None:
            batch = local_batch(mesh, batch, args.grad_accum)
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


def restore_onto(rank, ckpt_dir: str, arch: str, mesh_shape: tuple,
                 smoke: bool = True) -> dict:
    """One rank of the elastic restore: the newest training checkpoint in
    ``ckpt_dir`` (``{"params", "opt"}`` of ``arch``, its smoke config with
    ``smoke``) restored onto a ``DeviceMesh`` of ``mesh_shape`` over
    ("data", "model") by ``param_shardings`` / ``opt_state_shardings``,
    whatever mesh saved it. Returns the step and, for every leaf by its
    checkpoint key, its local shard (numpy) and placements (``None``: a
    plain tensor)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed import (opt_state_shardings, param_shardings,
                                         restore_checkpoint)
    from repro_torch.distributed.checkpoint import _SEP, _leaves
    from repro_torch.distributed.sharding import is_placed, local_tensor
    from repro_torch.models import LanguageModel
    from repro_torch.train import OptimizerConfig, adamw_init

    cfg = (get_smoke_config if smoke else get_config)(arch)
    mesh = init_device_mesh(rank.device.type, tuple(mesh_shape),
                            mesh_dim_names=("data", "model"))
    model = LanguageModel(cfg, device=rank.device)
    opt = adamw_init(dict(model.named_parameters()), OptimizerConfig())
    psh = param_shardings(mesh, model)
    state, step = restore_checkpoint(
        ckpt_dir, {"params": model.state_dict(), "opt": opt}, mesh=mesh,
        shardings={"params": psh, "opt": opt_state_shardings(mesh, opt, psh)})
    leaves = {_SEP.join(path): (
        local_tensor(t).detach().cpu().numpy(),
        tuple(t.placements) if is_placed(t) else None)
        for path, t in _leaves(state)}
    return {"step": step, "leaves": leaves,
            "specs": {"params": psh}, "coords": dict(zip(
                mesh.mesh_dim_names, mesh.get_coordinate()))}


def rank_main(rank, argv) -> int:
    """:func:`main` on one rank of
    :func:`~repro_torch.launch.mesh.spawn_ranks` (placed over the ranks),
    on the rank's device."""
    return main(list(argv) + ["--device", rank.device.type])


if __name__ == "__main__":
    sys.exit(main())
