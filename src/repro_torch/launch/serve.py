"""Serving launcher: batched prefill and greedy decode with the KV / ring /
recurrent caches, tokens/s reporting (counterpart of the reference's
``examples/serve_decode.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b --batch 8 --prompt-len 512

The full config is served unless ``--smoke``; weights come from the
model's own seeded initialization (``--seed``), the prompt from the same
generator. Every LM config but hubert-xlarge (encoder-only) serves, the
MoE ones (deepseek-v2-236b with MLA, grok-1-314b) too. The full
deepseek-v2-236b (471 GB of bf16 weights) and grok-1-314b (633 GB) do not
fit on one 80 GB card, nor do qwen1.5-32b, mistral-large-123b and
nemotron-4-340b: serve their smoke configs, or a depth-cut copy of the
config from Python (``chip_smoke.py``'s lm phase serves deepseek at 4 of
its 60 layers and grok at 2 of 64).

Prints the prefill and decode milliseconds (host clock, each ended by a
device synchronize; the first call's set-up included, as the example's),
tok/s, the first generated row, the weights' bytes and the peak device
bytes.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="granite-3-8b")
    p.add_argument("--smoke", action="store_true",
                   help="serve the smoke config (default: the full one)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to serve (default cuda; no fallback)")
    args = p.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import LanguageModel, ModelConfig
    from repro_torch.train import greedy_generate

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not isinstance(cfg, ModelConfig):
        raise SystemExit(f"{args.arch} is not a language model")
    if cfg.is_encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = LanguageModel(cfg, device=device, generator=gen)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device, dtype=torch.int32)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    times: dict = {}
    out, _ = greedy_generate(model, prompt, args.steps, timings=times)

    n_decode = args.steps - 1
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in model.state_dict().values())
    print(f"arch={cfg.name}  layers={cfg.num_layers}  d_model={cfg.d_model}  "
          f"dtype={cfg.dtype}  batch={args.batch}  device={device}")
    print(f"prefill {args.prompt_len} toks: {times['prefill_s'] * 1e3:.1f} ms")
    if n_decode:
        step_ms = times["decode_s"] * 1e3 / n_decode
        print(f"decode  {n_decode} steps: {times['decode_s'] * 1e3:.1f} ms "
              f"({step_ms:.2f} ms a step, "
              f"{args.batch * n_decode / times['decode_s']:,.0f} tok/s)")
    print(f"first generated row: {out[0, :12].tolist()}")
    itemsize = next(model.parameters()).element_size()
    print(f"weight bytes {weight_bytes:,} (param_count() x {itemsize} = "
          f"{cfg.param_count() * itemsize:,})")
    peak = (f"{torch.cuda.max_memory_allocated(device):,}"
            if device.type == "cuda" else "not measured (cpu)")
    print(f"peak device bytes: {peak}")
    if out.shape != (args.batch, args.steps):
        raise SystemExit(f"generated {tuple(out.shape)}, not "
                         f"{(args.batch, args.steps)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
