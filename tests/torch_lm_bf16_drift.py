"""How far the cached decode's logits lie from one uncached forward's, in
both packages, at f32 and bf16: the bar of ``chip_smoke.py``'s lm phase is
a distance the reference's own path shows too, not a fault of the port's
cache.

    PYTHONPATH=src python tests/torch_lm_bf16_drift.py [--layers 6] [--width 256]
        [--arch rwkv6-1.6b ...]

For granite-3-8b, recurrentgemma-2b and rwkv6-1.6b, or the ``--arch``
given (their smoke configs widened to ``--width`` and deepened to
``--layers``), both packages serve the identical seeded weights (the
port's own initialization, carried into the reference) on a 96-token
prompt for 12 greedy steps, on the CPU. Per arch and dtype it prints the
relative L2 distance of each package's cached step logits from its own
uncached forward's, and of the port's step logits from the reference's
(both fed the port's greedy tokens). For a MoE arch (deepseek-v2-236b:
MLA and routed experts; grok-1-314b) a forward over more tokens has
another capacity, so, as in ``chip_smoke.py``, the prefill's logits are
held against an uncached forward over the prompt alone (for deepseek,
MLA's absorbed mode against its expanded one).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

ARCHS = ("granite-3-8b", "recurrentgemma-2b", "rwkv6-1.6b")
MOE_ARCHS = ("deepseek-v2-236b", "grok-1-314b")


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def drift(arch, dtype, layers, width, B=4, S=96, T=12):
    import jax
    import jax.numpy as jnp
    import torch

    import torch_lm_golden as golden
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import forward as ref_forward
    from repro.models import init_cache as ref_init_cache
    from repro.train import make_decode_step, make_prefill_step
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LanguageModel, forward
    from repro_torch.train import greedy_generate

    kw = dict(dtype=dtype, param_dtype=dtype, num_layers=layers,
              d_model=width, d_ff=2 * width, vocab_size=512)
    if arch == "granite-3-8b":
        kw.update(num_heads=8, num_kv_heads=2, head_dim=width // 8)
    elif arch == "recurrentgemma-2b":
        kw.update(num_heads=8, num_kv_heads=1, head_dim=width // 8,
                  lru_width=width)
    elif arch == "grok-1-314b":
        kw.update(num_heads=8, num_kv_heads=2, head_dim=width // 8,
                  moe_d_ff=2 * width)
    elif arch == "deepseek-v2-236b":  # MLA ranks and experts: the smoke's
        kw.update(num_heads=8)
    cfg = dataclasses.replace(get_smoke_config(arch), **kw)
    rcfg = dataclasses.replace(ref_smoke(arch), **kw)
    model = LanguageModel(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    prompt = golden.prompt(cfg, seed=1, batch=B, length=S)
    out, steps = greedy_generate(model, torch.from_numpy(prompt), T,
                                 all_logits=True)
    toks = out.numpy()
    # the tokens of the uncached forward and the positions held to it
    seq, held = np.concatenate([prompt, toks[:, :-1]], 1), slice(S - 1, None)
    if cfg.is_moe:
        seq, held, steps = prompt, slice(S - 1, S), steps[:, :1]
    full, _ = forward(model, {"tokens": torch.from_numpy(seq)})
    port = rel_l2(steps.float().numpy(), full[:, held].float().numpy())

    params = golden.reference_params(rcfg, {
        k: v.float().numpy() for k, v in model.state_dict().items()})
    cache = ref_init_cache(rcfg, B, S + T)
    logits, cache = jax.jit(make_prefill_step(rcfg))(
        params, {"tokens": jnp.asarray(prompt)}, cache)
    decode = jax.jit(make_decode_step(rcfg))
    ref_steps = [np.asarray(logits, np.float32)]
    for t in range(steps.shape[1] - 1):  # the port's tokens: same inputs
        logits, cache = decode(params, jnp.asarray(toks[:, t:t + 1]), cache,
                               jnp.asarray(S + t, jnp.int32))
        ref_steps.append(np.asarray(logits, np.float32))
    ref_steps = np.stack(ref_steps, 1)
    ref_full, _, _ = ref_forward(params, rcfg, {"tokens": jnp.asarray(seq)})
    ref = rel_l2(ref_steps, np.asarray(ref_full[:, held], np.float32))
    across = rel_l2(steps.float().numpy(), ref_steps)
    return port, ref, across


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--layers", type=int, default=6)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--arch", action="append", choices=ARCHS + MOE_ARCHS)
    args = p.parse_args(argv)
    import jax

    jax.config.update("jax_enable_x64", True)  # as the test suite runs it
    for arch in args.arch or ARCHS:
        for dtype in ("float32", "bfloat16"):
            port, ref, across = drift(arch, dtype, args.layers, args.width)
            print(f"{arch} {dtype} ({args.layers} layers, width "
                  f"{args.width}): cached vs uncached: port {port:.3e}, "
                  f"reference {ref:.3e}; port vs reference {across:.3e}",
                  flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.join(here, "..", "src")]
    sys.exit(main())
