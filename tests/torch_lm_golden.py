"""Golden logits of the reference's LM smoke configs, for the port to meet
on the card, where there is no JAX.

    PYTHONPATH=src python tests/torch_lm_golden.py   # rewrites the file

For every arch of :data:`ARCHS` the reference (``repro``, on the CPU, f32)
runs its smoke config on the seeded numpy weights of
``repro_torch.interop.random_lm_state(cfg, SEED)`` and a seeded prompt,
and ``tests/data/torch_lm_golden.npz`` keeps, under ``<arch>/<key>``:
``prompt`` (B, S), ``forward`` (B, S, V) logits of one uncached forward,
and for the decoders ``prefill`` (B, V), ``decode`` (B, DECODE, V) (the
logits of DECODE greedy decode steps after the prefill) and ``tokens``
(B, DECODE + 1), the greedy tokens. ``tests/test_torch_lm_serve.py``
recomputes the file with the reference and compares, so it cannot go
stale; it and ``chip_smoke.py`` hold the port to it.

The helpers that build the reference's inputs (:func:`reference_params`,
:func:`reference_outputs`) import JAX and the reference; :func:`load` and
:func:`prompt` do not.
"""
from __future__ import annotations

import os
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "torch_lm_golden.npz"
ARCHS = ("granite-3-8b", "qwen2-vl-2b", "hubert-xlarge", "qwen1.5-32b",
         "mistral-large-123b", "nemotron-4-340b", "recurrentgemma-2b",
         "rwkv6-1.6b", "deepseek-v2-236b", "grok-1-314b")
SEED, BATCH, PROMPT, DECODE = 0, 2, 8, 3


def prompt(cfg, seed: int = SEED, batch: int = BATCH,
           length: int = PROMPT) -> np.ndarray:
    """The seeded (batch, length) int32 prompt of ``cfg``."""
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, cfg.vocab_size, (batch, length)).astype(np.int32)


def load(path=GOLDEN) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def reference_params(ref_cfg, state: dict):
    """The reference's params pytree holding ``state`` (the port's names,
    numpy), each leaf rounded to the reference's param dtype: the
    reference's own ``init_model`` gives the tree, ``body[j]`` stacks
    layer ``StackLayout.layer(j, c)`` over the cycles ``c``."""
    import jax
    import jax.numpy as jnp

    from repro.models import init_model
    from repro_torch.models.transformer import StackLayout

    template = init_model(jax.random.PRNGKey(0), ref_cfg)
    lay = StackLayout.build(ref_cfg)

    def key(entry):
        return str(getattr(entry, "key", getattr(entry, "idx", entry)))

    def leaf(path, x):
        names = [key(e) for e in path]
        if names[0] != "stack":
            v = state[".".join(names)]
        elif names[1] == "body":
            j, rest = int(names[2]), ".".join(names[3:])
            v = np.stack([state[f"blocks.{lay.layer(j, c)}.{rest}"]
                          for c in range(lay.cycles)])
        else:
            layers = lay.prologue if names[1] == "prologue" else lay.epilogue
            li = layers[int(names[2])]
            v = state[f"blocks.{li}." + ".".join(names[3:])]
        if v.shape != x.shape:
            raise ValueError(f"{names}: {v.shape} against {x.shape}")
        return jnp.asarray(v, x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, template)


def reference_outputs(arch: str, seed: int = SEED,
                      keep_cache: bool = False) -> dict:
    """The reference's golden outputs of ``arch`` (smoke config); with
    ``keep_cache`` also its cache after the decode steps (numpy, the
    reference's layout) under ``cache``, which the file does not keep."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.models import forward, init_cache
    from repro.train import make_decode_step, make_prefill_step
    from repro_torch.interop import random_lm_state

    cfg = get_smoke_config(arch)
    params = reference_params(cfg, random_lm_state(cfg, seed))
    tokens = prompt(cfg, seed)
    out = {"prompt": tokens}
    logits, _, _ = jax.jit(lambda p, t: forward(p, cfg, {"tokens": t}))(
        params, jnp.asarray(tokens))
    out["forward"] = np.asarray(logits, np.float32)
    if cfg.is_encoder_only:
        return out
    cache = init_cache(cfg, BATCH, PROMPT + DECODE)
    logits, cache = jax.jit(make_prefill_step(cfg))(
        params, {"tokens": jnp.asarray(tokens)}, cache)
    out["prefill"] = np.asarray(logits, np.float32)
    decode = jax.jit(make_decode_step(cfg))
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    toks, steps = [tok], []
    for t in range(DECODE):
        logits, cache = decode(params, tok, cache,
                               jnp.asarray(PROMPT + t, jnp.int32))
        steps.append(np.asarray(logits, np.float32))
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        toks.append(tok)
    out["decode"] = np.stack(steps, axis=1)
    out["tokens"] = np.asarray(jnp.concatenate(toks, axis=1), np.int32)
    if keep_cache:
        out["cache"] = jax.tree.map(np.asarray, cache)
    return out


def main() -> int:
    import jax

    jax.config.update("jax_enable_x64", True)  # as the test suite runs it
    arrays = {}
    for arch in ARCHS:
        for k, v in reference_outputs(arch).items():
            arrays[f"{arch}/{k}"] = v
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **arrays)
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size:,} bytes, "
          f"{len(arrays)} arrays)")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT / "src"))
    sys.exit(main())
