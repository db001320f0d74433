"""Shared building blocks of the LM path: norms, dense layers, MLPs, RoPE and
M-RoPE (counterpart of ``repro.models.layers``).

Modules hold their weights as frozen ``nn.Parameter``s in the reference's
orientation (a dense weight is (d_in, d_out), applied as ``x @ w``), so a
carried weight needs no transpose and every product rounds as the
reference's does. :class:`Init` draws them from an explicit
``torch.Generator`` on the model's device, with the reference's
distributions; on the ``meta`` device it only allocates (the shapes of a
state dict, without values).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.tensor_parallel import (TensorParallel,
                                                     enter_tp, sum_over_tp)

__all__ = [
    "DTYPES",
    "Init",
    "Norm",
    "Dense",
    "MLP",
    "rms_norm",
    "layer_norm",
    "gelu",
    "rope_frequencies",
    "apply_rope",
    "apply_mrope",
]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn}


@dataclasses.dataclass
class Init:
    """Where and how a module's weights are made: ``device``, the parameter
    ``dtype`` and the ``generator`` every draw takes its numbers from (in
    construction order). Draws are f32 normals rounded to ``dtype``."""

    device: torch.device
    dtype: torch.dtype
    generator: Optional[torch.Generator]

    def _empty(self, shape, dtype=None) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype or self.dtype,
                           device=self.device)

    def normal(self, shape, scale: float,
               dtype: Optional[torch.dtype] = None) -> nn.Parameter:
        """N(0, scale²) at ``dtype`` (default: the parameter dtype; the MoE
        router stays f32)."""
        if self.device.type == "meta":
            return _frozen(self._empty(shape, dtype))
        x = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32) * scale
        return _frozen(x.to(dtype or self.dtype))

    def full(self, shape, value: float) -> nn.Parameter:
        x = self._empty(shape)
        return _frozen(x if self.device.type == "meta" else x.fill_(value))

    def tensor(self, values: torch.Tensor) -> nn.Parameter:
        if self.device.type == "meta":
            return _frozen(self._empty(values.shape))
        return _frozen(values.to(device=self.device, dtype=self.dtype))


def _frozen(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


# ---------------------------------------------------------------- norms ----
def rms_norm(x, scale, eps):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)  # jnp.var: population
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class Norm(nn.Module):
    def __init__(self, d: int, kind: str, eps: float, init: Init):
        super().__init__()
        self.kind, self.eps = kind, eps
        self.scale = init.full((d,), 1.0)
        self.bias = init.full((d,), 0.0) if kind == "layernorm" else None

    def forward(self, x):
        if self.kind == "layernorm":
            return layer_norm(x, self.scale, self.bias, self.eps)
        return rms_norm(x, self.scale, self.eps)


# ---------------------------------------------------------------- dense ----
class Dense(nn.Module):
    """``x @ w (+ b)`` with ``w`` of shape (d_in, d_out); row-parallel with
    a 'model' group ``tp`` (its products summed over the group before the
    bias, the sum reduce-scattered to the rank's positions under sequence
    parallelism)."""

    def __init__(self, d_in: int, d_out: int, init: Init, bias: bool = False,
                 scale: float | None = None):
        super().__init__()
        scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
        self.w = init.normal((d_in, d_out), scale)
        self.b = init.full((d_out,), 0.0) if bias else None

    def forward(self, x, tp: Optional[TensorParallel] = None):
        y = sum_over_tp(x @ self.w, tp)
        return y + self.b if self.b is not None else y


# ------------------------------------------------------------------ MLP ----
def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    """A dense MLP. With a 'model' group ``tp`` (set by
    :func:`~repro_torch.distributed.sharding.distribute_model`) its weights
    are the rank's FFN slice: ``wi`` and ``wg`` column-parallel, ``wo``
    row-parallel."""

    def __init__(self, d_model: int, d_ff: int, kind: str, init: Init,
                 bias: bool = False):
        super().__init__()
        if kind not in ("swiglu", "geglu", "squared_relu", "gelu"):
            raise ValueError(f"unknown mlp kind {kind!r}")
        self.kind = kind
        self.tp: Optional[TensorParallel] = None
        self.wi = Dense(d_model, d_ff, init, bias)
        self.wg = (Dense(d_model, d_ff, init, bias)
                   if kind in ("swiglu", "geglu") else None)
        self.wo = Dense(d_ff, d_model, init, bias)

    def forward(self, x):
        x = enter_tp(x, self.tp)
        if self.kind == "swiglu":
            h = F.silu(self.wg(x)) * self.wi(x)
        elif self.kind == "geglu":
            h = gelu(self.wg(x)) * self.wi(x)
        elif self.kind == "squared_relu":  # nemotron-4
            h = torch.relu(self.wi(x)).square()
        else:
            h = gelu(self.wi(x))
        return self.wo(h, self.tp)


# ----------------------------------------------------------------- RoPE ----
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, f32."""
    half = head_dim // 2
    ex = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(theta, ex)  # a host scalar: no copy, no sync


def _rotate(x, cos, sin):
    """Halves, not interleaved pairs: (x1, x2) -> (x1 c - x2 s,
    x2 c + x1 s)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S) integer."""
    inv = rope_frequencies(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * inv  # (B, S, D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def apply_mrope(x, positions, theta: float, sections: Tuple[int, ...]):
    """Multimodal RoPE (Qwen2-VL): the head_dim/2 frequency slots split into
    (t, h, w) sections, each rotated by its own position stream.

    x: (B, S, H, D); positions: (B, S, 3) (t, h, w; equal for text tokens).
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    inv = rope_frequencies(x.shape[-1], theta, x.device)
    parts, lo = [], 0
    for i, s in enumerate(sections):
        parts.append(positions[..., i].float()[..., None] * inv[lo:lo + s])
        lo += s
    ang = torch.cat(parts, dim=-1)  # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)
