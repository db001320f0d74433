"""Model configuration of the LM serving path (the port's copy of the
reference's ``ModelConfig``, every field and count kept).

One dataclass; families select behaviour through the ``attn_kind`` /
``mlp_kind`` / ``layer_pattern`` fields rather than subclassing, so every
architecture flows through the same layer stack and serve steps. Pure
Python.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int

    # ---- attention ----
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    attn_kind: str = "gqa"  # gqa | mla | none
    qkv_bias: bool = False
    causal: bool = True  # False => encoder-only (hubert)
    rope_theta: float = 10_000.0
    pos_emb: str = "rope"  # rope | mrope | none
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl: (t, h, w) rope splits
    local_window: int = 0  # >0 => sliding-window attention

    # ---- MLA (deepseek-v2) ----
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # ---- MLP ----
    mlp_kind: str = "swiglu"  # swiglu | squared_relu | gelu | geglu
    mlp_bias: bool = False

    # ---- MoE ----
    num_experts: int = 0  # 0 => dense MLP everywhere
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # expert hidden size (deepseek: 1536)
    first_dense_layers: int = 0  # deepseek-v2: layer 0 keeps a dense MLP
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_impl: str = "gshard"  # "gshard" (one-hot einsum dispatch, the
    #   classic shardable baseline) | "sort" (argsort/gather dispatch,
    #   MegaBlocks-style: removes the 4·E·C·d dispatch-einsum flops —
    #   the §Perf hillclimb winner for deepseek/grok)

    # ---- recurrent / hybrid ----
    # layer_pattern cycles over the stack; entries: "attn" | "rwkv6" | "rglru"
    layer_pattern: Tuple[str, ...] = ("attn",)
    rwkv_head_dim: int = 64
    lru_width: int = 0  # rg-lru recurrent width (defaults to d_model)
    conv_width: int = 4  # rg-lru temporal conv

    # ---- embeddings / norms ----
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    has_lm_head: bool = True

    # ---- numerics ----
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    cache_dtype: str = ""  # "" => dtype; "float8_e4m3fn" halves KV memory
    #                        (needed for MHA-heavy archs at decode_32k:
    #                        qwen1.5-32b's 40-head cache is 5.5 TB in bf16)
    # optimizer moment dtype lives in TrainConfig; >=100B configs use bf16

    # ---- frontend stubs (audio/vlm): inputs are precomputed embeddings ----
    frontend_stub: bool = False

    def __post_init__(self):
        if self.attn_kind == "gqa" and self.num_heads:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.lru_width == 0 and "rglru" in self.layer_pattern:
            object.__setattr__(self, "lru_width", self.d_model)

    # ---- derived ----
    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.layer_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_subquadratic(self) -> bool:
        """True if the arch can run the long_500k decode shape."""
        kinds = set(self.layer_kinds)
        if "attn" in kinds and self.local_window == 0:
            return False
        return True

    def param_count(self) -> int:
        """Analytic parameter count (drives 6·N·D roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if self.has_lm_head and not self.tie_embeddings:
            total += v * d
        for kind in self.layer_kinds:
            if kind == "attn":
                if self.attn_kind == "mla":
                    qh = self.qk_nope_head_dim + self.qk_rope_head_dim
                    q_in = self.q_lora_rank or d
                    if self.q_lora_rank:
                        total += d * self.q_lora_rank
                    total += q_in * self.num_heads * qh
                    total += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    total += self.kv_lora_rank * self.num_heads * (
                        self.qk_nope_head_dim + self.v_head_dim
                    )
                    total += self.num_heads * self.v_head_dim * d
                else:
                    hd = self.head_dim
                    total += d * self.num_heads * hd
                    total += 2 * d * self.num_kv_heads * hd
                    total += self.num_heads * hd * d
            elif kind == "rwkv6":
                total += 6 * d * d  # r,k,v,g,w,out (lora terms are small)
                total += 2 * d * self.d_ff  # channel mix
            elif kind == "rglru":
                w = self.lru_width
                total += 2 * d * w + w * d + 3 * w  # in/out proj + gates
            # MLP
            if kind != "rwkv6":  # rwkv6 blocks carry their own channel mix
                total += self._mlp_params(d)
        total += sum(self._norm_params(d) for _ in self.layer_kinds) * 2
        return total

    def _mlp_params(self, d: int) -> int:
        if self.is_moe:
            e_ff = self.moe_d_ff or self.d_ff
            routed = self.num_experts * 3 * d * e_ff
            shared = self.num_shared_experts * 3 * d * e_ff
            router = d * self.num_experts
            dense_layers = self.first_dense_layers
            moe_layers = self.num_layers - dense_layers
            # averaged per layer (called once per layer)
            per_moe = routed + shared + router
            per_dense = 3 * d * self.d_ff
            return (per_moe * moe_layers + per_dense * dense_layers) // self.num_layers
        mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        return mult * d * self.d_ff

    def _norm_params(self, d: int) -> int:
        return 2 * d if self.norm == "layernorm" else d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        e_ff = self.moe_d_ff or self.d_ff
        full = self.param_count()
        inactive = (self.num_experts - self.top_k) * 3 * d * e_ff
        moe_layers = self.num_layers - self.first_dense_layers
        return full - inactive * moe_layers
