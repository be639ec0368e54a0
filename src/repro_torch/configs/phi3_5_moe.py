"""Phi-3.5-MoE-42B (6.6B active)  [hf:microsoft/Phi-3.5-MoE-instruct].

Assigned spec: 32L, d_model=4096, 32 heads (GQA kv=8), per-expert
d_ff=6400, vocab=32064, MoE 16 experts top-2 in every layer.
LayerNorm, SwiGLU experts.
"""

from repro_torch.config import ATTN_GLOBAL, MLP_MOE, ModelConfig, register_arch


@register_arch("phi3.5-moe-42b-a6.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        citation="hf:microsoft/Phi-3.5-MoE-instruct",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab_size=32064,
        pattern=(ATTN_GLOBAL,),
        mlp_pattern=(MLP_MOE,),
        activation="swiglu",
        norm="layernorm",
        rope_theta=10_000.0,
        num_experts=16,
        experts_per_token=2,
        router_aux_coef=0.01,
        long_context_window=4096,
    )
