"""Qwen2.5-32B  [hf:Qwen/Qwen2.5-0.5B family card].

Assigned spec: 64L, d_model=5120, 40 heads (GQA kv=8), d_ff=27648,
vocab=152064.  Qwen2.5 uses QKV bias, RMSNorm, SwiGLU, rope_theta=1e6.
"""

from repro_torch.config import ATTN_GLOBAL, MLP_DENSE, ModelConfig, register_arch


@register_arch("qwen2.5-32b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b",
        family="dense",
        citation="hf:Qwen/Qwen2.5-0.5B (scaled per assignment)",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=27648,
        vocab_size=152064,
        pattern=(ATTN_GLOBAL,),
        mlp_pattern=(MLP_DENSE,),
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=1_000_000.0,
        qkv_bias=True,
        long_context_window=4096,
    )
