"""Gemma-2B  [arXiv:2403.08295].

18L, d_model=2048, 8 heads with MQA (kv=1), d_ff=16384, vocab=256000.
GeGLU MLP, head_dim=256, RMSNorm (+1 weight), tied embeddings,
sqrt(d_model) embedding scale.
"""

from repro_torch.config import ATTN_GLOBAL, MLP_DENSE, ModelConfig, register_arch


@register_arch("gemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        citation="arXiv:2403.08295 (Gemma)",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        pattern=(ATTN_GLOBAL,),
        mlp_pattern=(MLP_DENSE,),
        activation="geglu",
        norm="rmsnorm",
        rope_theta=10_000.0,
        tie_embeddings=True,
        embed_scale=True,
        long_context_window=4096,
    )
