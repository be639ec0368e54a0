"""RecurrentGemma-2B (Griffin)  [arXiv:2402.19427].

Assigned spec: 26L, d_model=2560, 10 heads (MQA kv=1), d_ff=7680,
vocab=256000, RG-LRU recurrent blocks + local attention in a 2:1 pattern
(recurrent, recurrent, local-attention).  GeGLU MLP, head_dim=256,
window 2048, lru_width=2560.
"""

from repro_torch.config import (ATTN_LOCAL, MIX_RGLRU, MLP_DENSE, ModelConfig,
                                register_arch)


@register_arch("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        citation="arXiv:2402.19427 (Griffin / RecurrentGemma)",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        pattern=(MIX_RGLRU, MIX_RGLRU, ATTN_LOCAL),
        mlp_pattern=(MLP_DENSE,),
        window=2048,
        activation="geglu",
        norm="rmsnorm",
        rope_theta=10_000.0,
        tie_embeddings=True,
        embed_scale=True,
        lru_width=2560,
        lru_conv=4,
    )
