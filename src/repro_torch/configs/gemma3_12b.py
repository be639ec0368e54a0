"""Gemma-3-12B  [hf:google/gemma-3-1b-pt family card].

Assigned spec: 48L, d_model=3840, 16 heads (GQA kv=8), d_ff=15360,
vocab=262144, 5:1 local:global attention pattern with 1024-token sliding
window on local layers, 128k context.  GeGLU, RMSNorm, head_dim=256,
dual rope_theta (1e6 global / 1e4 local — we use the global theta).
"""

from repro_torch.config import (ATTN_GLOBAL, ATTN_LOCAL, MLP_DENSE,
                                ModelConfig, register_arch)


@register_arch("gemma3-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        family="dense",
        citation="hf:google/gemma-3-1b-pt (scaled per assignment)",
        num_layers=48,
        d_model=3840,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab_size=262144,
        pattern=(ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,),
        mlp_pattern=(MLP_DENSE,),
        window=1024,
        activation="geglu",
        norm="rmsnorm",
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        embed_scale=True,
    )
