"""MusicGen-medium  [arXiv:2306.05284].

Assigned spec: 48L, d_model=1536, 24 heads (MHA, kv=24), d_ff=6144,
vocab=2048 — a decoder-only transformer over EnCodec audio tokens.
The EnCodec codec (conv encoder/decoder) is the stubbed modality frontend:
the caller supplies the token stream directly.
MusicGen uses GELU MLPs, LayerNorm, learned-free sinusoidal positions — we
use RoPE-free positions via rope_kind="none" plus a learned frontend
embedding, matching the decoder's shape budget.
"""

from repro_torch.config import ATTN_GLOBAL, MLP_DENSE, ModelConfig, register_arch


@register_arch("musicgen-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        citation="arXiv:2306.05284 (MusicGen)",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        pattern=(ATTN_GLOBAL,),
        mlp_pattern=(MLP_DENSE,),
        activation="gelu",
        norm="layernorm",
        rope_kind="none",
        frontend="audio",
        frontend_tokens=0,   # EnCodec tokens are the input stream itself
        long_context_window=4096,
    )
