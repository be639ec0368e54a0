"""Qwen2-VL-72B  [arXiv:2409.12191].

Assigned spec: 80L, d_model=8192, 64 heads (GQA kv=8), d_ff=29568,
vocab=152064, M-RoPE (multimodal 3-section rotary: temporal/height/width),
dynamic-resolution vision.  The ViT vision encoder + projector is the
stubbed modality frontend — the caller supplies precomputed patch
embeddings of shape (batch, frontend_tokens, d_model); the language decoder
consumes them prepended to the text tokens.
"""

from repro_torch.config import ATTN_GLOBAL, MLP_DENSE, ModelConfig, register_arch


@register_arch("qwen2-vl-72b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        citation="arXiv:2409.12191 (Qwen2-VL)",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        pattern=(ATTN_GLOBAL,),
        mlp_pattern=(MLP_DENSE,),
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=1_000_000.0,
        rope_kind="mrope",
        qkv_bias=True,
        frontend="vision",
        frontend_tokens=1024,   # patch embeddings prepended to the text span
        long_context_window=4096,
    )
