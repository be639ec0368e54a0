"""StableLM-2-12B  [hf:stabilityai/stablelm-2-1_6b family card].

Assigned spec: 40L, d_model=5120, 32 heads (GQA kv=8), d_ff=13824,
vocab=100352.  StableLM-2 uses partial rotary embeddings (25% of head_dim),
LayerNorm without biases, SwiGLU MLP, untied embeddings.
"""

from repro_torch.config import ATTN_GLOBAL, MLP_DENSE, ModelConfig, register_arch


@register_arch("stablelm-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        family="dense",
        citation="hf:stabilityai/stablelm-2-1_6b (scaled per assignment)",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=160,
        d_ff=13824,
        vocab_size=100352,
        pattern=(ATTN_GLOBAL,),
        mlp_pattern=(MLP_DENSE,),
        activation="swiglu",
        norm="layernorm",
        rope_theta=10_000.0,
        rope_fraction=0.25,
        qkv_bias=False,
        long_context_window=4096,
    )
