"""OLMoE-1B-7B  [arXiv:2409.02060].

Assigned spec: 16L, d_model=2048, 16 heads (kv=16, MHA), per-expert
d_ff=1024, vocab=50304, MoE with 64 experts top-8 in every layer.
RMSNorm, SwiGLU experts, softmax-topk router with load-balance aux loss.
"""

from repro_torch.config import ATTN_GLOBAL, MLP_MOE, ModelConfig, register_arch


@register_arch("olmoe-1b-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        citation="arXiv:2409.02060 (OLMoE)",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1024,
        vocab_size=50304,
        pattern=("global",),
        mlp_pattern=(MLP_MOE,),
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=10_000.0,
        num_experts=64,
        experts_per_token=8,
        router_aux_coef=0.01,
        long_context_window=4096,
    )
