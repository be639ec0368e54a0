"""Mamba2-370M  [arXiv:2405.21060].

Assigned spec: 48L, d_model=1024, attention-free, vocab=50280,
ssm_state=128.  SSD (state-space duality) blocks: expand=2 ->
d_inner=2048, head_dim=64 -> 32 SSD heads, depthwise conv k=4,
no separate MLP (d_ff=0).
"""

from repro_torch.config import MIX_SSM, MLP_NONE, ModelConfig, register_arch


@register_arch("mamba2-370m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        citation="arXiv:2405.21060 (Mamba-2 / SSD)",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        head_dim=64,
        d_ff=0,
        vocab_size=50280,
        pattern=(MIX_SSM,),
        mlp_pattern=(MLP_NONE,),
        norm="rmsnorm",
        rope_kind="none",
        tie_embeddings=True,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_conv=4,
        ssm_chunk=128,  # 256 in the paper; 128 halves intra-chunk quadratic memory (§Perf C1)
    )
