"""Configuration for the PyTorch port: the model dataclasses, the
architecture registry and the serving-side :class:`Scenario`.

A copy of the parts of ``repro/config.py`` that the serving path reads.
It is stdlib-only, like the original, and the port keeps its own copy so
that it imports nothing of ``repro``.  Field names, defaults and
``reduced`` are the same, so a config built here and one built by the JAX
package compare equal field by field.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

# Sequence-mixer kinds.
ATTN_GLOBAL = "global"      # full causal attention
ATTN_LOCAL = "local"        # sliding-window causal attention
MIX_RGLRU = "rglru"         # RG-LRU recurrent block (RecurrentGemma)
MIX_SSM = "ssm"             # Mamba2 SSD block (attention-free)

# Channel-mixer kinds.
MLP_DENSE = "dense"
MLP_MOE = "moe"
MLP_NONE = "none"


@dataclass(frozen=True)
class LayerSpec:
    """Static description of one decoder layer."""

    mixer: str = ATTN_GLOBAL
    mlp: str = MLP_DENSE
    window: Optional[int] = None

    def signature(self) -> Tuple:
        return (self.mixer, self.mlp, self.window)


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "unnamed"
    family: str = "dense"
    citation: str = ""

    # core dims
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                 # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # layer pattern, tiled over num_layers
    pattern: Tuple[str, ...] = (ATTN_GLOBAL,)
    window: Optional[int] = None
    mlp_pattern: Tuple[str, ...] = (MLP_DENSE,)

    # attention
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_kind: str = "standard"       # standard | mrope | none
    rope_fraction: float = 1.0
    attn_logit_softcap: Optional[float] = None
    query_scale: Optional[float] = None   # None -> 1/sqrt(head_dim)

    # mlp
    activation: str = "swiglu"        # swiglu | geglu | gelu
    mlp_bias: bool = False

    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # ssm (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # rg-lru (recurrentgemma)
    lru_width: int = 0                # 0 -> d_model
    lru_conv: int = 4

    # norms / embeddings
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False         # gemma-style sqrt(d_model) input scale
    final_logit_softcap: Optional[float] = None

    # modality frontend
    frontend: str = "none"
    frontend_tokens: int = 0

    # long-context policy
    long_context_window: Optional[int] = None

    # numerics
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    @property
    def period(self) -> int:
        """Length of the repeating layer super-block."""
        a, b = len(self.pattern), len(self.mlp_pattern)
        return a * b // math.gcd(a, b)

    def layer_specs(self) -> List[LayerSpec]:
        specs = []
        for i in range(self.num_layers):
            mixer = self.pattern[i % len(self.pattern)]
            mlp = self.mlp_pattern[i % len(self.mlp_pattern)]
            win = self.window if mixer == ATTN_LOCAL else None
            specs.append(LayerSpec(mixer=mixer, mlp=mlp, window=win))
        return specs

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Scenario:
    """Replica fault scenario, as far as the serving router reads it.

    The router holds each field at zero (the ``clean`` scenario) until the
    fault simulator is ported; see ``serve/router.py``."""

    name: str = "clean"
    dropout_prob: float = 0.0
    straggler_fraction: float = 0.0
    straggler_slowdown: float = 1.0
    label_flip_fraction: float = 0.0
    gradient_noise_fraction: float = 0.0
    gradient_noise_scale: float = 0.0
    sign_flip_fraction: float = 0.0
    grad_scale_fraction: float = 0.0
    grad_scale_factor: float = 1.0
    adaptive_fraction: float = 0.0
    adaptive_margin: float = 1.5
    hop_dropout_prob: float = 0.0
    hop_latency_prob: float = 0.0
    hop_latency_slowdown: float = 1.0
    skew_alpha: Optional[float] = None
    seed: int = 0
    num_clients_hint: Optional[int] = None

    def is_clean(self) -> bool:
        return (self.dropout_prob == 0.0 and self.straggler_fraction == 0.0
                and self.label_flip_fraction == 0.0
                and self.gradient_noise_scale == 0.0
                and self.sign_flip_fraction == 0.0
                and self.grad_scale_fraction == 0.0
                and self.adaptive_fraction == 0.0
                and self.hop_dropout_prob == 0.0
                and self.hop_latency_prob == 0.0
                and self.skew_alpha is None)


# ---------------------------------------------------------------------------
# Architecture registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register_arch(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_arch(name: str) -> ModelConfig:
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401  (registers every config)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; ported so far: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family variant: <=2 layers, d_model <= 256, fp32 —
    runnable on the CPU in one step (same rules as the JAX package)."""
    seen: List[str] = []
    for p in cfg.pattern:
        if p not in seen:
            seen.append(p)
    pattern = tuple(seen[:2]) or (ATTN_GLOBAL,)
    mlp_seen: List[str] = []
    for p in cfg.mlp_pattern:
        if p not in mlp_seen:
            mlp_seen.append(p)
    mlp_pattern = tuple(mlp_seen[:2]) or (MLP_DENSE,)
    num_layers = max(2, len(pattern), len(mlp_pattern))

    d_model = min(cfg.d_model, 256)
    n_heads = max(2, min(cfg.num_heads, 4))
    kv = 1 if cfg.num_kv_heads == 1 else max(1, min(cfg.num_kv_heads, n_heads))
    head_dim = max(16, d_model // n_heads)
    return cfg.replace(
        name=cfg.name + "-reduced",
        num_layers=num_layers,
        d_model=d_model,
        num_heads=n_heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) or cfg.d_ff,
        vocab_size=min(cfg.vocab_size, 512),
        pattern=pattern,
        mlp_pattern=mlp_pattern,
        window=min(cfg.window, 64) if cfg.window else None,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_capacity_factor=4.0,
        ssm_state=min(cfg.ssm_state, 32) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else cfg.ssm_head_dim,
        ssm_chunk=32,
        lru_width=min(cfg.lru_width, d_model),
        frontend_tokens=min(cfg.frontend_tokens, 16),
        long_context_window=min(cfg.long_context_window, 64)
        if cfg.long_context_window
        else None,
        dtype="float32",
        param_dtype="float32",
    )
