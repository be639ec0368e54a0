"""Configuration for the PyTorch port: the model dataclasses, the
architecture registry, the fault :class:`Scenario`, the input shapes
(:class:`ShapeConfig`), the device mesh (:class:`MeshConfig`), and the
training blocks (:class:`WSSLConfig`,
:class:`TrainConfig`, :class:`AggregationConfig`, and the async and
compression blocks).

A copy of the parts of ``repro/config.py`` that the serving path and the
training rounds read, the synchronous and the bounded-staleness async one.
It is stdlib-only, like the original, and the port keeps its own copy so
that it imports nothing of ``repro``.  Field names, defaults and
``reduced`` are the same, so a config built here and one built by the JAX
package compare equal field by field.
"""

from __future__ import annotations

import dataclasses
import json
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

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.d_model * self.ssm_expand

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def uses_attention(self) -> bool:
        return any(p in (ATTN_GLOBAL, ATTN_LOCAL) for p in self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        n = 0
        emb = self.vocab_size * self.d_model
        n += emb
        if not self.tie_embeddings:
            n += emb
        hd = self.head_dim
        for spec in self.layer_specs():
            if spec.mixer in (ATTN_GLOBAL, ATTN_LOCAL):
                n += self.d_model * (self.num_heads * hd)          # q
                n += 2 * self.d_model * (self.num_kv_heads * hd)   # k,v
                n += (self.num_heads * hd) * self.d_model          # o
                if self.qkv_bias:
                    n += (self.num_heads + 2 * self.num_kv_heads) * hd
            elif spec.mixer == MIX_RGLRU:
                w = self.lru_width
                n += 2 * self.d_model * w + w * self.d_model       # in x2 + out
                n += self.lru_conv * w                             # conv
                n += 2 * w * w + 3 * w                             # gates + Λ etc.
            elif spec.mixer == MIX_SSM:
                di, st, nh = self.d_inner, self.ssm_state, self.ssm_heads
                n += self.d_model * (2 * di + 2 * st + nh)         # in_proj
                n += self.ssm_conv * (di + 2 * st)                 # conv
                n += di * self.d_model                             # out_proj
                n += 2 * nh + di                                   # A, D, dt_bias-ish
            if spec.mlp == MLP_DENSE:
                mult = 3 if self.activation in ("swiglu", "geglu") else 2
                n += mult * self.d_model * self.d_ff
            elif spec.mlp == MLP_MOE:
                mult = 3 if self.activation in ("swiglu", "geglu") else 2
                n += self.num_experts * mult * self.d_model * self.d_ff
                n += self.d_model * self.num_experts               # router
            n += 2 * self.d_model                                  # 2 norms
        n += self.d_model                                          # final norm
        return n

    def active_param_count(self) -> int:
        """Params active per token (MoE: only routed experts)."""
        if self.num_experts == 0:
            return self.param_count()
        mult = 3 if self.activation in ("swiglu", "geglu") else 2
        per_expert = mult * self.d_model * self.d_ff
        n_moe_layers = sum(1 for s in self.layer_specs() if s.mlp == MLP_MOE)
        inactive = n_moe_layers * (self.num_experts - self.experts_per_token) * per_expert
        return self.param_count() - inactive

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Scenario:
    """Client-population fault / heterogeneity scenario (``repro_torch.sim``).

    A Scenario says *who misbehaves and how* along the fixed client axis,
    without changing shapes: cohorts are deterministic index ranges
    (adversarial clients take the lowest indices, stragglers the highest,
    ``floor(fraction * N)`` clients each), and per-round dropout is
    Bernoulli over the clients.  The round reads it through
    ``repro_torch.sim.faults.scenario_params``; the serving router reads
    the replica faults and holds them at zero (see ``serve/router.py``).

    ``skew_alpha`` is the one partition-time knob: when set, client data is
    split with a Dirichlet(alpha) label skew instead of stratified / IID
    (``repro_torch.data.partition.partition_for_scenario``).
    """

    name: str = "clean"
    # transient failures: each client independently drops out of a round
    dropout_prob: float = 0.0
    # slow clients: the top `fraction` of client indices complete only
    # 1/slowdown of their local work per round (update scale in the fused
    # round; fewer local steps in the paper loop)
    straggler_fraction: float = 0.0
    straggler_slowdown: float = 1.0
    # adversarial clients (lowest indices): training labels shifted by
    # max(1, C//2) mod C; the server-held validation labels stay clean
    label_flip_fraction: float = 0.0
    # noisy-gradient clients (lowest indices): N(0, scale^2) added to the
    # client-stage gradient
    gradient_noise_fraction: float = 0.0
    gradient_noise_scale: float = 0.0
    # Byzantine adversaries (lowest indices): sign-flipped client-stage
    # gradients, or updates amplified by a constant factor
    sign_flip_fraction: float = 0.0
    grad_scale_fraction: float = 0.0
    grad_scale_factor: float = 1.0
    # adaptive adversaries (lowest indices): send mean(honest) - margin *
    # std(honest) per coordinate (ALIE style)
    adaptive_fraction: float = 0.0
    adaptive_margin: float = 1.5
    # per-hop faults (multi-hop pipelines): each edge-hop replica dies for
    # the round with hop_dropout_prob (masking the clients routed through
    # it), or straggles with hop_latency_prob at hop_latency_slowdown
    hop_dropout_prob: float = 0.0
    hop_latency_prob: float = 0.0
    hop_latency_slowdown: float = 1.0
    # partition-time label skew (Dirichlet alpha); None = stratified / IID
    skew_alpha: Optional[float] = None
    seed: int = 0
    # the client count a preset is calibrated for (advisory only)
    num_clients_hint: Optional[int] = None

    # -- deterministic cohorts ----------------------------------------------
    @staticmethod
    def _cohort_size(fraction: float, num_clients: int) -> int:
        return int(fraction * num_clients + 1e-6)

    def label_flip_ids(self, num_clients: int) -> List[int]:
        return list(range(self._cohort_size(self.label_flip_fraction,
                                            num_clients)))

    def noise_ids(self, num_clients: int) -> List[int]:
        return list(range(self._cohort_size(self.gradient_noise_fraction,
                                            num_clients)))

    def sign_flip_ids(self, num_clients: int) -> List[int]:
        return list(range(self._cohort_size(self.sign_flip_fraction,
                                            num_clients)))

    def grad_scale_ids(self, num_clients: int) -> List[int]:
        return list(range(self._cohort_size(self.grad_scale_fraction,
                                            num_clients)))

    def adaptive_ids(self, num_clients: int) -> List[int]:
        return list(range(self._cohort_size(self.adaptive_fraction,
                                            num_clients)))

    def adversary_ids(self, num_clients: int) -> List[int]:
        """Union of the corrupted cohorts (all are index prefixes), for
        reporting; each fault applies only to its own cohort."""
        k = self._cohort_size(max(self.label_flip_fraction,
                                  self.gradient_noise_fraction,
                                  self.sign_flip_fraction,
                                  self.grad_scale_fraction,
                                  self.adaptive_fraction), num_clients)
        return list(range(k))

    def straggler_ids(self, num_clients: int) -> List[int]:
        k = self._cohort_size(self.straggler_fraction, num_clients)
        return list(range(num_clients - k, num_clients))

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

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


# ---------------------------------------------------------------------------
# WSSL / train configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AsyncRoundsConfig:
    """Bounded-staleness asynchronous rounds (``core/async_round.py``).

    ``deadline`` is measured in simulated client latencies: a clean client
    finishes its round at t = 1.0, a straggler at slowdown x4 at t = 4.0
    (``sim.faults.client_latencies``).  A client that misses the deadline
    is buffered: its update lands ``ceil(latency / deadline) - 1`` rounds
    later at a staleness discount fused into the aggregation coefficients
    (``wssl.staleness_weights``).  ``deadline = inf`` is the synchronous
    round, bit for bit; ``max_staleness`` evicts (and resyncs) updates
    that would land that stale; ``buffer_size`` caps the parked updates
    (None: one slot per client)."""

    deadline: float = float("inf")
    max_staleness: int = 4
    staleness_weighting: str = "polynomial"
    staleness_alpha: float = 0.5
    buffer_size: Optional[int] = None

    _WEIGHTINGS = ("constant", "polynomial", "exponential")

    def __post_init__(self):
        if self.staleness_weighting not in self._WEIGHTINGS:
            raise ValueError(
                f"staleness_weighting {self.staleness_weighting!r} not in "
                f"{self._WEIGHTINGS}")
        if self.deadline <= 0:
            raise ValueError("deadline must be positive (inf = synchronous)")
        if self.max_staleness < 1:
            raise ValueError("max_staleness must be >= 1")
        if self.buffer_size is not None and self.buffer_size < 1:
            raise ValueError("buffer_size must be >= 1 (None = one slot "
                             "per client)")

    @property
    def enabled(self) -> bool:
        return math.isfinite(self.deadline)

    def replace(self, **kw) -> "AsyncRoundsConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class CompressionConfig:
    """Update- and activation-path compression (``repro_torch.compress``).

    Client updates (the post-optimizer stage deltas uploaded for
    aggregation) are compressed before they cross the wire and
    reconstructed in front of ``aggregation.aggregate_clients``, so every
    registry rule runs on the reconstructed updates.  The hot loops
    (stochastic quantize / dequantize, magnitude-top-k masking) are CUDA
    kernels on the card (``kernels/csrc/compress.cu``).

    * ``none`` — the round runs no compression op at all.
    * ``topk`` — each client keeps the ``rate`` fraction of largest-|x|
      coordinates per leaf row; the wire carries (value, index) pairs.
    * ``int8`` / ``int4`` — stochastic symmetric quantization at
      2^(bits-1)-1 levels per client row with an fp32 scale per row; both
      take the same ``"quant"`` branch (``kind``), the level count is a
      runtime value (``compress.CompressionParams``).

    ``error_feedback`` keeps a per-client fp32 residual
    (``WSSLState.ef_residual``): e <- (delta + e) - decompress(compress(
    delta + e)).  ``activations`` also compresses every split-hop crossing
    (activations up, their cotangents down) with the same scheme.
    """

    scheme: str = "none"          # none | topk | int8 | int4
    rate: float = 0.05            # topk: kept fraction of coordinates
    error_feedback: bool = True
    activations: bool = False

    _SCHEMES = ("none", "topk", "int8", "int4")

    def __post_init__(self):
        if self.scheme not in self._SCHEMES:
            raise ValueError(f"compression scheme {self.scheme!r} not in "
                             f"{self._SCHEMES}")
        if not 0.0 < self.rate <= 1.0:
            raise ValueError("compression rate must be in (0, 1]")

    @property
    def enabled(self) -> bool:
        return self.scheme != "none"

    @property
    def kind(self) -> str:
        """The branch the round takes: int8 and int4 share ``"quant"``."""
        if self.scheme in ("int8", "int4"):
            return "quant"
        return self.scheme

    @property
    def bits(self) -> int:
        """Wire bits per element (topk / none count full fp32 values)."""
        return {"int8": 8, "int4": 4}.get(self.scheme, 32)

    def replace(self, **kw) -> "CompressionConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class AggregationConfig:
    """Algorithm 2 step 5 as a policy block: ``rule`` names an entry of the
    aggregator registry (``core/aggregation.py``).  Every built-in rule of
    the JAX package is a valid name."""

    rule: str = "importance"
    trim_fraction: float = 0.1
    byzantine_f: int = 1
    multi_krum_m: Optional[int] = None
    clip_factor: float = 1.0

    _RULES = ("importance", "uniform", "trimmed_mean", "median", "krum",
              "multi_krum", "geometric_median", "norm_clip")

    def __post_init__(self):
        if self.rule not in self._RULES and not self._registered(self.rule):
            raise ValueError(f"aggregation rule {self.rule!r} not in "
                             f"{self._RULES} and not registered")
        if not 0.0 <= self.trim_fraction <= 0.5:
            raise ValueError("trim_fraction must be in [0, 0.5]")
        if self.byzantine_f < 0:
            raise ValueError("byzantine_f must be >= 0")
        if self.multi_krum_m is not None and self.multi_krum_m < 1:
            raise ValueError("multi_krum_m must be >= 1 (None = s - f)")
        if self.clip_factor <= 0.0:
            raise ValueError("clip_factor must be > 0")

    @staticmethod
    def _registered(rule: str) -> bool:
        # user rules registered with core.aggregation.register_aggregator
        from repro_torch.core.aggregation import list_aggregators
        return rule in list_aggregators()

    def replace(self, **kw) -> "AggregationConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class WSSLConfig:
    """Knobs of the paper's algorithm (Algorithms 1 & 2); the same fields,
    defaults and resolution rules as the JAX package's."""

    num_clients: int = 4
    split_layer: Optional[int] = None
    split_layers: Optional[Tuple[int, ...]] = None
    hop_replicas: int = 1
    selection_rule: str = "fraction"
    participation_fraction: float = 0.5
    importance_temp: float = 1.0
    importance_ema: float = 0.5
    aggregation: str = "importance"
    trim_fraction: float = 0.1
    agg: Optional[AggregationConfig] = None
    select_staleness_beta: float = 0.0
    async_rounds: AsyncRoundsConfig = AsyncRoundsConfig()
    compression: CompressionConfig = CompressionConfig()
    seed: int = 0

    def resolve_aggregation(self) -> AggregationConfig:
        """The ``agg`` block when set, else one built from the legacy
        ``aggregation`` / ``trim_fraction`` fields."""
        if self.agg is not None:
            return self.agg
        return AggregationConfig(rule=self.aggregation,
                                 trim_fraction=self.trim_fraction)

    def resolve_split(self, model: ModelConfig) -> int:
        """Default cut: a thin client, at most 4 super-blocks and at most
        L/4 layers."""
        if self.split_layer is not None:
            return self.split_layer
        period = model.period
        quarter = (model.num_layers // 4) // period * period
        cut = max(period, min(4 * period, quarter))
        return min(cut, model.num_layers - period)

    def resolve_cuts(self, model: ModelConfig) -> Tuple[int, ...]:
        """The pipeline's cut layers as a strictly increasing tuple, each on
        a super-block boundary in [0, num_layers]."""
        if self.split_layers is None:
            return (self.resolve_split(model),)
        cuts = tuple(int(c) for c in self.split_layers)
        if not cuts:
            raise ValueError("split_layers must name at least one cut")
        prev = -1
        for c in cuts:
            if c % model.period:
                raise ValueError(f"cut {c} must align to the super-block "
                                 f"period {model.period}")
            if not prev < c:
                raise ValueError(f"cuts must be strictly increasing: {cuts}")
            prev = c
        if cuts[-1] > model.num_layers:
            raise ValueError(
                f"last cut {cuts[-1]} exceeds num_layers "
                f"({model.num_layers})")
        return cuts

    def num_selected(self, norm_weights=None) -> int:
        if self.selection_rule == "literal":
            # alpha' = max(alpha * mean(gamma), 1); mean(gamma) == 1/alpha
            return 1
        return max(int(round(self.num_clients * self.participation_fraction)),
                   1)


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    rounds: int = 20
    steps_per_round: int = 10
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 10
    schedule: str = "cosine"          # cosine | linear | constant
    optimizer: str = "adamw"          # adamw | sgd
    remat: bool = True
    # recompute every `remat_span` super-blocks in the backward
    remat_span: int = 4
    # per-client fwd/bwd in chunks of this many clients: shared-stage
    # gradients and the loss sum per chunk, then across chunks; must divide
    # num_clients.  None = all clients at once
    client_chunk: Optional[int] = None
    # accepted for parity with the JAX config and changes nothing: the
    # port's AdamW always steps through kernels/ops.fused_adamw (the CUDA
    # kernel on the card, its plain version on the CPU)
    fused_adam: bool = False
    seed: int = 0

    def __post_init__(self):
        if self.client_chunk is not None and self.client_chunk < 1:
            raise ValueError(
                f"client_chunk must be a positive client count or None, "
                f"got {self.client_chunk}")
        if self.fused_adam and self.optimizer != "adamw":
            raise ValueError(
                f"fused_adam requires optimizer='adamw' (the kernel fuses "
                f"the Adam moment update), got optimizer={self.optimizer!r}")


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


INPUT_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


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


def list_archs() -> List[str]:
    """Every registered architecture's name, sorted."""
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401  (registers every config)
    return sorted(_REGISTRY)


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
