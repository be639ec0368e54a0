"""The decoder for serving: init, prefill and one-token decode.

The PyTorch twin of the serving half of ``repro/models/transformer.py``.
The parameter tree keeps the JAX layout — ``params["stack"]`` is a list
(one entry per layer of the repeating super-block) of trees whose leaves
carry a leading layer axis ``(L, ...)``; ``params["rem"]`` holds the
remainder layers — so the bridge from JAX is a plain copy and the layer
loop indexes views ``w[i]``.  Caches mirror the same layout and are
updated in place.

So far only global attention with a dense MLP is ported; any other mixer
or MLP kind raises ``NotImplementedError`` naming the ROADMAP item that
ports it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import (ATTN_GLOBAL, MLP_DENSE, LayerSpec,
                                ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_param,
                                       resolve_device, softcap,
                                       text_positions, torch_dtype)

Params = Dict[str, Any]


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer != ATTN_GLOBAL:
        raise NotImplementedError(
            f"mixer {spec.mixer!r} is not ported yet: local attention, SSM and "
            f"RG-LRU come with ROADMAP Queue 1, item 11 (the other model "
            f"families)")
    if spec.mlp != MLP_DENSE:
        raise NotImplementedError(
            f"mlp {spec.mlp!r} is not ported yet (ROADMAP Queue 1, item 11: "
            f"models/moe.py)")


def _superblock_layout(cfg: ModelConfig) -> Tuple[List[LayerSpec], int, int]:
    """Returns (period specs, n_full, n_rem), all specs checked as ported."""
    specs = cfg.layer_specs()
    for spec in specs:
        _check_spec(spec)
    p = cfg.period
    n_full = cfg.num_layers // p
    return specs[:p], n_full, cfg.num_layers - n_full * p


def _layers(params: Params, cache: Params, cfg: ModelConfig):
    """Yield (layer params, layer cache) for every layer in order: the
    stacked super-blocks (views ``w[i]``), then the remainder layers."""
    period_specs, n_full, _ = _superblock_layout(cfg)
    for i in range(n_full):
        for j in range(len(period_specs)):
            lp = _tree_index(params["stack"][j], i)
            lc = _tree_index(cache["stack"][j], i)
            yield lp, lc
    for lp, lc in zip(params["rem"], cache["rem"]):
        yield lp, lc


def _tree_index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _layer_init(gen, cfg: ModelConfig, layers: int, dtype, device) -> Params:
    """One layer's params, ``layers > 0`` stacked on a leading axis."""
    d, hq, hkv, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    lead = (layers,) if layers else ()

    def w(shape, scale=None):
        return dense_param(gen, shape, layers=layers, scale=scale,
                           dtype=dtype, device=device)

    def zeros():
        return torch.zeros(lead + (d,), dtype=torch.float32, device=device)

    mlp = {}
    if cfg.activation in ("swiglu", "geglu"):
        mlp["wg"] = w((d, f))
    mlp["wu"] = w((d, f))
    mlp["wd"] = w((f, d), scale=1.0 / f ** 0.5)
    return {
        "norm1": {"scale": zeros()},
        "mixer": {"wq": w((d, hq, hd)), "wk": w((d, hkv, hd)),
                  "wv": w((d, hkv, hd)),
                  "wo": w((hq, hd, d), scale=1.0 / (hq * hd) ** 0.5)},
        "norm2": {"scale": zeros()},
        "mlp": mlp,
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device="cuda") -> Params:
    """Random params from ``gen`` (a generator on ``device``), with the JAX
    package's init scales and tree layout.  Matrices are stored in
    ``cfg.dtype``, norm scales in fp32."""
    device = resolve_device(device)
    period_specs, n_full, n_rem = _superblock_layout(cfg)
    dtype = torch_dtype(cfg.dtype)
    params: Params = {
        "embed": {"tok": dense_param(gen, (cfg.vocab_size, cfg.d_model),
                                     scale=cfg.d_model ** -0.5, dtype=dtype,
                                     device=device)},
        "stack": [_layer_init(gen, cfg, n_full, dtype, device)
                  for _ in period_specs],
        "rem": [_layer_init(gen, cfg, 0, dtype, device) for _ in range(n_rem)],
        "final_norm": {"scale": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                            device=device)},
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_param(gen, (cfg.d_model, cfg.vocab_size),
                                     scale=cfg.d_model ** -0.5, dtype=dtype,
                                     device=device)
    return params


# ---------------------------------------------------------------------------
# Embed / unembed
# ---------------------------------------------------------------------------


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor
           ) -> torch.Tensor:
    dtype = torch_dtype(cfg.dtype)
    x = params["embed"]["tok"].to(dtype)[tokens.long()]
    if cfg.embed_scale:
        # the scale is rounded to the activation dtype first (45.25 in bf16);
        # rounding it on the host keeps a device copy off every step
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=dtype))
    return x


def _unembed(cfg: ModelConfig, params: Params, x: torch.Tensor
             ) -> torch.Tensor:
    dtype = x.dtype
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["tok"].to(dtype).t()
    else:
        logits = x @ params["head"].to(dtype)
    return softcap(logits.float(), cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def _layer_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device, paged: Optional[Tuple[int, int]],
                      layers: int) -> Params:
    if paged is not None:
        one = attn.init_paged_kv_cache(cfg, paged[0], paged[1], dtype, device)
    else:
        one = attn.init_kv_cache(cfg, batch, max_len, dtype, device)
    if not layers:
        return one
    return {k: v[None].repeat((layers,) + (1,) * v.dim())
            for k, v in one.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               paged: Optional[Tuple[int, int]] = None,
               device="cuda") -> Params:
    """Cache tree matching the stack/rem layout.  ``paged=(num_blocks,
    block_size)`` pools every global-attention layer's KV into a shared
    block pool; the decode entry points then need a block ``table``."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    period_specs, n_full, n_rem = _superblock_layout(cfg)
    return {
        "stack": [_layer_cache_init(cfg, batch, max_len, dtype, device, paged,
                                    n_full) for _ in period_specs],
        "rem": [_layer_cache_init(cfg, batch, max_len, dtype, device, paged, 0)
                for _ in range(n_rem)],
    }


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _decode_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  cache: Params, pos: torch.Tensor,
                  table: Optional[torch.Tensor],
                  paged_kernel: bool) -> torch.Tensor:
    h = apply_norm(cfg, p["norm1"], x)
    if "pk" in cache:
        mixed, _ = attn.paged_decode_attention(cfg, p["mixer"], h, cache, pos,
                                               table, kernel=paged_kernel)
    else:
        mixed, _ = attn.decode_attention(cfg, p["mixer"], h, cache, pos)
    x = x + mixed
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, pos: torch.Tensor, *,
                table: Optional[torch.Tensor] = None,
                paged_kernel: bool = False
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1); pos: (B,) per-row absolute
    positions -> (logits (B, 1, V) fp32, the cache updated in place).

    ``table`` is the ``(B, nb)`` block table of a paged cache (contiguous
    caches ignore it); ``paged_kernel`` sends paged layers through the
    CUDA block-table kernel instead of the gather."""
    x = _embed(cfg, params, tokens)
    for lp, lc in _layers(params, cache, cfg):
        x = _decode_layer(cfg, lp, x, lc, pos, table, paged_kernel)
    x = apply_norm(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x), cache


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _prefill_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   cache: Params, positions: torch.Tensor,
                   impl: str) -> torch.Tensor:
    h = apply_norm(cfg, p["norm1"], x)
    mixed, _ = attn.prefill_attention(cfg, p["mixer"], h, positions, cache,
                                      impl=impl)
    x = x + mixed
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: Optional[Params] = None, max_len: Optional[int] = None,
            impl: str = "dense", last_only: bool = False
            ) -> Tuple[torch.Tensor, Params]:
    """Full-sequence forward that fills a contiguous KV cache (in place).

    Returns (logits (B, S, V) fp32, or (B, 1, V) with ``last_only``, and
    the cache).  ``max_len`` sizes a fresh cache when ``cache`` is not
    given (default: the prompt length).  ``last_only`` unembeds only the
    final position, which is all the serving path reads."""
    x = _embed(cfg, params, tokens)
    b, s, _ = x.shape
    if cache is None:
        cache = init_cache(cfg, b, max_len or s, device=x.device)
    positions = text_positions(b, s, x.device)
    for lp, lc in _layers(params, cache, cfg):
        x = _prefill_layer(cfg, lp, x, lc, positions, impl)
    x = apply_norm(cfg, params["final_norm"], x)
    if last_only:
        x = x[:, -1:]
    return _unembed(cfg, params, x), cache
