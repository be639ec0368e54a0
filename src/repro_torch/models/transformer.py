"""The decoder: init, the full-sequence forward, prefill and one-token
decode (merged, or stage by stage through the WSSL cuts for split
serving), for every ported layer kind.

The PyTorch twin of ``repro/models/transformer.py``.  The parameter tree
keeps the JAX layout — ``params["stack"]`` is a list (one entry per layer
of the repeating super-block) of trees whose leaves carry a leading layer
axis ``(L, ...)``; ``params["rem"]`` holds the remainder layers — so the
bridge from JAX is a plain copy and the layer loop indexes views ``w[i]``.
Caches mirror the same layout and are updated in place.

Layer kinds: global and local (sliding-window) attention, the Mamba-2 SSD
block (``models/ssm.py``) and the RG-LRU block (``models/rglru.py``), with
a dense MLP, a Mixture-of-Experts MLP (``models/moe.py``) or none.
``impl="kernel"`` (alias ``"pallas"``) sends the full-sequence forward
through the flash, SSD-scan and RG-LRU kernels, as the JAX forward's
``"pallas"`` does; prefill into a cache runs the recurrent blocks' plain
scans, which return the final state the kernels do not.

A vision frontend (``models/frontend.py``) puts projected patch
embeddings (``embeds``) in front of the text in the full-sequence paths
(forward, prefill, the client stage), at M-RoPE grid positions; the later
stages and the loss see the spliced sequence at text positions and trim
the prefix, as in JAX.  Decode takes the long-context
``decode_window_override``: every global layer's cache is then a ring of
that window, never paged.

On a grid (``sharding.current_grid()``: the sharded prefill and decode
steps of ``launch/steps.py``) the forward, the prefill into a cache and
the decode steps run on this rank's blocks: each layer first gathers its
data-placed (FSDP) blocks over the data group (:func:`_layer_blocks`),
the attention, MLP and MoE layers run their model-axis splits and sum
over the model group, the embedding looks up the vocab rows this rank
holds and sums them, and the tied (or untied) logits are a vocab slice a
rank, gathered over the model group.  A cache on a grid is this rank's
block (:func:`init_cache` under the binding: split on its sequence over
the ``kv_seq`` axes, ``models/attention.py``).  A paged cache and the
training stages refuse a grid (the stages through
``sharding.refuse_grid``), as every step refuses the bindings no slice
executes yet (``sharding.check_executable``).

The MoE layers' load-balance aux loss is summed over the layers (fp32) by
the forward, an edge stage (``stage_forward(with_aux=True)``) and the
server stage, as in JAX; the client stage (stage 0), prefill and decode
drop it.

For training, a stacked leaf may also be a Python list of per-layer
tensors (``core/round.py`` binds each layer's slice as a leaf of its own,
so autograd accumulates into the slice and not into a full-size buffer
per layer); the layer loops index both forms the same way.  ``remat``
recomputes the activations of each span of super-blocks in the backward
(``torch.utils.checkpoint``), and with a period above 1 each layer of a
super-block under a checkpoint of its own inside the span's, as JAX
nests them; neither changes a number.  Training runs attention through
any impl of ``attention.TRAIN_IMPLS`` (the flash path's recomputing
backward under ``chunked`` / ``flash``) and the recurrent blocks through
their plain scans: the kernels have no backward, in either package.
"""

from __future__ import annotations

import functools
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch.config import (ATTN_GLOBAL, ATTN_LOCAL, MIX_RGLRU, MIX_SSM,
                                MLP_DENSE, MLP_MOE, MLP_NONE, LayerSpec,
                                ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import frontend as fe
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_param,
                                       resolve_device, softcap,
                                       text_positions, torch_dtype)

Params = Dict[str, Any]

_MIXERS = (ATTN_GLOBAL, ATTN_LOCAL, MIX_SSM, MIX_RGLRU)


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer not in _MIXERS:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    if spec.mlp not in (MLP_DENSE, MLP_MOE, MLP_NONE):
        raise ValueError(f"unknown mlp {spec.mlp!r}")


def _is_attn(spec: LayerSpec) -> bool:
    return spec.mixer in (ATTN_GLOBAL, ATTN_LOCAL)


def _superblock_layout(cfg: ModelConfig) -> Tuple[List[LayerSpec], int, int]:
    """Returns (period specs, n_full, n_rem), all specs checked as ported."""
    specs = cfg.layer_specs()
    for spec in specs:
        _check_spec(spec)
    p = cfg.period
    n_full = cfg.num_layers // p
    return specs[:p], n_full, cfg.num_layers - n_full * p


def _layers(params: Params, cache: Params, cfg: ModelConfig
            ) -> Iterator[Tuple[LayerSpec, Params, Params]]:
    """Yield (spec, layer params, layer cache) for every layer in order:
    the stacked super-blocks (views ``w[i]``), then the remainder layers."""
    period_specs, n_full, _ = _superblock_layout(cfg)
    for i in range(n_full):
        for j, spec in enumerate(period_specs):
            yield (spec, _tree_index(params["stack"][j], i),
                   _tree_index(cache["stack"][j], i))
    rem_specs = cfg.layer_specs()[n_full * len(period_specs):]
    yield from zip(rem_specs, params["rem"], cache["rem"])


def _tree_index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _layer_init(gen, cfg: ModelConfig, spec: LayerSpec, layers: int, dtype,
                device) -> Params:
    """One layer's params, ``layers > 0`` stacked on a leading axis."""
    d, hq, hkv, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    lead = (layers,) if layers else ()

    def w(shape, scale=None):
        return dense_param(gen, shape, layers=layers, scale=scale,
                           dtype=dtype, device=device)

    def bias(*shape):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    p: Params = {"norm1": _norm_init(cfg, lead, dtype, device)}
    # the MLP is drawn before the mixer, so a seed keeps giving the dense
    # models the weights it gave them before the other mixers came
    mlp = {}
    if spec.mlp == MLP_MOE:
        mlp = moe_mod.moe_init(gen, cfg, layers=layers, dtype=dtype,
                               device=device)
    elif spec.mlp != MLP_NONE:
        if cfg.activation in ("swiglu", "geglu"):
            mlp["wg"] = w((d, f))
        mlp["wu"] = w((d, f))
        mlp["wd"] = w((f, d), scale=1.0 / f ** 0.5)
        if cfg.mlp_bias:
            mlp["bu"], mlp["bd"] = bias(f), bias(d)
    if _is_attn(spec):
        p["mixer"] = {"wq": w((d, hq, hd)), "wk": w((d, hkv, hd)),
                      "wv": w((d, hkv, hd)),
                      "wo": w((hq, hd, d), scale=1.0 / (hq * hd) ** 0.5)}
        if cfg.qkv_bias:
            p["mixer"].update(bq=bias(hq, hd), bk=bias(hkv, hd),
                              bv=bias(hkv, hd))
    elif spec.mixer == MIX_SSM:
        p["mixer"] = ssm_mod.ssm_init(gen, cfg, layers=layers, dtype=dtype,
                                      device=device)
    else:
        p["mixer"] = rglru_mod.rglru_init(gen, cfg, layers=layers,
                                          dtype=dtype, device=device)
    if spec.mlp != MLP_NONE:
        p["norm2"] = _norm_init(cfg, lead, dtype, device)
        p["mlp"] = mlp
    return p


def _norm_init(cfg: ModelConfig, lead: Tuple[int, ...], dtype,
               device) -> Params:
    """A norm's leaves, as the JAX package initialises them: RMSNorm's
    ``scale`` zeros (it applies ``1 + scale``); LayerNorm's ``scale`` ones
    and ``bias`` zeros.  Scales are fp32; the bias is stored in ``dtype``
    like the matrices (the norm casts both at use)."""
    shape = lead + (cfg.d_model,)
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(shape, dtype=torch.float32,
                                    device=device),
                "bias": torch.zeros(shape, dtype=dtype, device=device)}
    return {"scale": torch.zeros(shape, dtype=torch.float32, device=device)}


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device="cuda", dtype: Optional[torch.dtype] = None) -> Params:
    """Random params from ``gen`` (a generator on ``device``), with the JAX
    package's init scales and tree layout.  Matrices are stored in
    ``dtype`` — by default ``cfg.dtype``, what serving computes in;
    training passes ``cfg.param_dtype`` (fp32 master weights, cast to
    ``cfg.dtype`` on use as in JAX), the biases (``bq``, ``bk``, ``bv``,
    ``bu``, ``bd``, LayerNorm's ``bias``; zeros, as in JAX) and the
    vision projector ``frontend.proj`` too — and the
    leaves the model reads in fp32 in fp32 (norm scales; the SSD block's
    ``A_log``, ``D``, ``dt_bias``, ``norm_scale``; the RG-LRU gates
    ``w_r``, ``w_i``, ``b_r``, ``b_i`` and ``lambda``).  The tree's keys
    and shapes are the JAX package's, so ``tree.py``'s sorted-key leaf
    order is shared with it.  On the meta device ``gen`` is None (nothing
    is drawn: :func:`abstract_params`)."""
    device = resolve_device(device)
    period_specs, n_full, n_rem = _superblock_layout(cfg)
    rem_specs = cfg.layer_specs()[n_full * len(period_specs):]
    dtype = dtype or torch_dtype(cfg.dtype)
    params: Params = {
        "embed": {"tok": dense_param(gen, (cfg.vocab_size, cfg.d_model),
                                     scale=cfg.d_model ** -0.5, dtype=dtype,
                                     device=device)},
        "stack": [_layer_init(gen, cfg, spec, n_full, dtype, device)
                  for spec in period_specs],
        "rem": [_layer_init(gen, cfg, spec, 0, dtype, device)
                for spec in rem_specs],
        "final_norm": _norm_init(cfg, (), dtype, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_param(gen, (cfg.d_model, cfg.vocab_size),
                                     scale=cfg.d_model ** -0.5, dtype=dtype,
                                     device=device)
    # drawn last, so a seed keeps giving every config without a vision
    # frontend the weights it gave it before the frontend came
    proj = fe.frontend_init(gen, cfg, dtype=dtype, device=device)
    if proj:
        params["frontend"] = proj
    return params


def init_params_by_layer(cfg: ModelConfig, seed: int, *, device="cuda",
                         keep: Optional[Callable] = None) -> Params:
    """Random params drawn a piece at a time, each piece from a generator
    of its own seeded from ``(seed, piece)``: the embedding, every layer
    of every super-block slot, the remainder layers, the head and the
    frontend, through :func:`init_params`' own inits (its scales, dtypes
    and tree).  ``keep(axes, leaf)`` maps each leaf of a drawn piece (one
    layer's, unstacked, with its logical axes) to what is kept, e.g. this
    rank's block (``_bridge.init_shard_params``); by default the leaf
    itself, so the whole tree.  At most one piece is ever whole, and
    every rank of a grid and the one-rank reference hold blocks of the
    same whole tree: the pieces do not depend on the order of the draws,
    unlike :func:`init_params`' one stream."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    keep = keep or (lambda axes, leaf: leaf)
    period_specs, n_full, _ = _superblock_layout(cfg)
    rem_specs = cfg.layer_specs()[n_full * len(period_specs):]
    axes = param_axes_tree(cfg)
    pieces = iter(range(1 << 16))

    def gen():
        g = torch.Generator(device=device)
        return g.manual_seed((seed << 16) + next(pieces))

    def kept(ax, tree):
        return sharding.map_axes(keep, ax, tree)

    def vocab(shape):
        return dense_param(gen(), shape, scale=cfg.d_model ** -0.5,
                           dtype=dtype, device=device)

    params: Params = {"embed": kept(axes["embed"], {"tok": vocab(
        (cfg.vocab_size, cfg.d_model))})}
    stack = []
    for spec in period_specs:
        ax = _layer_axes(cfg, spec, False)
        stacked = None
        for i in range(n_full):
            layer = kept(ax, _layer_init(gen(), cfg, spec, 0, dtype, device))
            if stacked is None:
                stacked = sharding.map_axes(
                    lambda _, t: t.new_empty((n_full,) + tuple(t.shape)),
                    ax, layer)
            _copy_layer(stacked, layer, i)
        stack.append(stacked)
    params["stack"] = stack
    params["rem"] = [kept(_layer_axes(cfg, spec, False),
                          _layer_init(gen(), cfg, spec, 0, dtype, device))
                     for spec in rem_specs]
    params["final_norm"] = kept(axes["final_norm"],
                                _norm_init(cfg, (), dtype, device))
    if not cfg.tie_embeddings:
        params["head"] = keep(axes["head"], vocab((cfg.d_model,
                                                   cfg.vocab_size)))
    proj = fe.frontend_init(gen(), cfg, dtype=dtype, device=device)
    if proj:
        params["frontend"] = kept(axes["frontend"], proj)
    return params


def _copy_layer(stacked: Params, layer: Params, i: int) -> None:
    for k, v in layer.items():
        if isinstance(v, dict):
            _copy_layer(stacked[k], v, i)
        else:
            stacked[k][i].copy_(v)


def abstract_params(cfg: ModelConfig, *, dtype: Optional[torch.dtype] = None
                    ) -> Tuple[Params, Dict[str, Any]]:
    """(params on the meta device, their logical-axes tree): the shapes
    and dtypes :func:`init_params` gives, allocating nothing (the
    counterpart of JAX's ``abstract_params``)."""
    return (init_params(cfg, None, device="meta", dtype=dtype),
            param_axes_tree(cfg))


# ---------------------------------------------------------------------------
# Logical axes (the rules of ``sharding.py`` bind them to mesh axes)
# ---------------------------------------------------------------------------


def _norm_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    if cfg.norm == "layernorm":
        return {"scale": ("embed",), "bias": ("embed",)}
    return {"scale": ("embed",)}


def _mixer_axes(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, Tuple]:
    if _is_attn(spec):
        # attn_din / attn_dout rebind to the model axis when the heads
        # cannot shard it (launch/specs.py::build_rules)
        ax = {"wq": ("attn_din", "heads", None),
              "wk": ("attn_din", "kv_heads", None),
              "wv": ("attn_din", "kv_heads", None),
              "wo": ("heads", None, "attn_dout")}
        if cfg.qkv_bias:
            ax.update(bq=("heads", None), bk=("kv_heads", None),
                      bv=("kv_heads", None))
        return ax
    if spec.mixer == MIX_SSM:
        return {"wz": ("fsdp", "ssm_inner"), "wx": ("fsdp", "ssm_inner"),
                "wB": ("fsdp", None), "wC": ("fsdp", None),
                "wdt": ("fsdp", "ssm_heads"), "wo": ("ssm_inner", "fsdp"),
                "conv_x": (None, "ssm_inner"), "conv_BC": (None, None),
                "A_log": ("ssm_heads",), "D": ("ssm_heads",),
                "dt_bias": ("ssm_heads",), "norm_scale": ("ssm_inner",)}
    return {"wy": ("fsdp", "lru"), "wgate": ("fsdp", "lru"),
            "conv": (None, "lru"), "w_r": (None, "lru"),
            "w_i": (None, "lru"), "wo": ("lru", "fsdp"),
            "lambda": ("lru",), "b_r": ("lru",), "b_i": ("lru",)}


def _mlp_axes(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, Tuple]:
    gated = cfg.activation in ("swiglu", "geglu")
    if spec.mlp == MLP_MOE:
        ax = {"router": ("fsdp", None),
              "wu": ("expert", "fsdp", None), "wd": ("expert", None, "fsdp")}
        if gated:
            ax["wg"] = ("expert", "fsdp", None)
        return ax
    ax = {"wu": ("fsdp", "ff"), "wd": ("ff", "fsdp")}
    if gated:
        ax["wg"] = ("fsdp", "ff")
    if cfg.mlp_bias:
        ax.update(bu=("ff",), bd=("embed",))
    return ax


def _layer_axes(cfg: ModelConfig, spec: LayerSpec, stacked: bool) -> Params:
    ax: Params = {"norm1": _norm_axes(cfg), "mixer": _mixer_axes(cfg, spec)}
    if spec.mlp != MLP_NONE:
        ax["norm2"] = _norm_axes(cfg)
        ax["mlp"] = _mlp_axes(cfg, spec)
    if stacked:     # the leading layer axis is never sharded
        ax = _prepend_none(ax)
    return ax


def _prepend_none(tree):
    if isinstance(tree, dict):
        return {k: _prepend_none(v) for k, v in tree.items()}
    return (None,) + tuple(tree)


def param_axes_tree(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical-axes tree of :func:`init_params`'s tree, leaf for leaf
    JAX's ``param_axes_tree``."""
    period_specs, n_full, _ = _superblock_layout(cfg)
    rem_specs = cfg.layer_specs()[n_full * len(period_specs):]
    axes: Dict[str, Any] = {
        "embed": {"tok": ("vocab", "fsdp")},
        "stack": [_layer_axes(cfg, spec, True) for spec in period_specs],
        "rem": [_layer_axes(cfg, spec, False) for spec in rem_specs],
        "final_norm": _norm_axes(cfg),
    }
    if cfg.frontend == "vision":
        axes["frontend"] = {"proj": ("fsdp", "embed")}
    if not cfg.tie_embeddings:
        axes["head"] = ("fsdp", "vocab")
    return axes


def _layer_cache_axes(spec: LayerSpec, stacked: bool,
                      paged: bool) -> Dict[str, Tuple]:
    if _is_attn(spec):
        if paged:
            ax = {"pk": (None, None, "kv_heads", None),
                  "pv": (None, None, "kv_heads", None),
                  "ppos": (None, None)}
        else:
            ax = {"k": ("batch", "kv_seq", "kv_heads", None),
                  "v": ("batch", "kv_seq", "kv_heads", None),
                  "pos": ("batch", None)}
    elif spec.mixer == MIX_SSM:
        ax = {"state": ("batch", "ssm_heads", None, None),
              "conv_x": ("batch", None, "ssm_inner"),
              "conv_BC": ("batch", None, None)}
    else:
        ax = {"h": ("batch", "lru"), "conv": ("batch", None, "lru")}
    return _prepend_none(ax) if stacked else ax


def cache_axes(cfg: ModelConfig, *, paged: bool = False,
               decode_window_override: Optional[int] = None
               ) -> Dict[str, Any]:
    """The logical-axes tree of :func:`init_cache`'s tree, JAX's
    ``cache_axes`` for a contiguous cache.  ``paged=True`` gives a paged
    cache's pools (layers that page, as :func:`init_cache` decides)
    unsharded block axes."""
    period_specs, n_full, _ = _superblock_layout(cfg)
    rem_specs = cfg.layer_specs()[n_full * len(period_specs):]

    def pages(spec):
        return (paged and _is_attn(spec)
                and _decode_window(spec, decode_window_override) is None)

    return {"stack": [_layer_cache_axes(s, True, pages(s))
                      for s in period_specs],
            "rem": [_layer_cache_axes(s, False, pages(s))
                    for s in rem_specs]}


# ---------------------------------------------------------------------------
# Embed / unembed
# ---------------------------------------------------------------------------


def _vocab_matrix(cfg: ModelConfig, params: Params, key: str
                  ) -> Tuple[torch.Tensor, Optional[int]]:
    """The embedding table (``key="tok"``) or the untied head as this
    rank computes with it: outside a grid the leaf itself; on a grid its
    data-placed dim gathered over the data group.  Returns (the matrix,
    where this rank's vocab block starts, or None when it holds the whole
    vocab)."""
    if key == "tok":
        w, axes, vdim = params["embed"]["tok"], ("vocab", "fsdp"), 0
        whole = (cfg.vocab_size, cfg.d_model)
    else:
        w, axes, vdim = params["head"], ("fsdp", "vocab"), 1
        whole = (cfg.d_model, cfg.vocab_size)
    if sharding.current_grid() is None:
        return w, None
    w = sharding.gather_data_blocks(
        w, axes, torch.empty(whole, device="meta"))
    return w, sharding.model_block(cfg.vocab_size, w.shape[vdim])


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
           embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings (B, S, D) in ``cfg.dtype``; with a vision frontend
    and ``embeds`` (B, F, D), the projected patches put in front of them
    (B, F + S, D).  On a grid whose model axis splits the vocab, a rank
    looks up the rows it holds (zeros for the others) and the model group
    sums them: exactly the one-rank lookup."""
    dtype = torch_dtype(cfg.dtype)
    tok, lo = _vocab_matrix(cfg, params, "tok")
    if lo is None:
        x = tok.to(dtype)[tokens.long()]
    else:
        ids = tokens.long() - lo
        mine = (ids >= 0) & (ids < tok.shape[0])
        x = tok.to(dtype)[ids.clamp(0, tok.shape[0] - 1)]
        x = sharding.model_sum(torch.where(
            mine[..., None], x, torch.zeros((), dtype=dtype,
                                            device=x.device)))
    if cfg.frontend == "vision" and embeds is not None:
        x = fe.splice_frontend(cfg, params.get("frontend", {}), x,
                               embeds.to(dtype))
    if cfg.embed_scale:
        # the scale is rounded to the activation dtype first (45.25 in bf16);
        # rounding it on the host keeps a device copy off every step
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=dtype))
    return x


def _positions(cfg: ModelConfig, tokens: torch.Tensor,
               embeds: Optional[torch.Tensor], x: torch.Tensor
               ) -> torch.Tensor:
    """The positions of the embedded sequence ``x``: the grid and text
    positions when patches were spliced in front, else the text's."""
    b, s, _ = x.shape
    if cfg.frontend == "vision" and embeds is not None:
        return fe.build_positions(cfg, b, tokens.shape[1], embeds.shape[1],
                                  x.device)
    return text_positions(b, s, cfg, x.device)


def _unembed(cfg: ModelConfig, params: Params, x: torch.Tensor
             ) -> torch.Tensor:
    """fp32 logits, softcapped.  On a grid whose model axis splits the
    vocab each rank computes its vocab slice, softcapped as one rank
    softcaps it, and the model group gathers the slices."""
    dtype = x.dtype
    if cfg.tie_embeddings:
        w, lo = _vocab_matrix(cfg, params, "tok")
        logits = x @ w.to(dtype).t()
    else:
        w, lo = _vocab_matrix(cfg, params, "head")
        logits = x @ w.to(dtype)
    logits = softcap(logits.float(), cfg.final_logit_softcap)
    return logits if lo is None else sharding.model_gather(logits, -1)


def _mlp_block(cfg: ModelConfig, spec: LayerSpec, p: Params,
               x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The residual MLP -> (x, the MoE aux loss, or None for a dense MLP
    or none)."""
    if spec.mlp == MLP_NONE:
        return x, None
    h = apply_norm(cfg, p["norm2"], x)
    if spec.mlp == MLP_MOE:
        y, aux = moe_mod.apply_moe(cfg, p["mlp"], h)
        return x + y, aux
    return x + apply_mlp(cfg, p["mlp"], h), None


def _add_aux(total: Optional[torch.Tensor], aux: Optional[torch.Tensor]
             ) -> Optional[torch.Tensor]:
    """Sum aux terms left to right; None stands for a dense layer's 0."""
    if aux is None:
        return total
    return aux if total is None else total + aux


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def _decode_window(spec: LayerSpec,
                   decode_window_override: Optional[int]) -> Optional[int]:
    """A layer's decode window: a local layer's own, or for a global one
    the long-context override (None: the full length)."""
    if spec.mixer == ATTN_GLOBAL and decode_window_override:
        return decode_window_override
    return spec.window


def _layer_cache_init(cfg: ModelConfig, spec: LayerSpec, batch: int,
                      max_len: int, dtype, device,
                      paged: Optional[Tuple[int, int]], layers: int,
                      decode_window_override: Optional[int]) -> Params:
    if _is_attn(spec):
        window = _decode_window(spec, decode_window_override)
        if paged is not None and window is None:
            # only effectively-global layers page: a ring (a local layer's,
            # or a global one's under the override) is already bounded at
            # `window` entries and gains nothing from a pool
            one = attn.init_paged_kv_cache(cfg, paged[0], paged[1], dtype,
                                           device)
        else:
            one = attn.init_kv_cache(cfg, batch, max_len, dtype, device,
                                     window=window)
    elif spec.mixer == MIX_SSM:
        one = ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
    else:
        one = rglru_mod.init_rglru_cache(cfg, batch, dtype, device)
    if not layers:
        return one
    return {k: v[None].repeat((layers,) + (1,) * v.dim())
            for k, v in one.items()}


# a paged pool on a grid: the JAX package gives it no placement
PAGED_ON_GRID = ("a paged KV cache on a grid: the JAX package places no "
                 "paged pool on a mesh (its kv_cache_axes cover k, v and "
                 "pos only), so neither does the port")
# a recurrent block's state on a grid: no case holds it against JAX yet
RECURRENT_ON_GRID = ("an SSD or RG-LRU block's decode cache on a grid: "
                     + sharding.ITEM_UNEXECUTED)


def _refuse_grid_cache(cfg: ModelConfig, paged: bool) -> None:
    """Under a grid: a recurrent block's cache, and a paged one."""
    if sharding.current_grid() is None:
        return
    if {s.mixer for s in cfg.layer_specs()} & {MIX_SSM, MIX_RGLRU}:
        raise NotImplementedError(RECURRENT_ON_GRID)
    if paged:
        raise NotImplementedError(PAGED_ON_GRID)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               decode_window_override: Optional[int] = None,
               paged: Optional[Tuple[int, int]] = None,
               device="cuda") -> Params:
    """Cache tree matching the stack/rem layout: KV for attention layers
    (full length for global ones, a ring for local ones), the state and
    conv windows for SSD and RG-LRU layers.  ``decode_window_override``
    (the long-context decode window) makes every global layer a ring of
    ``min(override, max_len)`` entries too, which never pages.
    ``paged=(num_blocks, block_size)`` pools every other global-attention
    layer's KV into a shared block pool; the decode entry points then need
    a block ``table``.

    Under a grid binding (``sharding.use_sharding_rules(grid, rules)``)
    it builds only this rank's blocks of the ``batch``-row cache, each
    leaf's ``sharding.block_shape`` under :func:`cache_axes` (filled as
    the whole would be: zeros, positions -1), never the whole cache; a
    paged cache, or a recurrent block's, raises there."""
    device = resolve_device(device)
    grid = sharding.current_grid() is not None
    _refuse_grid_cache(cfg, paged is not None)
    dtype = torch_dtype(cfg.dtype)
    period_specs, n_full, n_rem = _superblock_layout(cfg)
    rem_specs = cfg.layer_specs()[n_full * len(period_specs):]
    at = "meta" if grid else device
    cache = {
        "stack": [_layer_cache_init(cfg, spec, batch, max_len, dtype, at,
                                    paged, n_full, decode_window_override)
                  for spec in period_specs],
        "rem": [_layer_cache_init(cfg, spec, batch, max_len, dtype, at,
                                  paged, 0, decode_window_override)
                for spec in rem_specs],
    }
    if not grid:
        return cache
    return sharding.map_axes(
        lambda ax, t: torch.full(sharding.block_shape(ax, t.shape),
                                 0 if t.dtype.is_floating_point else -1,
                                 dtype=t.dtype, device=device),
        cache_axes(cfg, decode_window_override=decode_window_override),
        cache)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _check_grid_cache(cfg: ModelConfig, cache: Params) -> None:
    """Under a grid: the bindings every step refuses, a recurrent block's
    cache and a paged one."""
    sharding.check_executable(cfg)
    _refuse_grid_cache(cfg, any(
        "pk" in c for c in cache.get("stack", []) + cache.get("rem", [])))


def _decode_layer(cfg: ModelConfig, spec: LayerSpec, p: Params,
                  x: torch.Tensor, cache: Params, pos: torch.Tensor,
                  table: Optional[torch.Tensor], paged_kernel: bool,
                  decode_window_override: Optional[int]) -> torch.Tensor:
    p = _layer_blocks(cfg, spec, p)
    h = apply_norm(cfg, p["norm1"], x)
    if "pk" in cache:
        mixed, _ = attn.paged_decode_attention(cfg, p["mixer"], h, cache, pos,
                                               table, kernel=paged_kernel)
    elif _is_attn(spec):
        mixed, _ = attn.decode_attention(
            cfg, p["mixer"], h, cache, pos,
            window=_decode_window(spec, decode_window_override))
    elif spec.mixer == MIX_SSM:
        mixed, _ = ssm_mod.decode_ssm(cfg, p["mixer"], h, cache)
    else:
        mixed, _ = rglru_mod.decode_rglru(cfg, p["mixer"], h, cache)
    return _mlp_block(cfg, spec, p, x + mixed)[0]


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, pos: torch.Tensor, *,
                decode_window_override: Optional[int] = None,
                table: Optional[torch.Tensor] = None,
                paged_kernel: bool = False
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1); pos: (B,) per-row absolute
    positions -> (logits (B, 1, V) fp32, the cache updated in place).

    ``decode_window_override`` makes every global layer attend to the last
    that many positions (its cache a ring from :func:`init_cache` with the
    same override).  ``table`` is the ``(B, nb)`` block table of a paged
    cache (contiguous caches ignore it); ``paged_kernel`` sends paged
    layers through the CUDA block-table kernel instead of the gather.

    On a grid ``params`` and ``cache`` are this rank's blocks and
    ``tokens`` / ``pos`` its rows (all of them where the rules leave the
    batch unsplit); the logits are its rows' whole vocab."""
    _check_grid_cache(cfg, cache)
    x = _embed(cfg, params, tokens)
    for spec, lp, lc in _layers(params, cache, cfg):
        x = _decode_layer(cfg, spec, lp, x, lc, pos, table, paged_kernel,
                          decode_window_override)
    x = apply_norm(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x), cache


def early_exit_logits(params: Params, cfg: ModelConfig, x: torch.Tensor
                      ) -> torch.Tensor:
    """Self-drafting readout: the final norm and the unembedding applied to
    a mid-stack hop activation (B, 1, D).  The draft model is the client
    stage truncated at its cut, read out through the shared head; ``params``
    is the full tree (it holds ``final_norm`` and the tied embedding)."""
    return _unembed(cfg, params, apply_norm(cfg, params["final_norm"], x))


def partition_cache(cache: Params, cfg: ModelConfig, cuts: Sequence[int]
                    ) -> List[Params]:
    """Partition a decode cache at layers ``cuts`` into ``len(cuts) + 1``
    per-stage caches, as :func:`partition_params` partitions the params:
    the stacked super-block caches along the leading layer axis, the
    remainder layers' caches with the final (server) stage.

    Every stage leaf is a *view* of ``cache`` (a slice of the layer axis),
    not a copy: decode updates caches in place, so a stage's writes land in
    the joined cache and a caller that keeps ``cache`` never needs
    :func:`join_cache_stages`."""
    cuts = _check_cuts(cfg, cuts)
    bounds = [c // cfg.period for c in cuts]

    def part(lo, hi):
        return [{k: v[lo:hi] for k, v in d.items()} for d in cache["stack"]]

    stages: List[Params] = [{"stack": part(0, bounds[0])}]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        stages.append({"stack": part(lo, hi)})
    stages.append({"stack": part(bounds[-1], None), "rem": cache["rem"]})
    return stages


def join_cache_stages(stages: Sequence[Params]) -> Params:
    """Invert :func:`partition_cache`: a new cache tree whose stacked leaves
    are the stages' concatenated (copied) along the layer axis."""
    stack = [{k: torch.cat([s["stack"][j][k] for s in stages])
              for k in stages[0]["stack"][j]}
             for j in range(len(stages[0]["stack"]))]
    return {"stack": stack, "rem": stages[-1]["rem"]}


def stage_decode_step(stage_params: Params, cfg: ModelConfig,
                      x: torch.Tensor, cache: Params, pos: torch.Tensor,
                      stage_index: int, num_stages: int, *,
                      decode_window_override: Optional[int] = None,
                      table: Optional[torch.Tensor] = None,
                      paged_kernel: bool = False
                      ) -> Tuple[torch.Tensor, Params]:
    """One decode step through one pipeline stage, its cache updated in
    place.  Stage 0 reads ``x`` as tokens (B, 1) (the embedding, then the
    client's super-blocks); a later stage takes the upstream hop
    activation (B, 1, D).  The final stage also runs the remainder layers,
    the final norm and the unembedding, and returns logits (B, 1, V) fp32.
    Chaining every stage (:func:`split_decode_step`) reproduces
    :func:`decode_step` exactly: the cuts only move activations.  On a
    grid the stage's params and cache are this rank's blocks, as in
    :func:`decode_step`."""
    _check_grid_cache(cfg, cache)
    period_specs, _, _ = _superblock_layout(cfg)
    if stage_index == 0:
        x = _embed(cfg, stage_params, x)
    for i in range(_num_blocks(stage_params["stack"])):
        for j, spec in enumerate(period_specs):
            x = _decode_layer(cfg, spec, _tree_index(stage_params["stack"][j], i),
                              x, _tree_index(cache["stack"][j], i), pos, table,
                              paged_kernel, decode_window_override)
    if stage_index == num_stages - 1:
        rem = stage_params.get("rem", [])
        specs = cfg.layer_specs()[cfg.num_layers - len(rem):]
        for spec, lp, lc in zip(specs, rem, cache["rem"]):
            x = _decode_layer(cfg, spec, lp, x, lc, pos, table, paged_kernel,
                              decode_window_override)
        x = _unembed(cfg, stage_params,
                     apply_norm(cfg, stage_params["final_norm"], x))
    return x, cache


def split_decode_step(stages: Sequence[Params], cfg: ModelConfig,
                      tokens: torch.Tensor, cache_stages: Sequence[Params],
                      pos: torch.Tensor, *,
                      decode_window_override: Optional[int] = None,
                      table: Optional[torch.Tensor] = None,
                      paged_kernel: bool = False
                      ) -> Tuple[torch.Tensor, Sequence[Params]]:
    """One decode step through the whole client -> edge -> server pipeline:
    :func:`decode_step` with the params and the cache partitioned at the
    WSSL cuts.  Returns (logits (B, 1, V), the stage caches, updated in
    place)."""
    x = tokens
    for i, (sp, sc) in enumerate(zip(stages, cache_stages)):
        x, _ = stage_decode_step(sp, cfg, x, sc, pos, i, len(stages),
                                 decode_window_override=decode_window_override,
                                 table=table, paged_kernel=paged_kernel)
    return x, cache_stages


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _prefill_layer(cfg: ModelConfig, spec: LayerSpec, p: Params,
                   x: torch.Tensor, cache: Params, positions: torch.Tensor,
                   impl: str) -> torch.Tensor:
    p = _layer_blocks(cfg, spec, p)
    h = apply_norm(cfg, p["norm1"], x)
    if _is_attn(spec):
        mixed, _ = attn.prefill_attention(cfg, p["mixer"], h, positions,
                                          cache, window=spec.window,
                                          impl=impl)
    elif spec.mixer == MIX_SSM:
        mixed, _ = ssm_mod.prefill_ssm(cfg, p["mixer"], h, cache)
    else:
        mixed, _ = rglru_mod.prefill_rglru(cfg, p["mixer"], h, cache)
    return _mlp_block(cfg, spec, p, x + mixed)[0]


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            embeds: Optional[torch.Tensor] = None,
            cache: Optional[Params] = None, max_len: Optional[int] = None,
            impl: str = "dense", last_only: bool = False
            ) -> Tuple[torch.Tensor, Params]:
    """Full-sequence forward that fills a contiguous cache (in place).

    Returns (logits (B, S, V) fp32, or (B, 1, V) with ``last_only``, and
    the cache).  ``embeds`` (B, F, D) puts a vision frontend's patches in
    front of the text, at their grid positions; the logits and the cache
    then cover F + S positions.  ``max_len`` sizes a fresh cache when
    ``cache`` is not given (default: the sequence length); a cache built
    with a decode-window override keeps the last ``window`` entries of
    each global layer, the prompt attending in full.  ``last_only``
    unembeds only the final position, which is all the serving path
    reads.  ``impl`` picks the attention layers' path; the recurrent
    blocks run their plain scans, which yield the final state.

    On a grid ``params`` are this rank's blocks, ``tokens`` its rows and
    ``cache`` its blocks (:func:`init_cache` under the binding; required
    there, since the rows do not say the whole batch): each rank fills the
    entries its block of every cache holds."""
    _check_grid_cache(cfg, cache or {})
    attn._check_impl(impl)
    if cache is None and sharding.current_grid() is not None:
        raise ValueError("a prefill on a grid fills this rank's cache "
                         "blocks: pass them (init_cache under the binding)")
    x = _embed(cfg, params, tokens, embeds)
    b, s, _ = x.shape
    if cache is None:
        cache = init_cache(cfg, b, max_len or s, device=x.device)
    positions = _positions(cfg, tokens, embeds, x)
    for spec, lp, lc in _layers(params, cache, cfg):
        x = _prefill_layer(cfg, spec, lp, x, lc, positions, impl)
    x = apply_norm(cfg, params["final_norm"], x)
    if last_only:
        x = x[:, -1:]
    return _unembed(cfg, params, x), cache


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def _resolve_span(n_full: int, requested: int) -> int:
    """Largest divisor of n_full not exceeding the requested remat span."""
    span = max(min(requested, n_full), 1)
    while n_full % span:
        span -= 1
    return span


def _layer_blocks(cfg: ModelConfig, spec: LayerSpec, p: Params) -> Params:
    """A layer's params as its computation takes them: on a grid, this
    rank's blocks with their data-placed dims gathered over the data group
    just before use (FSDP; nothing else keeps them whole); else ``p``."""
    if sharding.current_grid() is None:
        return p
    return sharding.gather_data_blocks(p, _layer_axes(cfg, spec, False),
                                       _whole_layer(cfg, spec))


@functools.lru_cache(maxsize=64)
def _whole_layer(cfg: ModelConfig, spec: LayerSpec) -> Params:
    """One layer's whole params on the meta device (their shapes)."""
    return _layer_init(None, cfg, spec, 0, torch.float32, "meta")


def _apply_layer(cfg: ModelConfig, spec: LayerSpec, p: Params,
                 x: torch.Tensor, positions: torch.Tensor,
                 impl: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    p = _layer_blocks(cfg, spec, p)
    h = apply_norm(cfg, p["norm1"], x)
    use_kernel = impl in attn._KERNEL_IMPLS
    if _is_attn(spec):
        mixed = attn.multihead_attention(cfg, p["mixer"], h, positions,
                                         window=spec.window, impl=impl)
    elif spec.mixer == MIX_SSM:
        mixed = ssm_mod.apply_ssm(cfg, p["mixer"], h, use_kernel=use_kernel)
    else:
        mixed = rglru_mod.apply_rglru(cfg, p["mixer"], h,
                                      use_kernel=use_kernel)
    return _mlp_block(cfg, spec, p, x + mixed)


def _num_blocks(stack: List[Params]) -> int:
    """Super-blocks in a (stage's) stack: the leading length of a leaf,
    stacked tensor or per-layer list alike."""
    tree = stack[0]
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return len(tree)


def _stack_forward(stack: List[Params], cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, impl: str, remat: bool,
                   remat_span: int
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run a stage's stacked super-blocks over ``x`` -> (x, the summed MoE
    aux, None without MoE layers).  With ``remat`` each span of
    ``remat_span`` super-blocks (the largest divisor of the count not
    above it) is recomputed in the backward, as the JAX scan body; the
    aux sums within a span, then across spans, as JAX's forward does.
    With ``remat`` and a period above 1, each layer of a super-block also
    runs under a checkpoint of its own inside the span's (JAX's
    ``nested``), so the span's recompute holds one layer's activations at
    a time."""
    period_specs, _, _ = _superblock_layout(cfg)
    n = _num_blocks(stack)
    if n == 0:
        return x, None
    span = _resolve_span(n, remat_span if remat else 1)
    remat = remat and torch.is_grad_enabled()
    nested = remat and len(period_specs) > 1

    def span_block(x, first):
        aux = None
        for t in range(first, first + span):
            for j, spec in enumerate(period_specs):
                args = (cfg, spec, _tree_index(stack[j], t), x, positions,
                        impl)
                if nested:
                    x, a = checkpoint(_apply_layer, *args, use_reentrant=False,
                                      preserve_rng_state=False)
                else:
                    x, a = _apply_layer(*args)
                aux = _add_aux(aux, a)
        return x, aux

    total = None
    for first in range(0, n, span):
        if remat:
            x, aux = checkpoint(span_block, x, first, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = span_block(x, first)
        total = _add_aux(total, aux)
    return x, total


def _aux_or_zero(aux: Optional[torch.Tensor], x: torch.Tensor
                 ) -> torch.Tensor:
    # the MoE load-balance loss; a dense stack has none
    if aux is not None:
        return aux
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _rem_forward(rem: List[Params], cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, impl: str
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The remainder layers (the last ``len(rem)`` of the model) over x ->
    (x, their summed MoE aux or None)."""
    specs = cfg.layer_specs()[cfg.num_layers - len(rem):]
    aux = None
    for spec, lp in zip(specs, rem):
        x, a = _apply_layer(cfg, spec, lp, x, positions, impl)
        aux = _add_aux(aux, a)
    return x, aux


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None, impl: str = "dense",
            remat: bool = True, remat_span: int = 1,
            last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B, S, V) fp32, aux loss); with a
    vision frontend's ``embeds`` (B, F, D), (B, F + S, V), the patches at
    their grid positions.

    ``impl="kernel"`` (or ``"pallas"``) runs attention, SSD and RG-LRU
    layers through their kernels; with autograd on, attention raises (no
    backward kernel).  On a grid ``params`` are this rank's blocks and
    ``tokens`` its rows, and the logits are its rows' whole vocab."""
    attn._check_impl(impl)
    sharding.check_executable(cfg)
    x = _embed(cfg, params, tokens, embeds)
    if positions is None:
        positions = _positions(cfg, tokens, embeds, x)
    x, aux = _stack_forward(params["stack"], cfg, x, positions, impl, remat,
                            remat_span)
    x, rem_aux = _rem_forward(params["rem"], cfg, x, positions, impl)
    x = apply_norm(cfg, params["final_norm"], x)
    if last_only:
        x = x[:, -1:]
    return _unembed(cfg, params, x), _aux_or_zero(_add_aux(aux, rem_aux), x)


# ---------------------------------------------------------------------------
# WSSL stage partition (the N-stage pipeline; one cut is client/server)
# ---------------------------------------------------------------------------


def _check_cuts(cfg: ModelConfig, cuts: Sequence[int]) -> Tuple[int, ...]:
    cuts = tuple(int(c) for c in cuts)
    if not cuts:
        raise ValueError("need at least one cut")
    prev = -1      # cut 0 is legal: a thin client holding only the embedding
    for c in cuts:
        if c % cfg.period:
            raise ValueError(f"cut {c} must align to super-block "
                             f"({cfg.period})")
        if not prev < c:
            raise ValueError(f"cuts must be strictly increasing: {cuts}")
        prev = c
    if cuts[-1] > cfg.num_layers:
        raise ValueError(f"last cut {cuts[-1]} exceeds num_layers "
                         f"({cfg.num_layers})")
    return cuts


def _slice_stack(stack: List[Params], lo: int, hi: Optional[int],
                 copy: bool = True):
    """Super-blocks [lo, hi) of every stacked leaf: copies by default (a
    view would keep the whole unsplit stack alive), views with
    ``copy=False``."""
    def one(tree):
        if isinstance(tree, dict):
            return {k: one(v) for k, v in tree.items()}
        return tree[lo:hi].clone() if copy else tree[lo:hi]
    return [one(t) for t in stack]


def partition_params(params: Params, cfg: ModelConfig, cuts: Sequence[int],
                     *, copy: bool = True) -> List[Params]:
    """Partition a param tree at layers ``cuts`` into ``len(cuts) + 1``
    stages.  Stage 0 (the client) owns the embedding (and the vision
    frontend's projector) and the first
    ``cuts[0] // period`` super-blocks; each edge stage the super-blocks
    between two cuts; the server the rest, the remainder layers, the final
    norm and the head.  With tied embeddings the server holds its own
    *copy* of the embedding matrix (the server owns the output head): an
    alias would let one in-place optimizer step move both.

    ``copy=False`` (serving, which never steps the params) makes every
    stage leaf a view of ``params`` instead, the server's embedding too, so
    partitioning allocates nothing."""
    cuts = _check_cuts(cfg, cuts)
    bounds = [c // cfg.period for c in cuts]
    stages = [{"embed": params["embed"],
               "stack": _slice_stack(params["stack"], 0, bounds[0], copy)}]
    if "frontend" in params:
        stages[0]["frontend"] = params["frontend"]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        stages.append({"stack": _slice_stack(params["stack"], lo, hi, copy)})
    last: Params = {"stack": _slice_stack(params["stack"], bounds[-1], None,
                                          copy),
                    "rem": params["rem"], "final_norm": params["final_norm"]}
    if cfg.tie_embeddings:
        tok = params["embed"]["tok"]
        last["embed"] = {"tok": tok.clone() if copy else tok}
    elif "head" in params:
        last["head"] = params["head"]
    stages.append(last)
    return stages


def partition_axes(axes: Dict[str, Any], cfg: ModelConfig,
                   cuts: Sequence[int]) -> List[Dict[str, Any]]:
    """The logical-axes trees matching :func:`partition_params` (a stacked
    leaf's axes do not change when its layer axis is sliced)."""
    cuts = _check_cuts(cfg, cuts)
    first = {"embed": axes["embed"], "stack": axes["stack"]}
    if "frontend" in axes:
        first["frontend"] = axes["frontend"]
    stages: List[Dict[str, Any]] = [first]
    for _ in cuts[1:]:
        stages.append({"stack": axes["stack"]})
    last = {"stack": axes["stack"], "rem": axes["rem"],
            "final_norm": axes["final_norm"]}
    if cfg.tie_embeddings:
        last["embed"] = axes["embed"]
    elif "head" in axes:
        last["head"] = axes["head"]
    stages.append(last)
    return stages


def join_stages(stages: Sequence[Params], cfg: ModelConfig) -> Params:
    """Invert :func:`partition_params`: reassemble the full param tree."""
    first, last = stages[0], stages[-1]

    def cat(*trees):
        if isinstance(trees[0], dict):
            return {k: cat(*[t[k] for t in trees]) for k in trees[0]}
        return torch.cat(trees, dim=0)

    stack = [cat(*[s["stack"][j] for s in stages])
             for j in range(len(first["stack"]))]
    joined = {"embed": first["embed"], "stack": stack, "rem": last["rem"],
              "final_norm": last["final_norm"]}
    if "frontend" in first:
        joined["frontend"] = first["frontend"]
    if "head" in last:
        joined["head"] = last["head"]
    return joined


def client_forward(client_params: Params, cfg: ModelConfig,
                   tokens: torch.Tensor, *,
                   embeds: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   impl: str = "dense", remat: bool = True,
                   remat_span: int = 1) -> torch.Tensor:
    """Client stage: embedding (the patches of ``embeds`` in front, at
    their grid positions) + the client's super-blocks -> the cut
    activation (B, F + S, D) in ``cfg.dtype``."""
    sharding.refuse_grid("a training stage", sharding.ITEM_SERVER)
    x = _embed(cfg, client_params, tokens, embeds)
    if positions is None:
        positions = _positions(cfg, tokens, embeds, x)
    return _stack_forward(client_params["stack"], cfg, x, positions, impl,
                          remat, remat_span)[0]


def stage_forward(stage_params: Params, cfg: ModelConfig, x: torch.Tensor,
                  stage_index: int, *,
                  embeds: Optional[torch.Tensor] = None,
                  positions: Optional[torch.Tensor] = None,
                  impl: str = "dense", remat: bool = True,
                  remat_span: int = 1, with_aux: bool = False):
    """Forward one non-final pipeline stage -> the hop activation (and,
    with ``with_aux``, the stage's MoE aux loss: 0 for a dense stack, and
    always 0 for stage 0, whose aux JAX drops too).  Stage 0 reads ``x``
    as tokens (and ``embeds``); an edge stage takes the upstream hop
    activation, at text positions over its whole length unless given
    ``positions`` — with patches in front, not the grid positions stage 0
    used, as in JAX (the round passes none)."""
    sharding.refuse_grid("a training stage", sharding.ITEM_SERVER)
    aux = None
    if stage_index == 0:
        out = client_forward(stage_params, cfg, x, embeds=embeds,
                             positions=positions, impl=impl, remat=remat,
                             remat_span=remat_span)
    else:
        b, s, _ = x.shape
        if positions is None:
            positions = text_positions(b, s, cfg, x.device)
        out, aux = _stack_forward(stage_params["stack"], cfg, x, positions,
                                  impl, remat, remat_span)
    return (out, _aux_or_zero(aux, out)) if with_aux else out


def server_hidden(server_params: Params, cfg: ModelConfig,
                  activation: torch.Tensor, *,
                  positions: Optional[torch.Tensor] = None,
                  impl: str = "dense", remat: bool = True,
                  remat_span: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Server stage up to the final norm (before the unembedding) ->
    (x, aux).  Without ``positions``, text positions over the whole
    activation, as in JAX (with patches in front: not their grid)."""
    sharding.refuse_grid("a training stage", sharding.ITEM_SERVER)
    x = activation
    b, s, _ = x.shape
    if positions is None:
        positions = text_positions(b, s, cfg, x.device)
    x, aux = _stack_forward(server_params["stack"], cfg, x, positions, impl,
                            remat, remat_span)
    x, rem_aux = _rem_forward(server_params["rem"], cfg, x, positions, impl)
    return (apply_norm(cfg, server_params["final_norm"], x),
            _aux_or_zero(_add_aux(aux, rem_aux), x))


def server_loss(server_params: Params, cfg: ModelConfig,
                activation: torch.Tensor, labels: torch.Tensor, *,
                impl: str = "dense", remat: bool = True, remat_span: int = 1,
                xent_chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Server stage + the memory-bounded chunked cross-entropy ->
    (mean token loss, aux)."""
    x, aux = server_hidden(server_params, cfg, activation, impl=impl,
                           remat=remat, remat_span=remat_span)
    return chunked_xent(server_params, cfg, x, labels, chunk=xent_chunk), aux


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _xent_sum(cfg: ModelConfig, params: Params, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    logits = _unembed(cfg, params, x)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[..., None])[..., 0]
    return (lse - gold).sum()


def chunked_xent(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Mean token cross-entropy without the (B, S, V) logits: one (B, c, V)
    tile per sequence chunk, each recomputed in the backward instead of
    stored, so the logits' peak is O(c * V) rather than O(S * V).  An
    activation longer than ``labels`` (an image prefix in front) is
    trimmed to its last ``labels.shape[1]`` positions."""
    b, s, _ = x.shape
    if labels.shape[1] != s:
        x = x[:, -labels.shape[1]:]
        s = labels.shape[1]
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    tot = None
    for lo in range(0, s, chunk):
        xi, yi = x[:, lo:lo + chunk], labels[:, lo:lo + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_xent_sum, cfg, params, xi, yi,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            part = _xent_sum(cfg, params, xi, yi)
        tot = part if tot is None else tot + part
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, one rounding more than JAX's division
    return tot / torch.tensor(b * s, dtype=torch.float32, device=x.device)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32.  logits (B,S,V), labels (B,S)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, impl: str = "dense", remat: bool = True) -> torch.Tensor:
    """Mean token cross-entropy of the forward plus the MoE aux; with
    ``batch["embeds"]`` the image prefix's logits are trimmed off."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          embeds=batch.get("embeds"), impl=impl, remat=remat)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, -labels.shape[1]:]
    return cross_entropy(logits, labels, batch.get("mask")) + aux
