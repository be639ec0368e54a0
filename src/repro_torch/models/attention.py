"""Attention: causal GQA/MQA, global or sliding-window (local), prefill
into a KV cache, and one-token decode against a contiguous, ring or paged
cache.

The PyTorch twin of ``repro/models/attention.py``.  Every public function
keeps the JAX layout ``(B, S, H, hd)``.  Implementations (``impl``):

* ``dense``  — materialize the (Sq, Sk) scores; the plain model path.
* ``kernel`` — the hand-written CUDA flash kernel (``kernels/ops.py``),
  which takes any S >= 1 and a window.  ``pallas``, the JAX package's name
  for its kernel path, is accepted as an alias.  It has no backward yet,
  so :func:`multihead_attention` takes it only with autograd off (the
  prefill step), and training runs ``dense`` only.

Local layers keep a ring of ``min(window, max_len)`` entries, written at
slot ``pos % size``; global layers a full-length cache that refuses to
overflow, or, under the long-context decode-window override, a ring of
the override's size like a local layer's.

Under M-RoPE (``rope_kind="mrope"``) positions carry three streams
(B, S, 3); the dense path masks by the temporal one, the kernel path by
index, as the JAX package's two paths do.

KV caches are updated in place (``index_put_``) where the JAX package
donated its buffers: the functions return the cache they were given.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, softcap

Params = Dict[str, Any]

NEG_INF = -1e30
IMPLS = ("dense", "kernel", "pallas")


def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 positions: torch.Tensor):
    """x (B,S,D) -> q (B,S,Hq,hd), k, v (B,S,Hkv,hd), with RoPE applied.
    With ``qkv_bias`` each projection adds its bias ``bq`` (Hq, hd) /
    ``bk``, ``bv`` (Hkv, hd) in the activation dtype before RoPE, as the
    JAX package does; every attention path (dense and kernel prefill,
    contiguous and paged decode) projects here."""
    b, s, d = x.shape
    dtype = x.dtype

    def proj(w, bias):
        h, e = w.shape[1], w.shape[2]
        y = (x @ w.reshape(d, h * e).to(dtype)).view(b, s, h, e)
        return y + p[bias].to(dtype) if cfg.qkv_bias else y

    q = apply_rope(cfg, proj(p["wq"], "bq"), positions)
    k = apply_rope(cfg, proj(p["wk"], "bk"), positions)
    return q, k, proj(p["wv"], "bv")


def _out_proj(p: Params, out: torch.Tensor) -> torch.Tensor:
    """(B,S,Hq,hd) -> (B,S,D) through ``wo`` (Hq, hd, D)."""
    b, s, h, e = out.shape
    wo = p["wo"]
    return out.reshape(b, s, h * e) @ wo.reshape(h * e, wo.shape[2]).to(out.dtype)


def _group(cfg: ModelConfig, q: torch.Tensor) -> torch.Tensor:
    """(B,S,Hq,hd) -> (B,S,Hkv,G,hd)."""
    b, s, hq, hd = q.shape
    return q.view(b, s, cfg.num_kv_heads, hq // cfg.num_kv_heads, hd)


def _mask_positions(positions: torch.Tensor) -> torch.Tensor:
    """The positions the dense path masks by: M-RoPE's (B, S, 3) mask by
    their temporal stream (every image patch has t = 0, so the patches see
    each other both ways), as JAX's dense path masks them; (B, S) as they
    are."""
    return positions[..., 0] if positions.dim() == 3 else positions


def _one_token_positions(cfg: ModelConfig, pos_b: torch.Tensor
                         ) -> torch.Tensor:
    """A decode step's (B, 1) positions, repeated over the three M-RoPE
    streams (B, 1, 3) under ``mrope`` (a decoded token is text)."""
    positions = pos_b[:, None]
    if cfg.rope_kind == "mrope":
        return positions[..., None].expand(-1, -1, 3)
    return positions


def _scale(cfg: ModelConfig) -> float:
    return cfg.query_scale or 1.0 / math.sqrt(cfg.head_dim)


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown attn impl {impl!r}; the port has {IMPLS}")


# ---------------------------------------------------------------------------
# Full-sequence implementations
# ---------------------------------------------------------------------------


def _attn_dense(cfg: ModelConfig, q, k, v, q_pos, k_pos,
                window: Optional[int] = None) -> torch.Tensor:
    qg = _group(cfg, q)                                   # (B,Sq,K,G,hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * _scale(cfg)
    s = softcap(s, cfg.attn_logit_softcap)
    mask = k_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None]
    if window is not None:
        mask &= (q_pos[:, None, None, :, None]
                 - k_pos[:, None, None, None, :]) < window
    s = s.masked_fill(~mask, NEG_INF)
    pr = torch.softmax(s.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", pr, v)
    return out.reshape(q.shape)


def _attn_kernel(cfg: ModelConfig, q, k, v,
                 window: Optional[int] = None) -> torch.Tensor:
    """The flash kernel path, causal by index (positions ``arange(S)``
    from 0).  It ignores M-RoPE positions, as JAX's ``_attn_pallas`` does:
    with image patches in front, the dense path's temporal-stream mask
    lets the patches attend forward, this one does not."""
    return ops.flash_attention(q, k, v, causal=True, window=window,
                               scale=_scale(cfg),
                               logit_softcap=cfg.attn_logit_softcap)


# ---------------------------------------------------------------------------
# Training: full-sequence attention with autograd
# ---------------------------------------------------------------------------

TRAIN_IMPLS = ("dense",)


def check_train_impl(impl: str) -> None:
    """Training runs the dense path only: the flash kernel has no backward
    yet, and the JAX package's ``chunked`` / ``flash`` custom-VJP path is
    not ported."""
    if impl not in TRAIN_IMPLS:
        raise NotImplementedError(
            f"attention impl {impl!r} has no backward in the port yet: train "
            f"with impl='dense' (ROADMAP Queue 1, item 6: the chunked / flash "
            f"training path and the flash-attention backward kernel)")


def multihead_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                        positions: torch.Tensor, *,
                        window: Optional[int] = None,
                        impl: str = "dense") -> torch.Tensor:
    """Full-sequence causal self-attention (train / prefill without a
    cache), global or within ``window``.  x (B,S,D); positions (B,S), or
    (B,S,3) under M-RoPE (the dense path masks by the temporal stream, the
    kernel by index).  ``dense`` is differentiable by autograd; the kernel
    has no backward, so it raises while autograd is on."""
    _check_impl(impl)
    if torch.is_grad_enabled():
        check_train_impl(impl)
    q, k, v = _project_qkv(cfg, p, x, positions)
    if impl == "dense":
        pos1d = _mask_positions(positions)
        out = _attn_dense(cfg, q, k, v, pos1d, pos1d, window)
    else:
        out = _attn_kernel(cfg, q, k, v, window)
    return _out_proj(p, out)


# ---------------------------------------------------------------------------
# KV cache (prefill + decode)
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device=None, window: Optional[int] = None) -> Params:
    """Full-length KV of a global-attention layer, or a ring of
    ``min(window, max_len)`` entries for a local one; ``pos`` holds each
    entry's absolute position per row (-1 = empty)."""
    size = max_len if window is None else min(window, max_len)
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, size), -1, dtype=torch.int32,
                          device=device),
    }


def cache_write(cache: Params, k: torch.Tensor, v: torch.Tensor,
                pos, *, ring: bool = False) -> Params:
    """Write S new KV entries starting at absolute position ``pos``, in
    place.  ``pos`` is an int (all rows at the same position: prefill) or
    a ``(B,)`` tensor of per-row positions (single-token decode writes,
    which wrap modulo the cache length: an empty slot's garbage decode
    runs past it).

    A ``ring`` (a local layer's cache) takes entry ``p`` at slot
    ``p % size``; a write of S >= size entries keeps the last ``size``.
    A global cache raises where the write would run past its end."""
    b, s = k.shape[0], k.shape[1]
    size = cache["k"].shape[1]
    if isinstance(pos, torch.Tensor):
        if s != 1:
            raise ValueError("per-row cache writes are single-token only")
        rows = torch.arange(b, device=k.device)
        idx = (pos % size).long()
        cache["k"][rows, idx] = k[:, 0]
        cache["v"][rows, idx] = v[:, 0]
        cache["pos"][rows, idx] = pos.to(torch.int32)
        return cache
    if ring:
        keep = min(s, size)
        newpos = pos + s - keep + torch.arange(keep, dtype=torch.int32,
                                               device=k.device)
        slots = (newpos % size).long()
        cache["k"][:, slots] = k[:, s - keep:]
        cache["v"][:, slots] = v[:, s - keep:]
        cache["pos"][:, slots] = newpos
        return cache
    if pos + s > size:
        raise ValueError(f"{s} entries at position {pos} overflow the cache")
    cache["k"][:, pos:pos + s] = k
    cache["v"][:, pos:pos + s] = v
    cache["pos"][:, pos:pos + s] = pos + torch.arange(
        s, dtype=torch.int32, device=k.device)
    return cache


def prefill_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      positions: torch.Tensor, cache: Params, *,
                      window: Optional[int] = None,
                      impl: str = "dense") -> Tuple[torch.Tensor, Params]:
    """Full-sequence causal attention, global or within ``window``, that
    also fills the KV cache (in place) with entries at absolute positions
    ``arange(S)``.  A ring keeps the last entries: a local layer's, and a
    global layer's cache shorter than the prompt, which is a ring of the
    decode-window override (the prompt itself attends in full, as in
    JAX).  Positions start at 0, as every prefill does; under M-RoPE they
    are (B,S,3) and mask the dense path as in
    :func:`multihead_attention`."""
    _check_impl(impl)
    q, k, v = _project_qkv(cfg, p, x, positions)
    if impl == "dense":
        pos1d = _mask_positions(positions)
        out = _attn_dense(cfg, q, k, v, pos1d, pos1d, window)
    else:
        out = _attn_kernel(cfg, q, k, v, window)
    ring = window is not None or cache["k"].shape[1] < k.shape[1]
    cache = cache_write(cache, k, v, 0, ring=ring)
    return _out_proj(p, out), cache


def init_paged_kv_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                        dtype, device=None) -> Params:
    """Pooled (paged) KV storage for global-attention layers: ``num_blocks``
    blocks of ``block_size`` entries shared by every slot, with ``ppos``
    the absolute position of each entry (-1 = empty)."""
    shape = (num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    return {
        "pk": torch.zeros(shape, dtype=dtype, device=device),
        "pv": torch.zeros(shape, dtype=dtype, device=device),
        "ppos": torch.full((num_blocks, block_size), -1, dtype=torch.int32,
                           device=device),
    }


def paged_decode_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                           cache: Params, pos: torch.Tensor,
                           table: torch.Tensor, *,
                           kernel: bool = False) -> Tuple[torch.Tensor, Params]:
    """One-token attention against a paged (pooled) global KV cache.

    ``table`` is ``(B, nb)`` int32 mapping each row's logical blocks to pool
    blocks, in logical order.  The new token's K/V are written into the
    pool in place first.  ``kernel=False`` gathers the logical
    ``(B, nb * bs)`` view and runs the masked softmax (the plain path);
    ``kernel=True`` runs the CUDA block-table kernel straight off the pool
    (``kernels/ops.py``; the plain version on a CPU tensor)."""
    b = x.shape[0]
    pos_b = pos.to(torch.int32).expand(b)
    q, k, v = _project_qkv(cfg, p, x, _one_token_positions(cfg, pos_b))
    bs = cache["pk"].shape[1]
    nb = table.shape[1]
    rows = torch.arange(b, device=x.device)
    # physical write target: distinct across live rows
    phys = table[rows, (pos_b // bs) % nb].long()
    off = (pos_b % bs).long()
    cache["pk"][phys, off] = k[:, 0]
    cache["pv"][phys, off] = v[:, 0]
    cache["ppos"][phys, off] = pos_b
    if kernel:
        out = ops.paged_decode_attention(
            q[:, 0].contiguous(), cache["pk"], cache["pv"], cache["ppos"],
            table, pos_b.contiguous(), scale=_scale(cfg),
            logit_softcap=cfg.attn_logit_softcap)
        return _out_proj(p, out[:, None]), cache
    # gather the logical view: entry (b, l) holds absolute position l
    tab = table.long()
    kc = cache["pk"][tab].reshape(b, nb * bs, cfg.num_kv_heads, cfg.head_dim)
    vc = cache["pv"][tab].reshape(b, nb * bs, cfg.num_kv_heads, cfg.head_dim)
    pc = cache["ppos"][tab].reshape(b, nb * bs)
    valid = (pc >= 0) & (pc <= pos_b[:, None])
    return _out_proj(p, _attend_one(cfg, q, kc, vc, valid)), cache


def _attend_one(cfg: ModelConfig, q, kc, vc, valid) -> torch.Tensor:
    """Masked softmax of one query token per row over a cache view."""
    qg = _group(cfg, q)                                   # (B,1,K,G,hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kc) * _scale(cfg)
    s = softcap(s, cfg.attn_logit_softcap)
    s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    pr = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", pr, vc).reshape(q.shape)


def decode_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     cache: Params, pos: torch.Tensor, *,
                     window: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Params]:
    """One-token attention against a contiguous cache or a ring: a local
    layer's, or a global layer's under the decode-window override
    (``window`` is then the override).  x: (B,1,D); ``pos`` is a ``(B,)``
    tensor of per-row absolute positions (or a scalar one)."""
    b = x.shape[0]
    pos_b = pos.to(torch.int32).expand(b)
    q, k, v = _project_qkv(cfg, p, x, _one_token_positions(cfg, pos_b))
    cache = cache_write(cache, k, v, pos_b)
    pc = cache["pos"]
    valid = (pc >= 0) & (pc <= pos_b[:, None])
    if window is not None:
        valid &= (pos_b[:, None] - pc) < window
    return _out_proj(p, _attend_one(cfg, q, cache["k"], cache["v"], valid)), cache
