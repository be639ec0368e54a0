"""Attention: causal GQA/MQA, global or sliding-window (local), prefill
into a KV cache, and one-token decode against a contiguous, ring or paged
cache.

The PyTorch twin of ``repro/models/attention.py``.  Every public function
keeps the JAX layout ``(B, S, H, hd)``.  Implementations (``impl``), as in
JAX:

* ``dense``      — materialize the (Sq, Sk) scores; the plain model path.
* ``chunked`` / ``flash`` — for full-sequence attention (training), the
  flash path: an online softmax over KV blocks whose backward
  (:class:`_FlashAttention`) saves only ``(q, k, v, positions, out, m,
  l)`` and recomputes the probability tiles block by block, so a
  long-sequence train step never holds an (Sq, Sk) matrix; prefill takes
  the plain online-softmax scan (:func:`_attn_chunked`).
* ``triangular`` — the online softmax over the lower-triangular (q-block,
  kv-block) pairs: exact causal FLOPs, differentiated by autograd.
* ``banded``     — a local layer on a 2w band: exact O(S·2w) FLOPs.
* ``kernel``     — the hand-written CUDA flash kernel (``kernels/ops.py``),
  which takes any S >= 1 and a window.  ``pallas``, the JAX package's name
  for its kernel path, is accepted as an alias.  It has no backward (nor
  has JAX's Pallas flash), so :func:`multihead_attention` takes it only
  with autograd off (the prefill step).

Training runs every impl but ``kernel`` / ``pallas`` (:data:`TRAIN_IMPLS`).

Local layers keep a ring of ``min(window, max_len)`` entries, written at
slot ``pos % size``; global layers a full-length cache that refuses to
overflow, or, under the long-context decode-window override, a ring of
the override's size like a local layer's.

Under M-RoPE (``rope_kind="mrope"``) positions carry three streams
(B, S, 3); every path but the kernel masks by the temporal one, the kernel
by index, as the JAX package's paths do.

KV caches are updated in place (``index_put_``) where the JAX package
donated its buffers: the functions return the cache they were given.

On a grid (``sharding.current_grid()``; the sharded prefill and decode
steps), :func:`multihead_attention` runs this rank's query heads, split
over the model axis (``act_heads``), against its kv heads: split with
them where they divide the axis, else the replicated ones those query
heads read (Gemma-2B's one kv head on every rank).  ``wo`` is
row-parallel, so its product is summed over the model group.

A KV cache on a grid is this rank's block (``transformer.init_cache``
under the binding): split on its sequence over the ``kv_seq`` axes, its
kv heads whole, ``pos`` whole on every rank (JAX's ``kv_cache_axes``
under the decode rules).  :func:`prefill_attention` runs flash on the
rank's heads as above, gathers the new ``k`` / ``v`` over the model group
where the kv heads split, and writes the entries its block holds.
:func:`decode_attention` gathers the query heads (and the new entry's kv
heads) over the model group, writes the entry where the rank's block
holds its slot, and combines one token's softmax over the sequence's
blocks: the row max reduced with ``max`` over the ``kv_seq`` group, then
``exp(s - m)`` summed, ``exp(s - m) / l`` cast where one rank's softmax
is cast, and the blocks' weighted values summed in fp32 (GSPMD's
decomposition of the softmax JAX marks with ``kv_seq``).  A block whose
entries are all masked adds exact zeros.  The rank's heads of the result
go through ``wo``, summed over the model group.  A paged pool has no
placement in the JAX package (``kv_cache_axes`` covers ``k``, ``v`` and
``pos``), so a paged cache on a grid raises (``transformer.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import sharding
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, softcap

Params = Dict[str, Any]

NEG_INF = -1e30
IMPLS = ("dense", "chunked", "flash", "banded", "triangular", "kernel",
         "pallas")
_KERNEL_IMPLS = ("kernel", "pallas")


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
# Blocked attention: the online softmax over KV blocks.  The blocked paths
# work heads-first, (B, K, G, S, ...), so each block's products are one
# batched matmul over (B, K) with the group's queries folded into M.
# ---------------------------------------------------------------------------


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(B, S, K, G, hd) -> (B, K, G, S, hd); (B, S, K, hd) -> (B, K, S,
    hd)."""
    if x.dim() == 5:
        return x.permute(0, 2, 3, 1, 4).contiguous()
    return x.transpose(1, 2).contiguous()


def _seq_first(x: torch.Tensor) -> torch.Tensor:
    """(B, K, G, S, hd) -> (B, S, K, G, hd), contiguous."""
    return x.permute(0, 3, 1, 2, 4).contiguous()


def _scores(qt: torch.Tensor, kj: torch.Tensor) -> torch.Tensor:
    """qt (B, K, G, Sq, hd) · kj (B, K, Sk, hd) -> (B, K, G, Sq, Sk) in the
    activation dtype (JAX's ``einsum("bqkgd,bskd->bkgqs")``)."""
    b, kh, g, sq, hd = qt.shape
    return (qt.reshape(b, kh, g * sq, hd) @ kj.transpose(-1, -2)).view(
        b, kh, g, sq, kj.shape[2])


def _weighted(p: torch.Tensor, vj: torch.Tensor) -> torch.Tensor:
    """p (B, K, G, Sq, Sk) · vj (B, K, Sk, hd) -> (B, K, G, Sq, hd)."""
    b, kh, g, sq, sk = p.shape
    return (p.reshape(b, kh, g * sq, sk) @ vj).view(b, kh, g, sq,
                                                    vj.shape[-1])


def _flash_blocks(x: torch.Tensor, block: int, dim: int = 2):
    """Split ``x`` along its sequence ``dim`` into the KV blocks the
    online softmax walks in order (JAX's scan-major blocking)."""
    return x.split(block, dim=dim)


def _flash_mask(pj: torch.Tensor, q_pos: torch.Tensor,
                window: Optional[int]) -> torch.Tensor:
    """Causal (and windowed) validity of keys at ``pj`` (B, Sk) for queries
    at ``q_pos`` (B, Sq) -> (B, 1, 1, Sq, Sk)."""
    mask = pj[:, None, None, None, :] <= q_pos[:, None, None, :, None]
    if window is not None:
        mask &= (q_pos[:, None, None, :, None]
                 - pj[:, None, None, None, :]) < window
    return mask


def _softmax_step(m, l, acc, s, vj):
    """One block of the online softmax: the running max ``m`` and sum
    ``l`` (B, K, G, Sq) and the fp32 accumulator ``acc`` (B, K, G, Sq, hd)
    take the block's masked fp32 scores ``s`` and values ``vj`` (B, K,
    Sk, hd; P·V in their dtype).  A query with no valid key yet keeps
    ``m = NEG_INF`` and gathers exp(0) = 1 per key; the first valid key
    clears that through ``corr = exp(NEG_INF - m) = 0`` (with -inf this
    would be NaN), as in JAX."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * corr + p.sum(dim=-1)
    pv = _weighted(p.to(vj.dtype), vj).float()
    return m_new, l_new, acc * corr[..., None] + pv


def _softmax_init(qt: torch.Tensor):
    b, kh, g, sq, hd = qt.shape
    m = torch.full((b, kh, g, sq), NEG_INF, dtype=torch.float32,
                   device=qt.device)
    return m, torch.zeros_like(m), torch.zeros(qt.shape, dtype=torch.float32,
                                               device=qt.device)


def _flash_fwd_core(qg, k, v, q_pos, k_pos, scale: float,
                    cap: Optional[float], window: Optional[int], block: int):
    """The flash forward: qg (B, Sq, K, G, hd), k, v (B, Sk, K, hd) ->
    (out (B, Sq, K, G, hd) in qg's dtype, m, l (B, K, G, Sq) fp32, ``l``
    clamped to 1e-30).  Scores are cast to fp32 before the scale and the
    softcap, as JAX's ``_flash_fwd_core`` casts them."""
    qt = _heads_first(qg)
    m, l, acc = _softmax_init(qt)
    for kj, vj, pj in zip(_flash_blocks(_heads_first(k), block),
                          _flash_blocks(_heads_first(v), block),
                          _flash_blocks(k_pos, block, dim=1)):
        z = _scores(qt, kj).float() * scale
        s = cap * torch.tanh(z / cap) if cap is not None else z
        s = torch.where(_flash_mask(pj, q_pos, window), s, NEG_INF)
        m, l, acc = _softmax_step(m, l, acc, s, vj)
    l = torch.clamp(l, min=1e-30)
    return _seq_first((acc / l[..., None]).to(qg.dtype)), m, l


class _FlashAttention(torch.autograd.Function):
    """Flash attention with a recomputing backward: the twin of JAX's
    ``_flash`` custom VJP (``_flash_fwd`` / ``_flash_bwd``).

    The forward saves only ``qg, k, v, q_pos, k_pos, out, m, l``; the
    backward recomputes each block's normalized probabilities
    ``p = exp(s - m) / l``, accumulates ``dq`` in fp32 across blocks and
    emits ``dk`` and ``dv`` per block, summed over the query group (MQA
    folds every query head into one kv head).  The casts are JAX's: ``p``
    and ``ds`` go to the activation dtype before their products, ``dout``
    and ``v`` to fp32 for ``dp``."""

    @staticmethod
    def forward(ctx, qg, k, v, q_pos, k_pos, scale, cap, window, block):
        out, m, l = _flash_fwd_core(qg, k, v, q_pos, k_pos, scale, cap,
                                    window, block)
        ctx.save_for_backward(qg, k, v, q_pos, k_pos, out, m, l)
        ctx.args = (scale, cap, window, block)
        return out

    @staticmethod
    def backward(ctx, dout):
        qg, k, v, q_pos, k_pos, out, m, l = ctx.saved_tensors
        scale, cap, window, block = ctx.args
        b, sq, kh, g, hd = qg.shape
        qt = _heads_first(qg)
        dt = _heads_first(dout)
        dout32 = dt.float()
        # delta_i = sum_d dout_i * out_i  (B, K, G, Sq)
        delta = (dout32 * _heads_first(out).float()).sum(dim=-1)
        dq = torch.zeros(qt.shape, dtype=torch.float32, device=qt.device)
        dks, dvs = [], []
        for kj, vj, pj in zip(_flash_blocks(_heads_first(k), block),
                              _flash_blocks(_heads_first(v), block),
                              _flash_blocks(k_pos, block, dim=1)):
            z = _scores(qt, kj).float() * scale
            if cap is not None:
                s = cap * torch.tanh(z / cap)
                dsdz = 1.0 - torch.square(s / cap)
            else:
                s, dsdz = z, None
            mask = _flash_mask(pj, q_pos, window)
            s = torch.where(mask, s, NEG_INF)
            p = torch.exp(s - m[..., None]) / l[..., None]     # normalized
            bk = kj.shape[2]
            pt = p.to(dout.dtype).reshape(b, kh, g * sq, bk).transpose(-1, -2)
            dvs.append(pt @ dt.reshape(b, kh, g * sq, hd))
            dp = _scores(dout32, vj.float())
            ds = p * (dp - delta[..., None])
            if dsdz is not None:
                ds = ds * dsdz
            ds = torch.where(mask, ds, 0.0) * scale
            ds = ds.to(qg.dtype)
            dq = dq + _weighted(ds, kj).float()
            dks.append(ds.reshape(b, kh, g * sq, bk).transpose(-1, -2)
                       @ qt.reshape(b, kh, g * sq, hd))
        dk = torch.cat(dks, dim=2).transpose(1, 2).to(k.dtype)
        dv = torch.cat(dvs, dim=2).transpose(1, 2).to(v.dtype)
        return (_seq_first(dq).to(qg.dtype), dk, dv, None, None, None, None,
                None, None)


def _attn_flash(cfg: ModelConfig, q, k, v, q_pos, k_pos,
                window: Optional[int] = None, block: int = 256
                ) -> torch.Tensor:
    """Memory-bounded attention with a flash (recomputing) backward; the
    dense path where the keys do not split into whole blocks."""
    sk = k.shape[1]
    block = min(block, sk)
    if sk % block:
        return _attn_dense(cfg, q, k, v, q_pos, k_pos, window)
    out = _FlashAttention.apply(_group(cfg, q), k, v, q_pos, k_pos,
                                _scale(cfg), cfg.attn_logit_softcap, window,
                                block)
    return out.reshape(q.shape)


def _attn_chunked(cfg: ModelConfig, q, k, v, q_pos, k_pos,
                  window: Optional[int] = None, block: int = 1024
                  ) -> torch.Tensor:
    """The online-softmax scan over KV blocks (rectangle FLOPs, bounded
    forward memory), differentiated by autograd; the dense path where the
    keys do not split into whole blocks.  Scores are scaled and capped in
    the activation dtype, then cast, as JAX's ``_attn_chunked`` does."""
    sk = k.shape[1]
    block = min(block, sk)
    if sk % block:
        return _attn_dense(cfg, q, k, v, q_pos, k_pos, window)
    qt = _heads_first(_group(cfg, q))
    m, l, acc = _softmax_init(qt)
    for kj, vj, pj in zip(_flash_blocks(_heads_first(k), block),
                          _flash_blocks(_heads_first(v), block),
                          _flash_blocks(k_pos, block, dim=1)):
        s = softcap(_scores(qt, kj) * _scale(cfg), cfg.attn_logit_softcap)
        s = torch.where(_flash_mask(pj, q_pos, window), s.float(), NEG_INF)
        m, l, acc = _softmax_step(m, l, acc, s, vj)
    l = torch.clamp(l, min=1e-30)
    return _seq_first((acc / l[..., None]).to(q.dtype)).reshape(q.shape)


def _attn_triangular(cfg: ModelConfig, q, k, v, q_pos, k_pos,
                     window: Optional[int] = None, block: int = 1024
                     ) -> torch.Tensor:
    """Exact-causal-FLOPs blocked attention over the lower-triangular
    (q-block, kv-block) pairs, each q block's kv blocks in order, as JAX's
    pair scan; self-attention only (``chunked`` where Sq != Sk or the
    queries do not split into whole blocks).  Each q block's running
    state is its own tensor and the outputs are concatenated, out of
    place, so autograd differentiates it as JAX differentiates its
    scan."""
    sq, sk = q.shape[1], k.shape[1]
    block = min(block, sq, sk)
    if sq != sk or sq % block:
        return _attn_chunked(cfg, q, k, v, q_pos, k_pos, window)
    qb = _flash_blocks(_heads_first(_group(cfg, q)), block, dim=3)
    kb = _flash_blocks(_heads_first(k), block)
    vb = _flash_blocks(_heads_first(v), block)
    pqb = _flash_blocks(q_pos, block, dim=1)
    pkb = _flash_blocks(k_pos, block, dim=1)
    outs = []
    for i, (qi, pq) in enumerate(zip(qb, pqb)):
        m, l, acc = _softmax_init(qi)
        for kj, vj, pk in zip(kb[:i + 1], vb[:i + 1], pkb[:i + 1]):
            s = softcap(_scores(qi, kj) * _scale(cfg), cfg.attn_logit_softcap)
            s = torch.where(_flash_mask(pk, pq, window), s.float(), NEG_INF)
            m, l, acc = _softmax_step(m, l, acc, s, vj)
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=3).to(q.dtype)
    return _seq_first(out).reshape(q.shape)


def _attn_banded(cfg: ModelConfig, q, k, v, q_pos, k_pos,
                 window: int) -> torch.Tensor:
    """Sliding-window attention on a 2w band: query block i attends kv
    blocks {i-1, i} at block size ``window``, exact O(S·2w) FLOPs; the
    dense path where S is not a whole number of windows above one."""
    b, s, hq, hd = q.shape
    w = window
    if s % w or s <= w:
        return _attn_dense(cfg, q, k, v, q_pos, k_pos, window)
    n = s // w
    qg = _group(cfg, q)
    qb = qg.reshape(b, n, w, *qg.shape[2:])
    kb = k.reshape(b, n, w, *k.shape[2:])
    vb = v.reshape(b, n, w, *v.shape[2:])
    pqb, pkb = q_pos.reshape(b, n, w), k_pos.reshape(b, n, w)
    kprev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    pprev = torch.cat([torch.full_like(pkb[:, :1], -(10 ** 9)),
                       pkb[:, :-1]], dim=1)
    k2 = torch.cat([kprev, kb], dim=2)                # (B,n,2w,K,hd)
    v2 = torch.cat([vprev, vb], dim=2)
    p2 = torch.cat([pprev, pkb], dim=2)               # (B,n,2w)
    sc = torch.einsum("bnqkgd,bnskd->bnkgqs", qb, k2) * _scale(cfg)
    sc = softcap(sc, cfg.attn_logit_softcap)
    pq, pk = pqb[:, :, None, None, :, None], p2[:, :, None, None, None, :]
    mask = (pk <= pq) & (pq - pk < w)
    sc = torch.where(mask, sc.float(), NEG_INF)
    pr = torch.softmax(sc, dim=-1).to(q.dtype)
    out = torch.einsum("bnkgqs,bnskd->bnqkgd", pr, v2)
    return out.reshape(b, s, hq, hd)


# ---------------------------------------------------------------------------
# Training: full-sequence attention with autograd
# ---------------------------------------------------------------------------

TRAIN_IMPLS = ("dense", "chunked", "flash", "banded", "triangular")


def check_train_impl(impl: str) -> None:
    """Training runs JAX's five training impls; the CUDA flash kernel
    (``kernel`` / ``pallas``) has no backward, nor has JAX's Pallas
    flash."""
    _check_impl(impl)
    if impl not in TRAIN_IMPLS:
        raise NotImplementedError(
            f"attention impl {impl!r} runs the CUDA flash kernel, which has "
            f"no backward yet (ROADMAP Queue 4, item 4.11; nor has JAX's "
            f"Pallas flash): train with one of {TRAIN_IMPLS}")


def _full_attention(cfg: ModelConfig, q, k, v, positions, window, impl,
                    prefill: bool) -> torch.Tensor:
    """Route a full-sequence attention as JAX does: ``multihead_attention``
    (``prefill=False``) sends windowed ``banded`` to the band and
    ``chunked`` / ``flash`` / windowless ``banded`` to the flash VJP;
    ``prefill_attention`` sends windowed ``banded`` / ``chunked`` /
    ``triangular`` to the band and the rest but ``dense`` / ``triangular``
    to the online-softmax scan."""
    if impl in _KERNEL_IMPLS:
        return _attn_kernel(cfg, q, k, v, window)
    pos = _mask_positions(positions)
    if window is not None and (impl == "banded" or prefill and impl in (
            "chunked", "triangular")):
        return _attn_banded(cfg, q, k, v, pos, pos, window)
    if impl == "dense":
        return _attn_dense(cfg, q, k, v, pos, pos, window)
    if impl == "triangular":
        return _attn_triangular(cfg, q, k, v, pos, pos, window)
    if prefill:
        return _attn_chunked(cfg, q, k, v, pos, pos, window)
    return _attn_flash(cfg, q, k, v, pos, pos, window)


def multihead_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                        positions: torch.Tensor, *,
                        window: Optional[int] = None,
                        impl: str = "dense") -> torch.Tensor:
    """Full-sequence causal self-attention (train / prefill without a
    cache), global or within ``window``.  x (B,S,D); positions (B,S), or
    (B,S,3) under M-RoPE (every path but the kernel masks by the temporal
    stream, the kernel by index).  Every impl of :data:`TRAIN_IMPLS` is
    differentiable; the kernel has no backward, so it raises while
    autograd is on."""
    _check_impl(impl)
    if torch.is_grad_enabled():
        check_train_impl(impl)
    cfg, p, split = _model_heads(cfg, p)
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = _out_proj(p, _full_attention(cfg, q, k, v, positions, window,
                                       impl, prefill=False))
    return sharding.model_sum(out) if split else out


def _query_block(cfg: ModelConfig, p: Params) -> Optional[int]:
    """Where this rank's block of query heads starts (split over the model
    axis), or None when it holds them all."""
    h = p["wq"].shape[1]
    return None if h == cfg.num_heads else sharding.model_block(
        cfg.num_heads, h)


def _kv_read(cfg: ModelConfig, lo: int, h: int, kv: int, device):
    """The kv heads query heads ``[lo, lo + h)`` read out of ``kv`` held
    ones: None where the kv heads split with the query heads (or there is
    one), else heads ``(lo + i) // G``: a slice where the block holds
    whole groups, else an index, one kv head a query head."""
    if kv != cfg.num_kv_heads or kv == 1:
        return None
    g = cfg.num_heads // cfg.num_kv_heads
    if h % g == 0:
        return slice(lo // g, (lo + h) // g)
    return torch.div(torch.arange(lo, lo + h, device=device), g,
                     rounding_mode="floor")


def _take(t: torch.Tensor, idx, dim: int) -> torch.Tensor:
    if isinstance(idx, slice):
        return t.narrow(dim, idx.start, idx.stop - idx.start)
    return t.index_select(dim, idx)


def _model_heads(cfg: ModelConfig, p: Params
                 ) -> Tuple[ModelConfig, Params, bool]:
    """(``cfg`` with this rank's head counts, ``p`` with the kv heads its
    query heads read, whether ``wo``'s product is a partial sum over the
    model group).  Query heads split over the model axis are a
    contiguous block ``[lo, lo + h)``; kv heads split with them give
    groups of ``G`` as on one rank, replicated ones are cut to those the
    block reads (:func:`_kv_read`).  Unsplit heads give ``(cfg, p,
    False)``."""
    lo = _query_block(cfg, p)
    if lo is None:
        return cfg, p, False
    h = p["wq"].shape[1]
    idx = _kv_read(cfg, lo, h, p["wk"].shape[1], p["wk"].device)
    if idx is not None:
        p = dict(p)
        for name, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
            if name in p:
                p[name] = _take(p[name], idx, dim)
    return cfg.replace(num_heads=h, num_kv_heads=p["wk"].shape[1]), p, True


def _rank_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor,
              positions: torch.Tensor):
    """(this rank's query-head start, None where it holds every query
    head; q for its query heads; k and v for every kv head; k and v for
    the kv heads its query heads read).  On a grid ``k`` / ``v`` are
    projected from the rank's own kv block and gathered over the model
    group where the kv heads split."""
    lo = _query_block(cfg, p)
    q, k, v = _project_qkv(cfg, p, x, positions)
    ka, va = k, v
    if lo is not None:
        idx = _kv_read(cfg, lo, q.shape[2], k.shape[2], k.device)
        if idx is not None:
            ka, va = _take(k, idx, 2), _take(v, idx, 2)
        if k.shape[2] != cfg.num_kv_heads:
            k, v = sharding.model_gather(k, 2), sharding.model_gather(v, 2)
    return lo, q, k, v, ka, va


def _cache_block(cfg: ModelConfig, cache: Params) -> Tuple[int, Tuple]:
    """(where this rank's block of the cache's sequence starts, the mesh
    axes it is split over); its kv heads must be whole."""
    if cache["k"].shape[2] != cfg.num_kv_heads:
        raise NotImplementedError(
            f"a KV cache split on its kv heads ({cache['k'].shape[2]} of "
            f"{cfg.num_kv_heads} a rank): {sharding.ITEM_UNEXECUTED}")
    return sharding.seq_block(cache["pos"].shape[1], cache["k"].shape[1])


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
                pos, *, ring: bool = False, start: int = 0) -> Params:
    """Write S new KV entries starting at absolute position ``pos``, in
    place.  ``pos`` is an int (all rows at the same position: prefill) or
    a ``(B,)`` tensor of per-row positions (single-token decode writes,
    which wrap modulo the cache length: an empty slot's garbage decode
    runs past it).

    A ``ring`` (a local layer's cache) takes entry ``p`` at slot
    ``p % size``; a write of S >= size entries keeps the last ``size``.
    A global cache raises where the write would run past its end.

    On a grid the cache's ``k`` / ``v`` may be a block of the sequence,
    slots ``[start, start + local)`` of the whole ``size`` that ``pos``
    (never split) spans: only the entries whose slots it holds are
    written there, and ``pos`` takes every one."""
    b, s = k.shape[0], k.shape[1]
    size, local = cache["pos"].shape[1], cache["k"].shape[1]
    if isinstance(pos, torch.Tensor):
        if s != 1:
            raise ValueError("per-row cache writes are single-token only")
        rows = torch.arange(b, device=k.device)
        idx = (pos % size).long()
        cache["pos"][rows, idx] = pos.to(torch.int32)
        if local != size:
            # a row whose slot another rank holds rewrites an entry of its
            # own with itself (no host read of which rows are whose)
            mine = (idx >= start) & (idx < start + local)
            idx = torch.where(mine, idx - start, torch.zeros_like(idx))
            keep = mine[:, None, None]
            k = torch.where(keep, k[:, 0], cache["k"][rows, idx])[:, None]
            v = torch.where(keep, v[:, 0], cache["v"][rows, idx])[:, None]
        cache["k"][rows, idx] = k[:, 0]
        cache["v"][rows, idx] = v[:, 0]
        return cache
    if local != size:
        return _block_write(cache, k, v, pos, ring, start)
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


def _block_write(cache: Params, k: torch.Tensor, v: torch.Tensor, pos: int,
                 ring: bool, start: int) -> Params:
    """:func:`cache_write` of S entries at ``pos`` into a block of slots
    ``[start, start + local)``: the whole cache's slots reckoned on the
    host, the entries landing in the block written there, and every one
    into the whole ``pos``."""
    s = k.shape[1]
    size, local = cache["pos"].shape[1], cache["k"].shape[1]
    keep = min(s, size) if ring else s
    if not ring and pos + s > size:
        raise ValueError(f"{s} entries at position {pos} overflow the cache")
    src = torch.arange(s - keep, s)
    newpos = pos + src
    slots = newpos % size
    mine = (slots >= start) & (slots < start + local)
    dev = k.device
    cache["pos"][:, slots.to(dev)] = newpos.to(device=dev, dtype=torch.int32)
    dst, src = (slots[mine] - start).to(dev), src[mine].to(dev)
    cache["k"][:, dst] = k[:, src]
    cache["v"][:, dst] = v[:, src]
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
    are (B,S,3) and mask every path but the kernel as in
    :func:`multihead_attention`.  ``impl`` routes as JAX's prefill does: a
    windowed ``banded``, ``chunked`` or ``triangular`` layer takes the
    band, ``chunked`` / ``flash`` the online-softmax scan.

    On a grid the rank's query heads attend to the kv heads they read
    (flash on the card under ``impl="kernel"``), every kv head's entries
    are written where the rank's block of the cache holds their slots,
    and ``wo``'s product is summed over the model group."""
    _check_impl(impl)
    ring = window is not None or cache["pos"].shape[1] < x.shape[1]
    start, _ = _cache_block(cfg, cache)
    lo, q, k, v, ka, va = _rank_qkv(cfg, p, x, positions)
    if lo is not None:
        cfg = cfg.replace(num_heads=q.shape[2], num_kv_heads=ka.shape[2])
    out = _out_proj(p, _full_attention(cfg, q, ka, va, positions, window,
                                       impl, prefill=True))
    cache = cache_write(cache, k, v, 0, ring=ring, start=start)
    return (out if lo is None else sharding.model_sum(out)), cache


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
    tensor of per-row absolute positions (or a scalar one).

    On a grid every query head (gathered over the model group) attends to
    the rank's block of the cache's sequence, the softmax combined over
    the ``kv_seq`` group (:func:`_attend_split`), and the rank's heads of
    the result go through ``wo``, summed over the model group."""
    b = x.shape[0]
    pos_b = pos.to(torch.int32).expand(b)
    start, axes = _cache_block(cfg, cache)
    lo, q, k, v, _, _ = _rank_qkv(cfg, p, x, _one_token_positions(cfg, pos_b))
    h = q.shape[2]
    if lo is not None:
        q = sharding.model_gather(q, 2)
    cache = cache_write(cache, k, v, pos_b, start=start)
    local = cache["k"].shape[1]
    valid = _decode_valid(cache["pos"][:, start:start + local], pos_b, window)
    if axes:
        out = _attend_split(cfg, q, cache["k"], cache["v"], valid, axes)
    else:
        out = _attend_one(cfg, q, cache["k"], cache["v"], valid)
    if lo is None:
        return _out_proj(p, out), cache
    return sharding.model_sum(_out_proj(p, out[:, :, lo:lo + h])), cache


def _decode_valid(pc: torch.Tensor, pos_b: torch.Tensor,
                  window: Optional[int]) -> torch.Tensor:
    """The entries a token at ``pos_b`` (B,) sees among cache positions
    ``pc`` (B, n): filled, not ahead of it, within ``window``."""
    valid = (pc >= 0) & (pc <= pos_b[:, None])
    if window is not None:
        valid &= (pos_b[:, None] - pc) < window
    return valid


def _attend_split(cfg: ModelConfig, q, kc, vc, valid, axes) -> torch.Tensor:
    """:func:`_attend_one` over a cache view split on its sequence across
    the group along mesh axes ``axes``, this rank holding ``kc`` / ``vc``
    / ``valid``: the scores as one rank computes them, the row max reduced
    with ``max``, ``exp(s - m)`` summed, ``pr = exp(s - m) / l`` cast to
    the activation dtype where one rank casts its softmax, and the blocks'
    ``pr · v`` summed in fp32, then cast.  Masked scores (``NEG_INF``)
    give exact zeros beside the group's max, so an empty block adds
    nothing."""
    qg = _group(cfg, q)                                   # (B,1,K,G,hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kc) * _scale(cfg)
    s = softcap(s, cfg.attn_logit_softcap)
    s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF).float()
    m = sharding.group_max(s.amax(dim=-1, keepdim=True), axes)
    e = torch.exp(s - m)
    l = sharding.group_sum(e.sum(dim=-1, keepdim=True), axes)
    pr = (e / l).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", pr.float(), vc.float())
    return sharding.group_sum(out, axes).to(q.dtype).reshape(q.shape)
