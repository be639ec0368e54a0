"""Update- and activation-path compression with error feedback — the twin
of ``repro/compress.py``.

The client updates uploaded for aggregation (the post-optimizer stage
deltas) are compressed before they cross the wire and reconstructed in
front of ``aggregation.aggregate_clients``; with
``CompressionConfig.activations`` every split-hop crossing (activations
up, cotangents down) is compressed the same way.

Schemes (``CompressionConfig.kind``):

* ``topk`` — each row keeps the coordinates whose magnitude reaches its
  k-th largest |x|, k = round(rate * m) in fp32, clipped to [1, m]; the
  wire carries k (fp32 value, int32 index) pairs: 8k bytes a row.
* ``quant`` (int8 / int4) — stochastic symmetric quantization at
  ``levels = 2^(bits-1) - 1`` per row with an fp32 scale (max |x|):
  m * bits / 8 + 4 bytes a row.  Stochastic rounding keeps the
  reconstruction unbiased.

Error feedback keeps a per-client fp32 residual ``e`` shaped like the
stacked client stage: ``x = delta + e``, ``sent = decompress(compress(x))``,
``e' = x - sent``.  Masked clients send exactly 0 and keep ``e``.

The elementwise passes go through ``kernels/ops.py`` (the CUDA kernels of
``kernels/csrc/compress.cu`` on the card, their plain versions on the
CPU); the per-row reductions that feed them (max |x| for the scale, the
k-th largest |x| for the threshold) are plain PyTorch, as they are plain
XLA in JAX.  Every uniform draw ``u`` of the quantizer is an optional
argument; without it, ``u`` is drawn on the tensor's device from the
``generator`` passed.

Leaves are taken in the JAX package's order (dict keys sorted), so a leaf
index here is the one the JAX round folds into its draws.  Byte counts
are exact Python numbers, those of ``core/protocol.compressed_update_bytes``
(the JAX package's traced counterpart sums in fp32, which rounds once the
total passes 2^24).
"""

from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch.config import CompressionConfig
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_unflatten

Params = Any


class CompressionParams(NamedTuple):
    """The runtime values of a CompressionConfig, each rounded to fp32 as
    the JAX package's traced scalars are."""

    rate: float      # topk: kept fraction of coordinates per row
    levels: float    # quant: integer levels per side (127 = int8, 7 = int4)
    bits: float      # quant: wire bits per element


def compression_params(cfg: CompressionConfig) -> CompressionParams:
    f32 = lambda v: float(np.float32(v))
    levels = float(2 ** (cfg.bits - 1) - 1) if cfg.kind == "quant" else 1.0
    return CompressionParams(rate=f32(cfg.rate), levels=f32(levels),
                             bits=f32(cfg.bits))


def topk_count(m: int, rate: float) -> float:
    """k = round(rate * m) clipped to [1, m], in fp32 as the JAX package
    computes it (a float64 ``round(rate * m)`` can pick another k)."""
    k = np.round(np.float32(rate) * np.float32(m))
    return float(np.clip(k, np.float32(1.0), np.float32(m)))


def topk_threshold(x2: torch.Tensor, rate: float) -> torch.Tensor:
    """Per-row magnitude threshold of (N, M) ``x2``: the ascending sort's
    entry ``idx = m - k`` (computed in fp32, as JAX indexes it), taken as
    the smallest of the ``m - idx`` largest |x| -> (N,) fp32.

    ``torch.topk`` selects across many CUDA blocks; ``torch.kthvalue``
    gives the same value with one block per row, seconds on an embedding
    leaf of half a billion entries, and ``torch.sort`` holds 12 bytes per
    element."""
    n, m = x2.shape
    if m == 0:
        return torch.zeros((n,), dtype=torch.float32, device=x2.device)
    idx = np.clip(np.float32(m) - np.float32(topk_count(m, rate)),
                  np.float32(0.0), np.float32(m - 1))
    return torch.topk(x2.float().abs(), m - int(idx), dim=1,
                      sorted=False).values.amin(dim=1)


def _compress_leaf(x2: torch.Tensor, kind: str, params: CompressionParams,
                   u: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """fp32 (N, M) -> its wire reconstruction decompress(compress(x))."""
    if kind == "topk":
        # ties at the threshold may keep a few extra coordinates; the wire
        # format (and the byte count) carries exactly k pairs
        return ops.topk_mask(x2, topk_threshold(x2, params.rate))
    if kind == "quant":
        lo, hi = torch.aminmax(x2, dim=1)
        scale = torch.maximum(-lo, hi)                   # max |x| per row
        # the level count as an fp32 tensor on the device: a CUDA division
        # by a Python scalar multiplies by its reciprocal
        lv = torch.full((), params.levels, dtype=torch.float32,
                        device=x2.device)
        live = scale > 0
        step = torch.where(live, scale / lv, 0.0)
        inv_step = torch.where(live, lv / scale, 0.0)
        if u is None:
            u = torch.rand(x2.shape, generator=generator, dtype=torch.float32,
                           device=x2.device)
        q = ops.quantize_stochastic(x2, u, inv_step, params.levels)
        return ops.dequantize(q, step)
    raise ValueError(f"unknown compression kind {kind!r}")


def init_ef_residual(client_stack: Params) -> Params:
    """Zero fp32 residuals shaped like the stacked client stage."""
    return tree_map(lambda l: torch.zeros(l.shape, dtype=torch.float32,
                                          device=l.device), client_stack)


def apply_compression(delta: Params, residual: Params, mask: torch.Tensor,
                      cfg: CompressionConfig,
                      params: Optional[CompressionParams] = None, *,
                      u: Optional[Sequence[Optional[torch.Tensor]]] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[Params, Params]:
    """Compress stacked client updates with error feedback.

    delta: update tree, leaves (N, ...); residual: matching fp32 tree, or
    ``()`` without error feedback; mask: (N,) participation (``> 0`` is
    on); u: the uniform draw of each leaf, in :func:`tree_leaves` order
    (quant only; None draws from ``generator``).  Returns ``(sent,
    new_residual)``: sent is the wire reconstruction, exactly 0 on masked
    rows; masked rows keep their residual."""
    if params is None:
        params = compression_params(cfg)
    kind = cfg.kind
    if kind == "none":
        return delta, residual
    ef = bool(tree_leaves(residual))
    leaves_d = tree_leaves(delta)
    leaves_r = tree_leaves(residual) if ef else [None] * len(leaves_d)
    sent_leaves, res_leaves = [], []
    for i, (d, r) in enumerate(zip(leaves_d, leaves_r)):
        n = d.shape[0]
        x2 = d.reshape(n, -1).float()
        if x2.shape[1] == 0:     # empty leaf: nothing to send or accumulate
            sent_leaves.append(torch.zeros_like(d))
            res_leaves.append(r)
            continue
        on = (mask > 0).reshape(n, 1).to(x2.device)
        r2 = r.reshape(n, -1) if ef else None
        if ef:
            x2 = x2 + r2
        rec = _compress_leaf(x2, kind, params, None if u is None else u[i],
                             generator)
        if ef:
            # x2 is this function's own buffer: the new residual goes into
            # it, the sent rows into rec, without another leaf-size buffer
            x2.sub_(rec)
            res_leaves.append(torch.where(on, x2, r2, out=x2).reshape(r.shape))
        del x2
        rec.masked_fill_(~on, 0.0)
        sent_leaves.append(rec.reshape(d.shape).to(d.dtype))
    sent = tree_unflatten(delta, iter(sent_leaves))
    new_res = tree_unflatten(residual, iter(res_leaves)) if ef else residual
    return sent, new_res


def compressed_stage_bytes(client_stack: Params, cfg: CompressionConfig,
                           params: Optional[CompressionParams] = None
                           ) -> float:
    """Wire bytes of ONE client's compressed stage upload: topk k (fp32
    value, int32 index) pairs per leaf row; quant m * bits / 8 payload
    (whole bytes) + one fp32 scale per leaf row; none the raw bytes.
    Per-client elements come from each leaf's own leading axis."""
    if params is None:
        params = compression_params(cfg)
    kind = cfg.kind
    total = 0.0
    for l in tree_leaves(client_stack):
        m = l.numel() // l.shape[0]
        if m == 0:
            continue
        if kind == "none":
            total += m * l.element_size()
        elif kind == "topk":
            total += topk_count(m, params.rate) * 8.0
        else:
            total += math.ceil(m * params.bits / 8.0) + 4.0
    return total


def compress_activations(a: torch.Tensor, cfg: CompressionConfig,
                         params: Optional[CompressionParams] = None, *,
                         u: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """Wire reconstruction of a (..., d) activation (or cotangent)
    crossing a split hop: each d-vector is a row, compressed with the
    update path's scheme and no error feedback.  ``u``: (rows, d) fp32
    for quant, or None to draw from ``generator``."""
    if params is None:
        params = compression_params(cfg)
    if cfg.kind == "none":
        return a
    d = a.shape[-1]
    if d == 0 or a.numel() == 0:
        return a
    x2 = a.reshape(-1, d).float()
    rec = _compress_leaf(x2, cfg.kind, params, u, generator)
    return rec.reshape(a.shape).to(a.dtype)


def activation_wire_bytes(rows: int, d: int, cfg: CompressionConfig,
                          params: Optional[CompressionParams] = None
                          ) -> float:
    """Wire bytes of ONE client's activation crossing a hop: ``rows``
    d-vectors, in the per-row format of :func:`compressed_stage_bytes`."""
    if params is None:
        params = compression_params(cfg)
    kind = cfg.kind
    if kind == "none":
        return rows * d * 4.0
    if kind == "topk":
        return rows * topk_count(d, params.rate) * 8.0
    return rows * (math.ceil(d * params.bits / 8.0) + 4.0)
