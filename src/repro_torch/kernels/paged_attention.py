"""Paged decode attention: the wrapper of the CUDA kernel
``csrc/paged_attention.cu`` (replaces the Pallas TPU kernel
``repro/kernels/paged_attention.py::paged_decode_attention``).

The wrapper takes CUDA tensors only; ``kernels/ops.py`` dispatches CPU
tensors to the plain version in ``kernels/ref.py``.  Each call runs the
split-K design: a split kernel over runs of the block table, then a merge
kernel, both launched by one C call on the current stream.  ``launches``
counts the calls of this process; ``split_launches`` those that ran the
split-K pair (every call).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

launches = 0
split_launches = 0

# two CTAs on each of the H100's 132 SMs
_TARGET_CTAS = 264
# the fewest keys a split CTA scores
_MIN_SPLIT_KEYS = 16

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_fns = None


def _lib_fns():
    global _fns
    if _fns is None:
        lib = _build.load("paged_attention")
        fn = lib.paged_decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err_str = lib.paged_decode_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _fns = (fn, err_str)
    return _fns


def split_plan(b: int, hkv: int, nb: int, bs: int) -> Tuple[int, int]:
    """``(splits, blocks_per_split)`` of one call: the table's ``nb``
    logical blocks in runs of ``blocks_per_split``, one CTA per (run, kv
    head, row).  From the shapes alone, never from ``pos``: it lies on the
    card, and reading it here would synchronise the stream.  Runs are one
    block while the grid reaches ``_TARGET_CTAS``, longer past it, and hold
    at least ``_MIN_SPLIT_KEYS`` keys."""
    bps = max(1, (b * hkv * nb) // _TARGET_CTAS, -(-_MIN_SPLIT_KEYS // bs))
    bps = min(bps, nb)
    return -(-nb // bps), bps


def paged_decode_attention(q: torch.Tensor, pk: torch.Tensor,
                           pv: torch.Tensor, ppos: torch.Tensor,
                           table: torch.Tensor, pos: torch.Tensor, *,
                           scale: Optional[float] = None,
                           logit_softcap: Optional[float] = None
                           ) -> torch.Tensor:
    """q: (B, Hq, hd); pk/pv: (NB, bs, Hkv, hd) pool; ppos: (NB, bs) int32;
    table: (B, nb) int32 logical->physical block map; pos: (B,) int32
    current absolute position per row -> (B, Hq, hd).  All contiguous
    tensors on one CUDA device; q, pk and pv float32 or bfloat16."""
    global launches, split_launches
    if q.dim() != 3 or pk.dim() != 4 or pv.shape != pk.shape:
        raise ValueError(f"want q (B, Hq, hd) and pk/pv (NB, bs, Hkv, hd); "
                         f"got {tuple(q.shape)}, {tuple(pk.shape)}, "
                         f"{tuple(pv.shape)}")
    b, hq, hd = q.shape
    n_blocks, bs, hkv, hd_k = pk.shape
    if hd_k != hd or hkv < 1 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pool "
                         f"{tuple(pk.shape)}")
    if table.dim() != 2 or table.shape[0] != b or pos.shape != (b,) \
            or ppos.shape != (n_blocks, bs):
        raise ValueError(f"table {tuple(table.shape)}, pos {tuple(pos.shape)}"
                         f", ppos {tuple(ppos.shape)} do not fit B={b}, "
                         f"pool {tuple(pk.shape)}")
    nb = table.shape[1]
    for name, t, dtype in (("q", q, q.dtype), ("pk", pk, q.dtype),
                           ("pv", pv, q.dtype), ("ppos", ppos, torch.int32),
                           ("table", table, torch.int32),
                           ("pos", pos, torch.int32)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device")
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}, want {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not in {list(_DTYPE_CODES)}")
    fn, err_str = _lib_fns()
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    splits, bps = split_plan(b, hkv, nb, bs)
    # per split and query head: acc[hd], then (m, l) of every split
    scratch = torch.empty(b * hq * splits * (hd + 2), dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), pk.data_ptr(), pv.data_ptr(), ppos.data_ptr(),
                 table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), b, nb, bs, hq, hkv, hd,
                 _DTYPE_CODES[q.dtype], bps, float(scale),
                 float(logit_softcap or 0.0), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    launches += 1
    split_launches += 1
    return out
