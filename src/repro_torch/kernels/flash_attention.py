"""Flash-attention prefill: the wrapper of the CUDA kernel
``csrc/flash_attention.cu`` (replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_bhsd``).

The wrapper takes CUDA tensors only; ``kernels/ops.py`` dispatches CPU
tensors to the plain version in ``kernels/ref.py``.  ``launches`` counts
the kernel launches of this process; ``tc_launches`` those that took the
tensor-core body (every bfloat16 call: float32 takes the SIMT body);
``window_launches`` those with a sliding window (a model's local layers).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

launches = 0
tc_launches = 0
window_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the CUDA source is built for (160: padded to 192 in the
# tensor-core body's tiles, csrc/flash_attention.cu)
_HEAD_DIMS = (32, 64, 128, 160, 256)
_TILE_ROWS = 64   # rows of the grouped query tile (BM in the source)

_fn = None


def _lib_fn():
    global _fn
    if _fn is None:
        lib = _build.load("flash_attention")
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_attention_error_string)
    return _fn


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         scale: Optional[float] = None,
                         logit_softcap: Optional[float] = None
                         ) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd), contiguous CUDA tensors
    of one dtype (float32 or bfloat16) -> (B, Sq, Hq, hd).  Any S >= 1."""
    global launches, tc_launches, window_launches
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants 4-d (B, S, H, hd) tensors")
    b, sq, hq, hd = q.shape
    _, sk, hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hkv < 1 or hq % hkv or hq // hkv > _TILE_ROWS:
        raise ValueError(f"{hq} query heads over {hkv} kv heads: the group "
                         f"size must be a whole number <= {_TILE_ROWS}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {_HEAD_DIMS}")
    if sq < 1 or sk < 1:
        raise ValueError("empty sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not in {list(_DTYPE_CODES)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    fn, err_str = _lib_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, sk, hq, hkv, hd, _DTYPE_CODES[q.dtype], float(scale),
                 float(logit_softcap or 0.0), int(window or 0), int(causal),
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    launches += 1
    if q.dtype == torch.bfloat16:
        tc_launches += 1
    if window:
        window_launches += 1
    return out
