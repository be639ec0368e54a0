"""Fused masked AdamW: the wrapper of the CUDA kernel ``csrc/fused_adam.cu``
(replaces the Pallas TPU kernel ``repro/kernels/fused_adam.py::fused_adamw_2d``).

The wrapper takes CUDA tensors only and updates ``p``, ``m`` and ``v`` in
place; ``kernels/ops.py`` dispatches CPU tensors to the plain version in
``kernels/ref.py``.  ``launches`` counts the kernel launches of this
process.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS = 65535      # rows ride on gridDim.y

_fns = None


def _lib_fns():
    global _fns
    if _fns is None:
        lib = _build.load("fused_adam")
        fn = lib.fused_adamw_2d
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_float] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fused_adamw_error_string.argtypes = [ctypes.c_int]
        lib.fused_adamw_error_string.restype = ctypes.c_char_p
        _fns = (fn, lib.fused_adamw_error_string)
    return _fns


def fused_adamw_2d(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                   v: torch.Tensor, mask: Optional[torch.Tensor],
                   scalars: Sequence[float]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One masked-AdamW step over a stacked leaf, in place.

    p, g: (N, M) float32 or bfloat16; m, v: (N, M) float32; mask: (N,)
    float32 freeze mask, or None for every row on; scalars: the nine
    hyper-parameters ``[lr, b1, b2, 1-b1, 1-b2, eps, wd, bc1, bc2]`` as
    floats that fp32 represents exactly.  All tensors contiguous on one
    CUDA device.  Returns (p, m, v), the same tensors."""
    global launches
    if p.dim() != 2:
        raise ValueError(f"want a 2-d (N, M) leaf, got {tuple(p.shape)}")
    rows, cols = p.shape
    if not 1 <= rows <= _MAX_ROWS or cols < 1:
        raise ValueError(f"leaf {tuple(p.shape)}: want 1 <= N <= {_MAX_ROWS}"
                         f" and M >= 1")
    checks = [("p", p, tuple(_DTYPE_CODES)), ("g", g, tuple(_DTYPE_CODES)),
              ("m", m, (torch.float32,)), ("v", v, (torch.float32,))]
    for name, t, dtypes in checks:
        if t.shape != p.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != p {tuple(p.shape)}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} is {t.dtype}, want one of {dtypes}")
    if mask is not None:
        if mask.shape != (rows,) or mask.dtype != torch.float32:
            raise ValueError(f"mask must be ({rows},) float32, got "
                             f"{tuple(mask.shape)} {mask.dtype}")
        checks.append(("mask", mask, None))
    for name, t, _ in checks:
        if t.device.type != "cuda" or t.device != p.device:
            raise ValueError(f"{name} must lie on p's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    hyp = [float(x) for x in scalars]
    if len(hyp) != 9:
        raise ValueError(f"want 9 hyper-parameters, got {len(hyp)}")
    fn, err_str = _lib_fns()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    with torch.cuda.device(p.device):
        err = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(), rows, cols,
                 _DTYPE_CODES[p.dtype], _DTYPE_CODES[g.dtype], *hyp, stream)
    if err != 0:
        raise RuntimeError(f"fused_adamw_2d launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    launches += 1
    return p, m, v
