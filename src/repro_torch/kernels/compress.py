"""Stochastic quantize, dequantize and top-k mask: the wrappers of the CUDA
kernels ``csrc/compress.cu`` (replace the Pallas TPU kernels
``repro/kernels/compress.py::quantize_stochastic_2d``, ``::dequantize_2d``
and ``::topk_mask_2d``).

The wrappers take contiguous CUDA tensors only and allocate their
outputs; ``kernels/ops.py`` dispatches CPU tensors to the plain versions
in ``kernels/ref.py``.  A leaf with ``M == 0`` returns an empty output
without a launch (a zero-size grid is a launch error).  Each wrapper
counts its launches in this module: ``quantize_launches``,
``dequantize_launches`` and ``topk_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

quantize_launches = 0
dequantize_launches = 0
topk_launches = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("compress")
        ptrs = [ctypes.c_void_p] * 4
        lib.quantize_stochastic_2d.argtypes = (
            ptrs + [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_void_p])
        for fn in (lib.dequantize_2d, lib.topk_mask_2d):
            fn.argtypes = ptrs[:3] + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        for fn in (lib.quantize_stochastic_2d, lib.dequantize_2d,
                   lib.topk_mask_2d):
            fn.restype = ctypes.c_int
        lib.compress_error_string.argtypes = [ctypes.c_int]
        lib.compress_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} {tuple(t.shape)}, want {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, want {dtype}")
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name} must lie on one CUDA device, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _run(fn, *args, device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: "
                           f"{_load().compress_error_string(err).decode()} "
                           f"(cudaError {err})")


def _matrix(name: str, t: torch.Tensor, dtype) -> None:
    if t.dim() != 2:
        raise ValueError(f"want a 2-d (N, M) {name}, got {tuple(t.shape)}")
    _check(name, t, t.shape, dtype, None)


def quantize_stochastic_2d(x: torch.Tensor, u: torch.Tensor,
                           inv_step: torch.Tensor, levels: float
                           ) -> torch.Tensor:
    """x, u: (N, M) fp32; inv_step: (N,) fp32 = levels / scale (0 for an
    all-zero row); levels: a float -> int8 codes (N, M) in [-levels,
    levels]."""
    global quantize_launches
    _matrix("x", x, torch.float32)
    n, m = x.shape
    _check("u", u, (n, m), torch.float32, x.device)
    _check("inv_step", inv_step, (n,), torch.float32, x.device)
    q = torch.empty((n, m), dtype=torch.int8, device=x.device)
    if n == 0 or m == 0:
        return q
    _run(_load().quantize_stochastic_2d, x.data_ptr(), u.data_ptr(),
         inv_step.data_ptr(), q.data_ptr(), n, m, float(levels),
         device=x.device)
    quantize_launches += 1
    return q


def dequantize_2d(q: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """q: (N, M) int8 codes; step: (N,) fp32 = scale / levels -> fp32."""
    global dequantize_launches
    _matrix("q", q, torch.int8)
    n, m = q.shape
    _check("step", step, (n,), torch.float32, q.device)
    out = torch.empty((n, m), dtype=torch.float32, device=q.device)
    if n == 0 or m == 0:
        return out
    _run(_load().dequantize_2d, q.data_ptr(), step.data_ptr(), out.data_ptr(),
         n, m, device=q.device)
    dequantize_launches += 1
    return out


def topk_mask_2d(x: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """x: (N, M) fp32; thresh: (N,) fp32 -> x with every entry whose
    magnitude is below its row's threshold set to 0."""
    global topk_launches
    _matrix("x", x, torch.float32)
    n, m = x.shape
    _check("thresh", thresh, (n,), torch.float32, x.device)
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return out
    _run(_load().topk_mask_2d, x.data_ptr(), thresh.data_ptr(), out.data_ptr(),
         n, m, device=x.device)
    topk_launches += 1
    return out
