"""RG-LRU recurrence: the wrapper of the CUDA kernel ``csrc/rg_lru.cu``
(replaces the Pallas TPU kernel ``repro/kernels/rg_lru.py::rg_lru_scan``).

The wrapper takes CUDA tensors only; ``kernels/ops.py`` dispatches CPU
tensors to the plain version in ``kernels/ref.py``.  ``launches`` counts
the kernel launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_fns = None


def _lib_fns():
    global _fns
    if _fns is None:
        lib = _build.load("rg_lru")
        fn = lib.rg_lru_fwd
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.rg_lru_error_string.argtypes = [ctypes.c_int]
        lib.rg_lru_error_string.restype = ctypes.c_char_p
        _fns = (fn, lib.rg_lru_error_string)
    return _fns


def rg_lru_scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log_a (B, S, W) float32; b (B, S, W) float32 or bfloat16; both
    contiguous on one CUDA device -> h (B, S, W) in b's dtype."""
    global launches
    if b.dim() != 3 or log_a.shape != b.shape:
        raise ValueError(f"want log_a and b of one (B, S, W) shape, got "
                         f"{tuple(log_a.shape)} and {tuple(b.shape)}")
    bsz, s, w = b.shape
    if min(bsz, s, w) < 1:
        raise ValueError(f"empty shape {tuple(b.shape)}")
    if log_a.dtype != torch.float32 or b.dtype not in _DTYPE_CODES:
        raise ValueError(f"log_a must be float32 (is {log_a.dtype}) and b in "
                         f"{list(_DTYPE_CODES)} (is {b.dtype})")
    for name, t in (("log_a", log_a), ("b", b)):
        if t.device.type != "cuda" or t.device != b.device:
            raise ValueError(f"{name} must lie on b's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    h = torch.empty_like(b)
    fn, err_str = _lib_fns()
    stream = torch.cuda.current_stream(b.device).cuda_stream
    with torch.cuda.device(b.device):
        err = fn(log_a.data_ptr(), b.data_ptr(), h.data_ptr(), bsz, s, w,
                 _DTYPE_CODES[b.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rg_lru_scan launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    launches += 1
    return h
