"""Weighted client average: the wrapper of the CUDA kernel ``csrc/wavg.cu``
(replaces the Pallas TPU kernel ``repro/kernels/wavg.py::weighted_average_2d``).

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
_MAX_ROWS = 4096       # weights staged in shared memory (MAX_ROWS in the source)

_fns = None


def _lib_fns():
    global _fns
    if _fns is None:
        lib = _build.load("wavg")
        fn = lib.weighted_average_2d
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                                ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.weighted_average_error_string.argtypes = [ctypes.c_int]
        lib.weighted_average_error_string.restype = ctypes.c_char_p
        _fns = (fn, lib.weighted_average_error_string)
    return _fns


def weighted_average_2d(stacked: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """stacked: (N, M) float32 or bfloat16; weights: (N,) float32; both
    contiguous on one CUDA device -> (M,) in stacked's dtype, summed in
    fp32 over N in index order."""
    global launches
    if stacked.dim() != 2:
        raise ValueError(f"want a 2-d (N, M) stack, got {tuple(stacked.shape)}")
    rows, cols = stacked.shape
    if not 1 <= rows <= _MAX_ROWS or cols < 1:
        raise ValueError(f"stack {tuple(stacked.shape)}: want 1 <= N <= "
                         f"{_MAX_ROWS} and M >= 1")
    if stacked.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {stacked.dtype} not in {list(_DTYPE_CODES)}")
    if weights.shape != (rows,) or weights.dtype != torch.float32:
        raise ValueError(f"weights must be ({rows},) float32, got "
                         f"{tuple(weights.shape)} {weights.dtype}")
    for name, t in (("stacked", stacked), ("weights", weights)):
        if t.device.type != "cuda" or t.device != stacked.device:
            raise ValueError(f"{name} must lie on the stack's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((cols,), dtype=stacked.dtype, device=stacked.device)
    fn, err_str = _lib_fns()
    stream = torch.cuda.current_stream(stacked.device).cuda_stream
    with torch.cuda.device(stacked.device):
        err = fn(stacked.data_ptr(), weights.data_ptr(), out.data_ptr(), rows,
                 cols, _DTYPE_CODES[stacked.dtype], stream)
    if err != 0:
        raise RuntimeError(f"weighted_average_2d launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    launches += 1
    return out
