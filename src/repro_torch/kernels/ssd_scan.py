"""Mamba-2 SSD chunked scan: the wrapper of the CUDA kernel
``csrc/ssd_scan.cu`` (replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan``).

The wrapper takes CUDA tensors only; ``kernels/ops.py`` dispatches CPU
tensors to the plain version in ``kernels/ref.py``.  ``launches`` counts
the calls of this process that launched the kernel; ``tc_launches`` those
that took the tensor-core pair (the chunk pass, then the scan).  The
source's ``tc_body`` picks the body, and ``ssd_scan_workspace_floats``
reports it: a workspace for the tensor-core pair, none for the SIMT body.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = 0
tc_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_STATE = 256       # state size N (MAX_N in the source)

_fns = None


def _lib_fns():
    global _fns
    if _fns is None:
        lib = _build.load("ssd_scan")
        fn = lib.ssd_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ws = lib.ssd_scan_workspace_floats
        ws.argtypes = [ctypes.c_int] * 6
        ws.restype = ctypes.c_longlong
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _fns = (fn, ws, lib.ssd_scan_error_string)
    return _fns


@functools.lru_cache(maxsize=64)
def _workspace_floats(bsz, s, h, p, n, code):
    """The chunk pass's record floats for the tensor-core pair; 0 for the
    SIMT body."""
    return _lib_fns()[1](bsz, s, h, p, n, code)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_: torch.Tensor, c_: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, P) float32 or bfloat16; dt (B, S, H) float32; a (H,)
    float32; b_, c_ (B, S, N) in x's dtype; all contiguous on one CUDA
    device -> y (B, S, H, P) in x's dtype.  Any S >= 1."""
    global launches, tc_launches
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = b_.shape[-1]
    if dt.shape != (bsz, s, h) or a.shape != (h,):
        raise ValueError(f"dt {tuple(dt.shape)} / a {tuple(a.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if b_.shape != (bsz, s, n) or c_.shape != (bsz, s, n):
        raise ValueError(f"b_ {tuple(b_.shape)} / c_ {tuple(c_.shape)} must "
                         f"be ({bsz}, {s}, N)")
    if not 1 <= n <= _MAX_STATE or min(bsz, s, h, p) < 1:
        raise ValueError(f"want non-empty shapes and 1 <= N <= {_MAX_STATE}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {x.dtype} not in {list(_DTYPE_CODES)}")
    for name, t, want in (("x", x, x.dtype), ("dt", dt, torch.float32),
                          ("a", a, torch.float32), ("b_", b_, x.dtype),
                          ("c_", c_, x.dtype)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device")
        if t.dtype != want:
            raise ValueError(f"{name} is {t.dtype}, want {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    y = torch.empty_like(x)
    fn, _, err_str = _lib_fns()
    code = _DTYPE_CODES[x.dtype]
    n_ws = _workspace_floats(bsz, s, h, p, n, code)
    ws = (torch.empty(n_ws, dtype=torch.float32, device=x.device)
          if n_ws else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_.data_ptr(),
                 c_.data_ptr(), y.data_ptr(),
                 ws.data_ptr() if n_ws else None,
                 bsz, s, h, p, n, code, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: {err_str(err).decode()} "
                           f"(cudaError {err})")
    launches += 1
    if n_ws:
        tc_launches += 1
    return y
