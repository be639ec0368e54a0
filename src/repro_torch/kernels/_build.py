"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -I csrc [-Xptxas -v]
         -o build/repro_torch_kernels/lib<name>-<hash>.so

into ``build/`` at the root of the checkout (listed in ``.gitignore``), then
loaded with ``ctypes``.  The library name carries a hash of the source,
of every header in ``csrc/`` (``*.cuh``, which any source may include) and
of the flags with their include path, so an edited kernel or header is
rebuilt and a stale library is never loaded.  All missing libraries build
in parallel, one ``nvcc`` per source.  The attention and scan sources
build with ``-Xptxas -v``: ``BUILD_LOG`` keeps each of their kernels'
register and spill lines.  A failed build raises with the compiler's
output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("flash_attention", "paged_attention", "ssd_scan", "rg_lru",
           "fused_adam", "wavg", "compress")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC))
# sources whose resource use the build reports
VERBOSE_PTXAS = ("flash_attention", "paged_attention", "ssd_scan", "rg_lru")

_LIBS: Dict[str, ctypes.CDLL] = {}
# kernel -> ptxas lines of its last build in this process
BUILD_LOG: Dict[str, List[str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels are built on the machine with the card")


def _flags(name: str) -> List[str]:
    return [*NVCC_FLAGS, *(("-Xptxas", "-v") if name in VERBOSE_PTXAS else ())]


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _ptxas_lines(log: str) -> List[str]:
    """The lines of ``-Xptxas -v`` that name a kernel, its registers and
    its spills."""
    return [ln.strip() for ln in log.splitlines()
            if "spill" in ln or (ln.startswith("ptxas") and (
                "Compiling entry" in ln or "registers" in ln))]


def build(names: Sequence[str] = KERNELS) -> Dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, all at
    once, and return their paths.  Raises if any ``nvcc`` fails."""
    paths = {n: library_path(n) for n in names}
    todo = [n for n, p in paths.items() if not p.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n in todo:
            tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *_flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT,
                                              text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc {n}.cu exited {proc.returncode}:\n{log}")
            else:
                BUILD_LOG[n] = _ptxas_lines(log)
                os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build((name,))[name]))
    return _LIBS[name]
