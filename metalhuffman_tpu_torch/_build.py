"""Build and load the port's CUDA kernel library (nvcc + ctypes).

The kernels under ``csrc/`` have a plain C interface. At first use ``nvcc``
compiles them for Hopper (``sm_90a``) into one shared library whose name
carries a hash of the sources and flags, under ``build/metalhuffman_tpu_torch/``
at the root of the checkout; later loads of the same sources reuse it. There
is no fallback: a missing ``nvcc`` or a failed build raises with nvcc's
output, so a CUDA tensor never silently takes another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
SOURCES = (CSRC / "decode_images.cu",)
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "metalhuffman_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB: ctypes.CDLL | None = None
#: nvcc's output of the last build in this process (ptxas register report)
build_log: str = ""


def find_nvcc() -> str | None:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    return shutil.which("nvcc")


def library_path() -> Path:
    """Content-hashed path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmht_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library if it is not built yet; return its path."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found ($CUDA_HOME/bin or PATH): the CUDA kernels of "
            "metalhuffman_tpu_torch build with nvcc for sm_90a at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    build_log = proc.stdout + proc.stderr
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        dll = ctypes.CDLL(str(build()))
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        dll.mht_decode_images.argtypes = [
            ptr, i64, ptr, i64, i64, i64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ptr, ctypes.c_int, ptr, ptr,
        ]
        dll.mht_decode_images.restype = ctypes.c_int
        _LIB = dll
    return _LIB
