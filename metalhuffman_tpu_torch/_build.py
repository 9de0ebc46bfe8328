"""Build and load the port's native libraries (nvcc or g++, then ctypes).

Each CUDA kernel under ``csrc/`` has a plain C interface and builds into a
shared library of its own: at first use ``nvcc`` compiles every kernel for
Hopper (``sm_90a``), one process per source, all started together. A
library's name carries a hash of its sources and flags, and it lives under
``build/metalhuffman_tpu_torch/`` at the root of the checkout, with the
compiler's output beside it (``.log``); later loads of the same sources reuse
both. The host C++ codec (``native``) builds the same
way with g++. There is no fallback: a missing compiler or a failed build
raises with the compiler's output, so a CUDA tensor never silently takes
another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
#: kernel name -> its source; the library exports ``mht_<name>``
KERNELS = {
    "decode_images": CSRC / "decode_images.cu",
    "decode_blocks": CSRC / "decode_blocks.cu",
    "encode_stream": CSRC / "encode_stream.cu",
    "encode_rows": CSRC / "encode_rows.cu",
    "decode_strips": CSRC / "decode_strips.cu",
    "ablate_decode": CSRC / "ablate_decode.cu",
    "int16_rate": CSRC / "int16_rate.cu",
    "temporal_fold": CSRC / "temporal_fold.cu",
    "frame_crc": CSRC / "frame_crc.cu",
}
#: the headers each kernel source includes, part of its library's hash
HEADERS = {
    "decode_images": (CSRC / "decode_common.cuh",),
    "decode_blocks": (CSRC / "decode_common.cuh",),
    "encode_stream": (),
    "encode_rows": (),
    "decode_strips": (CSRC / "decode_common.cuh",),
    "ablate_decode": (CSRC / "decode_common.cuh",),
    "int16_rate": (),
    "temporal_fold": (),
    "frame_crc": (),
}
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "metalhuffman_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_i64, _ptr, _int = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
_TABLE = (ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32))
_LUT = (_ptr, _i64, _int)  # table, entries, t2_smem
_ARGTYPES = {
    # words, n_words, offsets, n_blocks, bh, bw, table, table_entries,
    # t2_smem, mode, out, end (NULL: no end bits), stream
    "decode_images": [_ptr, _i64, _ptr, _i64, _i64, _i64, *_LUT, _int, _ptr,
                      _ptr, _ptr],
    # words, n_words, offsets, n_blocks, num_steps, table, table_entries,
    # t2_smem, mode, out, end (NULL: no end bits), stream
    "decode_blocks": [_ptr, _i64, _ptr, _i64, _int, *_LUT, _int, _ptr, _ptr,
                      _ptr],
    # symbols, n, table, bits, incl, stream words, offsets, pass (0 count,
    # 1 pack), stream
    "encode_stream": [_ptr, _i64, _ptr, _ptr, _ptr, _ptr, _ptr, _int, _ptr],
    # symbols, n_blocks, table, wmax, rows, stream
    "encode_rows": [_ptr, _i64, _ptr, _int, _ptr, _ptr],
    # words, n_words, offsets, n_blocks, bw, table, table_entries, t2_smem,
    # prefetch, out, stream
    "decode_strips": [_ptr, _i64, _ptr, _i64, _i64, *_LUT, _int, _ptr, _ptr],
    # words, n_words, offsets, n_blocks, bh, bw, bounds, adj, symbols,
    # variant, n_terms, term_bounds, term_incs, term_base, t1, t2, n_t2,
    # table, table_entries, t2_smem, out, stream
    "ablate_decode": [_ptr, _i64, _ptr, _i64, _i64, _i64, *_TABLE, _ptr, _int,
                      _int, *_TABLE, ctypes.c_int32, _ptr, _ptr, _int, *_LUT,
                      _ptr, _ptr],
    # x, n, variant, step, thresh, out, stream
    "int16_rate": [_ptr, _i64, _int, ctypes.c_int32, ctypes.c_int32, _ptr,
                   _ptr],
    # frames, h, row_bytes, elem_bytes, vec, rows, shared, table, stream
    "temporal_fold": [_ptr, _i64, _i64, _int, _int, _int, _int, _ptr, _ptr],
    # frames, frame bytes, frames, vec, params, out, stream
    "frame_crc": [_ptr, _i64, _i64, _int, _ptr, _ptr, _ptr],
}
#: the decode kernels' ``mht_<name>_shape`` (launch shape without a launch):
#: [n_words,] n_blocks, [num_steps,] table_entries, t2_smem, mode,
#: int shape[6]; the probes': n_blocks, table_entries, t2_smem, prefetch,
#: shape (S1),
#: n_blocks, variant, n_terms, n_t2, table_entries, t2_smem, shape (S2)
SHAPE_ARGTYPES = {
    "decode_images": [_i64, _i64, _int, _int, _ptr],
    "decode_blocks": [_i64, _i64, _int, _i64, _int, _int, _ptr],
    "decode_strips": [_i64, _i64, _int, _int, _ptr],
    "ablate_decode": [_i64, _int, _int, _int, _i64, _int, _ptr],
}

_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str | None:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    return shutil.which("nvcc")


def hashed_path(stem: str, flags, sources) -> Path:
    """Content-hashed library path for ``sources`` built with ``flags``."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def compile_all(jobs) -> None:
    """Run every ``(command, out)`` job at once and wait for all of them.

    Each command gets ``-o <temporary>``; a job that succeeds is renamed to
    ``out`` (atomic, so concurrent builds never load a partial file), after
    its compiler output is kept beside it as ``out`` with suffix ``.log``.
    Raises RuntimeError with the command and stderr of every job that
    failed.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for cmd, out in jobs:
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        proc = subprocess.Popen([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((cmd, out, tmp, proc))
    errors = []
    for cmd, out, tmp, proc in running:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{Path(cmd[0]).name} failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{stderr}")
        else:
            tmp_log = tmp.with_suffix(".log")
            tmp_log.write_text(stdout + stderr)
            os.replace(tmp_log, out.with_suffix(".log"))
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def library_path(name: str) -> Path:
    """Content-hashed path of kernel ``name``'s library."""
    return hashed_path(f"libmht_{name}", NVCC_FLAGS,
                       (KERNELS[name], *HEADERS[name]))


def build() -> dict[str, Path]:
    """Compile every kernel library not built yet (or built without its
    log); return name -> path."""
    paths = {name: library_path(name) for name in KERNELS}
    todo = [name for name, path in paths.items()
            if not (path.exists() and path.with_suffix(".log").exists())]
    if todo:
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "nvcc not found ($CUDA_HOME/bin or PATH): the CUDA kernels of "
                "metalhuffman_tpu_torch build with nvcc for sm_90a at first use")
        compile_all([([nvcc, *NVCC_FLAGS, str(KERNELS[name])], paths[name])
                     for name in todo])
    return paths


def build_log(name: str) -> str:
    """nvcc's output when kernel ``name``'s library was built (ptxas's
    register, shared-memory and spill report), kept beside the library."""
    return build()[name].with_suffix(".log").read_text()


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (all kernels build at first use)."""
    if name not in _LIBS:
        dll = ctypes.CDLL(str(build()[name]))
        fn = getattr(dll, f"mht_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        if name in SHAPE_ARGTYPES:
            shape = getattr(dll, f"mht_{name}_shape")
            shape.argtypes = SHAPE_ARGTYPES[name]
            shape.restype = ctypes.c_int
        _LIBS[name] = dll
    return _LIBS[name]


def launch(name: str, device, *args) -> None:
    """Call kernel ``name``'s C entry ``mht_<name>(*args, stream)`` on the
    current stream of CUDA ``device``; raise if it reports a CUDA error."""
    import torch

    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(name, device, *args)
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib(name), f"mht_{name}")(*args, stream)
    if err:
        raise RuntimeError(f"mht_{name} launch failed: CUDA error {err}")
