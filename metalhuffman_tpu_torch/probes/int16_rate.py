"""S3: the int16 against int32 integer rate probe, and its plain version.

Counterpart of the TPU probe ``scratch/int16_rate.py`` (``run``, body
``make_kernel``): :data:`CHAIN` dependent pairs ``v += 1; acc += (v > 7)``
per element, then ``out = v + acc``, with the wraparound of the element
type. :func:`int16_rate` (``csrc/int16_rate.cu``) runs it as one of
:data:`VARIANTS`: ``i32`` (int32 elements), ``i16`` (int16 elements, one
per thread register) and ``i16x2`` (int16 elements, two per 32-bit register
through the SIMD intrinsics). Whether ``i16x2`` beats ``i32`` per element
decides whether packing two symbols' state per register can pay.

Run on the card (from the root of a checkout)::

    python3 -m metalhuffman_tpu_torch.probes.int16_rate

times the three variants on 2^22 elements and prints each one's ms and
T ops/s, the per-element speedups over ``i32``, and what ptxas made of
each kernel's loop (the SASS opcodes, from ``cuobjdump -sass``).
"""

from __future__ import annotations

import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from .. import _build
from . import card, measure_interleaved, median, require_cuda

CHAIN = 512  # dependent op pairs per element
STEP, THRESH = 1, 7
OPS_PER_STEP = 3  # add, compare, accumulate
VARIANTS = ("i32", "i16", "i16x2")
#: the card-filling size of the timings
ELEMENTS = 1 << 22

#: kernel launches made by the wrapper in this process
launches = {"int16_rate": 0}


def dtype_of(variant: str) -> torch.dtype:
    """The element type of ``variant``."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    return torch.int32 if variant == "i32" else torch.int16


def make_input(n: int, variant: str, device="cuda", seed: int = 0):
    """(n,) elements of ``variant``'s type, ``integers(0, 100)`` as the TPU
    probe drew them."""
    x = np.random.default_rng(seed).integers(0, 100, n)
    return torch.from_numpy(x).to(dtype_of(variant)).to(device)


def int16_rate_plain(x: torch.Tensor, variant: str) -> torch.Tensor:
    """Plain PyTorch version: the chain as a loop of torch ops, in the
    element type (wraparound included)."""
    dtype = dtype_of(variant)
    if x.dtype != dtype:
        raise ValueError(f"{variant} takes {dtype} elements, got {x.dtype}")
    v = x.clone()
    acc = torch.zeros_like(x)
    for _ in range(CHAIN):
        v += STEP
        acc += (v > THRESH).to(dtype)
    return v + acc


def int16_rate(x: torch.Tensor, variant: str) -> torch.Tensor:
    """The chain over the 1-D elements ``x`` as ``variant`` -> a tensor like
    ``x``. CPU tensors run :func:`int16_rate_plain`; CUDA tensors launch the
    kernel."""
    dtype = dtype_of(variant)
    if x.dtype != dtype or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{variant} takes a contiguous 1-D {dtype} tensor")
    if variant == "i16x2" and x.numel() % 2:
        raise ValueError("i16x2 packs elements in pairs: n must be even")
    if x.device.type == "cpu":
        return int16_rate_plain(x, variant)
    if x.device.type != "cuda":
        raise ValueError(f"no rate probe for tensors on {x.device}")
    out = torch.empty_like(x)
    if x.numel():
        _build.launch("int16_rate", x.device, x.data_ptr(), x.numel(),
                      VARIANTS.index(variant), STEP, THRESH, out.data_ptr())
        launches["int16_rate"] += 1
    return out


def ops(n: int, variant: str) -> int:
    """32-bit register operations of the chain over n elements: i16x2
    does each on two elements at once."""
    regs = n // 2 if variant == "i16x2" else n
    return regs * CHAIN * OPS_PER_STEP


def sass_opcodes() -> dict[str, Counter]:
    """Kernel name -> the count of each SASS opcode in its code, from
    ``cuobjdump -sass`` of the built library (next to nvcc)."""
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: cuobjdump lies beside it")
    lib = _build.build()["int16_rate"]
    dump = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts: dict[str, Counter] = {}
    name = None
    for line in dump.splitlines():
        m = re.search(r"Function : \S*?(rate_i(?:32|16x2|16))", line)
        if m:
            name = m.group(1)
            counts[name] = Counter()
            continue
        m = re.match(
            r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)",
            line)
        if name and m:
            counts[name][m.group(1)] += 1
    return counts


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        print("usage: python3 -m metalhuffman_tpu_torch.probes.int16_rate",
              file=sys.stderr)
        return 2
    device = require_cuda()
    xs = {v: make_input(ELEMENTS, v, device) for v in VARIANTS}
    for v, x in xs.items():
        if not torch.equal(int16_rate(x, v), int16_rate_plain(x, v)):
            print(f"  !! {v} differs from its plain version")
            return 1
    fns = {v: (lambda i, v=v: int16_rate(xs[v], v)) for v in VARIANTS}
    times = {v: median(ms) for v, ms in measure_interleaved(fns, 1).items()}
    name = card()
    for v, ms in times.items():
        print(f"{v:6s} {ELEMENTS} elements: {ms:8.4f} ms  "
              f"{ops(ELEMENTS, v) / ms / 1e9:6.2f} T ops/s, on {name}")
    print(f"i16x2 vs i32 per-element speedup: {times['i32'] / times['i16x2']:.2f}x")
    print(f"i16 vs i32 per-element speedup: {times['i32'] / times['i16']:.2f}x")
    for kernel, counts in sass_opcodes().items():
        print(f"SASS {kernel}: " + ", ".join(
            f"{op} {n}" for op, n in counts.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
