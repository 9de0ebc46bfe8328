"""Probes of the decode kernels on the card: the counterparts of the TPU
scratch kernels that ranked what bounds the decode. S1 and the b1 family
of S2 run B1's lookup-table body as it is now; S2's first five variants
keep the interval body B1 ran before its redesign.

- ``strips``: B1 with each CUDA block's code span staged into shared
  memory and its output stored as pixel-row runs, both by bulk copies
  (``csrc/decode_strips.cu``; TPU prototype ``scratch/kernel_strips.py``).
- ``ablate_decode``: B1 in timing variants that each change one thing of a
  body (``csrc/ablate_decode.cu``; TPU ``scratch/ablate_decode.py``).
- ``int16_rate``: the int16 against int32 integer rate
  (``csrc/int16_rate.cu``; TPU ``scratch/int16_rate.py``).

Each wrapper routes by the device of its tensors, as the ops do: CPU
tensors take the plain PyTorch version, CUDA tensors launch the kernel or
raise. Each module's ``main()`` times its kernel on the card:
``python3 -m metalhuffman_tpu_torch.probes.<name>``.
"""

from __future__ import annotations

import re
import subprocess
from collections import Counter
from pathlib import Path


def card(index: int = 0) -> str:
    """Card ``index``'s name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip()


def require_cuda():
    """The first CUDA device; exits with a message when there is none (a
    probe's numbers come from the card only)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("this probe times a CUDA kernel: no CUDA device")
    return torch.device("cuda", 0)


def measure_interleaved(fns: dict, n_inputs: int, rounds: int = 7,
                        per: int = 6) -> dict:
    """Device ms per call of each ``fns[name](i)`` (i: input index), timed in
    ``rounds`` rounds that take the functions in turn, each round ``per``
    calls back to back over the inputs between two CUDA events. Returns
    name -> the sorted per-round means (the median is the middle one)."""
    import torch

    for fn in fns.values():  # warm up every input
        for i in range(n_inputs):
            fn(i)
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(per):
                fn(i % n_inputs)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / per)
    return {name: sorted(t) for name, t in times.items()}


def median(xs) -> float:
    return sorted(xs)[len(xs) // 2]


def sass_opcodes(kernel: str) -> dict[str, Counter]:
    """Mangled function name -> the count of each SASS opcode in its code,
    for every function of kernel ``kernel``'s built library, from
    ``cuobjdump -sass`` (next to nvcc)."""
    from .. import _build

    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: cuobjdump lies beside it")
    dump = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(_build.build()[kernel])], capture_output=True,
                          text=True, check=True).stdout
    counts: dict[str, Counter] = {}
    name = None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
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
