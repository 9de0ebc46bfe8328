"""Probes of the decode kernels on the card: the counterparts of the TPU
scratch kernels that ranked what bounds the decode.

- ``strips``: B1 with its output staged through shared memory and stored
  as coalesced image strips (``csrc/decode_strips.cu``; TPU prototype
  ``scratch/kernel_strips.py``).
- ``ablate_decode``: B1 in timing variants that each change one thing of its
  body (``csrc/ablate_decode.cu``; TPU ``scratch/ablate_decode.py``).
- ``int16_rate``: the int16 against int32 integer rate
  (``csrc/int16_rate.cu``; TPU ``scratch/int16_rate.py``).

Each wrapper routes by the device of its tensors, as the ops do: CPU
tensors take the plain PyTorch version, CUDA tensors launch the kernel or
raise. Each module's ``main()`` times its kernel on the card:
``python3 -m metalhuffman_tpu_torch.probes.<name>``.
"""

from __future__ import annotations

import subprocess


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
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
