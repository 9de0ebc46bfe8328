"""What the port's example and script twins (``examples/*_torch.py``,
``scripts/*_torch.py``) share: the ``--device`` argument, the equality check
that ends a twin on a mismatch, and the card's name for a table header."""

from __future__ import annotations

import argparse

import numpy as np

from ..cli import _device


def parser(description: str) -> argparse.ArgumentParser:
    """An argument parser with ``--device`` (default ``cuda``; ``cuda:N``
    or ``cpu``, where the kernels' plain PyTorch versions run)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", type=_device, default="cuda",
                    help="decode device: cuda (default), cuda:N, or cpu")
    return ap


def same(label: str, got, want, decoded: dict) -> np.ndarray:
    """``got`` (a numpy array or a tensor) must equal ``want`` in shape,
    dtype and every element, else ValueError; records the pair as
    ``decoded[label]`` and returns ``got`` as numpy."""
    if hasattr(got, "cpu"):
        got = got.cpu().numpy()
    got, want = np.asarray(got), np.asarray(want)
    decoded[label] = (got, want)
    if got.shape != want.shape or got.dtype != want.dtype \
            or not np.array_equal(got, want):
        raise ValueError(f"{label}: the decoded array differs from its "
                         f"source ({got.dtype}{got.shape} against "
                         f"{want.dtype}{want.shape})")
    return got


def card(device) -> str:
    """``"<name>, <power limit>"`` of a CUDA device, as ``nvidia-smi`` gives
    them, or ``"cpu"``."""
    import torch

    from ..probes import card as smi_card

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    return smi_card(torch.cuda.current_device() if dev.index is None
                    else dev.index)
