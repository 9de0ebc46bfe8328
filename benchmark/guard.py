"""The import guard: no run may load JAX or the JAX package.

Each module name is cut to its top-level part (before the first dot) and
compared whole, so ``metalhuffman_tpu_torch`` passes where
``metalhuffman_tpu`` fails.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "metalhuffman_tpu")


def forbidden(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: the
    modules loaded in this process)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names.intersection(FORBIDDEN))
