"""What the benchmark's process may not hold: JAX, its libraries and the JAX
package the port was made from. Names are compared whole at the top level
(the part before the first dot): ``visiondepth3d_tpu_torch`` is the port,
``visiondepth3d_tpu`` the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "visiondepth3d_tpu"})
PORT = "visiondepth3d_tpu_torch"


def top_level(module_name: str) -> str:
    return module_name.split(".", 1)[0]


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules (``sys.modules`` unless given) whose top-level name
    is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in FORBIDDEN)
