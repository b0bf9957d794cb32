"""The import guard: the benchmark drives the port alone, so no module of
JAX, of Flax or of the JAX package ``repro`` may be loaded. Module names
are compared by their top-level part, whole: ``repro_torch`` is the port
and passes, ``repro`` and ``repro.core`` do not."""
from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(modules) -> list:
    """The forbidden top-level names among the loaded module names."""
    return sorted({name.split(".")[0] for name in modules} & FORBIDDEN)
