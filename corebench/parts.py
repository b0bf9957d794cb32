"""The benchmark's parts, found by name: ``corebench/<part>/<name>.py``
under a checkout's root, for ``part`` one of ``metrics``, ``generators``,
``kinds`` and ``references``. A later configuration, traffic kind,
reference or metric is a new file there and an entry that names it."""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(part: str, name: str, root: Path = ROOT):
    """The module ``corebench/<part>/<name>.py`` under ``root``."""
    path = Path(root) / HERE.name / part / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {part[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"corebench_{part}_{name.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    # registered before it runs, as an import would (a dataclass looks its
    # module up while it is built)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod
