"""Architecture registry: --arch <id> -> config module.

The reference's registry, holding only the archs whose model the port
has: the GNNs (``pna``, ``gin-tu``, ``dimenet``, ``nequip``), ``deepfm``
and ``coremaint``, in the reference's order. The LM configs import a
model that is not ported yet; asking for one raises the reference's
``KeyError`` with that note.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

# the reference's full registry, in its order
_REFERENCE_ARCHS = (
    "deepseek-v2-236b", "deepseek-v2-lite-16b", "yi-34b", "qwen3-8b",
    "qwen2-7b", "pna", "gin-tu", "dimenet", "nequip", "deepfm", "coremaint",
)
_ARCHS: Dict[str, str] = {
    "pna": "pna",
    "gin-tu": "gin_tu",
    "dimenet": "dimenet",
    "nequip": "nequip",
    "deepfm": "deepfm",
    "coremaint": "coremaint",
}


def arch_names(include_coremaint: bool = False) -> List[str]:
    names = [n for n in _ARCHS if n != "coremaint"]
    if include_coremaint:
        names.append("coremaint")
    return names


def get_arch(name: str):
    if name not in _ARCHS:
        note = " (not ported yet)" if name in _REFERENCE_ARCHS else ""
        raise KeyError(
            f"unknown arch {name!r}{note}; known: {sorted(_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")
