"""Architecture registry: --arch <id> -> config module.

The reference's registry, every arch in its order: the LMs
(``models/transformer.py``), the GNNs, ``deepfm`` and ``coremaint``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

_ARCHS: Dict[str, str] = {
    "deepseek-v2-236b": "deepseek_v2_236b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "yi-34b": "yi_34b",
    "qwen3-8b": "qwen3_8b",
    "qwen2-7b": "qwen2_7b",
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
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")
