"""Builds and loads the port's CUDA library.

Every ``csrc/*.cu`` of the package goes into one shared library, compiled
with ``nvcc`` for ``sm_90a`` on first use: one ``nvcc -c`` per source, all
started together, then one link. The library is named by the hash of all
the sources (their names and contents) and the flags, so an edited
source never loads a stale library. It lands in ``build/repro_torch/`` at
the checkout root (or ``$REPRO_TORCH_BUILD_DIR``) and is loaded with
``ctypes``; each kernel module registers its C entry points' argument
types once, at import, with ``register``, and launches them with
``launch``. A missing ``nvcc`` or a failed build raises
``RuntimeError``. ``ptxas -v`` reports every kernel's registers and
spills; the report is kept beside the library (``<library>.ptxas.txt``)
and read back with ``ptxas_usage``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, object] = {}
_argtypes: Dict[str, list] = {}


def sources() -> list:
    """The package's CUDA sources, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def library_name(srcs: Optional[Sequence[Path]] = None) -> str:
    """``libreprotorch_<hash>.so``: the hash covers every source's name
    and bytes and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources() if srcs is None else srcs:
        p = Path(p)
        h.update(b"\0" + p.name.encode() + b"\0" + p.read_bytes())
    return f"libreprotorch_{h.hexdigest()[:16]}.so"


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "repro_torch build from source on first use"
    )


def _run_all(cmds) -> list:
    """Run the commands in parallel; raise with the first failure's
    output. Returns each command's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{o}")
    return outs


def build() -> Path:
    """Compile every ``csrc/*.cu`` into the shared library (only when it
    is missing) and return its path."""
    srcs = sources()
    out_dir = build_dir()
    out = out_dir / library_name(srcs)
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{p.stem}.o" for p in srcs]
        outs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                         for p, o in zip(srcs, objs)])
        lib = Path(tmp) / out.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
                   *map(str, objs)]])
        report = Path(tmp) / "ptxas.txt"
        report.write_text("".join(outs))
        os.replace(report, _ptxas_report(out))
        os.replace(lib, out)  # atomic: a concurrent loader never sees half
    return out


def _ptxas_report(lib: Path) -> Path:
    return lib.with_name(lib.name + ".ptxas.txt")


def ptxas_usage(pattern: str) -> Dict[str, dict]:
    """``parse_ptxas`` of the built library's report."""
    return parse_ptxas(_ptxas_report(build()).read_text(), pattern)


def parse_ptxas(text: str, pattern: str) -> Dict[str, dict]:
    """``{kernel: {"registers", "spill_stores", "spill_loads"}}`` from a
    ``ptxas -v`` report, for the kernels whose mangled name contains
    ``pattern``."""
    usage, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if pattern in m.group(1) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage.setdefault(name, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage.setdefault(name, {})["registers"] = int(m.group(1))
    return usage


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def register(signatures: Dict[str, Sequence]) -> None:
    """Record the argument types of C entries (name -> types, the last
    one the stream); this builds and loads nothing."""
    _argtypes.update({k: list(v) for k, v in signatures.items()})


def launch(name: str, *args) -> None:
    """Call the library's C entry ``name`` (registered with ``register``)
    with ``args`` on PyTorch's current stream; raise when the
    ``cudaGetLastError()`` it returns is not 0."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = _argtypes[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def forward_only(what: str, *tensors) -> None:
    """The CUDA kernels have no backward, as the reference's Pallas
    kernels have no VJP: refuse a CUDA input that would need one."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel is forward-only, as the reference's "
            "Pallas kernel is; training runs the plain path "
            "(kernel_backend='torch', use_pallas_fm=False). Call it "
            "under torch.no_grad() or on tensors that do not require grad"
        )
