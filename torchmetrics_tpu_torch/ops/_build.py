# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, at first use, from the
sources in the package; the headers they share (``csrc/*.cuh``) are found
through ``-I csrc``. Libraries go to ``_build/`` beside the sources, named
by a hash of the source and the shared headers so an edited kernel is
rebuilt, and are written under a temporary name and renamed so two
processes building at once never load a half-written file. Nothing here runs at import: importing the port
needs neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = _CSRC / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[str, Any] = {}


def kernel_sources() -> List[str]:
    """Names of every kernel source in ``csrc/`` (without ``.cu``)."""
    return sorted(p.stem for p in _CSRC.glob("*.cu"))


def _nvcc() -> str:
    for candidate in (shutil.which("nvcc"), os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels of the port are built on the machine with the card")


def _lib_path(name: str) -> Tuple[Path, Path]:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256()
    for part in (src, *sorted(_CSRC.glob("*.cuh"))):
        digest.update(part.name.encode() + b"\0" + part.read_bytes())
    digest = digest.hexdigest()[:12]
    return src, _BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str) -> Tuple[Path, Path, "subprocess.Popen[bytes]"]:
    src, lib = _lib_path(name)
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *_NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp), str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT
    )
    return tmp, lib, proc


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` each, all at once.

    Returns ``nvcc``'s output for each kernel it built (``ptxas`` reports
    each kernel's registers and shared memory there).
    """
    pending = [(name, *_start_build(name)) for name in names if not _lib_path(name)[1].exists()]
    failures, logs = [], {}
    for name, tmp, lib, proc in pending:
        out, _ = proc.communicate()
        logs[name] = out.decode(errors="replace")
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
            continue
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("building the CUDA kernels failed:\n" + "\n".join(failures))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The shared library of kernel ``name``, built first if need be."""
    with _lock:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(str(_lib_path(name)[1]))
        return _loaded[name]


def function(name: str, argtypes: list, library: Optional[str] = None) -> Any:
    """The C entry point ``name`` of library ``library`` (``name`` by
    default), its ``argtypes`` and ``restype`` declared (ctypes would
    otherwise cut pointers to 32 bits). Looked up once and kept: every
    launch goes through here."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(load(library or name), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(status: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError`` after the launch)."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: cudaError {status}")
