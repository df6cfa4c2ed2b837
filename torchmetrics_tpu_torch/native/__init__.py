# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Native (C++) host extensions of the port.

- ``rle_codec.cpp``: the COCO RLE mask codec (encode, decode, area, the
  crowd-aware IoU matrix, polygon rasterization), a copy of the JAX
  package's source kept in this package.
- ``edit_distance.cpp``: the batched Levenshtein DP behind WER, CER, MER,
  WIL, WIP and ``EditDistance`` (two rows a pair, OpenMP over the pairs),
  a copy of the JAX package's source kept in this package.

A source is compiled with the system ``g++`` at first use into ``_build/``
beside it, with the flags every source takes and its own (``_SOURCE_FLAGS``),
named by a hash of the source and those flags, written under a temporary
name and renamed so two processes building at once never load a half-written
file, then bound with ``ctypes``. There is no fallback: if the build fails
the call raises with the compiler's output. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Tuple

_HERE = Path(__file__).resolve().parent
_BUILD_DIR = _HERE / "_build"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
#: the flags a source takes beyond ``_CXX_FLAGS``
_SOURCE_FLAGS: Dict[str, Tuple[str, ...]] = {"edit_distance": ("-fopenmp",)}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _flags(stem: str) -> Tuple[str, ...]:
    return (*_CXX_FLAGS, *_SOURCE_FLAGS.get(stem, ()))


def _library_path(stem: str) -> Path:
    digest = hashlib.sha256((_HERE / f"{stem}.cpp").read_bytes() + " ".join(_flags(stem)).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"lib{stem}-{digest}.so"


def _build_library(stem: str) -> Path:
    """Compile ``<stem>.cpp`` unless its library is built already; raise with g++'s output if it fails."""
    lib = _library_path(stem)
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_flags(stem), str(_HERE / f"{stem}.cpp"), "-o", str(tmp)]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as err:
        raise RuntimeError(f"building the native extension {stem!r} failed: {' '.join(cmd)}: {err}") from err
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native extension {stem!r} failed: {' '.join(cmd)} exited {done.returncode}\n{done.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def _bind_rle(lib: ctypes.CDLL) -> None:
    lib.rle_encode.restype = ctypes.c_uint64
    lib.rle_encode.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p]
    lib.rle_decode.restype = None
    lib.rle_decode.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64]
    lib.rle_area.restype = ctypes.c_uint64
    lib.rle_area.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rle_iou_pair.restype = ctypes.c_double
    lib.rle_iou_pair.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]
    lib.rle_iou_matrix.restype = None
    lib.rle_iou_matrix.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_uint64] + [ctypes.c_void_p] * 3 + [ctypes.c_uint64] + [ctypes.c_void_p] * 2
    )
    lib.rle_from_polygon.restype = ctypes.c_uint64
    lib.rle_from_polygon.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p]


def _get_library(stem: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    with _lock:
        if stem not in _libs:
            lib = ctypes.CDLL(str(_build_library(stem)))
            bind(lib)
            _libs[stem] = lib
        return _libs[stem]


def _bind_edit(lib: ctypes.CDLL) -> None:
    lib.batch_edit_distance.restype = None
    lib.batch_edit_distance.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]


def get_rle_library() -> ctypes.CDLL:
    """The compiled RLE codec, built first if need be (raises if it cannot be built)."""
    return _get_library("rle_codec", _bind_rle)


def get_edit_library() -> ctypes.CDLL:
    """The compiled batched edit distance, built first if need be (raises if it cannot be built)."""
    return _get_library("edit_distance", _bind_edit)


__all__ = ["get_edit_library", "get_rle_library"]
