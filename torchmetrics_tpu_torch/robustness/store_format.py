# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""On-disk checkpoint-store format primitives — STDLIB ONLY.

This module defines the durable layout a :class:`~torchmetrics_tpu_torch.
robustness.store.CheckpointStore` directory follows and every operation that
needs no metric semantics: atomic byte writes, CRC32 integrity, manifest
read/write, verification and retention pruning. It is a copy of
``torchmetrics_tpu/robustness/store_format.py`` (the port imports nothing of
the JAX package), with the same layout, names and ``STORE_FORMAT_VERSION``:
a store written by either package reads in the other, and
``tools/metricdoctor.py`` verifies/lists/prunes it without importing torch
or jax. It deliberately imports nothing beyond the standard library.

Directory layout::

    <store>/
      manifest.json                  # see MANIFEST schema below
      snapshot-000000000004.ckpt     # pickled payload, CRC32 recorded in manifest
      snapshot-000000000006.ckpt
      snapshot-000000000008.ckpt.tmp-a1b2c3   # torn write: crash before os.replace

Manifest schema (version 1)::

    {"store_format_version": 1,
     "fingerprint": "<16-hex registry fingerprint or null>",
     "snapshots": [{"step": 4, "file": "snapshot-000000000004.ckpt",
                    "crc32": 123456789, "bytes": 4096}, ...]}   # ascending step

Every write is atomic: bytes land in a ``.tmp-*`` sibling, are fsync'd, and
``os.replace`` publishes them — a reader never observes a half-written
snapshot or manifest, only a missing one (torn write: the temp file survives,
the manifest never references it). Snapshot steps are strictly monotonic so
the newest valid snapshot is always the resume point.
"""
from __future__ import annotations

import json
import os
import tempfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

MANIFEST_NAME = "manifest.json"
SNAPSHOT_PREFIX = "snapshot-"
SNAPSHOT_SUFFIX = ".ckpt"
STORE_FORMAT_VERSION = 1

_MANIFEST_KEYS = ("store_format_version", "fingerprint", "snapshots")
_ENTRY_KEYS = ("step", "file", "crc32", "bytes")


class StoreFormatError(ValueError):
    """The on-disk store violates the format contract (bad manifest, wrong
    version, non-monotonic steps). File-level damage to an individual
    snapshot is NOT this error — it is reported per-snapshot by
    :func:`verify_store` / skipped by ``CheckpointStore.latest()``."""


def snapshot_filename(step: int) -> str:
    """Canonical file name for the snapshot at ``step`` (zero-padded so
    lexicographic order equals step order)."""
    return f"{SNAPSHOT_PREFIX}{int(step):012d}{SNAPSHOT_SUFFIX}"


def payload_crc(data: bytes) -> int:
    """CRC32 of a snapshot payload as recorded in the manifest."""
    return zlib.crc32(data) & 0xFFFFFFFF


def _fsync_dir(directory: str) -> None:
    # directory fsync publishes the rename itself; best-effort on platforms
    # (or filesystems) that refuse O_RDONLY directory descriptors
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically: temp sibling + fsync +
    ``os.replace`` + directory fsync. A crash at any point leaves either the
    old file or the new one — never a torn ``path``."""
    directory = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".tmp-", dir=directory)
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(directory)


def empty_manifest(fingerprint: Optional[str] = None) -> Dict[str, Any]:
    return {"store_format_version": STORE_FORMAT_VERSION, "fingerprint": fingerprint, "snapshots": []}


def read_manifest(directory: str) -> Optional[Dict[str, Any]]:
    """Parse and structurally validate ``manifest.json``.

    Returns ``None`` when no manifest exists (fresh/empty store); raises
    :class:`StoreFormatError` on a malformed or wrong-version manifest —
    the store as a whole is unusable then, there is nothing to fall back to.
    """
    path = os.path.join(directory, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "r") as fh:
            manifest = json.load(fh)
    except (OSError, ValueError) as err:
        raise StoreFormatError(f"unreadable checkpoint-store manifest {path}: {err}") from err
    if not isinstance(manifest, dict) or any(k not in manifest for k in _MANIFEST_KEYS):
        raise StoreFormatError(f"malformed checkpoint-store manifest {path}: expected keys {_MANIFEST_KEYS}")
    version = manifest["store_format_version"]
    if not isinstance(version, int) or version < 1 or version > STORE_FORMAT_VERSION:
        raise StoreFormatError(
            f"checkpoint-store format version {version!r} is not supported"
            f" (this build reads <= {STORE_FORMAT_VERSION})"
        )
    entries = manifest["snapshots"]
    if not isinstance(entries, list) or any(
        not isinstance(e, dict) or any(k not in e for k in _ENTRY_KEYS) for e in entries
    ):
        raise StoreFormatError(f"malformed snapshot list in {path}: each entry needs keys {_ENTRY_KEYS}")
    steps = [int(e["step"]) for e in entries]
    if steps != sorted(set(steps)):
        raise StoreFormatError(f"snapshot steps in {path} are not strictly increasing: {steps}")
    return manifest


def write_manifest(directory: str, manifest: Dict[str, Any]) -> None:
    atomic_write(
        os.path.join(directory, MANIFEST_NAME),
        json.dumps(manifest, indent=1, sort_keys=True).encode(),
    )


def read_snapshot_bytes(directory: str, entry: Dict[str, Any]) -> bytes:
    """Read one manifest entry's payload, enforcing the recorded CRC32.

    Raises ``FileNotFoundError`` for a deleted snapshot and
    :class:`StoreFormatError` for a size or CRC mismatch (bitrot, torn
    content) — callers decide whether to fall back or surface.
    """
    path = os.path.join(directory, entry["file"])
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) != int(entry["bytes"]):
        raise StoreFormatError(
            f"snapshot {entry['file']} (step {entry['step']}) is {len(data)} bytes,"
            f" manifest records {entry['bytes']} — torn or truncated payload"
        )
    crc = payload_crc(data)
    if crc != int(entry["crc32"]):
        raise StoreFormatError(
            f"snapshot {entry['file']} (step {entry['step']}) fails its CRC32 check"
            f" (got {crc}, manifest records {entry['crc32']}) — corrupt payload"
        )
    return data


def temp_files(directory: str) -> List[str]:
    """Orphaned ``.tmp-*`` files: the residue of torn writes (crash between
    temp publish and rename). Never referenced by the manifest; safe to prune."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(n for n in names if ".tmp-" in n)


def verify_store(directory: str) -> Dict[str, Any]:
    """Full integrity report for one store directory.

    Returns ``{"ok": bool, "manifest_ok": bool, "problems": [str, ...],
    "snapshots": [{"step", "file", "bytes", "valid", "problem"}, ...],
    "torn_temp_files": [...], "fingerprint": ...}``. ``ok`` means the
    manifest parses AND every listed snapshot passes its size+CRC check;
    torn temp files are reported but are not failures (they are expected
    debris after a crash-during-save).
    """
    report: Dict[str, Any] = {
        "ok": True,
        "manifest_ok": True,
        "fingerprint": None,
        "problems": [],
        "snapshots": [],
        "torn_temp_files": temp_files(directory),
    }
    if not os.path.isdir(directory):
        report["ok"] = report["manifest_ok"] = False
        report["problems"].append(f"not a directory: {directory}")
        return report
    try:
        manifest = read_manifest(directory)
    except StoreFormatError as err:
        report["ok"] = report["manifest_ok"] = False
        report["problems"].append(str(err))
        return report
    if manifest is None:
        report["problems"].append("no manifest.json — empty or never-written store")
        return report
    report["fingerprint"] = manifest["fingerprint"]
    for entry in manifest["snapshots"]:
        row = {"step": int(entry["step"]), "file": entry["file"], "bytes": int(entry["bytes"]),
               "valid": True, "problem": None}
        try:
            read_snapshot_bytes(directory, entry)
        except FileNotFoundError:
            row["valid"] = False
            row["problem"] = "missing file (manifest points at a deleted snapshot)"
        except (OSError, StoreFormatError) as err:
            row["valid"] = False
            row["problem"] = str(err)
        if not row["valid"]:
            report["ok"] = False
            report["problems"].append(f"step {row['step']}: {row['problem']}")
        report["snapshots"].append(row)
    return report


def prune_entries(
    directory: str, manifest: Dict[str, Any], keep_last: Optional[int], drop_temp: bool = True
) -> Tuple[Dict[str, Any], List[str]]:
    """Apply ``keep_last`` retention: drop the oldest manifest entries beyond
    the newest ``keep_last`` and delete their files (manifest first, so a
    crash mid-prune leaves unreferenced files, never dangling references).

    Returns ``(new_manifest, removed_file_names)``. ``keep_last=None`` keeps
    everything (still drops torn temp files when ``drop_temp``).
    """
    removed: List[str] = []
    entries = list(manifest["snapshots"])
    if keep_last is not None and keep_last >= 0 and len(entries) > keep_last:
        victims = entries[: len(entries) - keep_last]
        manifest = dict(manifest, snapshots=entries[len(entries) - keep_last:])
        write_manifest(directory, manifest)
        for entry in victims:
            try:
                os.unlink(os.path.join(directory, entry["file"]))
            except OSError:
                pass  # already gone — the manifest no longer references it
            removed.append(entry["file"])
    if drop_temp:
        for name in temp_files(directory):
            try:
                os.unlink(os.path.join(directory, name))
            except OSError:
                pass
            removed.append(name)
    return manifest, removed
