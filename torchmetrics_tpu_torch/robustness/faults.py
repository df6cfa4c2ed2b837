# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Deterministic fault injection for the sync and restore paths (counterpart
of ``torchmetrics_tpu/robustness/faults.py``: the same points, kinds and
``TM_TPU_FAULTS`` grammar).

Fleets lose hosts, corrupt payloads on the wire, and preempt workers
mid-epoch; code that only ever runs on the happy path is untested exactly
where it matters most. This module plants **zero-cost-when-off** injection
points inside ``Metric.sync()`` / ``utilities/distributed.py`` /
``Metric.update`` / ``DeviceFeed`` so tests (single-process and the real
2-process ``torch.distributed`` suite) can rehearse those failures
deterministically. A fault's ``rank`` is ``torch.distributed.get_rank()``.

In this package ``sync.attempt``, ``sync.state_gather``, ``sync.state_apply``,
``gather_arrays.pre``, ``gather_bytes.pre``, ``gather_bytes.payload``,
``update.preempt`` and ``feed.stage`` fire. The other points of the table
(sketch sync, the durable store and runner, the serve plane) are registered
so that one ``TM_TPU_FAULTS`` schedule serves both packages; they fire once
those modules are ported.

Injection points
----------------

=========================  =====================  ==================================
point                      kinds                  fires
=========================  =====================  ==================================
``sync.attempt``           fail, delay            at the start of every ``Metric.sync`` attempt
``sync.state_gather``      fail, delay            before each state's gather inside ``_sync_dist``
                                                  (use ``after=`` to leave earlier states
                                                  overwritten — a genuine mid-sync failure)
``gather_bytes.pre``       fail, delay            before the object-gather collective
``gather_bytes.payload``   corrupt, truncate      on the wire buffer of ``_gather_objects_via_bytes``
``sync.sketch_state``      corrupt                on the per-rank gathered sketch states of a
                                                  ``dist_reduce_fx="merge"`` sync (``arg`` = which
                                                  rank's payload to mangle; fires in lockstep on
                                                  every process so the group agrees on the error)
``update.preempt``         preempt                after a completed ``Metric.update`` (raises
                                                  :class:`SimulatedPreemption` — checkpoint/restore drills)
``runner.preempt``         preempt                in ``StreamingEvaluator`` after batch k is applied,
                                                  BEFORE its snapshot (``after=k`` kills at batch k+1 —
                                                  kill-and-resume drills)
``store.write.torn``       fail, preempt          in ``CheckpointStore.save`` between the temp write
                                                  and the rename: the temp file survives, the manifest
                                                  never references it (a torn write)
``store.payload``          corrupt, truncate      on the snapshot bytes as written to disk; the
                                                  manifest keeps the TRUE crc, so ``latest()`` detects
                                                  the bitrot and falls back
``feed.stage``             fail, delay            on the ``DeviceFeed`` staging thread, per batch
                                                  staged — the captured error must propagate to the
                                                  consumer's next ``get()``, never stall the drive
                                                  loop until the watchdog
``serve.accept``           fail, delay            in ``ServeDaemon.create_stream`` before the spec
                                                  is admitted — a rejected create must leave no
                                                  stream directory behind
``serve.ingest``           fail, delay            in ``Stream.offer`` after decode, before the
                                                  batch is admitted to the queue — a failed
                                                  admission must NOT advance ``next_seq`` (the
                                                  client retries the same seq)
``serve.drain``            fail, delay, preempt   at the top of ``Stream.drain`` — a daemon killed
                                                  mid-drain must restart from the last snapshot
                                                  with no double count
``serve.worker.crash``     fail, delay, preempt   in the stream worker immediately before a batch
                                                  is applied — the supervisor must restart the
                                                  worker and replay the retained batch;
                                                  ``count >= poison_threshold`` turns the same
                                                  batch into a dead-letter quarantine drill
``store.write.enospc``     fail                   in ``CheckpointStore.save`` just before the
                                                  atomic write — surfaces as ``OSError(ENOSPC)``,
                                                  the disk-exhaustion degradation drill
``deadletter.write``       fail                   before a stream's ``deadletter.jsonl`` rewrite —
                                                  surfaces as ``OSError(ENOSPC)``; quarantine must
                                                  stay in memory and re-persist when disk recovers
=========================  =====================  ==================================

Every point above is registered in :data:`KNOWN_POINTS`;
:func:`install_from_env` rejects a ``TM_TPU_FAULTS`` entry naming anything
else, so a typo'd chaos schedule fails loudly instead of silently never
firing. In-process :func:`inject` accepts arbitrary points (tests plant
private ones).

Faults are scoped with the :func:`inject` context manager (in-process tests)
or installed from the ``TM_TPU_FAULTS`` environment variable (subprocess
workers), e.g.::

    TM_TPU_FAULTS="corrupt:gather_bytes.payload:rank=1;fail:sync.attempt:count=2"

Grammar: ``;``-separated faults, each ``kind:point[:key=value]*`` with keys
``rank`` (only that rank; default all), ``after`` (skip
the first N matching hits), ``count`` (fire at most N times; default
unbounded), ``arg`` (seconds for ``delay``, bytes for ``corrupt``/``truncate``).
All injection is deterministic — no randomness — so 2-process scenarios stay
in lockstep and failures reproduce bit-for-bit.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

_KINDS = ("fail", "delay", "corrupt", "truncate", "preempt")

#: every injection point wired into the codebase (the docstring table above).
#: ``install_from_env`` validates against this set; ``inject``/``install``
#: deliberately do not, so tests can plant private points.
KNOWN_POINTS = frozenset(
    {
        "sync.attempt",
        "sync.state_gather",
        "sync.state_apply",
        "sync.sketch_state",
        "gather_arrays.pre",
        "gather_bytes.pre",
        "gather_bytes.payload",
        "update.preempt",
        "runner.preempt",
        "store.write.torn",
        "store.write.enospc",
        "store.payload",
        "feed.stage",
        "serve.accept",
        "serve.ingest",
        "serve.drain",
        "serve.worker.crash",
        "deadletter.write",
    }
)


class FaultInjected(RuntimeError):
    """Raised by a ``fail`` fault — stands in for a transient transport error."""


class SimulatedPreemption(RuntimeError):
    """Raised by a ``preempt`` fault — stands in for host preemption between updates."""


@dataclass
class Fault:
    """One deterministic fault at one injection point."""

    kind: str
    point: str
    rank: Optional[int] = None  # None = every process
    after: int = 0  # skip the first `after` matching hits
    count: Optional[int] = None  # fire at most `count` times (None = unbounded)
    arg: float = 1.0  # delay seconds / corrupt-truncate byte count
    _hits: int = field(default=0, repr=False, compare=False)

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {_KINDS}")
        if self.after < 0 or (self.count is not None and self.count < 0):
            raise ValueError("`after` and `count` must be non-negative")

    def _should_fire(self, point: str, rank: int) -> bool:
        """Match + hit accounting: a matching call counts as a hit whether or
        not it fires, so ``after``/``count`` windows are deterministic."""
        if point != self.point or (self.rank is not None and rank != self.rank):
            return False
        hit = self._hits
        self._hits = hit + 1
        if hit < self.after:
            return False
        return self.count is None or hit < self.after + self.count


#: the live fault list. Hot paths guard with ``if faults._ACTIVE:`` — one
#: attribute load + truth test when no faults are installed.
_ACTIVE: List[Fault] = []


def active() -> bool:
    """True when any fault is installed."""
    return bool(_ACTIVE)


def _rank() -> int:
    """This process's rank in the default ``torch.distributed`` group, else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def install(*faults: Fault) -> None:
    """Install faults for the rest of the process (tests prefer :func:`inject`)."""
    _ACTIVE.extend(faults)


def clear() -> None:
    """Remove every installed fault and reset hit counters."""
    for f in _ACTIVE:
        f._hits = 0
    del _ACTIVE[:]


@contextmanager
def inject(*faults: Fault) -> Iterator[None]:
    """Scope faults to a ``with`` block; counters reset on exit."""
    _ACTIVE.extend(faults)
    try:
        yield
    finally:
        for f in faults:
            f._hits = 0
            # remove by IDENTITY: dataclass equality would match (and evict)
            # a distinct but equal fault installed by e.g. TM_TPU_FAULTS
            for i, installed in enumerate(_ACTIVE):
                if installed is f:
                    del _ACTIVE[i]
                    break


def fire(point: str) -> None:
    """Trigger ``fail``/``delay``/``preempt`` faults registered at ``point``."""
    if not _ACTIVE:
        return
    rank = _rank()
    for f in _ACTIVE:
        if f.kind in ("fail", "delay", "preempt") and f._should_fire(point, rank):
            if f.kind == "delay":
                time.sleep(f.arg)
            elif f.kind == "preempt":
                raise SimulatedPreemption(f"injected preemption at {point!r} (rank {rank})")
            else:
                raise FaultInjected(f"injected failure at {point!r} (rank {rank})")


def mutate_bytes(point: str, data: bytes, header_len: int = 0) -> bytes:
    """Apply ``corrupt``/``truncate`` faults registered at ``point`` to a wire
    buffer, leaving the first ``header_len`` bytes intact (corruption strikes
    the payload, so integrity headers can detect it)."""
    if not _ACTIVE:
        return data
    rank = _rank()
    for f in _ACTIVE:
        if f.kind in ("corrupt", "truncate") and f._should_fire(point, rank):
            n = max(1, int(f.arg))
            if f.kind == "truncate":
                keep = max(header_len, len(data) - n)
                data = data[:keep]
            elif len(data) > header_len:
                lo = header_len + (len(data) - header_len) // 2
                window = data[lo : lo + n]
                data = data[:lo] + bytes(b ^ 0xFF for b in window) + data[lo + len(window) :]
    return data


def corrupt_index(point: str, n: int) -> Optional[int]:
    """Index (< ``n``) whose payload a ``corrupt`` fault at ``point`` asks the
    caller to mangle, or ``None``. ``arg`` selects the payload (rank) index;
    rank-unscoped faults fire identically on every process, keeping a
    multi-process group in lockstep about WHICH payload went bad."""
    if not _ACTIVE:
        return None
    rank = _rank()
    for f in _ACTIVE:
        if f.kind == "corrupt" and f._should_fire(point, rank):
            return int(f.arg) % max(n, 1)
    return None


def install_from_env(value: Optional[str] = None) -> List[Fault]:
    """Parse ``TM_TPU_FAULTS`` (or ``value``) and install the faults it names.

    Entries naming a point outside :data:`KNOWN_POINTS` raise ``ValueError``
    listing the valid points: a fault that can never fire is a chaos test
    silently testing nothing.
    """
    spec = os.environ.get("TM_TPU_FAULTS", "") if value is None else value
    faults: List[Fault] = []
    for item in filter(None, (part.strip() for part in spec.split(";"))):
        fields = item.split(":")
        if len(fields) < 2:
            raise ValueError(f"malformed TM_TPU_FAULTS entry {item!r}: expected 'kind:point[:key=value]*'")
        kind, point, kwargs = fields[0], fields[1], {}
        if point not in KNOWN_POINTS:
            raise ValueError(
                f"unknown TM_TPU_FAULTS point {point!r} in {item!r} — it would never fire;"
                f" known points: {', '.join(sorted(KNOWN_POINTS))}"
            )
        for opt in fields[2:]:
            key, _, val = opt.partition("=")
            if key not in ("rank", "after", "count", "arg"):
                raise ValueError(f"unknown TM_TPU_FAULTS option {key!r} in {item!r}")
            kwargs[key] = float(val) if key == "arg" else int(val)
        faults.append(Fault(kind=kind, point=point, **kwargs))
    install(*faults)
    return faults


if os.environ.get("TM_TPU_FAULTS"):
    install_from_env()
