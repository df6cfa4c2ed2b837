# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Fault-tolerance policy for cross-process metric sync (a copy of
``torchmetrics_tpu/robustness/sync_config.py``; stdlib only).

On a production fleet preemption and host loss are routine (ROADMAP
north-star); a straggler rank must not hang ``Metric.sync()`` forever and a
transient transport hiccup must not abort an evaluation epoch. :class:`SyncConfig`
makes the policy explicit and threads through ``Metric.sync()`` /
``Metric.compute()``'s implicit sync.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

_ON_ERROR_CHOICES = ("raise", "local")


@dataclass(frozen=True)
class SyncConfig:
    """Policy for one cross-process state synchronization.

    Args:
        timeout_s: wall-clock budget for a single sync attempt. ``None``
            (default) calls the collectives directly; a number runs them on a
            daemon worker thread and raises
            :class:`~torchmetrics_tpu_torch.utilities.exceptions.SyncError` when the
            budget elapses (last-resort straggler protection — an abandoned
            attempt's collective cannot be cancelled, so after a timeout the
            process group should be considered poisoned and re-initialized
            before the next sync).
        retries: additional attempts after the first failure. Every rank must
            use the same value — a retry re-enters the collective on all
            ranks, so divergent configs desynchronize the group.
        backoff_base_s: sleep before the first retry.
        backoff_factor: multiplier applied per further retry.
        backoff_max_s: cap on a single backoff sleep.
        on_error: ``"raise"`` (default) surfaces a ``SyncError`` once attempts
            are exhausted; ``"local"`` degrades to the metric's local-only
            state with a single :class:`SyncWarning` — best-effort eval
            logging keeps flowing with per-host values instead of dying.
    """

    timeout_s: Optional[float] = None
    retries: int = 0
    backoff_base_s: float = 0.5
    backoff_factor: float = 2.0
    backoff_max_s: float = 8.0
    on_error: str = "raise"

    def __post_init__(self) -> None:
        if self.on_error not in _ON_ERROR_CHOICES:
            raise ValueError(f"`on_error` must be one of {_ON_ERROR_CHOICES}, got {self.on_error!r}")
        if self.retries < 0:
            raise ValueError(f"`retries` must be >= 0, got {self.retries}")
        if self.timeout_s is not None and self.timeout_s <= 0:
            raise ValueError(f"`timeout_s` must be positive or None, got {self.timeout_s}")
        if self.backoff_base_s < 0 or self.backoff_factor < 1 or self.backoff_max_s < 0:
            raise ValueError(
                "backoff parameters must satisfy backoff_base_s >= 0, backoff_factor >= 1, backoff_max_s >= 0"
            )

    @property
    def attempts(self) -> int:
        return self.retries + 1

    def backoff(self, attempt: int) -> float:
        """Sleep before retrying after failed attempt ``attempt`` (0-based)."""
        return min(self.backoff_max_s, self.backoff_base_s * self.backoff_factor**attempt)


#: module default used when neither the metric nor the call provides a config
DEFAULT_SYNC_CONFIG = SyncConfig()
