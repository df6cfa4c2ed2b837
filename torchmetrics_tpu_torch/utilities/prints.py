# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Rank-zero printing/warning discipline (counterpart of ``torchmetrics_tpu/utilities/prints.py``).

The rank is ``torch.distributed``'s when a process group is initialised,
else 0.
"""
from __future__ import annotations

import logging
import warnings
from functools import partial, wraps
from typing import Any, Callable

import torch


def _process_index() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    """Call ``fn`` only on rank 0 of a multi-process run."""

    @wraps(fn)
    def wrapped_fn(*args: Any, **kwargs: Any) -> Any:
        if _process_index() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped_fn


@rank_zero_only
def rank_zero_warn(message: str, *args: Any, **kwargs: Any) -> None:
    kwargs.setdefault("stacklevel", 5)
    warnings.warn(message, *args, **kwargs)


rank_zero_deprecation = partial(rank_zero_warn, category=DeprecationWarning)


@rank_zero_only
def rank_zero_print(*args: Any, **kwargs: Any) -> None:
    print(*args, **kwargs)


_log = logging.getLogger("torchmetrics_tpu")


@rank_zero_only
def rank_zero_debug(*args: Any, **kwargs: Any) -> None:
    """Log at debug level on rank 0 only."""
    _log.debug(*args, **kwargs)


@rank_zero_only
def rank_zero_info(*args: Any, **kwargs: Any) -> None:
    """Log at info level on rank 0 only."""
    _log.info(*args, **kwargs)
