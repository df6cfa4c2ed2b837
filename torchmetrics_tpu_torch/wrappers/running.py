# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Running-window wrapper (counterpart of ``torchmetrics_tpu/wrappers/running.py``).

``Running(base, window)`` keeps ``window`` copies of every state of the
wrapped metric, keyed ``{state}_{i}``, on the base metric's device. Each
update runs the base metric's update on a reset state and stores the result
in the next slot; ``compute`` folds the slots back into the base metric
with its declared reductions and computes there.

The slot pointer is a host counter (``_host_counters``), so the fused plan
refuses a ``Running`` member with the JAX package's reason. Under
``sharded_update`` one event fills one window slot with the mesh-reduced
state (``_fold_sharded_state``), as in the JAX package. At serving scale
:class:`~torchmetrics_tpu_torch.parallel.windowing.WindowRing` supersedes
it: a tumbling ring with ``every_n=1`` equals ``Running(window=N)`` on the
overlap.
"""
from __future__ import annotations

from typing import Any, Dict

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


class Running(WrapperMetric):
    """Compute a metric over a running window of the last ``window`` updates."""

    _host_counters = ("_num_vals_seen",)
    # update() folds the base state into a window slot and resets the base: the
    # base is scratch, so the sharded fold leaves it pristine
    _sharded_fold_children = False

    def __init__(self, base_metric: Metric, window: int = 5) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of `Metric` but got {base_metric}")
        super().__init__(device=base_metric.device)
        if not (isinstance(window, int) and window > 0):
            raise ValueError(f"Expected argument `window` to be a positive integer but got {window}")
        self.base_metric = base_metric
        self.window = window
        if base_metric.full_state_update is not False:
            raise ValueError(
                f"Expected attribute `full_state_update` set to `False` but got {base_metric.full_state_update}"
            )
        self._num_vals_seen = 0
        for key in base_metric._defaults:
            for i in range(window):
                self.add_state(
                    name=key + f"_{i}", default=base_metric._defaults[key], dist_reduce_fx=base_metric._reductions[key]
                )

    def _store(self) -> None:
        """The base metric's state into the current slot; reset the base."""
        val = self._num_vals_seen % self.window
        for key in self.base_metric._defaults:
            setattr(self, key + f"_{val}", getattr(self.base_metric, key))
        self.base_metric.reset()
        self._num_vals_seen += 1

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update the base metric and store its state in the current window slot."""
        self._refuse_local_update()
        self.base_metric.update(*args, **kwargs)
        self._store()

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """The base metric's batch value; its state goes into the current slot."""
        self._refuse_local_update()
        res = self.base_metric.forward(*args, **kwargs)
        self._store()
        self._computed = None
        return res

    def compute(self) -> Any:
        """Merge the window slots into the base metric and compute."""
        for i in range(self.window):
            self.base_metric._update_count += 1
            self.base_metric._reduce_states({key: getattr(self, key + f"_{i}") for key in self.base_metric._defaults})
        self.base_metric._update_count = self._num_vals_seen
        # slots a sharded fold filled hold every rank's batches already: no sync
        self.base_metric._mesh_replicated = self._mesh_replicated
        val = self.base_metric.compute()
        self.base_metric.reset()
        return val

    def reset(self) -> None:
        super().reset()
        self.base_metric.reset()
        self._num_vals_seen = 0

    def _refuse_sharded_fold(self, prev_count: int) -> None:
        # the window's own count: a wrapper's update leaves _update_count alone
        super()._refuse_sharded_fold(self._num_vals_seen)

    def _fold_sharded_state(self, part: Dict[str, Any], prev_count: int) -> None:
        """One sharded update event fills one window slot: the mesh-reduced
        slot-0 state (the scratch update starts from ``_num_vals_seen == 0``)
        goes into the slot this event takes; the other slots stay."""
        self._refuse_sharded_fold(prev_count)
        slot = self._num_vals_seen % self.window
        for key in self.base_metric._defaults:
            setattr(self, f"{key}_{slot}", part[f"{key}_0"])
        self._num_vals_seen += 1
        self._mesh_replicated = True
