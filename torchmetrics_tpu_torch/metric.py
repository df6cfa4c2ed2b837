# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The ``Metric`` base runtime (counterpart of ``torchmetrics_tpu/metric.py``).

States are tensors (or lists of tensors for ``cat`` states) registered with
:meth:`Metric.add_state` and a reduction, on the metric's ``device``. As in
the JAX package, an update *replaces* a state tensor and never writes into
it, so a snapshot that keeps references is a true snapshot: the
transactional update, the ``forward`` detours and the collection's compute
groups all rely on that.

Every metric runs on the device it is given, ``"cuda"`` by default. With no
CUDA device present, construction raises unless ``device="cpu"`` was asked
for: the metric never moves to the CPU on its own.

In a multi-process job (an initialised ``torch.distributed`` group of more
than one rank) ``compute()`` syncs the states across the ranks first, as the
JAX package does: every state is gathered with
:func:`~torchmetrics_tpu_torch.utilities.distributed.gather_all_tensors` and
reduced with its ``dist_reduce_fx``, under the retries, rollback and
``on_error`` policy of a :class:`~torchmetrics_tpu_torch.robustness.SyncConfig`,
and the local states come back after the value is computed. ``sync``,
``unsync``, ``sync_context`` and ``dist_sync_on_step`` work as there.

Metrics compose with Python's operators (``0.5 * (f1 + acc)``) into a
:class:`CompositionalMetric`, and plot with ``metric.plot()`` (matplotlib,
where installed).

States checkpoint with :meth:`Metric.save_checkpoint` /
:meth:`Metric.load_checkpoint`, in the JAX package's format.

A state may also be a mergeable sketch (``dist_reduce_fx="merge"``, a
registered :mod:`~torchmetrics_tpu_torch.sketch` state: a NamedTuple of
tensors, replaced whole by every update like any tensor state): it syncs by
a leaf-by-leaf gather and a pairwise merge, and checkpoints as the JAX
package's ``{"__sketch__": class, "leaves": {...}}`` payload.

:meth:`Metric.sliced` fans a metric out over cohort cells
(:class:`~torchmetrics_tpu_torch.parallel.sliced.SlicedPlan`).

A metric with a :meth:`Metric.domain_contract` can be guarded
(:func:`~torchmetrics_tpu_torch.robustness.guard.enable_guard`): the guarded
update runs inside the transactional wrapper, so its counters roll back with
the states, and pickling and deep copies install it again.

Tracing (:mod:`~torchmetrics_tpu_torch.obs`): ``update``, ``compute``,
``forward``, ``sync`` and ``reset`` record the JAX package's spans and
counters when ``obs.trace.ENABLED`` is set, and cost attribution and device
telemetry meet the host at ``compute()``/``sync()``. With tracing and the
live plane off, each hook is one flag check.
"""
from __future__ import annotations

import functools
import inspect
import threading
import time
from contextlib import contextmanager
from copy import deepcopy
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch._reduction_names import VALID_REDUCTION_NAMES
from torchmetrics_tpu_torch.obs import attribution as _obs_attr
from torchmetrics_tpu_torch.obs import counters as _obs_counters
from torchmetrics_tpu_torch.obs import device as _obs_device
from torchmetrics_tpu_torch.obs import live as _obs_live
from torchmetrics_tpu_torch.obs import trace as _obs_trace
from torchmetrics_tpu_torch.robustness import faults
from torchmetrics_tpu_torch.robustness.sync_config import DEFAULT_SYNC_CONFIG, SyncConfig
from torchmetrics_tpu_torch.sketch.registry import is_sketch_state, map_leaves, merge_states, reduce_merge_states
from torchmetrics_tpu_torch.utilities.data import (
    _flatten,
    _squeeze_if_scalar,
    _to_tensor,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    resolve_device,
)
from torchmetrics_tpu_torch.utilities.distributed import distributed_available as _dist_available
from torchmetrics_tpu_torch.utilities.distributed import gather_all_tensors
from torchmetrics_tpu_torch.utilities.exceptions import SyncError, SyncWarning, TorchMetricsUserError
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

_REDUCTION_MAP: Dict[str, Callable] = {
    "sum": dim_zero_sum,
    "mean": dim_zero_mean,
    "cat": dim_zero_cat,
    "min": dim_zero_min,
    "max": dim_zero_max,
    # sketch states: a per-rank sequence reduces by pairwise merge
    "merge": reduce_merge_states,
}
assert set(_REDUCTION_MAP) == set(VALID_REDUCTION_NAMES)


def _as_state_tensor(value: Any, device: torch.device) -> torch.Tensor:
    """A state default as a tensor of its own on ``device``.

    Python ints become int32 and floats float32, the dtypes the JAX package
    gives them, so the registries of the two packages fingerprint alike.
    """
    if isinstance(value, bool):
        return torch.tensor(value, device=device)
    if isinstance(value, int):
        return torch.tensor(value, dtype=torch.int32, device=device)
    if isinstance(value, float):
        return torch.tensor(value, dtype=torch.float32, device=device)
    if isinstance(value, torch.Tensor):
        return value.detach().to(device, copy=True)
    if isinstance(value, np.ndarray):
        return torch.tensor(np.array(value, copy=True), device=device)
    raise ValueError("state variable must be a tensor or any empty list (where you can append tensors)")


class Metric:
    """Base class for all metrics of the port.

    Subclasses implement ``update(self, ...)`` and ``compute(self)`` on
    states declared with :meth:`add_state`; accumulation bookkeeping, the
    ``forward`` dual return, reset and state-tree (de)serialization are
    generic code driven by the state registry.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = False

    #: host-side (non-tensor) attributes the sharded regime snapshots and
    #: restores around its scratch update (``Running._num_vals_seen``)
    _host_counters: Tuple[str, ...] = ()

    #: an explanatory string on metrics whose ``update`` cannot run under
    #: ``parallel.sharded_update`` (per-update host randomness); the sharded
    #: regime raises it
    _sharded_update_unsupported: Optional[str] = None

    #: False on wrappers that consume their children's state at every update
    #: and reset them (``Running``): the sharded fold leaves those children alone
    _sharded_fold_children: bool = True

    plot_lower_bound: Optional[float] = None
    plot_upper_bound: Optional[float] = None
    plot_legend_name: Optional[str] = None

    def __init__(self, **kwargs: Any) -> None:
        self._device = resolve_device(kwargs.pop("device", "cuda"), type(self).__name__)
        # the JAX package's config kwargs, with its validation messages
        self.compute_on_cpu = kwargs.pop("compute_on_cpu", False)
        if not isinstance(self.compute_on_cpu, bool):
            raise ValueError(f"Expected keyword argument `compute_on_cpu` to be a `bool` but got {self.compute_on_cpu}")
        self.dist_sync_on_step = kwargs.pop("dist_sync_on_step", False)
        if not isinstance(self.dist_sync_on_step, bool):
            raise ValueError(f"Expected keyword argument `dist_sync_on_step` to be a `bool` but got {self.dist_sync_on_step}")
        self.process_group = kwargs.pop("process_group", None)
        self.dist_sync_fn = kwargs.pop("dist_sync_fn", None)
        if self.dist_sync_fn is not None and not callable(self.dist_sync_fn):
            raise ValueError(f"Expected keyword argument `dist_sync_fn` to be an callable function but got {self.dist_sync_fn}")
        self.distributed_available_fn = kwargs.pop("distributed_available_fn", None) or _dist_available
        self.sync_on_compute = kwargs.pop("sync_on_compute", True)
        if not isinstance(self.sync_on_compute, bool):
            raise ValueError(f"Expected keyword argument `sync_on_compute` to be a `bool` but got {self.sync_on_compute}")
        self.compute_with_cache = kwargs.pop("compute_with_cache", True)
        if not isinstance(self.compute_with_cache, bool):
            raise ValueError(f"Expected keyword argument `compute_with_cache` to be a `bool` but got {self.compute_with_cache}")
        self.sync_config = kwargs.pop("sync_config", None)
        if self.sync_config is not None and not isinstance(self.sync_config, SyncConfig):
            raise ValueError(f"Expected keyword argument `sync_config` to be a `SyncConfig` but got {self.sync_config}")
        if kwargs:
            kwargs_ = [f"`{a}`" for a in sorted(kwargs)]
            raise ValueError(f"Unexpected keyword arguments: {', '.join(kwargs_)}")

        self._dtype = torch.float32
        self._defaults: Dict[str, Union[torch.Tensor, List]] = {}
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Union[str, Callable, None]] = {}

        self._update_count = 0
        self._computed: Any = None
        self._to_sync = self.sync_on_compute
        self._should_unsync = True

        # pending device telemetry (obs/device.py): accumulated on the device
        # by the captured update paths, read into device.* gauges only at
        # compute()/sync() boundaries, never per batch
        self._device_telemetry: Optional[Any] = None

        # sync bookkeeping: the pre-sync local state while synced
        self._is_synced = False
        self._cache: Optional[Dict[str, Any]] = None
        # set by a sharded fold: the states already cover every rank of the
        # mesh, so sync() leaves them alone until reset()
        self._mesh_replicated = False
        self._rewrap()

    # ------------------------------------------------------------------ wrap
    def _rewrap(self) -> None:
        if getattr(self, "_guard_policy", None) is not None:
            # StateGuard-enabled metric (robustness/guard.py): the guarded
            # closure replaces the raw update INSIDE the transactional wrapper,
            # so pickle/__setstate__ round-trips install the guard again
            from torchmetrics_tpu_torch.robustness.guard import _guard_wrap_update

            self.update: Callable[..., None] = self._wrap_update(_guard_wrap_update(self))  # type: ignore[method-assign]
        else:
            self.update = self._wrap_update(self.__class__.update.__get__(self))  # type: ignore[method-assign]
        self.compute: Callable[..., Any] = self._wrap_compute(self.__class__.compute.__get__(self))  # type: ignore[method-assign]

    def domain_contract(self) -> Optional[Any]:
        """Input-domain contract for the StateGuard plane, or ``None``.

        Families whose ``update`` consumes float predictions override this to
        return a :class:`~torchmetrics_tpu_torch.robustness.guard.DomainContract`
        describing per-argument validity (finite, probs in [0, 1], labels <
        num_classes), run inside the update step by
        :func:`~torchmetrics_tpu_torch.robustness.guard.enable_guard`.
        """
        return None

    def __getstate__(self) -> Dict[str, Any]:
        """Drop the wrapped closures for pickling and deep copies."""
        return {k: v for k, v in self.__dict__.items() if k not in ("update", "compute")}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._rewrap()

    # ----------------------------------------------------------------- state
    def add_state(
        self,
        name: str,
        default: Union[torch.Tensor, np.ndarray, list, float, int],
        dist_reduce_fx: Optional[Union[str, Callable]] = None,
        persistent: bool = False,
    ) -> None:
        """Register a metric state.

        ``default`` is a tensor (a fixed-shape accumulator), an empty list
        (an append/``cat`` state) or, with ``dist_reduce_fx="merge"``, a
        registered mergeable sketch state (:mod:`torchmetrics_tpu_torch.sketch`).
        ``dist_reduce_fx`` is one of ``"sum"``, ``"mean"``, ``"cat"``,
        ``"min"``, ``"max"``, ``"merge"``, a callable, or ``None``.
        """
        if dist_reduce_fx == "merge":
            if not is_sketch_state(default):
                raise ValueError(
                    f"dist_reduce_fx='merge' requires the default of state {name!r} to be a registered"
                    " mergeable sketch state (see torchmetrics_tpu_torch.sketch.register_sketch_state),"
                    f" got {type(default).__name__}"
                )
        elif is_sketch_state(default):
            raise ValueError(
                f"state {name!r} holds a {type(default).__name__} sketch state — it must be registered"
                " with dist_reduce_fx='merge' (any other reduction would mangle the state)"
            )
        if dist_reduce_fx is not None and not (dist_reduce_fx in _REDUCTION_MAP or callable(dist_reduce_fx)):
            valid = ", ".join(repr(name_) for name_ in _REDUCTION_MAP)
            raise ValueError(f"`dist_reduce_fx` must be callable or one of [{valid}, None]")
        if is_sketch_state(default):
            default = map_leaves(lambda leaf: leaf.detach().to(self._device, copy=True), default)
        elif isinstance(default, list):
            if default:
                raise ValueError("state variable must be a tensor or any empty list (where you can append tensors)")
        else:
            default = _as_state_tensor(default, self._device)
        if name in ("update", "compute", "forward", "reset"):
            raise ValueError(f"The name `{name}` is reserved and cannot be used for a metric state")

        self._defaults[name] = [] if isinstance(default, list) else default
        self._persistent[name] = persistent
        self._reductions[name] = dist_reduce_fx
        setattr(self, name, [] if isinstance(default, list) else default)

    @property
    def metric_state(self) -> Dict[str, Union[torch.Tensor, List[torch.Tensor]]]:
        """Current values of all registered states."""
        return {attr: getattr(self, attr) for attr in self._defaults}

    def state_tree(self, include_count: bool = False) -> Dict[str, Any]:
        """The state registry as a dict (references, not copies).

        With ``include_count=True`` the tree also carries the update counter
        under the reserved key ``"_update_count"``.
        """
        tree: Dict[str, Any] = {attr: getattr(self, attr) for attr in self._defaults}
        if include_count:
            tree["_update_count"] = self._update_count
        return tree

    def state_spec(self) -> Dict[str, Any]:
        """Declared schema of every state plus the registry fingerprint, the
        same fingerprint the JAX package computes for its counterpart."""
        from torchmetrics_tpu_torch.robustness.spec import build_state_specs, spec_fingerprint

        return {
            "states": build_state_specs(self),
            "fingerprint": spec_fingerprint(self),
            "_update_count": self._update_count,
        }

    def load_state_tree(self, tree: Dict[str, Any], strict: bool = True) -> None:
        """Validate and install a tree of tensors or numpy arrays as the state.

        Every leaf is checked against the registry (key set, kind, dtype,
        shape) before any state is touched, and installed as a copy on the
        metric's device: the metric never shares memory with the caller's
        arrays. The reserved key ``"_update_count"`` restores the counter.
        """
        from torchmetrics_tpu_torch.robustness.spec import validate_state_tree

        tree = dict(tree)
        count = tree.pop("_update_count", None)
        validated = validate_state_tree(self, tree, strict=strict)
        for attr, value in validated.items():
            setattr(self, attr, value)
        if count is not None:
            self._update_count = int(count)
        self._computed = None

    def _install_state_tree(self, tree: Dict[str, Any]) -> None:
        """Install a tree WITHOUT validation — only for snapshots this metric
        took of itself (the forward detours, update rollback)."""
        for attr, value in tree.items():
            if attr == "_update_count":
                self._update_count = int(value)
            else:
                setattr(self, attr, value)

    def _copy_state_dict(self) -> Dict[str, Any]:
        """Snapshot the current state. Tensors are replaced, never written in
        place, so references suffice; list states get a shallow copy."""
        return {attr: list(v) if isinstance(v, list) else v for attr, v in self.state_tree().items()}

    @contextmanager
    def _scratch(self) -> Iterator[None]:
        """Run updates on this metric for their resulting state tree only: on
        exit the states, the update count, the cached value and the
        mesh-replicated flag are restored as they were. Inside, the flag is
        clear, so these updates are not refused as local ones."""
        saved = self._copy_state_dict()
        count, computed, replicated = self._update_count, self._computed, self._mesh_replicated
        telemetry = self._device_telemetry  # a reset() inside must not drop pending telemetry
        self._mesh_replicated = False
        try:
            yield
        finally:
            self._install_state_tree(saved)  # self-snapshot: trusted
            self._update_count, self._computed, self._mesh_replicated = count, computed, replicated
            self._device_telemetry = telemetry

    def _fold_sharded_state(self, part: Dict[str, Any], prev_count: int) -> None:
        """Fold one merged sharded-update event (``parallel.sharded_update``)
        into the live state.

        ``part`` is the state one ``update`` over the whole (all ranks')
        batch would have produced. The first event loads it; later ones
        merge it with the declared reductions, ``"mean"`` states weighted by
        the running update count. The states then cover every rank of the
        mesh, so ``compute()`` does not sync them again (until ``reset()``).
        Raises :class:`TorchMetricsUserError`, before touching the state, when
        plain updates of this rank alone are already in it and sync would run.
        """
        self._refuse_sharded_fold(prev_count)
        if prev_count == 0:
            self.load_state_tree(part)
        else:
            from torchmetrics_tpu_torch.parallel.sharded import tree_merge

            self.load_state_tree(tree_merge(self._reductions, self.state_tree(), part, weight_a=prev_count, weight_b=1))
        self._mesh_replicated = True

    def _refuse_sharded_fold(self, prev_count: int) -> None:
        """Refuse a sharded fold into a state that already holds ``prev_count``
        plain updates of this rank alone, where sync would run (a metric with
        no states of its own, a ``ClasswiseWrapper``, has nothing to refuse)."""
        if self._defaults and prev_count > 0 and not self._mesh_replicated and self._sync_would_run():
            raise TorchMetricsUserError(
                f"{type(self).__name__}: a sharded update cannot fold into a state that holds this rank's own"
                " plain updates: those would never be synced. Call reset() first to clear the state."
            )

    def _sync_would_run(self) -> bool:
        """Whether ``compute()`` would sync: a process group of more than one rank is up."""
        return bool(self.distributed_available_fn())

    def _refuse_local_update(self) -> None:
        """Refuse a plain (rank-local) update into a state a sharded fold made
        the same on every rank, where sync would otherwise run: ``sync()``
        skips such a state, so the ranks would report different values."""
        if self._mesh_replicated and self._sync_would_run():
            raise TorchMetricsUserError(
                f"{type(self).__name__}: a plain update() or forward() after a sharded update (or a mesh plan's"
                " fold_back) would fold this rank's batch alone into a state every rank shares, and compute()"
                " would not sync it. Call reset() first to clear the state."
            )

    # ---------------------------------------------------------------- update
    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any) -> None:
            self._refuse_local_update()
            self._computed = None
            # transactional: an exception mid-update rolls the count AND the
            # states back together. Tensors are replaced, never mutated, so a
            # reference is a snapshot; list states are append-only, so a
            # (list, length) pair rolls them back by truncation.
            prior_state = {attr: (v, len(v)) if isinstance(v, list) else v for attr, v in self.state_tree().items()}
            self._update_count += 1
            try:
                # disabled-tracing path: one module-level flag check; the span
                # (and its tag dict) is only allocated inside the branch
                if _obs_trace.ENABLED:
                    with _obs_trace.span("metric.update", metric=type(self).__name__, n=self._update_count):
                        update(*args, **kwargs)
                else:
                    update(*args, **kwargs)
            except Exception:
                self._update_count -= 1
                for attr, prior in prior_state.items():
                    if isinstance(self._defaults[attr], list):  # a (list, length) pair; a sketch state is a tuple too
                        lst, length = prior
                        del lst[length:]
                        setattr(self, attr, lst)
                    else:
                        setattr(self, attr, prior)
                raise
            if self.compute_on_cpu:
                self._move_list_states_to_cpu()
            if faults._ACTIVE:  # simulated preemption between completed updates (checkpoint drills)
                faults.fire("update.preempt")

        return wrapped_func

    def _move_list_states_to_cpu(self) -> None:
        """Move list states to host memory (``compute_on_cpu=True``, the user's request)."""
        for key in self._defaults:
            current = getattr(self, key)
            if isinstance(current, list):
                setattr(self, key, [c.cpu() for c in current])

    def update(self, *_: Any, **__: Any) -> None:  # pragma: no cover - abstract
        """Override in subclass: fold a batch into the metric state."""
        raise NotImplementedError

    # ---------------------------------------------------------------- compute
    def _wrap_compute(self, compute: Callable) -> Callable:
        @functools.wraps(compute)
        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
            if self._device_telemetry is not None:
                # compute() is THE host boundary: pending device telemetry
                # becomes device.* gauges here (also on a cache-served
                # compute: the gauges must not go stale)
                _obs_device.drain_metric(self)
            if (_obs_trace.ENABLED or _obs_live.ENABLED) and self._should_unsync:
                # the same boundary for cost attribution: the state-bytes
                # gauge and the ledger row. TOP-LEVEL computes only: forward's
                # per-batch detours (_should_unsync=False) run this wrapper on
                # a temporarily reset single-batch state
                _obs_attr.metric_boundary(self)
            if self._update_count == 0:
                rank_zero_warn(
                    f"The ``compute`` method of metric {self.__class__.__name__} was called before the ``update`` method"
                    " which may lead to errors, as metric states have not yet been updated.",
                    UserWarning,
                )
            if self._computed is not None:
                value = self._computed
            elif _obs_trace.ENABLED:
                with _obs_trace.span("metric.compute", metric=type(self).__name__, n=self._update_count), self.sync_context(
                    dist_sync_fn=self.dist_sync_fn,
                    should_sync=self._to_sync,
                    should_unsync=self._should_unsync,
                ):
                    value = _squeeze_if_scalar(compute(*args, **kwargs))
            else:
                with self.sync_context(
                    dist_sync_fn=self.dist_sync_fn,
                    should_sync=self._to_sync,
                    should_unsync=self._should_unsync,
                ):
                    value = _squeeze_if_scalar(compute(*args, **kwargs))
            if self.compute_with_cache:
                self._computed = value
            if _obs_trace.ENABLED and self._should_unsync:
                # costs.json only from a TOP-LEVEL compute, and only now: the
                # metric.compute/metric.sync spans just closed, so the ledger
                # includes this compute's own cost (collection members are
                # deferred and emitted once by the collection)
                _obs_attr.maybe_emit()
            return value

        return wrapped_func

    def compute(self) -> Any:  # pragma: no cover - abstract
        """Override in subclass: finalize the metric value from the state."""
        raise NotImplementedError

    # ---------------------------------------------------------------- forward
    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate globally AND return the batch-local value (synced across
        the ranks with ``dist_sync_on_step=True``)."""
        if self._is_synced:
            raise TorchMetricsUserError("The Metric shouldn't be synced when performing ``forward``")
        self._refuse_local_update()
        full = self.full_state_update or self.full_state_update is None or self.dist_sync_on_step
        if _obs_trace.ENABLED:
            with _obs_trace.span("metric.forward", metric=type(self).__name__, full_state=bool(full)):
                if full:
                    return self._forward_full_state_update(*args, **kwargs)
                return self._forward_reduce_state_update(*args, **kwargs)
        if full:
            return self._forward_full_state_update(*args, **kwargs)
        return self._forward_reduce_state_update(*args, **kwargs)

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Double-update path: update the global state, then compute the batch
        value on a fresh state and restore the global one."""
        self.update(*args, **kwargs)
        _update_count = self._update_count
        _device_telemetry = self._device_telemetry  # reset() inside the detour must not drop it
        self._to_sync = self.dist_sync_on_step
        _temp_compute_with_cache = self.compute_with_cache
        self.compute_with_cache = False
        self._should_unsync = False

        cache = self._copy_state_dict()
        self.reset()
        self.update(*args, **kwargs)
        batch_val = self.compute()

        self._install_state_tree(cache)
        self._update_count = _update_count
        self._device_telemetry = _device_telemetry
        self._should_unsync = True
        self._to_sync = self.sync_on_compute
        self.compute_with_cache = _temp_compute_with_cache
        self._computed = None
        self._is_synced = False
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Single-update path: compute the batch value on a fresh state, then
        merge the previous global state in."""
        global_state = self._copy_state_dict()
        _update_count = self._update_count
        _device_telemetry = self._device_telemetry  # reset() below must not drop pending telemetry
        self.reset()

        self._to_sync = self.dist_sync_on_step
        _temp_compute_with_cache = self.compute_with_cache
        self.compute_with_cache = False
        self._should_unsync = False

        self.update(*args, **kwargs)
        self._update_count = _update_count + 1
        batch_val = self.compute()

        self._reduce_states(global_state)

        self._device_telemetry = _device_telemetry
        self._should_unsync = True
        self._to_sync = self.sync_on_compute
        self.compute_with_cache = _temp_compute_with_cache
        self._computed = None
        self._is_synced = False
        return batch_val

    def _reduce_states(self, incoming_state: Dict[str, Any]) -> None:
        """Merge an incoming (older global) state into the current (batch)
        state, per each state's declared reduction."""
        for attr in self._defaults:
            local_state = getattr(self, attr)
            global_state = incoming_state[attr]
            reduce_fn = self._reductions[attr]
            if reduce_fn == "sum":
                reduced = global_state + local_state
            elif reduce_fn == "mean":
                reduced = ((self._update_count - 1) * global_state + local_state) / self._update_count
            elif reduce_fn == "max":
                reduced = torch.maximum(global_state, local_state)
            elif reduce_fn == "min":
                reduced = torch.minimum(global_state, local_state)
            elif reduce_fn == "merge":
                reduced = merge_states(global_state, local_state)
            elif reduce_fn == "cat":
                if isinstance(global_state, list):
                    reduced = global_state + local_state
                else:
                    reduced = torch.cat([torch.atleast_1d(global_state), torch.atleast_1d(local_state)])
            elif reduce_fn is None and isinstance(global_state, list):
                reduced = _flatten([global_state, local_state])
            elif reduce_fn is None:
                reduced = torch.stack([global_state, local_state])
            elif callable(reduce_fn):
                reduced = reduce_fn(torch.stack([global_state, local_state]))
            else:
                raise TypeError(f"Unsupported reduce_fn: {reduce_fn}")
            setattr(self, attr, reduced)

    # ------------------------------------------------------------------ sync
    def _sync_dist(self, dist_sync_fn: Callable = gather_all_tensors, process_group: Optional[Any] = None) -> None:
        """Gather every state from all ranks and apply its reduction."""
        input_dict = {attr: getattr(self, attr) for attr in self._reductions}
        for attr, reduction_fn in self._reductions.items():
            if reduction_fn == "cat" and isinstance(input_dict[attr], list) and len(input_dict[attr]) > 1:
                input_dict[attr] = [dim_zero_cat(input_dict[attr])]
            if reduction_fn == "cat" and isinstance(input_dict[attr], list) and len(input_dict[attr]) == 0:
                # a rank with no data contributes an empty tensor
                input_dict[attr] = [torch.zeros((0,), dtype=torch.float32, device=self._device)]

        if _obs_trace.ENABLED or _obs_live.ENABLED:
            # the payload this rank contributes to the gather (nbytes is
            # tensor metadata: no device read happens here)
            _obs_attr.publish_sync_bytes(self, input_dict)
        output_dict: Dict[str, Any] = {}
        group = self.process_group if process_group is None else process_group
        for attr, value in input_dict.items():
            if faults._ACTIVE:  # mid-sync fault point: earlier states are already gathered
                faults.fire("sync.state_gather")
            if self._reductions[attr] == "merge":
                # a sketch state gathers leaf by leaf (each leaf a fixed-shape
                # tensor), then regroups into one state per rank
                gathered_leaves = [dist_sync_fn(leaf, group=group) for leaf in value]
                output_dict[attr] = [type(value)(*per_rank) for per_rank in zip(*gathered_leaves)]
            elif isinstance(value, list):
                output_dict[attr] = [dist_sync_fn(v, group=group) for v in value]
            else:
                output_dict[attr] = dist_sync_fn(value, group=group)

        for attr, reduction_fn in self._reductions.items():
            if faults._ACTIVE:  # mid-apply fault point: earlier states are already overwritten
                faults.fire("sync.state_apply")
            gathered = output_dict[attr]
            if reduction_fn == "merge":
                if faults._ACTIVE:  # deterministic corrupt-payload drill (lockstep on all ranks)
                    idx = faults.corrupt_index("sync.sketch_state", len(gathered))
                    if idx is not None:
                        gathered = list(gathered)
                        gathered[idx] = _structurally_corrupt_state(gathered[idx])
                self._validate_merge_gather(attr, input_dict[attr], gathered)
                setattr(self, attr, reduce_merge_states(gathered))
                continue
            if isinstance(gathered, list) and len(gathered) == 0:
                setattr(self, attr, [])
                continue
            if isinstance(gathered[0], list):
                gathered = _flatten(gathered)
            else:
                gathered = torch.stack(gathered)
            if isinstance(reduction_fn, str):
                reduction_fn = _REDUCTION_MAP[reduction_fn]
            if not (callable(reduction_fn) or reduction_fn is None):
                raise TypeError("reduction_fn must be callable or None")
            reduced = reduction_fn(gathered) if reduction_fn is not None else gathered
            setattr(self, attr, reduced)

    def _validate_merge_gather(self, attr: str, template: Any, gathered: List[Any]) -> None:
        """Check every rank's gathered sketch state against the local one
        before merging: a corrupt payload (wrong class, missing leaf,
        reshaped or re-typed leaf) raises :class:`SyncError` naming the state
        and the rank instead of failing inside the merge, or merging garbage."""
        for rank, state in enumerate(gathered):
            if type(state) is not type(template):
                raise SyncError(
                    f"merge-state gather: state {attr!r} from rank {rank} has class"
                    f" {type(state).__name__}, expected {type(template).__name__} — corrupt payload"
                )
            if len(state) != len(template):
                raise SyncError(
                    f"merge-state gather: state {attr!r} from rank {rank} has {len(state)} leaves,"
                    f" expected {len(template)} — corrupt payload"
                )
            for got, want in zip(state, template):
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise SyncError(
                        f"merge-state gather: state {attr!r} from rank {rank} has a leaf of"
                        f" shape {tuple(got.shape)}/{got.dtype}, expected {tuple(want.shape)}/{want.dtype} —"
                        " corrupt payload"
                    )

    def _sync_dist_bounded(self, dist_sync_fn: Callable, process_group: Optional[Any], timeout_s: Optional[float]) -> None:
        """Run ``_sync_dist``, optionally under a wall-clock budget.

        With a timeout the collectives run on a daemon worker thread and a
        straggler raises :class:`SyncError` instead of hanging forever. The
        abandoned attempt cannot be cancelled: if it ever completes it may
        still write states, which the caller's cache-restore then overwrites;
        a timed-out group should be considered poisoned (see ``SyncConfig``).
        """
        if not timeout_s:
            self._sync_dist(dist_sync_fn, process_group=process_group)
            return
        box: Dict[str, Any] = {}

        def _runner() -> None:
            try:
                self._sync_dist(dist_sync_fn, process_group=process_group)
            except BaseException as err:  # noqa: BLE001 - handed to the waiting thread, which raises it
                box["err"] = err

        worker = threading.Thread(target=_runner, daemon=True, name=f"tm-tpu-sync-{type(self).__name__}")
        worker.start()
        worker.join(timeout_s)
        if worker.is_alive():
            raise SyncError(f"{type(self).__name__}.sync() timed out after {timeout_s}s — straggler rank or lost host?")
        if "err" in box:
            raise box["err"]

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Callable] = None,
        sync_config: Optional[SyncConfig] = None,
    ) -> None:
        """Sync the states across ranks, fault-tolerantly.

        Attempts are governed by ``sync_config`` (argument, else the metric's
        ``sync_config`` kwarg, else :data:`DEFAULT_SYNC_CONFIG`): each failed
        attempt rolls the states back to the pre-sync cache, so a mid-gather
        failure never leaves the metric half-synced, then retries with
        exponential backoff. Exhausted attempts raise :class:`SyncError`, or,
        with ``on_error="local"``, keep the local-only state with a single
        :class:`SyncWarning` (rank zero only).
        """
        if self._device_telemetry is not None:
            # sync is the other host boundary for device telemetry
            _obs_device.drain_metric(self)
        if (_obs_trace.ENABLED or _obs_live.ENABLED) and should_sync and self._should_unsync:
            # pre-sync state footprint: the bytes about to ride the gather
            _obs_attr.metric_boundary(self)
        if _obs_trace.ENABLED:
            with _obs_trace.span("metric.sync", metric=type(self).__name__, n=self._update_count):
                return self._sync_impl(dist_sync_fn, process_group, should_sync, distributed_available, sync_config)
        return self._sync_impl(dist_sync_fn, process_group, should_sync, distributed_available, sync_config)

    def _sync_impl(
        self,
        dist_sync_fn: Optional[Callable],
        process_group: Optional[Any],
        should_sync: bool,
        distributed_available: Optional[Callable],
        sync_config: Optional[SyncConfig],
    ) -> None:
        if self._is_synced and should_sync:
            raise TorchMetricsUserError("The Metric has already been synced.")
        if distributed_available is None and self.distributed_available_fn is not None:
            distributed_available = self.distributed_available_fn
        is_distributed = distributed_available() if callable(distributed_available) else None
        if not should_sync or not is_distributed or self._mesh_replicated:
            return
        if dist_sync_fn is None:
            dist_sync_fn = gather_all_tensors
        cfg = sync_config or self.sync_config or DEFAULT_SYNC_CONFIG
        # cache the prior state so accumulation can continue locally after
        # unsync AND so any failed attempt can roll back cleanly
        self._cache = self._copy_state_dict()
        group = process_group or self.process_group
        last_err: Optional[BaseException] = None
        for attempt in range(cfg.attempts):
            try:
                if faults._ACTIVE:
                    faults.fire("sync.attempt")
                # the sync health counters also feed the live plane's
                # liveness derivation (obs/live.py), so they count when
                # EITHER recorder is on
                if _obs_trace.ENABLED or _obs_live.ENABLED:
                    _obs_counters.inc("metric.sync.attempt")
                self._sync_dist_bounded(dist_sync_fn, group, cfg.timeout_s)
                self._is_synced = True
                return
            except Exception as err:
                # roll back any partial overwrite before retrying or surfacing;
                # fresh list copies so a later attempt cannot alias the cache
                self._install_state_tree({k: list(v) if isinstance(v, list) else v for k, v in self._cache.items()})
                last_err = err
                if _obs_trace.ENABLED or _obs_live.ENABLED:
                    _obs_counters.inc("metric.sync.rollback")
                if _obs_trace.ENABLED:
                    _obs_trace.instant(
                        "metric.sync.rollback",
                        metric=type(self).__name__,
                        attempt=attempt,
                        error=type(err).__name__,
                        reason=str(err)[:200],
                    )
                if attempt + 1 < cfg.attempts:
                    backoff_s = cfg.backoff(attempt)
                    if _obs_trace.ENABLED:
                        _obs_trace.instant("metric.sync.retry", metric=type(self).__name__, attempt=attempt + 1, backoff_s=backoff_s)
                    time.sleep(backoff_s)
        self._cache = None
        if cfg.on_error == "local":
            if _obs_trace.ENABLED or _obs_live.ENABLED:
                _obs_counters.inc("metric.sync.degrade")
            if _obs_trace.ENABLED:
                _obs_trace.instant(
                    "metric.sync.degrade", metric=type(self).__name__, attempts=cfg.attempts, error=type(last_err).__name__
                )
            rank_zero_warn(
                f"{type(self).__name__}.sync() failed after {cfg.attempts} attempt(s) ({last_err}); falling back"
                " to local-only state (SyncConfig.on_error='local') — reported values cover this process only.",
                SyncWarning,
            )
            return
        if _obs_trace.ENABLED or _obs_live.ENABLED:
            _obs_counters.inc("metric.sync.failure")
        if _obs_trace.ENABLED:
            _obs_trace.instant(
                "metric.sync.failure", metric=type(self).__name__, attempts=cfg.attempts, error=type(last_err).__name__
            )
        raise SyncError(f"{type(self).__name__}.sync() failed after {cfg.attempts} attempt(s): {last_err}") from last_err

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore the cached pre-sync local state."""
        if not should_unsync:
            return
        if not self._is_synced:
            raise TorchMetricsUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise TorchMetricsUserError("The internal cache should exist to unsync the Metric.")
        self._install_state_tree(self._cache)  # self-snapshot: trusted
        self._is_synced = False
        self._cache = None

    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[Callable] = None,
    ) -> "_SyncContext":
        """Context manager: sync on enter, unsync on exit."""
        return _SyncContext(self, dist_sync_fn, process_group, should_sync, should_unsync, distributed_available)

    # ------------------------------------------------------------------ reset
    def reset(self) -> None:
        """Reset all states to their defaults."""
        if _obs_trace.ENABLED:
            with _obs_trace.span("metric.reset", metric=type(self).__name__):
                return self._reset_impl()
        self._reset_impl()

    def _reset_impl(self) -> None:
        self._update_count = 0
        self._computed = None
        self._device_telemetry = None
        self._mesh_replicated = False
        for attr, default in self._defaults.items():
            setattr(self, attr, [] if isinstance(default, list) else default)

    def clone(self) -> "Metric":
        """Deep copy of the metric."""
        return deepcopy(self)

    # -------------------------------------------------------------- serialization
    def save_checkpoint(self) -> Dict[str, Any]:
        """Snapshot the metric (wrapper children included) as one plain dict of
        host numpy arrays plus spec fingerprint, format version and update
        count, the layout the JAX package writes: it pickles without torch
        and loads in either package. See
        :mod:`torchmetrics_tpu_torch.robustness.checkpoint`."""
        from torchmetrics_tpu_torch.robustness.checkpoint import save_checkpoint

        return save_checkpoint(self)

    def load_checkpoint(self, checkpoint: Dict[str, Any], strict: bool = True) -> None:
        """Validate a :meth:`save_checkpoint` dict (of either package) end-to-end,
        then install it on the metric's device.

        A truncated/corrupted payload or a schema mismatch (e.g. different
        ``num_classes``) raises
        :class:`~torchmetrics_tpu_torch.utilities.exceptions.StateRestoreError`
        naming the offending state, and the live metric keeps its previous
        state — never a half-restored metric.
        """
        from torchmetrics_tpu_torch.robustness.checkpoint import load_checkpoint

        load_checkpoint(self, checkpoint, strict=strict)

    def state_dict(self, destination: Optional[Dict] = None, prefix: str = "", keep_vars: bool = False) -> Dict[str, Any]:
        """State-dict of persistent states as host numpy arrays (copies)."""
        destination = {} if destination is None else destination
        for key in self._defaults:
            if not self._persistent[key]:
                continue
            current_val = getattr(self, key)
            if isinstance(current_val, list):
                destination[prefix + key] = [v.detach().cpu().numpy().copy() for v in current_val]
            elif is_sketch_state(current_val):
                destination[prefix + key] = map_leaves(lambda v: v.detach().cpu().numpy().copy(), current_val)
            else:
                destination[prefix + key] = current_val.detach().cpu().numpy().copy()
        return destination

    def load_state_dict(self, state_dict: Dict[str, Any], strict: bool = True, prefix: str = "") -> None:
        """Restore states from a state-dict, copying every array onto the device."""
        from torchmetrics_tpu_torch.robustness.spec import _owned_tensor

        for key in self._defaults:
            name = prefix + key
            if name in state_dict:
                value = state_dict[name]
                if isinstance(value, list):
                    setattr(self, key, [_owned_tensor(v, self._device) for v in value])
                elif is_sketch_state(value):
                    setattr(self, key, map_leaves(lambda v: _owned_tensor(v, self._device), value))
                else:
                    setattr(self, key, _owned_tensor(value, self._device))
            elif strict and self._persistent[key]:
                raise KeyError(f"Missing key {name!r} in state_dict")
        self._computed = None

    def persistent(self, mode: bool = False) -> None:
        """Toggle persistence of all states."""
        for key in self._persistent:
            self._persistent[key] = mode

    # ------------------------------------------------------------ device
    @property
    def device(self) -> torch.device:
        """The device the metric's states live on."""
        return self._device

    @property
    def dtype(self) -> torch.dtype:
        """The floating dtype of the metric's states (float32 until :meth:`set_dtype`)."""
        return self._dtype

    def to(self, device: Union[str, torch.device]) -> "Metric":
        """Move every state (and its default) to ``device``."""
        self._device = resolve_device(device, type(self).__name__)
        self._apply(lambda x: x.to(self._device))
        self._computed = None
        return self

    def cpu(self) -> "Metric":
        """Move every state (and its default) to the CPU."""
        return self.to("cpu")

    def set_dtype(self, dst_type: torch.dtype) -> "Metric":
        """Cast the floating states and their defaults (sketch leaves one by
        one) to ``dst_type``; integer and boolean states keep their dtype.
        Arbitrary casting is only available through this method."""
        self._dtype = dst_type
        self._apply(lambda x: x.to(dst_type) if x.dtype.is_floating_point else x)
        return self

    def type(self, dst_type: torch.dtype) -> "Metric":
        return self.set_dtype(dst_type)

    def float(self) -> "Metric":
        return self.set_dtype(torch.float32)

    def double(self) -> "Metric":
        return self.set_dtype(torch.float64)

    def half(self) -> "Metric":
        return self.set_dtype(torch.float16)

    def _apply(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> None:
        """``fn`` on every state tensor and on every default (list states
        element by element, sketch states leaf by leaf)."""
        for attr, default in self._defaults.items():
            current = getattr(self, attr)
            if isinstance(current, list):
                setattr(self, attr, [fn(c) for c in current])
            elif is_sketch_state(current):
                setattr(self, attr, map_leaves(fn, current))
            else:
                setattr(self, attr, fn(current))
            if is_sketch_state(default):
                self._defaults[attr] = map_leaves(fn, default)
            elif not isinstance(default, list):
                self._defaults[attr] = fn(default)
        self._computed = None

    # ------------------------------------------------------------------- misc
    def _inputs(self, preds: Any, target: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        """Update inputs (tensors, numpy arrays) as tensors on the metric's device."""
        return _to_tensor(preds, self._device), _to_tensor(target, self._device)

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Only the kwargs the update signature takes."""
        _params = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        _sign_params = inspect.signature(self.__class__.update).parameters
        filtered_kwargs = {k: v for k, v in kwargs.items() if (k in _sign_params and _sign_params[k].kind not in _params)}
        exists_var_keyword = any(v.kind == inspect.Parameter.VAR_KEYWORD for v in _sign_params.values())
        return kwargs if exists_var_keyword else filtered_kwargs

    def __hash__(self) -> int:
        """Class name plus the bytes of every state: one host copy per state."""
        hash_vals: List[Any] = [self.__class__.__name__]
        for key in self._defaults:
            val = getattr(self, key)
            if isinstance(val, list):
                hash_vals.extend(v.detach().cpu().numpy().tobytes() for v in val)
            elif is_sketch_state(val):
                hash_vals.extend(leaf.detach().cpu().numpy().tobytes() for leaf in val)
            else:
                hash_vals.append(val.detach().cpu().numpy().tobytes())
        return hash(tuple(hash_vals))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"

    # --------------------------------------------------------------- plotting
    def sliced(self, *, num_cells: int, **kwargs: Any) -> Any:
        """Fan this metric out over up to ``num_cells`` cohort cells — one
        step per batch updates EVERY cohort's copy of the state (hashed slice
        table + a leading ``[num_cells]`` state axis; see
        :class:`~torchmetrics_tpu_torch.parallel.sliced.SlicedPlan`)::

            plan = acc.sliced(num_cells=1024)
            plan.update(cohort_ids, preds, target)   # one step, all cohorts
            per_cohort = plan.results()

        The metric is the pristine per-cell TEMPLATE (``reset()`` first);
        ``kwargs`` pass through to ``SlicedPlan`` (``cat_capacity``,
        ``example_batch``, ``donate``, ``mesh``, ``axis_name``,
        ``key_width``, ``example_keys``).
        """
        from torchmetrics_tpu_torch.parallel.sliced import SlicedPlan

        return SlicedPlan(self, num_cells=num_cells, **kwargs)

    def plot(self, *args: Any, **kwargs: Any) -> Any:
        """Plot a single or multiple values of the metric (matplotlib)."""
        return self._plot(*args, **kwargs)

    def _plot(self, val: Any = None, ax: Any = None) -> Any:
        from torchmetrics_tpu_torch.utilities.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute()
        return plot_single_or_multi_val(
            val,
            ax=ax,
            higher_is_better=self.higher_is_better,
            lower_bound=self.plot_lower_bound,
            upper_bound=self.plot_upper_bound,
            legend_name=self.plot_legend_name,
            name=self.__class__.__name__,
        )

    # --------------------------------------------------- composition operators
    # ``__eq__`` and the comparisons return a CompositionalMetric, which is
    # truthy: code of the port compares metrics by ``is`` and ``id()``, never
    # by ``==``, ``in``, ``.index`` or ``.remove``.
    def __add__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, self, other)

    def __radd__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, other, self)

    def __sub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, self, other)

    def __rsub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, other, self)

    def __mul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, self, other)

    def __rmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, other, self)

    def __truediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, self, other)

    def __rtruediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, other, self)

    def __floordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, self, other)

    def __rfloordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, other, self)

    def __mod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.remainder, self, other)

    def __rmod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.remainder, other, self)

    def __pow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, self, other)

    def __rpow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, other, self)

    def __matmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, self, other)

    def __rmatmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, other, self)

    def __and__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, self, other)

    def __rand__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, other, self)

    def __or__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, self, other)

    def __ror__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, other, self)

    def __xor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, self, other)

    def __rxor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, other, self)

    def __eq__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.eq, self, other)

    def __ne__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.ne, self, other)

    def __lt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.lt, self, other)

    def __le__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.le, self, other)

    def __gt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.gt, self, other)

    def __ge__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.ge, self, other)

    def __abs__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __neg__(self) -> "CompositionalMetric":
        return CompositionalMetric(_neg, self, None)

    def __pos__(self) -> "CompositionalMetric":  # abs, as the JAX package (and the reference) define it
        return CompositionalMetric(torch.abs, self, None)

    def __invert__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.logical_not, self, None)

    def __getitem__(self, idx: Any) -> "CompositionalMetric":
        return CompositionalMetric(lambda x: x[idx], self, None)


def _structurally_corrupt_state(state: Any) -> Any:
    """The mutation of the ``sync.sketch_state`` fault point (drills only):
    the first leaf gets a trailing extra axis, so the gather's check trips."""
    first = state[0]
    return type(state)(torch.zeros(tuple(first.shape) + (2,), dtype=first.dtype, device=first.device), *state[1:])


def _neg(x: torch.Tensor) -> torch.Tensor:
    """``-abs(x)``: the JAX package's (and the reference's) ``__neg__``."""
    return -torch.abs(x)


class _SyncContext:
    def __init__(self, metric: Metric, dist_sync_fn, process_group, should_sync, should_unsync, distributed_available) -> None:
        self.metric = metric
        self.kwargs = dict(
            dist_sync_fn=dist_sync_fn,
            process_group=process_group,
            should_sync=should_sync,
            distributed_available=distributed_available,
        )
        self.should_unsync = should_unsync

    def __enter__(self) -> None:
        self.metric.sync(**self.kwargs)

    def __exit__(self, *exc: Any) -> None:
        self.metric.unsync(should_unsync=self.should_unsync and self.metric._is_synced)


# JAX without 64-bit mode: numpy's 64-bit scalars and arrays become 32-bit arrays
_JAX_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32, torch.complex128: torch.complex64}


def _operand(value: Any, device: torch.device) -> Tuple[Any, bool]:
    """A non-metric operand of a :class:`CompositionalMetric` as a tensor on
    ``device``, with whether it is weakly typed.

    The dtypes are ``jnp.asarray``'s: a Python ``int`` is int32 and a
    ``float`` float32, both weak (they take the other operand's dtype of
    their kind, as ``2 * x`` keeps a float16 ``x`` float16); ``bool``, numpy
    values and tensors are strong, numpy's 64-bit ones 32-bit.
    """
    if value is None:
        return None, False
    if isinstance(value, torch.Tensor):
        return value.to(device), False
    if isinstance(value, bool):
        return torch.tensor(value, device=device), False
    if isinstance(value, int):
        return torch.tensor(value, dtype=torch.int32, device=device), True
    if isinstance(value, float):
        return torch.tensor(value, dtype=torch.float32, device=device), True
    tensor = torch.as_tensor(np.array(value, copy=True))
    return tensor.to(device, _JAX_CANONICAL.get(tensor.dtype, tensor.dtype)), False


def _apply_op(op: Callable, a: Any, b: Any, weak: Tuple[bool, bool], device: torch.device) -> Any:
    """``op(a)`` or ``op(a, b)`` with JAX's result dtype.

    A weak operand takes the other's dtype when that is of its kind or
    higher (int < float < complex); then both operands go to their common
    dtype by the dtype lattice alone, as ``jnp`` promotes them. Torch would
    let a 0-d tensor lose to a dimensioned one of the same kind.
    """
    if b is None:
        return op(a)
    ta, wa = (a, weak[0]) if isinstance(a, torch.Tensor) else _operand(a, device)
    tb, wb = (b, weak[1]) if isinstance(b, torch.Tensor) else _operand(b, device)
    if wa != wb:
        weak_t, strong_t = (ta, tb) if wa else (tb, ta)
        if _kind(strong_t.dtype) >= _kind(weak_t.dtype):
            weak_t = weak_t.to(strong_t.dtype)
        ta, tb = (weak_t, strong_t) if wa else (strong_t, weak_t)
    common = torch.promote_types(ta.dtype, tb.dtype)
    return op(ta.to(common), tb.to(common))


def _kind(dtype: torch.dtype) -> int:
    if dtype.is_complex:
        return 3
    if dtype.is_floating_point:
        return 2
    return 0 if dtype == torch.bool else 1


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:<current>`` name one device."""

    def index(d: torch.device) -> Optional[int]:
        return d.index if d.index is not None or d.type != "cuda" else torch.cuda.current_device()

    return a.type == b.type and index(a) == index(b)


def _child_device(owner: str, devices: List[torch.device], device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device of a metric built on children that live on ``devices``:
    theirs. Children on two devices raise, and so does an explicit ``device``
    that differs from theirs."""
    distinct: List[torch.device] = []
    for d in devices:
        if not any(_same_device(d, seen) for seen in distinct):
            distinct.append(d)
    if len(distinct) > 1:
        raise ValueError(f"{owner}: its metrics live on different devices {[str(d) for d in distinct]}")
    if device is not None:
        device = resolve_device(device, owner)
        if distinct and not _same_device(device, distinct[0]):
            raise ValueError(f"{owner} was given device={device}, but its metrics live on {distinct[0]}")
        return device
    return distinct[0] if distinct else resolve_device("cuda", owner)


class CompositionalMetric(Metric):
    """Lazy arithmetic composition of metrics (``metric_a <op> metric_b``).

    An operand that is not a metric becomes a tensor on the metric operand's
    device (see :func:`_operand` for its dtype). The operands' own updates,
    syncs and resets run through this metric; its value is ``op`` over theirs.
    """

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, float, int, torch.Tensor, None],
        metric_b: Union[Metric, float, int, torch.Tensor, None],
    ) -> None:
        devices = [m.device for m in (metric_a, metric_b) if isinstance(m, Metric)]
        super().__init__(device=_child_device(type(self).__name__, devices))
        self.op = operator
        weak = []
        for name, operand in (("metric_a", metric_a), ("metric_b", metric_b)):
            if not isinstance(operand, Metric):
                operand, is_weak = _operand(operand, self._device)
                weak.append(is_weak)
            else:
                weak.append(False)
            setattr(self, name, operand)
        self._weak = tuple(weak)

    def _sync_dist(self, dist_sync_fn: Callable = gather_all_tensors, process_group: Optional[Any] = None) -> None:
        # no syncing here: the operands sync themselves at their compute()
        pass

    def _value(self, val_a: Any, val_b: Any) -> Any:
        return _apply_op(self.op, val_a, val_b, self._weak, self._device)

    def update(self, *args: Any, **kwargs: Any) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        return self._value(val_a, val_b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        a, b = self.metric_a, self.metric_b
        val_a = a(*args, **a._filter_kwargs(**kwargs)) if isinstance(a, Metric) else a
        val_b = b(*args, **b._filter_kwargs(**kwargs)) if isinstance(b, Metric) else b
        if val_a is None:
            self._computed = None
            return None
        if val_b is None and isinstance(self.metric_b, Metric):
            self._computed = None
            return None
        self._computed = self._value(val_a, val_b)
        return self._computed

    def reset(self) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()
        self._update_count = 0
        self._computed = None

    def persistent(self, mode: bool = False) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.persistent(mode=mode)
        if isinstance(self.metric_b, Metric):
            self.metric_b.persistent(mode=mode)

    def __repr__(self) -> str:
        name = self.op.__name__ if hasattr(self.op, "__name__") else "op"
        return self.__class__.__name__ + f"(\n  {name}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"

    def __hash__(self) -> int:
        return object.__hash__(self)
