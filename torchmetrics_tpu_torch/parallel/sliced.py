# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Sliced evaluation plane: thousands of cohort cells updated in ONE step per
batch (counterpart of ``torchmetrics_tpu/parallel/sliced.py``).

A serving-scale eval plane answers "accuracy per country, per model-version"
— naively one ``Metric`` per cohort and one ``update()`` per cohort per
batch. :class:`SlicedPlan` keeps every cohort's state in one carry instead:

- **slice table** — a fixed-capacity open-addressed hash table maps cohort
  keys (integer arrays, one value or tuple per batch row) to cell indices
  inside the step: murmur-style mixing, linear probing in rounds where the
  lowest contending row claims an empty slot (insertion is order-independent
  and replayable), no deletions. Rows whose key finds no cell after a full
  sweep are DROPPED and counted in ``spills``. On the card the table is
  kernel K4 (``ops.slice_assign``), whose rounds run inside one block, so
  the step holds no loop whose trip count the host would have to read; on
  the CPU its plain version replays JAX's ``while_loop`` round by round.
  Tables are JAX's bit for bit, so a plan saved by either package lands its
  cohorts in the same cells of the other.
- **cell-carried state** — every registered state of every compute-group
  leader carries a leading ``[num_cells]`` axis in one carry, written in
  place. A batch updates ALL cells at once: the member's own ``update``
  runs per row (``torch.func.vmap`` over the batch rows, each row presented
  as a size-1 batch) and the per-row fresh states are folded into their
  cells — ``index_add``/``scatter_reduce`` for ``sum``/``max``/``min``
  states, an offset scatter into per-cell
  :class:`~torchmetrics_tpu_torch.parallel.cat_buffer.CatBuffer`\\ s for list
  ("cat") states, and a serial sketch ``merge`` fold in row order for
  ``dist_reduce_fx="merge"`` states. Sketches whose merge is an int32 add or
  max leaf by leaf (``HistogramSketch``, ``HLLSketch``) fold by segment
  instead, bit for bit the same (integer adds and maxes commute).
- **the kernel route** — a member whose update reaches K2 (the multiclass
  stat-scores bincount branch) or K1 (the binned curve state) does not go
  through ``vmap``: a ``BatchedTensor`` has no data pointer for a hand
  kernel, and the ``[B, *state]`` row states of a binned curve would not fit
  (65536 x 128 x 64 x 4 int32 is 8.6 GB). Its private hook
  ``_sliced_fresh_states(cells, num_cells, *batch)`` returns the per-cell
  states from K2s or K1s (``ops.stat_counts_segmented``,
  ``ops.binned_curve_state_segmented``), which add each row into its cell:
  bit for bit JAX's per-row ``vmap`` segment-summed. On the CPU the same
  hook runs the kernels' plain versions.

Queries (:meth:`SlicedPlan.compute_all`) run each member's own ``compute``
under ``torch.func.vmap`` over the cell axis.

**Exactness contract** (JAX's). Splitting a batch by cohort is the contract
in-step sharding relies on: ``update(A ∪ B) == reduce(update(A),
update(B))``. ``sliced(k=N)`` equals N independent per-cohort metrics
bitwise for integer elementwise states, cat states (row order within a cell
is preserved) and add-style sketch states; float sums agree up to summation
order. Array states declaring ``mean``, ``None`` or a callable are refused
at build.

**On the card** the step (table, fresh states, fold) is captured once per
input signature into a CUDA graph and replayed, with the fused plan's parts
(:class:`~torchmetrics_tpu_torch.parallel.fused._GraphCapture`: the carry
written in place, static inputs, a warm-up on a side stream against a
scratch copy of the carry). :meth:`SlicedPlan.run_scan` captures the step
over a stacked chunk. A failed capture raises; the step never runs eagerly
on the card instead. On the CPU the step runs eagerly.

``donate=True`` (the default) is the port's counterpart of JAX's donated
carry: there is no buffer invalidation, and a ``plan.state`` read before an
update aliases the carry after it. ``donate=False`` returns a copy per read.

**Sharded variant** (``mesh=``, a ``torch.distributed`` ``DeviceMesh``, and
``axis_name``): every rank passes its LOCAL rows and keys. The plan gathers
the keys in rank order, so every rank places the same full key vector in
its table (JAX's global batch order). Each rank folds its own rows into
per-cell partials; the ranks all-reduce them (``sum``/``max``/``min``) and
all-gather cat rows and serial-sketch row states in rank order, which fold
with the global cells — sliced-sharded equals sliced-local bitwise. gloo
collectives cannot be captured, so on the card the step is two graphs with
the collectives between them.

Durability: :meth:`SlicedPlan.save_checkpoint` /
:meth:`SlicedPlan.load_checkpoint` round-trip the whole carry (table
included) in JAX's payload, so a plan saved by either package loads into the
other.

Observability: with tracing on, the build records the ``sliced.build`` span
and each capture the ``sliced.update``/``sliced.scan`` capture spans and
records (:mod:`~torchmetrics_tpu_torch.obs.xla`); :meth:`SlicedPlan.publish_gauges`
publishes the ``slice.table.*`` gauges and the plan's state-bytes row at
host boundaries (checkpoints, runner snapshots), and
:meth:`SlicedPlan.live_probe` feeds the live publisher.

A guarded member (:func:`~torchmetrics_tpu_torch.robustness.guard.enable_guard`)
folds each row as its guarded update of a one-row batch, as JAX's per-row
``vmap`` does: its kernel route gets the invalid rows as cell ``-1`` (unless
the policy is ``propagate``), the ``vmap`` route selects the defaults for
them, and the ``guard_*`` partials are the segment sums of the row verdicts.

Not ported yet (ROADMAP): the cross-plan compiled-step cache.
"""
from __future__ import annotations

import math
from copy import deepcopy
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map

from torchmetrics_tpu_torch.obs import attribution as _obs_attr
from torchmetrics_tpu_torch.obs import counters as _obs_counters
from torchmetrics_tpu_torch.obs import live as _obs_live
from torchmetrics_tpu_torch.obs import trace as _obs_trace
from torchmetrics_tpu_torch.ops.slice_assign import hash_rows, slice_assign
from torchmetrics_tpu_torch.parallel.cat_buffer import CatBuffer, cat_buffer_values
from torchmetrics_tpu_torch.parallel.fused import (
    _as_input,
    _Captured,
    _GraphCapture,
    _MemberInfo,
    _resolve_members,
    _stage,
    fusion_ineligibility,
)
from torchmetrics_tpu_torch.parallel.sharded import _axis_group, _fingerprint_digest, _walk_fingerprint
from torchmetrics_tpu_torch.robustness import guard as _guard
from torchmetrics_tpu_torch.sketch.hll import HLLSketch
from torchmetrics_tpu_torch.sketch.histogram import HistogramSketch
from torchmetrics_tpu_torch.sketch.registry import is_sketch_state, map_leaves, merge_states, sketch_state_class
from torchmetrics_tpu_torch.utilities.checks import _fused_step
from torchmetrics_tpu_torch.utilities.distributed import all_reduce_, gather_all_tensors
from torchmetrics_tpu_torch.utilities.exceptions import StateRestoreError

Tensor = torch.Tensor

__all__ = [
    "SlicedPlan",
    "SliceTable",
    "sliced_ineligibility",
    "slice_key_reason",
    "slice_table_size_reason",
]

#: payload layout version of :meth:`SlicedPlan.save_checkpoint`
SLICED_FORMAT_VERSION = 1

#: reductions whose per-cell fold is exact at row granularity (see module
#: docstring); ``cat`` covers list states, ``merge`` sketch states
_SLICEABLE_REDUCTIONS = ("sum", "max", "min", "cat", "merge")

#: sketch classes whose merge is an int32 add or max leaf by leaf (a leaf
#: missing here is a constant of the class, kept from the carry): they fold
#: by segment, bit for bit the serial merge fold
_SEGMENTED_SKETCHES: Dict[type, Dict[str, str]] = {
    HistogramSketch: {"counts": "sum", "low": "sum", "high": "sum", "count": "sum"},
    HLLSketch: {"registers": "max", "count": "sum"},
}

_REDUCE_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


# -------------------------------------------------------------- eligibility


def slice_table_size_reason(num_cells: Any) -> Optional[str]:
    """Why ``num_cells`` cannot size a slice table, or ``None``: the table is
    a fixed shape, so its size must be a static positive python int (the
    predicate metriclint's ML008 applies statically)."""
    if isinstance(num_cells, bool) or not isinstance(num_cells, int):
        return (
            f"num_cells must be a static positive python int (a compiled-in shape), got"
            f" {type(num_cells).__name__} — float or traced sizing is dynamic-shape"
        )
    if num_cells < 1:
        return f"num_cells must be >= 1, got {num_cells}"
    return None


def _dtype_name(dtype: Any) -> str:
    return str(dtype).replace("torch.", "") if isinstance(dtype, torch.dtype) else str(np.dtype(dtype))


def _is_integer_dtype(dtype: Any) -> bool:
    if isinstance(dtype, torch.dtype):
        return not (dtype.is_floating_point or dtype.is_complex)
    dtype = np.dtype(dtype)
    return bool(np.issubdtype(dtype, np.integer) or dtype == np.bool_)


def slice_key_reason(dtype: Any) -> Optional[str]:
    """Why a cohort-key dtype (torch or numpy) cannot enter the slice table,
    or ``None``: keys are hashed and compared for exact equality, so they
    must be integer (or bool) arrays."""
    if _is_integer_dtype(dtype):
        return None
    return (
        f"cohort keys must be integer (hashable) arrays, got dtype {_dtype_name(dtype)} — bucket or"
        " hash float features to ints on the producer side"
    )


def sliced_ineligibility(metric: Any) -> Optional[str]:
    """Why ``metric`` cannot enter a sliced plan, or ``None`` when it can.

    Everything fusion requires (positional update, no host state) plus the
    row-granular fold contract: every array state must declare a named
    reduction from ``{sum, max, min, merge}`` (list states are ``cat``).
    """
    reason = fusion_ineligibility(metric)
    if reason:
        return reason
    for name, red in metric._reductions.items():
        default = metric._defaults[name]
        if isinstance(default, list):
            if red not in ("cat", None):
                return (
                    f"list state {name!r} declares dist_reduce_fx={red!r}; sliced list"
                    " states append per cell (cat semantics)"
                )
            continue
        if red == "mean":
            return (
                f"state {name!r} declares dist_reduce_fx='mean': the per-cell fold weight"
                " (rows vs update events) is ambiguous at row granularity — restructure as"
                " sum + count states (like MeanMetric) to slice exactly"
            )
        if red not in _SLICEABLE_REDUCTIONS:
            return (
                f"state {name!r} declares dist_reduce_fx={red!r}, whose stacking fold grows"
                " the state per step — a fixed-shape cell carry needs a named reduction"
                " (sum/max/min/merge)"
            )
    return None


# --------------------------------------------------------------- slice table


class SliceTable(NamedTuple):
    """The cohort-key → cell-index map, carried inside the step."""

    keys: Tensor  # (num_cells, key_width) int32; rows meaningful only where occupied
    occupied: Tensor  # (num_cells,) bool
    spills: Tensor  # () int32: rows dropped because a full probe sweep found no cell


#: JAX's ``_hash_rows``: the murmur3-style mix of each row's key columns
_hash_rows = hash_rows


def _assign_cells(table: SliceTable, kmat: Tensor) -> Tuple[SliceTable, Tensor]:
    """Place every row's key in ``table`` (in place) and return ``(table,
    cells)``, ``-1`` for spilled rows: K4 on the card, its plain version
    (JAX's ``while_loop`` as a host loop) on the CPU."""
    cells = slice_assign(table.keys, table.occupied, table.spills, kmat)
    return table, cells


def _within_cell_rank(cells: Tensor) -> Tensor:
    """Per row: how many earlier batch rows share its cell — the cat-scatter
    offset that preserves row order within a cell."""
    batch = cells.shape[0]
    idx = torch.arange(batch, dtype=torch.int64, device=cells.device)
    order = torch.argsort(cells, stable=True)
    sorted_cells = cells[order]
    starts = torch.ones((batch,), dtype=torch.bool, device=cells.device)
    starts[1:] = sorted_cells[1:] != sorted_cells[:-1]
    seg_start = torch.cummax(torch.where(starts, idx, 0), 0).values
    return torch.zeros((batch,), dtype=torch.int64, device=cells.device).index_copy(0, order, idx - seg_start)


# ----------------------------------------------------------- per-row updates


def _row_states(metric: Any, batch: Tuple[Tensor, ...], update: Optional[Callable[..., None]] = None) -> Dict[str, Any]:
    """One fresh update per batch row under ``torch.func.vmap``: every leaf
    gains a leading ``[batch]`` axis (list states: each appended chunk gains
    it). The row is presented as a size-1 batch so the member's ``update``
    (or ``update``, given: the StateGuard's raw update) sees its ordinary
    batched shapes."""
    lead = [a.shape[0] for a in batch if a.ndim >= 1]
    if not lead:
        raise ValueError("sliced update needs at least one batched (ndim >= 1) input")
    rows = lead[0]
    in_dims = tuple(0 if a.ndim >= 1 else None for a in batch)
    staged = tuple(a.reshape((rows, 1) + tuple(a.shape[1:])) if d == 0 else a for a, d in zip(batch, in_dims))
    update = metric.update if update is None else update

    def one(*row: Tensor) -> Dict[str, Any]:
        with metric._scratch():
            metric.reset()
            update(*row)
            return metric.state_tree()

    return torch.func.vmap(one, in_dims=in_dims)(*staged)


def _segment_reduce(red: str, rows: Tensor, seg: Tensor, num_cells: int) -> Tensor:
    """Reduce per-row leaves into cells; spilled rows carry segment id
    ``num_cells`` and fall off the ``[:num_cells]`` slice. Cells without rows
    hold zeros, which the ``recv`` mask of the fold never reads."""
    out = torch.zeros((num_cells + 1, *rows.shape[1:]), dtype=rows.dtype, device=rows.device)
    if red == "sum":
        return out.index_add(0, seg, rows)[:num_cells]
    if red in ("max", "min"):
        index = seg.reshape((-1,) + (1,) * (rows.ndim - 1)).expand(rows.shape)
        return out.scatter_reduce(0, index, rows, reduce="amax" if red == "max" else "amin", include_self=False)[:num_cells]
    raise ValueError(f"unexpected sliced array reduction {red!r}")


def _merge_cells_(red: str, carry: Tensor, fresh: Tensor, recv: Tensor) -> None:
    """Fold a batch's per-cell fresh states into the carry in place; cells
    that received no rows keep their carry bitwise. An integer sum adds in
    place: a cell without rows holds a fresh 0, and ``x + 0 == x`` for
    integers (not for a float ``-0.0``, which the mask keeps)."""
    if red == "sum" and not (carry.is_floating_point() or carry.is_complex() or carry.dtype == torch.bool):
        carry.add_(fresh)
        return
    if red == "sum":
        merged = carry + fresh
    elif red == "max":
        merged = torch.maximum(carry, fresh)
    elif red == "min":
        merged = torch.minimum(carry, fresh)
    else:  # pragma: no cover - guarded by sliced_ineligibility
        raise ValueError(f"unexpected sliced array reduction {red!r}")
    mask = recv.reshape(recv.shape + (1,) * (merged.ndim - 1))
    carry.copy_(torch.where(mask, merged, carry))


def _cat_rows(data: Tensor) -> Tensor:
    """The ``(num_cells * capacity + 1, *elem)`` rows under a per-cell
    CatBuffer's ``data``, the spare row last: a row that does not fit is
    written there, which nothing reads (PyTorch has no scatter that drops)."""
    n = data.shape[0] * data.shape[1]
    row = math.prod(data.shape[2:])
    need = (data.storage_offset() + (n + 1) * row) * data.element_size()
    if not data.is_contiguous() or data.untyped_storage().nbytes() < need:
        raise ValueError("sliced CatBuffer data has no spare row")
    return data.as_strided((n + 1, *data.shape[2:]), (row, *data.stride()[2:]), data.storage_offset())


def _cell_cat_buffer(num_cells: int, capacity: int, elem: Sequence[int], dtype: torch.dtype, device: Any) -> CatBuffer:
    storage = torch.zeros((num_cells * capacity + 1, *elem), dtype=dtype, device=device)
    return CatBuffer(
        data=storage[: num_cells * capacity].view(num_cells, capacity, *elem),
        count=torch.zeros((num_cells,), dtype=torch.int32, device=device),
        overflowed=torch.zeros((num_cells,), dtype=torch.bool, device=device),
    )


def _scatter_cat_(buf: CatBuffer, appended: Sequence[Tensor], cells: Tensor, seg: Tensor) -> None:
    """Scatter each row's appended cat rows into its cell's buffer at offset
    ``count[cell] + within_cell_rank * rows_per_update``, in place — row
    order within a cell is preserved, overflow drops and latches per cell,
    spilled rows drop."""
    if not appended:
        return
    num_cells, cap = buf.data.shape[0], buf.data.shape[1]
    rows2 = torch.cat([a.reshape(a.shape[0], -1, *buf.data.shape[2:]) for a in appended], dim=1)  # [B, R, *elem]
    batch, per_update = rows2.shape[0], rows2.shape[1]
    ranks = _within_cell_rank(cells)
    cells64 = cells.to(torch.int64)
    base = torch.where(cells64 >= 0, buf.count[cells64.clamp(min=0)].to(torch.int64), 0)
    pos = base[:, None] + ranks[:, None] * per_update + torch.arange(per_update, device=cells.device)[None, :]
    keep = (cells64[:, None] >= 0) & (pos < cap)
    flat = torch.where(keep, cells64[:, None] * cap + pos, num_cells * cap)
    _cat_rows(buf.data).index_copy_(0, flat.reshape(-1), rows2.reshape(batch * per_update, *rows2.shape[2:]).to(buf.data.dtype))
    added = _segment_reduce("sum", torch.full((batch,), per_update, dtype=torch.int32, device=cells.device), seg, num_cells)
    new_total = buf.count + added
    buf.overflowed.logical_or_(new_total > cap)
    buf.count.copy_(torch.clamp(new_total, max=cap))


def _fold_sketch_(cell_states: Any, row_states: Any, cells: Tensor) -> None:
    """Merge each row's fresh sketch into its cell, in row order (serial over
    the batch — sketch merges are arbitrary functions, not segment
    reductions), in place. Spilled rows write back the untouched cell."""
    for i in range(cells.shape[0]):
        c = cells[i : i + 1].to(torch.int64)
        safe = c.clamp(min=0)
        cur = map_leaves(lambda x: x.index_select(0, safe)[0], cell_states)
        row = map_leaves(lambda x: x[i], row_states)
        merged = merge_states(cur, row)
        for leaf, m, old in zip(cell_states, merged, cur):
            leaf.index_copy_(0, safe, torch.where(c[0] >= 0, m, old)[None])


def _sketch_partial(cls: type, row_states: Any, seg: Tensor, num_cells: int) -> Dict[str, Tensor]:
    """The per-cell partial of a segmented sketch: each foldable leaf's rows
    reduced into their cells (``_SEGMENTED_SKETCHES``)."""
    leaves = dict(zip(cls._fields, row_states))
    return {field: _segment_reduce(red, leaves[field], seg, num_cells) for field, red in _SEGMENTED_SKETCHES[cls].items()}


# ---------------------------------------------------------------- the plan


class _ShardedStep(NamedTuple):
    """The sharded plan's buffers for one input signature: static inputs,
    the fresh partials of the local rows, their mesh-reduced counterparts,
    and the two graphs around the collectives (``None`` on the CPU)."""

    inputs: Tuple[Tensor, ...]
    fresh: Dict[str, Any]
    reduced: Dict[str, Any]
    fresh_graph: Any
    fold_graph: Any


def _copy_into_(dst: Any, src: Any) -> None:
    """Copy a tree of tensors into a tree of the same structure, in place."""
    for d, s_ in zip(tree_flatten(dst)[0], tree_flatten(src)[0]):
        d.copy_(s_)


class SlicedPlan(_GraphCapture):
    """Fan a metric (or ``MetricCollection``) out over cohort cells — one
    step per batch for ALL cells.

    ::

        acc = MulticlassAccuracy(num_classes=10, validate_args=False)
        plan = acc.sliced(num_cells=1024)
        for country, preds, target in stream:
            plan.update(country, preds, target)   # one step, 1024 cohorts
        per_cohort = plan.results()               # {(country,): accuracy}

    Args:
        target: a ``Metric`` or ``MetricCollection`` used as the per-cell
            TEMPLATE — it must be pristine (``reset()``); its accumulated
            state never enters the cells.
        num_cells: slice-table capacity — a static python int.
        key_width: number of integer key components per row (a tuple of K
            arrays or a ``[B, K]`` array at ``update``); default 1.
        example_keys: optional example of the cohort keys ``update`` will
            receive — validated eagerly (integer dtype) and used to infer
            ``key_width``; passing BOTH with disagreeing widths raises.
        cat_capacity: max rows PER CELL for list ("cat") states.
        example_batch: example positional batch (sizes CatBuffer row shapes).
        donate: ``True`` (the default): ``plan.state`` is the carry itself,
            rewritten in place by every update (read, don't hold);
            ``False``: each read returns a copy.
        mesh/axis_name: build the sharded variant over a ``DeviceMesh`` dim
            (each rank passes its local rows; see the module docstring).
    """

    _obs_kind = "sliced"

    def __init__(
        self,
        target: Any,
        *,
        num_cells: int,
        key_width: Optional[int] = None,
        example_keys: Optional[Any] = None,
        cat_capacity: Optional[int] = None,
        example_batch: Optional[Tuple[Any, ...]] = None,
        donate: bool = True,
        mesh: Optional[Any] = None,
        axis_name: str = "data",
    ) -> None:
        from torchmetrics_tpu_torch.collections import MetricCollection

        reason = slice_table_size_reason(num_cells)
        if reason:
            raise ValueError(f"cannot build a slice table: {reason}")
        if key_width is not None and (not isinstance(key_width, int) or key_width < 1):
            raise ValueError(f"key_width must be a positive int, got {key_width!r}")
        if example_keys is not None:
            cols = list(example_keys) if isinstance(example_keys, (tuple, list)) else [example_keys]
            cols = [c if isinstance(c, Tensor) else np.asarray(c) for c in cols]
            if len(cols) == 1 and cols[0].ndim == 2:
                cols = [cols[0][:, i] for i in range(cols[0].shape[1])]
            for col in cols:
                key_issue = slice_key_reason(col.dtype)
                if key_issue:
                    raise ValueError(f"bad example_keys: {key_issue}")
            if key_width is not None and key_width != len(cols):
                raise ValueError(
                    f"key_width={key_width} disagrees with example_keys"
                    f" ({len(cols)} component(s)) — drop one or make them match"
                )
            key_width = len(cols)
        key_width = 1 if key_width is None else key_width
        members, groups = _resolve_members(target)
        report = {k: sliced_ineligibility(m) for k, m in members.items()}
        bad = {k: r for k, r in report.items() if r}
        if bad:
            detail = "; ".join(f"{k}: {r}" for k, r in sorted(bad.items()))
            raise ValueError(f"cannot slice {type(target).__name__}: {detail}")
        dirty = sorted(k for k, m in members.items() if m._update_count > 0)
        if dirty:
            raise ValueError(
                f"sliced plans start from a pristine per-cell template; member(s) {dirty}"
                " hold accumulated state — reset() the target first (restore progress via"
                " plan.load_checkpoint instead)"
            )
        devices = {m.device for m in members.values()}
        if len(devices) != 1:
            raise ValueError(f"cannot slice {type(target).__name__}: members on several devices {sorted(map(str, devices))}")
        self.members = members
        self.groups = groups
        self._collection = target if isinstance(target, MetricCollection) else None
        self._target_cls = type(target).__name__
        self._template = deepcopy(target)
        self._device: torch.device = devices.pop()
        self.num_cells = num_cells
        self.key_width = key_width
        self._cat_capacity = cat_capacity
        self._donate = bool(donate)
        self._mesh = mesh
        self._axis = axis_name
        self._infos = [_MemberInfo(cg[0], members[cg[0]], cat_capacity, example_batch) for cg in groups]
        if _obs_trace.ENABLED:
            with _obs_trace.span(
                "sliced.build", metric=self._target_cls, cells=num_cells, leaders=len(self._infos), sharded=mesh is not None
            ):
                self._carry = self._initial_state()
        else:
            self._carry = self._initial_state()
        self._captured: Dict[Any, _Captured] = {}
        self._sharded: Dict[Any, _ShardedStep] = {}
        self._in_member: Optional[str] = None  # the leader whose update the step is running
        if _obs_trace.ENABLED or _obs_live.ENABLED:
            _obs_attr.note_instances(type(self).__name__, list(self.members))

    # ------------------------------------------------------------------ build
    def _fingerprint(self) -> str:
        """The build identity, JAX's parts (process-local: the walk holds object ids)."""
        return _fingerprint_digest(
            "sliced",
            self._target_cls,
            tuple(
                (info.key, type(info.metric).__name__, _walk_fingerprint(info.metric), tuple(info.list_keys))
                for info in self._infos
            ),
            tuple(tuple(cg) for cg in self.groups),
            self.num_cells,
            self.key_width,
            self._cat_capacity,
            self._donate,
            self._axis if self._mesh is not None else None,
        )

    def stable_fingerprint(self) -> str:
        """Process-independent identity for checkpoint validation: the
        members' registry fingerprints plus the table geometry (JAX's string)."""
        from torchmetrics_tpu_torch.robustness.checkpoint import checkpoint_fingerprint

        return _fingerprint_digest(
            "sliced-ckpt",
            self._target_cls,
            tuple(sorted((k, checkpoint_fingerprint(m)) for k, m in self.members.items())),
            self.num_cells,
            self.key_width,
            self._cat_capacity,
        )

    def _initial_state(self) -> Dict[str, Any]:
        num_cells, device = self.num_cells, self._device
        members: Dict[str, Any] = {}
        for info in self._infos:
            metric = info.metric
            slice_: Dict[str, Any] = {}
            for name, default in metric._defaults.items():
                if name in info.list_keys:
                    elem, dtype = info.layout[name]
                    slice_[name] = _cell_cat_buffer(num_cells, self._cat_capacity, elem, dtype, device)
                elif is_sketch_state(default):
                    slice_[name] = map_leaves(lambda x: x[None].repeat(num_cells, *([1] * x.ndim)).to(device), default)
                else:
                    slice_[name] = default[None].repeat(num_cells, *([1] * default.ndim)).to(device)
            slice_["_update_count"] = torch.zeros((num_cells,), dtype=torch.int32, device=device)
            members[info.key] = slice_
        return {
            "members": members,
            "table": SliceTable(
                keys=torch.zeros((num_cells, self.key_width), dtype=torch.int32, device=device),
                occupied=torch.zeros((num_cells,), dtype=torch.bool, device=device),
                spills=torch.zeros((), dtype=torch.int32, device=device),
            ),
            "_update_count": torch.zeros((), dtype=torch.int32, device=device),
        }

    @staticmethod
    def _copy_carry(tree: Any) -> Any:
        """A deep copy of a carry (per-cell CatBuffers with their spare row)."""
        if isinstance(tree, CatBuffer):
            rows = _cat_rows(tree.data).clone()
            n = tree.data.shape[0] * tree.data.shape[1]
            return CatBuffer(rows[:n].view(tree.data.shape), tree.count.clone(), tree.overflowed.clone())
        if isinstance(tree, dict):
            return {k: SlicedPlan._copy_carry(v) for k, v in tree.items()}
        if isinstance(tree, tuple):  # SliceTable or a sketch state
            return type(tree)(*[SlicedPlan._copy_carry(v) for v in tree])
        return tree.clone()

    # ------------------------------------------------------------------- step
    def _member_fresh(self, info: _MemberInfo, cells: Tensor, seg: Tensor, batch: Tuple[Tensor, ...]) -> Dict[str, Any]:
        """One leader's fresh partials for the rows of ``batch`` (cells
        ``cells``): per-cell tensors for array states and segmented sketches
        (the kernel route's own, or the ``vmap`` rows reduced into cells),
        the rows themselves for cat states and serially folded sketches."""
        num_cells, metric = self.num_cells, info.metric
        if getattr(metric, "_guard_policy", None) is not None:
            # a guarded member: each row is its guarded update of a one-row
            # batch, as JAX's per-row vmap runs it (robustness/guard.py)
            verdict = _guard.row_verdict(metric, batch)
            per_cell = _guard._kernel_fresh(metric, _guard.kernel_cells(metric, cells, verdict), num_cells, batch)
            if per_cell is not None:
                return {**per_cell, **_guard.guard_cell_counters(metric, verdict, seg, num_cells)}
            rows = _guard.guard_rows(metric, _row_states(metric, batch, update=_guard._raw_update(metric)), verdict)
        else:
            hook = getattr(metric, "_sliced_fresh_states", None)
            per_cell = hook(cells, num_cells, *batch) if hook is not None else None
            if per_cell is not None:
                return per_cell
            rows = _row_states(metric, batch)
        fresh: Dict[str, Any] = {}
        for name, default in metric._defaults.items():
            red = metric._reductions[name]
            if name in info.list_keys:
                fresh[name] = rows[name]
            elif red == "merge":
                cls = type(default)
                fresh[name] = _sketch_partial(cls, rows[name], seg, num_cells) if cls in _SEGMENTED_SKETCHES else rows[name]
            else:
                fresh[name] = _segment_reduce(red, rows[name], seg, num_cells)
        return fresh

    def _fresh(self, table: SliceTable, inputs: Tuple[Tensor, ...], offset: int = 0) -> Dict[str, Any]:
        """Place the keys (``inputs[0]``, every rank's rows in a sharded plan)
        in the table and compute every leader's fresh partials for the rows
        of ``inputs[1:]`` (this rank's, from row ``offset`` of the keys)."""
        kmat, batch = inputs[0], inputs[1:]
        _, cells_all = _assign_cells(table, kmat)
        lead = [a.shape[0] for a in batch if a.ndim >= 1]
        cells = cells_all[offset : offset + lead[0]] if lead else cells_all
        seg = torch.where(cells >= 0, cells, self.num_cells).to(torch.int64)
        members = {}
        with _fused_step():
            for info in self._infos:
                self._in_member = info.key
                members[info.key] = self._member_fresh(info, cells, seg, batch)
        self._in_member = None
        return {"cells": cells_all, "members": members}

    def _fold(self, carry: Dict[str, Any], fresh: Dict[str, Any]) -> None:
        """Fold the (mesh-reduced) fresh partials into the carry, in place,
        with the global cells."""
        num_cells = self.num_cells
        cells = fresh["cells"]
        seg = torch.where(cells >= 0, cells, num_cells).to(torch.int64)
        recv = torch.zeros((num_cells + 1,), dtype=torch.bool, device=cells.device).index_fill(0, seg, True)[:num_cells]
        for info in self._infos:
            mstate, part = carry["members"][info.key], fresh["members"][info.key]
            for name, default in info.metric._defaults.items():
                red = info.metric._reductions[name]
                if name in info.list_keys:
                    _scatter_cat_(mstate[name], part[name], cells, seg)
                elif red == "merge" and type(default) in _SEGMENTED_SKETCHES:
                    leaves = dict(zip(type(default)._fields, mstate[name]))
                    for field, field_red in _SEGMENTED_SKETCHES[type(default)].items():
                        _merge_cells_(field_red, leaves[field], part[name][field], recv)
                elif red == "merge":
                    _fold_sketch_(mstate[name], part[name], cells)
                else:
                    _merge_cells_(red, mstate[name], part[name], recv)
            mstate["_update_count"].add_(recv.to(torch.int32))
        carry["_update_count"].add_(1)

    def _step(self, carry: Dict[str, Any], inputs: Tuple[Tensor, ...]) -> None:
        """Apply one batch (``inputs = (kmat, *batch)``) to ``carry`` in place."""
        self._fold(carry, self._fresh(carry["table"], inputs))

    def _chunk(self, carry: Dict[str, Any], stacked: Tuple[Tensor, ...]) -> None:
        """Apply every slice of a stacked chunk, in order."""
        for i in range(stacked[0].shape[0]):
            self._step(carry, tuple(s[i] for s in stacked))

    def _scratch_carry(self) -> Dict[str, Any]:
        return self._copy_carry(self._carry)

    def _record(self, fn: Callable[[], None]) -> Any:
        try:
            return super()._record(fn)
        finally:
            self._in_member = None

    def _capture_site(self) -> str:
        where = self._in_member
        call = f"member {where!r} ({type(self.members[where]).__name__}.update)" if where else "the slice table or the fold"
        return f"the sliced step of {self._target_cls} in {call}"

    # ----------------------------------------------------------- sharded step
    def _reduce(self, fresh: Dict[str, Any]) -> Dict[str, Any]:
        """The fresh partials reduced over the mesh dim (collectives, outside
        any graph): per-cell partials all-reduced, bucketed by op and dtype;
        cat rows and serial-sketch row states gathered in rank order."""
        group = _axis_group(self._mesh, self._axis)
        out: Dict[str, Any] = {"cells": fresh["cells"], "members": {}}
        buckets: Dict[Tuple[str, torch.dtype], List[Tuple[str, str, Optional[str], Tensor]]] = {}

        def gather_rows(t: Tensor) -> Tensor:
            return torch.cat(gather_all_tensors(t, group=group))

        for info in self._infos:
            part = fresh["members"][info.key]
            mine: Dict[str, Any] = {}
            for name, default in info.metric._defaults.items():
                red, value = info.metric._reductions[name], part[name]
                if name in info.list_keys:
                    mine[name] = [gather_rows(chunk) for chunk in value]
                elif red == "merge" and type(default) in _SEGMENTED_SKETCHES:
                    mine[name] = {}
                    for field, field_red in _SEGMENTED_SKETCHES[type(default)].items():
                        buckets.setdefault((_REDUCE_OPS[field_red], value[field].dtype), []).append((info.key, name, field, value[field]))
                elif red == "merge":
                    mine[name] = map_leaves(gather_rows, value)
                else:
                    buckets.setdefault((_REDUCE_OPS[red], value.dtype), []).append((info.key, name, None, value))
            out["members"][info.key] = mine
        for (op, _), entries in buckets.items():
            flat = all_reduce_(torch.cat([t.reshape(-1) for *_, t in entries]), getattr(dist.ReduceOp, op), group)
            for (key, name, field, t), piece in zip(entries, flat.split([t.numel() for *_, t in entries])):
                piece = piece.view(t.shape)
                if field is None:
                    out["members"][key][name] = piece
                else:
                    out["members"][key][name][field] = piece
        return out

    def _run_sharded(self, kmat_local: Tensor, batch: Tuple[Tensor, ...]) -> None:
        """One batch through the sharded plan: the keys gathered in rank
        order, the table and this rank's fresh partials (a graph replay on
        the card), the collectives, the fold (a second replay)."""
        group = _axis_group(self._mesh, self._axis)
        parts = gather_all_tensors(kmat_local, group=group)
        rank = dist.get_rank(group)
        offset = sum(p.shape[0] for p in parts[:rank])
        inputs = (torch.cat(parts),) + batch
        key = (offset, tuple((tuple(t.shape), t.dtype) for t in inputs))
        step = self._sharded.get(key)
        if step is None:
            self._sharded[key] = self._build_sharded(inputs, offset)
            return  # the build ran this batch
        for dst, src in zip(step.inputs, inputs):
            dst.copy_(src)
        if step.fresh_graph is None:
            self._fold(self._carry, self._reduce(self._fresh(self._carry["table"], step.inputs, offset)))
            return
        step.fresh_graph.replay()
        _copy_into_(step.reduced, self._reduce(step.fresh))
        step.fold_graph.replay()

    def _build_sharded(self, inputs: Tuple[Tensor, ...], offset: int) -> _ShardedStep:
        """Run ``inputs`` through the sharded step; on the card capture the
        fresh and the fold graphs on the way, sized by a warm-up of each
        against a scratch copy of the carry."""
        static = tuple(t.clone() for t in inputs)
        if self._device.type != "cuda":
            self._fold(self._carry, self._reduce(self._fresh(self._carry["table"], static, offset)))
            return _ShardedStep(static, {}, {}, None, None)
        sized = self._warm(lambda: self._fresh(self._copy_carry(self._carry["table"]), static, offset))
        fresh = tree_map(torch.empty_like, sized)
        fresh_graph = self._record(lambda: _copy_into_(fresh, self._fresh(self._carry["table"], static, offset)))
        fresh_graph.replay()
        reduced = tree_map(torch.clone, self._reduce(fresh))
        self._warm(lambda: self._fold(self._copy_carry(self._carry), reduced))
        fold_graph = self._record(lambda: self._fold(self._carry, reduced))
        fold_graph.replay()
        return _ShardedStep(static, fresh, reduced, fresh_graph, fold_graph)

    # ------------------------------------------------------------------ drive
    @property
    def state(self) -> Dict[str, Any]:
        """The carry. With ``donate=True`` (default) the carry itself, which
        the next ``update``/``run_scan`` rewrites in place — read, don't hold.
        With ``donate=False`` a copy that later updates leave alone."""
        return self._carry if self._donate else self._copy_carry(self._carry)

    @property
    def updates_applied(self) -> int:
        """Batches applied since the plan was built (reads the device)."""
        return int(self._carry["_update_count"])

    def key_matrix(self, keys: Any) -> Tensor:
        """Normalize cohort keys (one int array, a tuple of arrays, or a
        ``[B, K]`` matrix) to the ``[B, key_width]`` int32 the step consumes.
        Refuses float keys and guards the table's int32 columns: 64-bit host
        inputs (numpy, CPU tensors) are bounds-checked (values past int32
        would silently ALIAS cohorts mod 2^32 — split wide ids into two
        components via ``key_width`` instead); 64-bit CUDA tensors are
        refused outright (checking them would read the card every batch)."""
        if isinstance(keys, (tuple, list)):
            raw_cols = list(keys)
        elif getattr(keys, "ndim", None) == 2:
            raw_cols = [keys[:, i] for i in range(keys.shape[1])]
        else:
            raw_cols = [keys]
        cols = []
        for raw in raw_cols:
            is_device = isinstance(raw, Tensor) and raw.device.type != "cpu"
            host = raw if isinstance(raw, Tensor) else np.asarray(raw)
            reason = slice_key_reason(host.dtype)
            if reason:
                raise ValueError(f"bad cohort key: {reason}")
            if host.ndim != 1:
                raise ValueError(f"cohort key components must be 1-D per row, got shape {tuple(host.shape)}")
            wide = host.element_size() > 4 if isinstance(host, Tensor) else host.dtype.itemsize > 4
            if wide:
                if is_device:
                    raise ValueError(
                        "bad cohort key: 64-bit device arrays cannot be bounds-checked without a"
                        " per-batch host sync and would silently alias cohorts mod 2^32 when"
                        " truncated — cast to int32, or split wide ids into two int32"
                        " components (key_width)"
                    )
                values = host.numpy() if isinstance(host, Tensor) else host
                if values.size and (values.max() > np.iinfo(np.int32).max or values.min() < np.iinfo(np.int32).min):
                    raise ValueError(
                        "bad cohort key: values exceed int32 — truncating would silently alias"
                        " distinct cohorts mod 2^32; split wide ids into two int32 components"
                        " (key_width), e.g. (ids >> 32, ids & 0xFFFFFFFF)"
                    )
            col = host if isinstance(host, Tensor) else torch.from_numpy(np.ascontiguousarray(host))
            cols.append(col.to(self._device).to(torch.int32))
        if len(cols) != self.key_width:
            raise ValueError(
                f"expected {self.key_width} cohort key component(s) (key_width), got {len(cols)}"
            )
        return torch.stack(cols, dim=1)

    def update(self, keys: Any, *batch: Any) -> None:
        """Fold one batch into its cohort cells: ONE step (one graph replay on
        the card) for ALL cells. ``keys`` is one int array ``[B]``, a tuple of
        them, or a ``[B, key_width]`` matrix — row ``i``'s cohort for
        ``batch[...][i]`` (this rank's rows in a sharded plan)."""
        kmat = self.key_matrix(keys)
        batch = tuple(_as_input(b).to(self._device) for b in batch)
        if self._mesh is not None:
            self._run_sharded(kmat, batch)
        else:
            self._run(self._step, (kmat,) + batch)

    def run_scan(self, keys_seq: Any, batches: Any) -> None:
        """Push a pre-staged chunk through the step: ``keys_seq`` is a
        sequence (or stacked ``[N, B]``/``[N, B, K]`` array) of per-batch
        keys, ``batches`` a sequence of positional batch tuples or
        already-stacked arrays whose leading axis is the chunk. On the card
        one replay of a graph captured for the chunk (a sharded plan takes the
        chunk's batches one by one)."""
        # every per-batch key vector routes through key_matrix, so a scan gets
        # the SAME validation update() gives (key_width, float refusal, int32 bounds)
        if isinstance(keys_seq, (list, tuple)):
            per_batch = list(keys_seq)
        else:
            arr = keys_seq if hasattr(keys_seq, "ndim") else np.asarray(keys_seq)
            per_batch = [arr[i] for i in range(arr.shape[0])]
        kstack = torch.stack([self.key_matrix(k) for k in per_batch])
        staged = _stage(batches, self._device)
        if self._mesh is not None:
            for i in range(kstack.shape[0]):
                self._run_sharded(kstack[i], tuple(s[i] for s in staged))
        else:
            self._run(self._chunk, (kstack,) + staged)

    # ---------------------------------------------------------------- queries
    def _table_host(self) -> Tuple[np.ndarray, np.ndarray, int]:
        table = self._carry["table"]
        return table.keys.cpu().numpy(), table.occupied.cpu().numpy(), int(table.spills)

    @property
    def spills(self) -> int:
        """Rows dropped because the table was full (reads the device)."""
        return self._table_host()[2]

    @property
    def occupancy(self) -> float:
        """Fraction of cells holding a cohort (reads the device)."""
        _, occupied, _ = self._table_host()
        return float(occupied.sum()) / float(self.num_cells)

    def occupied_cells(self) -> Dict[Tuple[int, ...], int]:
        """``{cohort key tuple: cell index}`` for every resident cohort."""
        keys, occupied, _ = self._table_host()
        return {tuple(int(v) for v in keys[i]): int(i) for i in np.nonzero(occupied)[0]}

    def lookup(self, key: Any) -> Optional[int]:
        """Cell index of one cohort key (int or tuple), or ``None``."""
        if not isinstance(key, (tuple, list)):
            key = (key,)
        return self.occupied_cells().get(tuple(int(k) for k in key))

    def cell_state_tree(self, member: str, cell: int) -> Dict[str, Any]:
        """One cell's state for one member, in ``load_state_tree`` form
        (CatBuffers fold to list states, raising on that cell's overflow;
        ``"_update_count"`` rides the reserved key)."""
        group = next((cg for cg in self.groups if member in cg), None)
        if group is None:
            raise KeyError(f"unknown member {member!r}; members: {sorted(self.members)}")
        info = next(i for i in self._infos if i.key == group[0])  # the group leader's carry
        mstate = self._carry["members"][info.key]
        tree: Dict[str, Any] = {}
        for name in info.metric._defaults:
            value = mstate[name]
            if name in info.list_keys:
                buf = CatBuffer(data=value.data[cell], count=value.count[cell], overflowed=value.overflowed[cell])
                rows = cat_buffer_values(buf)  # raises on per-cell overflow
                tree[name] = [rows] if int(buf.count) else []
            elif is_sketch_state(info.metric._defaults[name]):
                tree[name] = map_leaves(lambda x: x[cell], value)
            else:
                tree[name] = value[cell]
        tree["_update_count"] = int(mstate["_update_count"][cell])
        return tree

    def export_cell(self, key: Any) -> Any:
        """A fresh copy of the target holding one cohort's state — compute,
        checkpoint or inspect it like any ordinary metric. ``key`` is the
        cohort key (int or tuple)."""
        cell = self.lookup(key)
        if cell is None:
            raise KeyError(f"cohort key {key!r} holds no cell (spilled or never seen)")
        return self._export_cell_index(cell)

    def _export_cell_index(self, cell: int) -> Any:
        clone = deepcopy(self._template)
        exported_members, _ = _resolve_members(clone, propagate_state=False)
        for cg in self.groups:
            leader_tree = self.cell_state_tree(cg[0], cell)
            for member_key in cg:
                exported_members[member_key].load_state_tree(dict(leader_tree))
                exported_members[member_key]._computed = None
                # a sharded plan's cells cover every rank: compute() must not sync them again
                exported_members[member_key]._mesh_replicated = self._mesh is not None
        if self._collection is not None:
            clone._state_is_copy = False
        return clone

    def results(self) -> Dict[Tuple[int, ...], Any]:
        """``{cohort key tuple: compute() value}`` over every resident cell
        (host loop — evaluation-end cost, not per-batch). The table is read
        back ONCE; per-cohort exports index straight into the carry."""
        self.publish_gauges()
        return {key: self._export_cell_index(cell).compute() for key, cell in self.occupied_cells().items()}

    def compute_all(self) -> Dict[str, Any]:
        """Every member's ``compute`` under ``torch.func.vmap`` over the cell
        axis — per-cell values ``[num_cells, ...]`` per member key.
        Unoccupied cells compute on default state (typically NaN/0) — mask
        with :meth:`occupied_cells`. Refuses cat-state members (per-cell
        valid counts are dynamic)."""
        values: Dict[str, Any] = {}
        for info in self._infos:
            if info.list_keys:
                raise ValueError(
                    f"member {info.key!r} holds list ('cat') states {info.list_keys}: per-cell"
                    " valid row counts are dynamic — use results()/export_cell instead"
                )
            leader_state = self._carry["members"][info.key]
            # compute-group members SHARE the leader's state but each has its
            # own compute — vmap every member's own compute over the carry
            for member_key in next(cg for cg in self.groups if cg[0] == info.key):
                member = self.members[member_key]

                def one_cell(mstate: Dict[str, Any], _metric: Any = member) -> Any:
                    saved = _metric._copy_state_dict()
                    saved_count, saved_computed = _metric._update_count, _metric._computed
                    try:
                        _metric._install_state_tree({k: v for k, v in mstate.items() if k != "_update_count"})
                        _metric._computed = None
                        return type(_metric).compute(_metric)  # raw compute: no sync detour
                    finally:
                        _metric._install_state_tree(saved)
                        _metric._update_count = saved_count
                        _metric._computed = saved_computed

                values[member_key] = torch.func.vmap(one_cell)(leader_state)
        return values

    # ----------------------------------------------------------- durability
    def save_checkpoint(self) -> Dict[str, Any]:
        """The whole carry (slice table included) as one plain numpy dict, the
        JAX package's payload — store it through ``CheckpointStore`` like any
        metric checkpoint."""
        state = self._carry
        members: Dict[str, Any] = {}
        for info in self._infos:
            mstate = state["members"][info.key]
            encoded: Dict[str, Any] = {}
            for name in info.metric._defaults:
                value = mstate[name]
                if name in info.list_keys:
                    encoded[name] = {
                        "__catbuffer__": True,
                        "data": value.data.cpu().numpy().copy(),
                        "count": value.count.cpu().numpy().copy(),
                        "overflowed": value.overflowed.cpu().numpy().copy(),
                    }
                elif is_sketch_state(info.metric._defaults[name]):
                    encoded[name] = {
                        "__sketch__": type(info.metric._defaults[name]).__name__,
                        "leaves": {
                            field: leaf.cpu().numpy().copy()
                            for field, leaf in zip(type(info.metric._defaults[name])._fields, value)
                        },
                    }
                else:
                    encoded[name] = value.cpu().numpy().copy()
            encoded["_update_count"] = mstate["_update_count"].cpu().numpy().copy()
            members[info.key] = encoded
        table = state["table"]
        payload = {
            "sliced_format": SLICED_FORMAT_VERSION,
            "fingerprint": self.stable_fingerprint(),
            "num_cells": self.num_cells,
            "key_width": self.key_width,
            "update_count": int(state["_update_count"]),
            "table": {
                "keys": table.keys.cpu().numpy().copy(),
                "occupied": table.occupied.cpu().numpy().copy(),
                "spills": table.spills.cpu().numpy().copy(),
            },
            "members": members,
        }
        if _obs_trace.ENABLED or _obs_live.ENABLED:
            self.publish_gauges()
        return payload

    def load_checkpoint(self, payload: Dict[str, Any]) -> None:
        """Validate-ALL-then-apply restore of :meth:`save_checkpoint` (either
        package's): any mismatch (format, fingerprint, geometry, leaf
        shape/dtype) raises :class:`StateRestoreError` and the live carry is
        untouched. The values are copied into the carry in place, so graphs
        captured over it stay valid."""
        version = payload.get("sliced_format")
        if not isinstance(version, int) or version < 1 or version > SLICED_FORMAT_VERSION:
            raise StateRestoreError(
                f"sliced checkpoint format {version!r} is not supported"
                f" (this build reads <= {SLICED_FORMAT_VERSION})"
            )
        want_fp = self.stable_fingerprint()
        if payload.get("fingerprint") != want_fp:
            raise StateRestoreError(
                f"sliced checkpoint fingerprint {payload.get('fingerprint')!r} does not match"
                f" this plan's {want_fp!r} — different members or table geometry"
            )
        if payload.get("num_cells") != self.num_cells or payload.get("key_width") != self.key_width:
            raise StateRestoreError(
                "sliced checkpoint table geometry"
                f" ({payload.get('num_cells')}x{payload.get('key_width')}) does not match the"
                f" plan ({self.num_cells}x{self.key_width})"
            )
        live = self._carry
        writes: List[Tuple[Tensor, np.ndarray]] = []

        def check(name: str, got: Any, want: Tensor) -> None:
            got = np.asarray(got)
            want_dtype = torch.empty((), dtype=want.dtype).numpy().dtype
            if tuple(got.shape) != tuple(want.shape) or got.dtype != want_dtype:
                raise StateRestoreError(
                    f"sliced checkpoint leaf {name!r} has shape {got.shape}/{got.dtype},"
                    f" expected {tuple(want.shape)}/{want_dtype}"
                )
            writes.append((want, got))

        try:
            table_p = payload["table"]
            table = live["table"]
            check("table.keys", table_p["keys"], table.keys)
            check("table.occupied", table_p["occupied"], table.occupied)
            check("table.spills", table_p["spills"], table.spills)
            update_count = int(payload["update_count"])
            for info in self._infos:
                encoded = payload["members"][info.key]
                ref_m = live["members"][info.key]
                for name in info.metric._defaults:
                    value = encoded[name]
                    prefix = f"{info.key}.{name}"
                    if name in info.list_keys:
                        ref_buf = ref_m[name]
                        check(f"{prefix}.data", value["data"], ref_buf.data)
                        check(f"{prefix}.count", value["count"], ref_buf.count)
                        check(f"{prefix}.overflowed", value["overflowed"], ref_buf.overflowed)
                    elif is_sketch_state(info.metric._defaults[name]):
                        cls = sketch_state_class(value["__sketch__"])
                        fields = type(info.metric._defaults[name])._fields
                        leaves_in = value["leaves"]
                        if (
                            cls is not type(info.metric._defaults[name])
                            or not isinstance(leaves_in, dict)
                            or sorted(leaves_in) != sorted(fields)
                        ):
                            raise StateRestoreError(
                                f"sliced checkpoint sketch state {prefix!r} does not match the"
                                " registered sketch class/fields"
                            )
                        for field in fields:
                            check(f"{prefix}.{field}", leaves_in[field], getattr(ref_m[name], field))
                    else:
                        check(prefix, value, ref_m[name])
                check(f"{info.key}._update_count", encoded["_update_count"], ref_m["_update_count"])
        except (KeyError, TypeError, ValueError) as err:
            if isinstance(err, StateRestoreError):
                raise
            raise StateRestoreError(f"sliced checkpoint is malformed: {err}") from err
        # validate-all passed: apply, in place
        for dst, src in writes:
            dst.copy_(torch.from_numpy(np.array(src)))
        live["_update_count"].fill_(update_count)

    # -------------------------------------------------------------- obs plane
    def state_byte_sizes(self) -> Dict[str, int]:
        """Per-state byte footprint of the whole carry (tensor metadata — no
        device read), keyed ``<member>.<state>`` plus the ``table``."""
        sizes: Dict[str, int] = {}
        for info in self._infos:
            mstate = self._carry["members"][info.key]
            for name in info.metric._defaults:
                sizes[f"{info.key}.{name}"] = int(sum(t.numel() * t.element_size() for t in tree_flatten(mstate[name])[0]))
        table = self._carry["table"]
        sizes["table"] = int(table.keys.numel() * table.keys.element_size() + table.occupied.numel() * table.occupied.element_size())
        return sizes

    def publish_gauges(self) -> None:
        """Publish ``slice.table.occupancy``/``.spills``/``.cells`` gauges
        plus the per-table ``state_bytes`` attribution row. One flag check
        when obs is off: call freely at host boundaries (results,
        checkpoints, runner snapshots); never per batch (it reads the
        table)."""
        if not (_obs_trace.ENABLED or _obs_live.ENABLED):
            return
        _, occupied, spills = self._table_host()
        occupancy = float(occupied.sum()) / self.num_cells
        # the bare names feed the fleet dashboard column (last writer wins
        # when a process drives several plans); the target-class-namespaced
        # copies tell several tables apart
        for prefix in ("slice.table", f"slice.table.{self._target_cls}"):
            _obs_counters.set_gauge(f"{prefix}.occupancy", occupancy)
            _obs_counters.set_gauge(f"{prefix}.cells", self.num_cells)
            _obs_counters.set_gauge(f"{prefix}.spills", spills)
        _obs_attr.note_instances(type(self).__name__, list(self.members))
        leaves = {
            f"{info.key}.{name}": tree_flatten(self._carry["members"][info.key][name])[0]
            for info in self._infos
            for name in info.metric._defaults
        }
        leaves["table"] = [self._carry["table"].keys, self._carry["table"].occupied]
        _obs_attr.note_state_bytes(self, self.state_byte_sizes(), updates=self.updates_applied, leaves=leaves)

    def live_probe(self) -> Dict[str, float]:
        """Probe payload for a live publisher: table occupancy and spills, as
        a host dict (reads the device)."""
        _, occupied, spills = self._table_host()
        occupancy = float(occupied.sum()) / self.num_cells
        return {
            "slice.table.occupancy": occupancy,
            "slice.table.spills": float(spills),
            f"slice.table.{self._target_cls}.occupancy": occupancy,
            f"slice.table.{self._target_cls}.spills": float(spills),
        }
