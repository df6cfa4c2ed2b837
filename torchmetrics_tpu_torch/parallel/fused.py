# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""One-replay fused evaluation plan: a whole ``MetricCollection``'s update as
ONE captured CUDA graph (counterpart of ``torchmetrics_tpu/parallel/fused.py``,
its local variant).

The unfused loop pays, per batch and per metric, a Python ``update()``
call, a transactional snapshot and the launch of every small kernel from
the host. :class:`FusedCollectionPlan` removes that:

- every compute-group LEADER's registered states are gathered into ONE
  state carry ``{"members": {leader: {state..., "_update_count": int32}},
  "_update_count": int32}``, the JAX package's layout; list ("cat") states
  become fixed-capacity :class:`~torchmetrics_tpu_torch.parallel.cat_buffer.CatBuffer`
  carries. Group members keep riding the collection's state-ref propagation;
- the step for one batch installs the carry into each leader, runs the
  leader's own (wrapped) ``update`` and writes the new states back into
  the carry IN PLACE (``copy_``; a CatBuffer appends at its device-side
  offset), the counterpart of XLA's ``donate_argnums=0``. Running the
  metric's own update makes fused == unfused bitwise by construction;
- on a CUDA device the step is captured once per input signature (shapes
  and dtypes, the analogue of a jit retrace) into a CUDA graph, and
  :meth:`FusedCollectionPlan.update` copies the batch into the graph's
  static input buffers and replays it: one launch from the host for the
  whole collection. :meth:`~FusedCollectionPlan.run_scan` captures the step
  over every slice of a stacked chunk into one graph (JAX's ``lax.scan``):
  one replay per chunk, zero per-batch Python. On the CPU (``device="cpu"``,
  as the tests run it) the same step runs eagerly;
- :meth:`~FusedCollectionPlan.fold_back` installs copies of the carried
  totals back into the member metrics, so ``compute()`` and checkpointing
  are unchanged.

**What capture requires, and how the plan meets it.** A graph replays fixed
addresses: the carry is allocated once and only ever written in place, and
each signature owns static input buffers. Before a capture, one warm-up step
runs on a side stream against a scratch copy of the carry (it builds the
hand kernels and fills their launch caches; it counts as no batch). Nothing
on the host is replayed: Python counters move only at warm-up and capture,
so the update counts ride the carry as device int32, as in JAX, and the hand
kernels' ``launches`` counters count the warm-up's launch and the capture's
recorded one, never a replay's (a profiler trace of the replays counts
those). The step must not read the device
on the host: value checks of ``validate_args`` skip themselves under capture
(``utilities/checks.py::_is_concrete``), and numpy inputs are staged before
the replay. If a capture fails, the plan raises and names the member and
its call; it never runs the step eagerly instead.

**Eligibility.** Fusion requires a positional update on device states:
kwargs-only updates, host-state updates (``_sharded_update_unsupported``),
host-side counters, wrappers of child metrics and metrics without states
are refused with a per-member report (:func:`fusion_report`), with the JAX
package's reasons.

**The sharded variant** (``mesh=``, a ``torch.distributed`` ``DeviceMesh``,
and ``axis_name``, one of its dims): every rank of that dim drives the plan
with its LOCAL shard of each batch, and every rank's carry ends up holding
the whole batch's totals, as ``sharded_update`` leaves a metric. Per batch:

1. a captured graph runs each leader's update from a fresh state on the
   shard and writes the partial states into static buffers (list states
   into a per-shape CatBuffer);
2. :func:`~torchmetrics_tpu_torch.parallel.sharded.mesh_reduce_tree` (array
   states) and :func:`~torchmetrics_tpu_torch.parallel.cat_buffer.cat_buffer_all_gather`
   (list states) reduce them over the dim's group OUTSIDE the graph: a gloo
   collective cannot be captured;
3. a second captured graph folds the reduced partials into the carry with
   ``tree_merge``'s count-weighted rule (the first event loads them, as
   ``sharded_update`` does) and appends the gathered rows.

On the CPU the same three steps run eagerly. ``run_scan`` drives the chunk's
batches one by one (the collectives sit between the graphs). An array state
whose reduction is ``None`` or a callable is refused, naming the member, as
in JAX: its stacking fold would grow the carry every step.

Sketch (``"merge"``) members ride the carry leaf by leaf: the local step
writes each new leaf back in place, and the sharded fold merges the reduced
sketch into the carry (the first event loads it, as ``sharded_update``
does: a merge into an empty default is not the identity bit for bit).

The capture machinery (the side stream, the warm-up against a scratch copy
of the carry, the graph pool) is :class:`_GraphCapture`, which the
one-metric step of ``parallel.sharded.make_jit_update``
(:class:`JitUpdateStep`) shares.

With device telemetry enabled at build (:mod:`torchmetrics_tpu_torch.obs.device`)
the carry additionally holds ONE ``TelemetryState`` for the whole collection
(members see the same batch, so per-member carries would be copies), written
in place by the step like the states; ``fold_back`` accumulates it into
every leader's pending slot. With tracing on, the build records the
``fused.build`` span, and each capture the ``fused.update``/``fused.scan``
``.lower``/``.compile``/``.first_step`` spans and records of
:mod:`~torchmetrics_tpu_torch.obs.xla`, keyed by the plan's fingerprint.

**The compiled-step cache** (JAX's ``plan_cache_lookup``/``plan_cache_store``
in :mod:`~torchmetrics_tpu_torch.parallel.sharded`). What a plan's captures
bind is one :class:`_CaptureEntry`: the carry, the graphs with their static
inputs, a sharded plan's buffers and graphs, the graph pool and the side
stream. A plan built over the same (target, mesh, axis) with the same
fingerprint and carry layout adopts the entry and writes its own initial
state into the adopted carry in place, so every address a graph holds stays
valid and its first update on the card is a replay, not a capture (a
resumed evaluator, a plan per epoch or drive). A carry of another layout
(shapes or dtypes) is a miss and stores a fresh entry. If the plan that held
the entry is still alive, it gets a copy of its carry in fresh buffers and
no graphs: its next update on the card captures anew, and its results stay
its own. The cache keeps one entry per (kind, target, mesh, axis), with its
carry (134 MB for the exact group) and graph pool, for as long as the
target lives; entries are swept only when a plan stores one.

Not ported yet (ROADMAP): capturing NCCL collectives in the sharded step's graph.
"""
from __future__ import annotations

import gc
import inspect
import weakref
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten

from torchmetrics_tpu_torch.obs import attribution as _obs_attr
from torchmetrics_tpu_torch.obs import device as _obs_device
from torchmetrics_tpu_torch.obs import live as _obs_live
from torchmetrics_tpu_torch.obs import trace as _obs_trace
from torchmetrics_tpu_torch.obs import xla as _obs_xla
from torchmetrics_tpu_torch.parallel.cat_buffer import (
    CatBuffer,
    _append_,
    _copy,
    _merge_,
    cat_buffer_all_gather,
    cat_buffer_init,
    cat_buffer_values,
    infer_cat_layout,
)
from torchmetrics_tpu_torch.parallel.sharded import (
    _update_arity,
    _walk_metrics,
    mesh_reduce_tree,
    plan_cache_lookup,
    plan_cache_store,
    tree_merge,
)
from torchmetrics_tpu_torch.sketch.registry import is_sketch_state, map_leaves
from torchmetrics_tpu_torch.utilities.checks import _fused_step
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = ["FusedCollectionPlan", "fusion_ineligibility", "fusion_report"]

_POSITIONAL_KINDS = (
    inspect.Parameter.POSITIONAL_ONLY,
    inspect.Parameter.POSITIONAL_OR_KEYWORD,
    inspect.Parameter.VAR_POSITIONAL,
)


# ---------------------------------------------------------------- eligibility


def fusion_ineligibility(metric: Any) -> Optional[str]:
    """Why ``metric`` cannot enter a fused plan, or ``None`` when it can."""
    reason = getattr(metric, "_sharded_update_unsupported", None)
    if reason:
        return f"host-state update ({reason})"
    counters = getattr(metric, "_host_counters", ())
    if counters:
        return f"host-side counters {sorted(counters)} cannot ride the device state carry"
    if not getattr(metric, "_defaults", None):
        return "declares no registered states"
    if len(_walk_metrics(metric)) > 1:
        return "wraps child metrics; the fused state pytree covers only the root registry"
    params = [p for name, p in inspect.signature(type(metric).update).parameters.items() if name != "self"]
    if not any(p.kind in _POSITIONAL_KINDS for p in params):
        return "update() accepts no positional batch arguments (kwargs-only signature)"
    return None


def fusion_report(target: Any) -> Dict[str, Optional[str]]:
    """Per-member eligibility report for a Metric or MetricCollection:
    ``{member: None}`` when fusable, ``{member: reason}`` otherwise. The
    plan's build raises with exactly these reasons. Read-only: asking for a
    report never touches the collection's state-ref propagation."""
    members, _ = _resolve_members(target, propagate_state=False)
    return {key: fusion_ineligibility(m) for key, m in members.items()}


def _resolve_members(target: Any, propagate_state: bool = True) -> Tuple[Dict[str, Any], List[List[str]]]:
    """``(members, groups)``: base-keyed member dict plus compute groups
    (leader first). A bare Metric is a one-member collection. With
    ``propagate_state`` (the plan build) a copy-state collection first
    re-propagates leader state into members, the entry protocol of
    ``MetricCollection.update``; eligibility queries skip it."""
    from torchmetrics_tpu_torch.collections import MetricCollection
    from torchmetrics_tpu_torch.metric import Metric

    if isinstance(target, MetricCollection):
        if propagate_state and target._state_is_copy:
            target._compute_groups_create_state_ref(copy=False)
            target._state_is_copy = False
        keys = sorted(dict.keys(target))
        members = {k: dict.__getitem__(target, k) for k in keys}
        if target._enable_compute_groups and target._groups_checked:
            groups = [list(cg) for cg in target._groups.values()]
        else:
            # groups not (yet) established: every member leads itself. Run two
            # eager updates (or pass explicit compute_groups) before fusing to
            # let the dedup discovery fire; the plan freezes the assignment.
            groups = [[k] for k in keys]
        return members, groups
    if isinstance(target, Metric):
        name = type(target).__name__
        return {name: target}, [[name]]
    raise TypeError(f"cannot fuse a {type(target).__name__}; expected Metric or MetricCollection")


# --------------------------------------------------------------------- helpers


def _copy_tree(tree: Any) -> Any:
    """Deep copy of a state carry (CatBuffers with their spare row, sketch
    states and the telemetry state leaf by leaf)."""
    if isinstance(tree, CatBuffer):
        return _copy(tree)
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if is_sketch_state(tree):
        return map_leaves(torch.clone, tree)
    if isinstance(tree, tuple):
        return type(tree)(*[None if v is None else _copy_tree(v) for v in tree])
    return tree.clone()


def _copy_leaves_(dst: Any, src: Any) -> None:
    """Copy a tensor, a CatBuffer, a sketch or telemetry state, or a dict of
    them into ``dst`` in place."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k, v in src.items():
            _copy_leaves_(dst[k], v)
    elif dst is not None:
        for d, s_ in zip(dst, src):
            _copy_leaves_(d, s_)


def _check_kept(key: str, name: str, carried: Any, value: Any, when: str) -> None:
    """Raise unless ``value`` has the shape and dtype of ``carried`` (leaf by
    leaf for a sketch state): a carry keeps both."""
    pairs = zip(carried, value) if is_sketch_state(carried) else [(carried, value)]
    for c, v in pairs:
        if v.shape != c.shape or v.dtype != c.dtype:
            raise ValueError(
                f"member {key!r}: state {name!r} changed from {tuple(c.shape)} {c.dtype}"
                f" to {tuple(v.shape)} {v.dtype} {when}; a fused carry keeps its shape and dtype"
            )


def _fresh_buffers(info: "_MemberInfo", tree: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """Static buffers for one leader's fresh partial state, shaped by ``tree``:
    array states as they are, list states as a CatBuffer holding one batch's rows."""
    out: Dict[str, Any] = {}
    for name, value in tree.items():
        if name in info.list_keys:
            elem, dtype = info.layout[name]
            rows = sum(torch.atleast_1d(v).shape[0] for v in value)
            out[name] = cat_buffer_init(rows, elem, dtype, device)
        elif is_sketch_state(value):
            out[name] = map_leaves(torch.empty_like, value)
        else:
            out[name] = torch.empty_like(value)
    return out


def _concat_rows(appended: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([torch.atleast_1d(x) for x in appended])


def _as_input(x: Any) -> torch.Tensor:
    """A batch argument as a tensor, where it lies (numpy arrays on the host)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _stage(batches: Any, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """A sequence of batch tuples stacked into chunk tensors on ``device`` (one
    copy per input), or an already stacked tuple moved there."""
    if isinstance(batches, tuple):
        stacked = [_as_input(b) for b in batches]
    else:
        seq = [b if isinstance(b, tuple) else (b,) for b in batches]
        if not seq:
            raise ValueError("run_scan needs at least one batch")
        stacked = [torch.stack([_as_input(b[i]) for b in seq]) for i in range(len(seq[0]))]
    return tuple(s.to(device) for s in stacked)


class _MemberInfo:
    """Static per-leader build record."""

    __slots__ = ("key", "metric", "list_keys", "layout")

    def __init__(self, key: str, metric: Any, cat_capacity: Optional[int], example_batch) -> None:
        self.key = key
        self.metric = metric
        self.list_keys = [k for k, v in metric._defaults.items() if isinstance(v, list)]
        if self.list_keys and (cat_capacity is None or example_batch is None):
            raise ValueError(
                f"member {key!r} ({type(metric).__name__}) has list ('cat') states"
                f" {self.list_keys}; the fused plan needs cat_capacity (max total rows)"
                " and an example_batch to give them fixed-capacity CatBuffer carries"
            )
        self.layout = infer_cat_layout(metric, tuple(example_batch)) if self.list_keys else {}


def _member_update(info: _MemberInfo, mstate: Dict[str, Any], batch: Tuple[torch.Tensor, ...]) -> Dict[str, Any]:
    """One leader's update run AGAINST the carried state: the carry is
    installed, the metric's own (wrapped) ``update`` runs, and the new state
    tree is returned; the metric is restored after. List ("cat") states are
    installed empty, so the tree holds what this batch appends. The update
    runs under :func:`~torchmetrics_tpu_torch.utilities.checks._fused_step`,
    so value-dependent shapes stay out of the step on every device."""
    metric = info.metric
    with metric._scratch():
        install = {k: v for k, v in mstate.items() if k not in info.list_keys and k != "_update_count"}
        for k in info.list_keys:
            install[k] = []
        metric._install_state_tree(install)
        metric._computed = None
        with _fused_step():
            metric.update(*batch)
        return metric.state_tree()


def _write_back(info: _MemberInfo, mstate: Dict[str, Any], tree: Dict[str, Any]) -> None:
    """Write one leader's new state tree into its carry, in place."""
    for name, value in tree.items():
        carried = mstate[name]
        if name in info.list_keys:
            if value:
                _append_(carried, _concat_rows(value).to(carried.data.dtype))
        elif value is not carried:
            _check_kept(info.key, name, carried, value, "in an update")
            _copy_leaves_(carried, value)
    mstate["_update_count"].add_(1)


class _Captured(NamedTuple):
    """A captured step: its graph and static inputs."""

    graph: Any  # torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]


class _ShardedStep(NamedTuple):
    """The sharded plan's buffers for one input signature: static inputs, the
    fresh partial states of the local shard, their reduced counterparts, and
    the two graphs around the collectives (``None`` on the CPU)."""

    inputs: Tuple[torch.Tensor, ...]
    fresh: Dict[str, Dict[str, Any]]
    reduced: Dict[str, Dict[str, Any]]
    fresh_graph: Any
    fold_graph: Any


def _write_fresh(info: _MemberInfo, fresh: Dict[str, Any], tree: Dict[str, Any]) -> None:
    """Write one leader's fresh partial state tree into its static buffers."""
    for name, value in tree.items():
        buf = fresh[name]
        if name in info.list_keys:
            buf.count.zero_()
            buf.overflowed.zero_()
            if value:
                _append_(buf, _concat_rows(value).to(buf.data.dtype))
        else:
            _check_kept(info.key, name, buf, value, "between updates")
            _copy_leaves_(buf, value)


def _fold_reduced(info: _MemberInfo, mstate: Dict[str, Any], reduced: Dict[str, Any]) -> None:
    """Fold one leader's mesh-reduced partial state into its carry, in place.

    The count-weighted ``tree_merge`` of ``sharded_update``; while the
    carried count is 0 the reduced state is loaded instead (selected on the
    device, so one captured graph serves every step)."""
    prev = mstate["_update_count"]
    arrays = [k for k in reduced if k not in info.list_keys]
    merged = tree_merge(
        {k: info.metric._reductions[k] for k in arrays},
        {k: mstate[k] for k in arrays},
        {k: reduced[k] for k in arrays},
        weight_a=prev,
        weight_b=1,
    )
    first = prev == 0
    for k in arrays:
        if is_sketch_state(mstate[k]):
            _copy_leaves_(mstate[k], [torch.where(first, r, m) for r, m in zip(reduced[k], merged[k])])
        else:
            mstate[k].copy_(torch.where(first, reduced[k], merged[k]))
    for k in info.list_keys:
        _merge_(mstate[k], reduced[k])
    mstate["_update_count"].add_(1)


# ------------------------------------------------------------- capture parts


def _same_layout(a: Any, b: Any) -> bool:
    """Whether two carries have one structure and, leaf by leaf, one shape,
    dtype and device (a carry that a captured graph could be handed)."""
    leaves_a, spec_a = tree_flatten(a)
    leaves_b, spec_b = tree_flatten(b)
    return spec_a == spec_b and all(
        type(x) is type(y)
        and (not isinstance(x, torch.Tensor) or (x.shape == y.shape and x.dtype == y.dtype and x.device == y.device))
        for x, y in zip(leaves_a, leaves_b)
    )


class _CaptureEntry:
    """What an owner's captured CUDA graphs bind, as one entry of the
    compiled-step cache: the carry they write in place, the graphs with
    their static inputs (``captured``, keyed by body and input signature),
    a sharded plan's buffers and graphs (``sharded``), the graph pool and the
    side stream, and a weak reference to the plan that holds it."""

    __slots__ = ("carry", "captured", "sharded", "pool", "side", "holder")

    def __init__(self, carry: Any) -> None:
        self.carry = carry
        self.captured: Dict[Any, Any] = {}
        self.sharded: Dict[Any, Any] = {}
        self.pool: Any = None
        self.side: Any = None  # the side stream of warm-ups and captures
        self.holder: Optional[weakref.ref] = None


class _EntryField:
    """An owner attribute that lives on its :class:`_CaptureEntry`
    (``_carry`` is ``_entry.carry``), so adopting an entry moves all of it."""

    def __set_name__(self, owner: type, name: str) -> None:
        self._field = name.lstrip("_")

    def __get__(self, owner: Any, cls: Optional[type] = None) -> Any:
        return self if owner is None else getattr(owner._entry, self._field)

    def __set__(self, owner: Any, value: Any) -> None:
        setattr(owner._entry, self._field, value)


class _GraphCapture:
    """What capturing a step as a CUDA graph needs: a side stream for the
    warm-ups and captures, a graph pool shared by every graph of the owner,
    and a capture that raises (naming where it failed, see
    :meth:`_capture_site`) instead of running the step eagerly. All of it,
    with the carry the graphs write, lives on the owner's ``_entry``."""

    _device: torch.device
    _entry: _CaptureEntry
    _carry = _EntryField()
    _captured = _EntryField()
    _sharded = _EntryField()
    _pool = _EntryField()
    _side = _EntryField()

    def _adopt(self, target: Any, carry: Dict[str, Any]) -> None:
        """Take this plan's entry of the compiled-step cache, keyed by
        (kind, target, mesh, axis, fingerprint). On a hit the plan writes
        ``carry``, its initial state, into the entry's carry in place, and a
        live plan that held the entry gets a copy of its own carry in fresh
        buffers and no graphs. On a miss, or where the cached carry's layout
        differs from ``carry``'s, a new entry holding ``carry`` is stored."""
        cache_key, entry = plan_cache_lookup(
            self._obs_kind, target, self._mesh, self._axis, self._fingerprint(),
            fits=lambda cached: _same_layout(cached.carry, carry),
        )
        if entry is None:
            entry = _CaptureEntry(carry)
            plan_cache_store(self._obs_kind, cache_key, target, self._mesh, entry)
        else:
            held = entry.holder()
            if held is not None and held is not self:
                held._entry = _CaptureEntry(held._scratch_carry())
            _copy_leaves_(entry.carry, carry)
        entry.holder = weakref.ref(self)
        self._entry = entry

    def _warm(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` once on the side stream (a warm-up: it builds the hand
        kernels and fills their launch caches), ordered after and before the
        current stream's work; returns what ``fn`` returns."""
        if self._side is None:
            self._side = torch.cuda.Stream(self._device)
        current = torch.cuda.current_stream(self._device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            out = fn()
        current.wait_stream(self._side)
        return out

    def _record(self, fn: Callable[[], None]) -> Any:
        """``fn`` captured as a CUDA graph on the side stream (after its warm-up).

        The cycle collector runs first and is held off during the capture:
        unreachable objects that own CUDA graphs (a plan dropped with a
        reference cycle) would otherwise be finalized inside the capture, and
        destroying a graph there ends the capture with an error."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: a DeviceFeed thread may pin and copy meanwhile
            with torch.cuda.graph(graph, pool=self._pool, stream=self._side, capture_error_mode="thread_local"):
                fn()
        except Exception as err:
            cause = err.__context__ if err.__context__ is not None else err
            raise RuntimeError(
                f"capturing {self._capture_site()} as a CUDA graph failed: {cause}."
                " The step is not run eagerly instead; a host read of a device value inside update"
                " (a value check without _is_concrete, .item(), a numpy upload) cannot be captured"
            ) from err
        finally:
            if collecting:
                gc.enable()
        return graph

    def _capture_site(self) -> str:
        """What was being captured, for the error of a failed capture."""
        raise NotImplementedError

    #: the plan kind of the capture records ("fused", "sliced")
    _obs_kind: str

    def _obs_site(self, body: Callable) -> Dict[str, str]:
        """``key``, ``metric``, ``kind`` and ``span_prefix`` of a capture's
        obs record (:mod:`~torchmetrics_tpu_torch.obs.xla`), JAX's names for
        a plan's step and its scan; asked for only while tracing is on."""
        scan = getattr(body, "__name__", "") == "_chunk"
        return {
            "key": f"{self._fingerprint()}:scan" if scan else self._fingerprint(),
            "metric": self._target_cls,
            "kind": f"{self._obs_kind}_scan" if scan else self._obs_kind,
            "span_prefix": f"{self._obs_kind}.scan" if scan else f"{self._obs_kind}.update",
        }

    def _scratch_carry(self) -> Dict[str, Any]:
        """A copy of the carry in fresh buffers (a warm-up's, a handover's)."""
        raise NotImplementedError

    def _run(self, body: Callable, batch: Tuple[torch.Tensor, ...]) -> None:
        """Run ``body(carry, batch)``: eagerly on the CPU; on the card as a
        replay of the graph captured for this body and input signature."""
        if self._device.type != "cuda":
            body(self._carry, batch)
            return
        key = (body.__name__, tuple((tuple(b.shape), b.dtype) for b in batch))
        captured = self._captured.get(key)
        if captured is None:
            captured = self._captured[key] = self._capture(body, batch)
            if _obs_trace.ENABLED:
                site = self._obs_site(body)
                with _obs_xla.first_step(site["key"], site["metric"], site["span_prefix"]):
                    captured.graph.replay()
                return
        else:
            for dst, src in zip(captured.inputs, batch):
                dst.copy_(src)
        captured.graph.replay()

    def _capture(self, body: Callable, batch: Tuple[torch.Tensor, ...]) -> _Captured:
        """Capture ``body`` on static copies of ``batch``'s buffers, after one
        warm-up run against a scratch copy of the carry (both timed by
        :func:`~torchmetrics_tpu_torch.obs.xla.timed_capture` under tracing)."""
        inputs = tuple(torch.empty(b.shape, dtype=b.dtype, device=self._device) for b in batch)
        for dst, src in zip(inputs, batch):
            dst.copy_(src)
        return self._capture_inputs(lambda carry: body(carry, inputs), inputs, body)

    def _capture_inputs(self, step: Callable[[Dict[str, Any]], None], inputs: Tuple[torch.Tensor, ...], body: Callable) -> _Captured:
        def warm() -> None:
            self._warm(lambda: step(self._scratch_carry()))

        def record() -> Any:
            return self._record(lambda: step(self._carry))

        if not _obs_trace.ENABLED:
            warm()
            return _Captured(record(), inputs)
        graph, _ = _obs_xla.timed_capture(warm, record, **self._obs_site(body))
        return _Captured(graph, inputs)


# ------------------------------------------------------------------- the plan


class FusedCollectionPlan(_GraphCapture):
    """A whole collection's update as one in-place step: one CUDA graph
    replay per batch on the card, the same step eagerly on the CPU.

    ::

        suite = MetricCollection({"acc": ..., "f1": ..., "auroc": ...})
        suite.update(p0, t0); suite.update(p1, t1)   # let compute groups form
        plan = suite.fused()
        for preds, target in stream:
            plan.update(preds, target)               # one replay, N metrics
        plan.run_scan(chunk)                          # or: one replay per chunk
        plan.fold_back()                              # states back in the metrics
        suite.compute()                               # unchanged from here on

    The carry is seeded from COPIES of the members' current states (fusing
    mid-stream or after a checkpoint restore just works) and updated in place.

    Args:
        target: a ``MetricCollection`` (or bare ``Metric``); its members share one device.
        cat_capacity: max TOTAL rows per list ("cat") state; required (with
            ``example_batch``) when any member has list states.
        example_batch: example positional batch; one update on it, from a
            reset state that is restored after, sizes the CatBuffer carries.
        donate: ``True`` (the default): ``plan.state`` is the carry itself,
            rewritten in place by every update ("read, don't hold").
            ``False``: every read of ``plan.state`` returns a copy of the
            carry, which later updates leave unchanged (a copy of every state
            per read).
        mesh/axis_name: build the sharded variant over the ``DeviceMesh``
            dim ``axis_name``: each rank passes its local shard of every
            batch, and every rank's carry holds the whole batch's totals
            (see the module docstring).
    """

    _obs_kind = "fused"

    def __init__(
        self,
        target: Any,
        *,
        cat_capacity: Optional[int] = None,
        example_batch: Optional[Tuple[Any, ...]] = None,
        donate: bool = True,
        mesh: Optional[Any] = None,
        axis_name: str = "data",
    ) -> None:
        from torchmetrics_tpu_torch.collections import MetricCollection

        members, groups = _resolve_members(target)
        report = {k: fusion_ineligibility(m) for k, m in members.items()}
        bad = {k: r for k, r in report.items() if r}
        if bad:
            detail = "; ".join(f"{k}: {r}" for k, r in sorted(bad.items()))
            raise ValueError(f"cannot fuse {type(target).__name__}: {detail}")
        devices = {m.device for m in members.values()}
        if len(devices) != 1:
            raise ValueError(f"cannot fuse {type(target).__name__}: members on several devices {sorted(map(str, devices))}")
        self.members = members
        self.groups = groups
        self._collection = target if isinstance(target, MetricCollection) else None
        self._target_cls = type(target).__name__
        self._device: torch.device = devices.pop()
        self._donate = bool(donate)
        self._cat_capacity = cat_capacity
        self._infos = [_MemberInfo(cg[0], members[cg[0]], cat_capacity, example_batch) for cg in groups]
        self._mesh = mesh
        self._axis = axis_name
        for key, metric in members.items():
            # a carry seeded from a state of the other sync regime would mix
            # rank-local and mesh-replicated updates, which sync cannot tell apart
            if metric._update_count > 0 and metric._mesh_replicated != (mesh is not None) and metric._sync_would_run():
                held = "the whole mesh's (a sharded fold)" if metric._mesh_replicated else "this rank's alone (plain updates)"
                raise TorchMetricsUserError(
                    f"cannot fuse {key!r} ({type(metric).__name__}) {'over a mesh' if mesh is not None else 'without a mesh'}:"
                    f" its state holds {held}, and compute() could not sync the mix. Call reset() first to clear the state."
                )
        if mesh is not None:
            # the sharded carry folds fresh events with tree_merge: a None or
            # callable reduction on an ARRAY state stacks (its shape grows
            # every step), which a fixed-shape carry cannot hold
            for info in self._infos:
                for name, red in info.metric._reductions.items():
                    if name not in info.list_keys and not isinstance(red, str):
                        raise ValueError(
                            f"cannot fuse {info.key!r} ({type(info.metric).__name__}) over a mesh:"
                            f" array state {name!r} declares dist_reduce_fx={red!r}, whose stacking"
                            " fold grows the state per step; fixed-shape carries need a named"
                            " reduction (sum/mean/max/min)"
                        )
        # device telemetry is a BUILD-time decision (obs/device.py)
        self._telemetry_on, self._histogram = _obs_device.config_token()
        self._arity = len(example_batch) if example_batch is not None else max(_update_arity(i.metric) for i in self._infos)
        self._in_member: Optional[str] = None  # the leader whose update the step is running
        ref_target = target if self._collection is not None else self._infos[0].metric
        if _obs_trace.ENABLED:
            with _obs_trace.span(
                "fused.build", metric=self._target_cls, members=len(members), leaders=len(self._infos), sharded=mesh is not None
            ):
                self._adopt(ref_target, self._initial_state())
        else:
            self._adopt(ref_target, self._initial_state())
        if _obs_trace.ENABLED or _obs_live.ENABLED:
            self._note_attribution()

    def _fingerprint(self) -> str:
        """Build identity: group structure, per-leader walk fingerprints, cat
        config, donation, the mesh dim and the telemetry token: the key the
        plan's capture records are filed under."""
        from torchmetrics_tpu_torch.parallel.sharded import _fingerprint_digest, _walk_fingerprint

        return _fingerprint_digest(
            "fused",
            self._target_cls,
            tuple(
                (info.key, type(info.metric).__name__, _walk_fingerprint(info.metric), tuple(info.list_keys))
                for info in self._infos
            ),
            tuple(tuple(cg) for cg in self.groups),
            self._cat_capacity,
            self._donate,
            self._axis if self._mesh is not None else None,
            (self._telemetry_on, self._histogram),
        )

    def _note_attribution(self) -> None:
        """Record the plan's join keys in the cost-attribution registry:
        member names under the COLLECTION row (where the plan's capture
        records land) and under each member's own class row."""
        _obs_attr.note_instances(self._target_cls, list(self.members))
        for key, metric in self.members.items():
            _obs_attr.note_instance(type(metric).__name__, key)

    def _initial_state(self) -> Dict[str, Any]:
        members: Dict[str, Any] = {}
        for info in self._infos:
            metric = info.metric
            slice_: Dict[str, Any] = {}
            for name in metric._defaults:
                value = getattr(metric, name)
                if name in info.list_keys:
                    elem, dtype = info.layout[name]
                    buf = cat_buffer_init(self._cat_capacity, elem, dtype, self._device)
                    if value:  # fusing mid-stream: existing rows seed the buffer
                        _append_(buf, _concat_rows(value).to(dtype))
                    slice_[name] = buf
                else:
                    # copies decouple the carry, written in place from here
                    # on, from the live metric (or a checkpoint in flight)
                    slice_[name] = _copy_tree(value)
            slice_["_update_count"] = torch.tensor(metric._update_count, dtype=torch.int32, device=self._device)
            members[info.key] = slice_
        carry = {"members": members, "_update_count": torch.zeros((), dtype=torch.int32, device=self._device)}
        if self._telemetry_on:
            carry["_telemetry"] = _obs_device.telemetry_init(self._arity, self._histogram, self._device)
        return carry

    # ------------------------------------------------------------------ step
    def _step(self, carry: Dict[str, Any], batch: Tuple[torch.Tensor, ...]) -> None:
        """Apply one batch to ``carry`` in place: every leader updates first,
        then every new state is written back, so a failing update leaves the
        carry as it was."""
        trees = []
        for info in self._infos:
            self._in_member = info.key
            trees.append(_member_update(info, carry["members"][info.key], batch))
        self._in_member = None
        for info, tree in zip(self._infos, trees):
            _write_back(info, carry["members"][info.key], tree)
        if self._telemetry_on:
            _copy_leaves_(carry["_telemetry"], _obs_device.telemetry_update(carry["_telemetry"], batch))
        carry["_update_count"].add_(1)

    def _chunk(self, carry: Dict[str, Any], stacked: Tuple[torch.Tensor, ...]) -> None:
        """Apply every slice of a stacked chunk, in order."""
        for i in range(stacked[0].shape[0]):
            self._step(carry, tuple(s[i] for s in stacked))

    def _fresh_trees(self, batch: Tuple[torch.Tensor, ...]) -> List[Dict[str, Any]]:
        """Every leader's update of ``batch`` from a fresh (default) state."""
        trees = []
        for info in self._infos:
            self._in_member = info.key
            trees.append(_member_update(info, info.metric._defaults, batch))
        self._in_member = None
        return trees

    def _fresh_step(self, fresh: Dict[str, Dict[str, Any]], batch: Tuple[torch.Tensor, ...]) -> None:
        for info, tree in zip(self._infos, self._fresh_trees(batch)):
            _write_fresh(info, fresh[info.key], tree)
        self._fresh_telemetry(fresh, batch)

    def _fresh_telemetry(self, fresh: Dict[str, Any], batch: Tuple[torch.Tensor, ...]) -> None:
        """This rank's telemetry of the batch, into the static ``"_telemetry"``
        buffer (telemetry on): reduced over the mesh with the partials."""
        if self._telemetry_on:
            init = _obs_device.telemetry_init(self._arity, self._histogram, self._device)
            _copy_leaves_(fresh["_telemetry"], _obs_device.telemetry_update(init, batch))

    def _reduce(self, fresh: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
        """The fresh partial states reduced over the mesh dim (collectives;
        outside any graph). Every leader's array states go through one
        ``mesh_reduce_tree``, so states of one op and dtype share one collective."""
        arrays, reductions = {}, {}
        for info in self._infos:
            for k, v in fresh[info.key].items():
                if k not in info.list_keys:
                    arrays[(info.key, k)] = v
                    reductions[(info.key, k)] = info.metric._reductions[k]
        reduced = mesh_reduce_tree(reductions, arrays, self._axis, mesh=self._mesh)
        out: Dict[str, Dict[str, Any]] = {info.key: {} for info in self._infos}
        for (key, name), value in reduced.items():
            out[key][name] = value
        for info in self._infos:
            for k in info.list_keys:
                out[info.key][k] = cat_buffer_all_gather(fresh[info.key][k], self._axis, mesh=self._mesh)
        if self._telemetry_on:
            out["_telemetry"] = _obs_device.telemetry_mesh_reduce(fresh["_telemetry"], self._axis, mesh=self._mesh)
        return out

    def _fold_step(self, carry: Dict[str, Any], reduced: Dict[str, Dict[str, Any]]) -> None:
        for info in self._infos:
            _fold_reduced(info, carry["members"][info.key], reduced[info.key])
        if self._telemetry_on:
            _copy_leaves_(carry["_telemetry"], _obs_device.telemetry_merge(carry["_telemetry"], reduced["_telemetry"]))
        carry["_update_count"].add_(1)

    def _run_sharded(self, batch: Tuple[torch.Tensor, ...]) -> None:
        """One batch through the sharded plan: fresh partials (a graph replay
        on the card), the collectives, the fold (a second replay)."""
        key = tuple((tuple(b.shape), b.dtype) for b in batch)
        step = self._sharded.get(key)
        if step is None:
            self._sharded[key] = self._build_sharded(batch)
            return  # the build ran this batch
        for dst, src in zip(step.inputs, batch):
            dst.copy_(src)
        if step.fresh_graph is None:
            self._fresh_step(step.fresh, step.inputs)
            self._fold_step(self._carry, self._reduce(step.fresh))
            return
        step.fresh_graph.replay()
        for name, part in self._reduce(step.fresh).items():
            _copy_leaves_(step.reduced[name], part)
        step.fold_graph.replay()

    def _build_sharded(self, batch: Tuple[torch.Tensor, ...]) -> _ShardedStep:
        """Allocate the static buffers of a new input signature, sized by one
        fresh update (the warm-up on the card), and run ``batch`` through
        them; on the card capture the fresh and the fold graphs on the way."""
        cuda = self._device.type == "cuda"
        inputs = tuple(b.to(self._device, copy=True) for b in batch)
        trees = self._warm(lambda: self._fresh_trees(inputs)) if cuda else self._fresh_trees(inputs)
        fresh = {info.key: _fresh_buffers(info, tree, self._device) for info, tree in zip(self._infos, trees)}
        if self._telemetry_on:
            fresh["_telemetry"] = _obs_device.telemetry_init(self._arity, self._histogram, self._device)
        if not cuda:
            for info, tree in zip(self._infos, trees):
                _write_fresh(info, fresh[info.key], tree)
            self._fresh_telemetry(fresh, inputs)
            self._fold_step(self._carry, self._reduce(fresh))
            return _ShardedStep(inputs, fresh, {}, None, None)
        fresh_graph = self._record(lambda: self._fresh_step(fresh, inputs))
        fresh_graph.replay()
        reduced = {key: _copy_tree(part) for key, part in self._reduce(fresh).items()}
        self._warm(lambda: self._fold_step(_copy_tree(self._carry), reduced))
        fold_graph = self._record(lambda: self._fold_step(self._carry, reduced))
        fold_graph.replay()
        return _ShardedStep(inputs, fresh, reduced, fresh_graph, fold_graph)

    def _scratch_carry(self) -> Dict[str, Any]:
        return _copy_tree(self._carry)

    def _record(self, fn: Callable[[], None]) -> Any:
        try:
            return super()._record(fn)
        finally:
            self._in_member = None

    def _capture_site(self) -> str:
        where = self._in_member
        call = f"member {where!r} ({type(self.members[where]).__name__}.update)" if where else "the carry's write-back"
        return f"the fused step of {self._target_cls} in {call}"

    # ------------------------------------------------------------------ drive
    @property
    def state(self) -> Dict[str, Any]:
        """The state carry. With ``donate=True`` (the default) the carry itself,
        which the next ``update``/``run_scan`` rewrites in place: read, don't
        hold. With ``donate=False`` a copy that later updates leave alone."""
        return self._carry if self._donate else _copy_tree(self._carry)

    @property
    def updates_applied(self) -> int:
        """Fused steps applied since the plan was built (reads the device)."""
        return int(self._carry["_update_count"])

    def update(self, *batch: Any) -> None:
        """Apply one batch: one graph replay for the whole collection on the
        card (two around the collectives for a sharded plan, whose ``batch``
        is this rank's shard)."""
        batch = tuple(_as_input(b) for b in batch)
        if self._mesh is not None:
            self._run_sharded(batch)
        else:
            self._run(self._step, batch)

    def run_scan(self, batches: Any) -> None:
        """Push a chunk of batches through the step: on the card one replay of
        a graph captured for the chunk's length and signature (a sharded plan
        takes the chunk's batches one by one). ``batches`` is a sequence of
        positional batch tuples (stacked here) or an already stacked tuple of
        tensors whose leading axis is the chunk."""
        stacked = self.stage(batches)
        if self._mesh is not None:
            for i in range(stacked[0].shape[0]):
                self._run_sharded(tuple(s[i] for s in stacked))
        else:
            self._run(self._chunk, stacked)

    def run_stream(self, batches: Iterable[Any], prefetch: int = 2) -> None:
        """Drive an iterable of host batches through the double-buffered
        device feed: staging batch k+1 overlaps the step on batch k (see
        :mod:`torchmetrics_tpu_torch.parallel.feed`)."""
        from torchmetrics_tpu_torch.parallel.feed import DeviceFeed

        for batch in DeviceFeed(batches, device=self._device, depth=prefetch):
            if isinstance(batch, tuple):
                self.update(*batch)
            else:
                self.update(batch)

    def stage(self, batches: Any) -> Tuple[torch.Tensor, ...]:
        """Stack a sequence of batch tuples into chunk tensors on the plan's
        device (one copy per input), or take an already stacked tuple there."""
        return _stage(batches, self._device)

    # -------------------------------------------------------------- fold-back
    def fold_back(self) -> None:
        """Install the carried totals back into the member metrics.

        Call at snapshot/compute boundaries, never per batch: it reads the
        device. Leaders get their exact state tree (CatBuffers fold to list
        states, raising on overflow; the update count restores as
        ``init + fused steps``); compute-group members resync counts and ride
        the collection's state-ref propagation at the next ``compute()``.
        Idempotent: folding twice installs the same totals. The carry stays
        valid: keep updating and fold again later. Installed values are
        COPIES, so the next in-place step cannot change state the metrics
        now hold.
        """
        for info in self._infos:
            metric = info.metric
            mstate = self._carry["members"][info.key]
            tree: Dict[str, Any] = {}
            for name in metric._defaults:
                if name in info.list_keys:
                    tree[name] = [cat_buffer_values(mstate[name])]  # raises on overflow
                else:
                    tree[name] = mstate[name]
            tree["_update_count"] = int(mstate["_update_count"])
            metric.load_state_tree(tree)  # installs copies
            metric._computed = None
        telemetry = self._carry.get("_telemetry")
        if telemetry is not None and int(self._carry["_update_count"]) > 0:
            # one carry for the whole collection (members saw the same
            # batches): every leader's pending slot accumulates a copy, and
            # the carry restarts empty, in place
            for info in self._infos:
                _obs_device.accumulate(info.metric, _copy_tree(telemetry), self._histogram)
            _copy_leaves_(telemetry, _obs_device.telemetry_init(self._arity, self._histogram, self._device))
        for cg in self.groups:
            leader = self.members[cg[0]]
            for key in cg[1:]:
                member = self.members[key]
                member._update_count = leader._update_count
                member._computed = None
        if self._mesh is not None:
            # the totals cover every rank's shards: compute() must not sync them again
            for member in self.members.values():
                member._mesh_replicated = True
        if self._collection is not None:
            # members hold (or will lazily receive) leader state: the same
            # post-update invariant MetricCollection.update leaves behind
            self._collection._state_is_copy = False
        if _obs_trace.ENABLED or _obs_live.ENABLED:
            self._note_attribution()
            for info in self._infos:
                _obs_attr.metric_boundary(info.metric)


# ------------------------------------------------------- the one-metric step


class JitUpdateStep(_GraphCapture):
    """``step(state, *batch) -> state`` of ``parallel.sharded.make_jit_update``.

    One batch: the metric's update from a fresh state, merged into ``state``
    with :func:`~torchmetrics_tpu_torch.parallel.sharded.tree_merge`
    (``"mean"`` states weighted by the carried ``"_update_count"``), list
    states appended to their CatBuffers. The step keeps a carry of its own;
    a ``state`` that is not that carry is copied into it first. On the card
    the first call of an input signature runs eagerly; the second captures
    the step as a CUDA graph (after a warm-up against a scratch copy of the
    carry) and every later one replays it. On the CPU every call runs eagerly.

    ``donate=False`` returns a copy of the carry, which later calls leave
    unchanged. ``donate=True`` returns the carry itself and a later call
    given that dict updates it in place: the caller's old dict then aliases
    the new state (XLA would instead invalidate the donated buffers).

    ``telemetry`` (the build's :func:`~torchmetrics_tpu_torch.obs.device.config_token`):
    with it on, the carry's ``"_telemetry"`` state folds each batch's inputs
    in place, inside the graph.
    """

    def __init__(self, metric: Any, list_keys: List[str], donate: bool, telemetry: Tuple = (False, None)) -> None:
        self.metric = metric
        self.list_keys = list_keys
        self._device = metric.device
        self._donate = donate
        self._telemetry_on = telemetry[0]
        self._telemetry_token = telemetry
        self._reductions = {k: r for k, r in metric._reductions.items() if k not in list_keys}
        self._entry = _CaptureEntry(None)  # not cached: the carry is made at the first call
        self._seen: set = set()

    def _body(self, carry: Dict[str, Any], batch: Tuple[torch.Tensor, ...]) -> None:
        metric = self.metric
        with metric._scratch():
            metric.reset()
            with _fused_step():
                metric.update(*batch)
            fresh = metric.state_tree()
        for k in self.list_keys:
            if fresh[k]:
                _append_(carry[k], _concat_rows(fresh[k]).to(carry[k].data.dtype))
        count = carry["_update_count"]
        arrays = {k: carry[k] for k in self._reductions}
        merged = tree_merge(self._reductions, arrays, {k: fresh[k] for k in arrays}, weight_a=count, weight_b=1)
        for k, value in merged.items():
            _check_kept(type(metric).__name__, k, carry[k], value, "in an update")
            _copy_leaves_(carry[k], value)
        if self._telemetry_on:
            _copy_leaves_(carry["_telemetry"], _obs_device.telemetry_update(carry["_telemetry"], batch))
        count.add_(1)

    def _capture_site(self) -> str:
        return f"the update step of {type(self.metric).__name__} (make_jit_update)"

    def _obs_site(self, body: Callable) -> Dict[str, str]:
        from torchmetrics_tpu_torch.parallel.sharded import _fingerprint_digest, _walk_fingerprint

        name = type(self.metric).__name__
        key = _fingerprint_digest("jit_update", name, _walk_fingerprint(self.metric), self._telemetry_on, self._donate)
        return {"key": key, "metric": name, "kind": "jit_update", "span_prefix": "parallel.jit_update"}

    def _scratch_carry(self) -> Dict[str, Any]:
        return _copy_tree(self._carry)

    def __call__(self, state: Dict[str, Any], *batch: Any) -> Dict[str, Any]:
        batch = tuple(_as_input(b).to(self._device) for b in batch)
        if self._carry is None:
            self._carry = _copy_tree(state)
        elif state is not self._carry:
            for k, v in state.items():
                _copy_leaves_(self._carry[k], v)
        carry = self._carry
        key = tuple((tuple(b.shape), b.dtype) for b in batch)
        if self._device.type != "cuda" or key not in self._seen:
            self._seen.add(key)
            self._body(carry, batch)
        else:
            captured = self._captured.get(key)
            if captured is None:
                inputs = tuple(b.clone() for b in batch)
                captured = self._captured[key] = self._capture_inputs(lambda c: self._body(c, inputs), inputs, self._body)
                if _obs_trace.ENABLED:
                    site = self._obs_site(self._body)
                    with _obs_xla.first_step(site["key"], site["metric"], site["span_prefix"]):
                        captured.graph.replay()
                    return carry if self._donate else _copy_tree(carry)
            else:
                for dst, src in zip(captured.inputs, batch):
                    dst.copy_(src)
            captured.graph.replay()
        return carry if self._donate else _copy_tree(carry)
