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

Not ported yet (ROADMAP): the sharded variant (``mesh=``, A6); obs spans,
device telemetry and cost attribution (A12); sketch ``"merge"`` members
(A9, refused by ``Metric.add_state``); the cross-plan compiled-step cache.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.parallel.cat_buffer import (
    CatBuffer,
    _append_,
    _copy,
    cat_buffer_init,
    cat_buffer_values,
    infer_cat_layout,
)

__all__ = ["FusedCollectionPlan", "fusion_ineligibility", "fusion_report"]

_POSITIONAL_KINDS = (
    inspect.Parameter.POSITIONAL_ONLY,
    inspect.Parameter.POSITIONAL_OR_KEYWORD,
    inspect.Parameter.VAR_POSITIONAL,
)


# ---------------------------------------------------------------- eligibility


def _walk_metrics(metric: Any) -> List[Tuple[str, Any]]:
    """Depth-first ``[(path, metric), ...]`` over ``metric`` and every Metric
    reachable through its attributes, held directly or inside nested
    list/tuple/dict values (a copy of ``parallel/sharded.py::_walk_metrics``
    of the JAX package, without its set check: fusion only asks whether a
    metric has children)."""
    from torchmetrics_tpu_torch.metric import Metric

    def find(seg: str, val: Any, found: list, visiting: set) -> None:
        if isinstance(val, Metric):
            found.append((seg, val))
        elif isinstance(val, (list, tuple, dict)):
            if id(val) in visiting:  # self-referential container
                return
            visiting.add(id(val))
            items = val.items() if isinstance(val, dict) else enumerate(val)
            for k, v in items:
                find(f"{seg}[{k}]", v, found, visiting)

    seen = {id(metric)}
    out = [("", metric)]
    stack = [("", metric)]
    while stack:
        path, m = stack.pop()
        for attr, val in vars(m).items():
            found: list = []
            find(attr, val, found, set())
            for seg, child in found:
                if id(child) in seen:
                    continue
                seen.add(id(child))
                child_path = f"{path}/{seg}" if path else seg
                out.append((child_path, child))
                stack.append((child_path, child))
    return out


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
    """Deep copy of a state carry (CatBuffers with their spare row)."""
    if isinstance(tree, CatBuffer):
        return _copy(tree)
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree.clone()


def _concat_rows(appended: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([torch.atleast_1d(x) for x in appended])


def _as_input(x: Any) -> torch.Tensor:
    """A batch argument as a tensor, where it lies (numpy arrays on the host)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


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
    installed empty, so the tree holds what this batch appends."""
    metric = info.metric
    saved = metric._copy_state_dict()
    saved_count, saved_computed = metric._update_count, metric._computed
    try:
        install = {k: v for k, v in mstate.items() if k not in info.list_keys and k != "_update_count"}
        for k in info.list_keys:
            install[k] = []
        metric._install_state_tree(install)
        metric._computed = None
        metric.update(*batch)
        return metric.state_tree()
    finally:
        metric._install_state_tree(saved)  # self-snapshot: trusted
        metric._update_count = saved_count
        metric._computed = saved_computed


def _write_back(info: _MemberInfo, mstate: Dict[str, Any], tree: Dict[str, Any]) -> None:
    """Write one leader's new state tree into its carry, in place."""
    for name, value in tree.items():
        carried = mstate[name]
        if name in info.list_keys:
            if value:
                _append_(carried, _concat_rows(value).to(carried.data.dtype))
        elif value is not carried:
            if value.shape != carried.shape or value.dtype != carried.dtype:
                raise ValueError(
                    f"member {info.key!r}: state {name!r} changed from {tuple(carried.shape)} {carried.dtype}"
                    f" to {tuple(value.shape)} {value.dtype} in an update; a fused carry keeps its shape and dtype"
                )
            carried.copy_(value)
    mstate["_update_count"].add_(1)


class _Captured(NamedTuple):
    """A captured step: its graph and static inputs."""

    graph: Any  # torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]


# ------------------------------------------------------------------- the plan


class FusedCollectionPlan:
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
        mesh/axis_name: the sharded variant; not ported yet (ROADMAP A6).
    """

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

        if mesh is not None:
            raise NotImplementedError(
                f"the sharded fused plan (mesh=..., axis_name={axis_name!r}) is not ported yet: ROADMAP A6 (distributed sync)"
            )
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
        self._carry = self._initial_state()
        self._captured: Dict[Any, _Captured] = {}
        self._pool: Any = None
        self._in_member: Optional[str] = None  # the leader whose update the step is running

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
                    slice_[name] = value.clone()
            slice_["_update_count"] = torch.tensor(metric._update_count, dtype=torch.int32, device=self._device)
            members[info.key] = slice_
        return {"members": members, "_update_count": torch.zeros((), dtype=torch.int32, device=self._device)}

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
        carry["_update_count"].add_(1)

    def _chunk(self, carry: Dict[str, Any], stacked: Tuple[torch.Tensor, ...]) -> None:
        """Apply every slice of a stacked chunk, in order."""
        for i in range(stacked[0].shape[0]):
            self._step(carry, tuple(s[i] for s in stacked))

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
        for dst, src in zip(captured.inputs, batch):
            dst.copy_(src)
        captured.graph.replay()

    def _capture(self, body: Callable, batch: Tuple[torch.Tensor, ...]) -> _Captured:
        """Capture ``body`` on static copies of ``batch``'s buffers, after one
        warm-up run against a scratch copy of the carry."""
        inputs = tuple(torch.empty(b.shape, dtype=b.dtype, device=self._device) for b in batch)
        for dst, src in zip(inputs, batch):
            dst.copy_(src)
        current = torch.cuda.current_stream(self._device)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            body(_copy_tree(self._carry), inputs)
        current.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: a DeviceFeed thread may pin and copy meanwhile
            with torch.cuda.graph(graph, pool=self._pool, stream=side, capture_error_mode="thread_local"):
                body(self._carry, inputs)
        except Exception as err:
            where = self._in_member
            call = f"member {where!r} ({type(self.members[where]).__name__}.update)" if where else "the carry's write-back"
            cause = err.__context__ if err.__context__ is not None else err
            raise RuntimeError(
                f"capturing the fused step of {self._target_cls} as a CUDA graph failed in {call}: {cause}."
                " The plan does not run the step eagerly instead; a host read of a device value inside update"
                " (a value check without _is_concrete, .item(), a numpy upload) cannot be captured"
            ) from err
        finally:
            self._in_member = None
        return _Captured(graph, inputs)

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
        """Apply one batch: one graph replay for the whole collection on the card."""
        self._run(self._step, tuple(_as_input(b) for b in batch))

    def run_scan(self, batches: Any) -> None:
        """Push a chunk of batches through the step: on the card one replay of
        a graph captured for the chunk's length and signature. ``batches`` is
        a sequence of positional batch tuples (stacked here) or an already
        stacked tuple of tensors whose leading axis is the chunk."""
        self._run(self._chunk, self.stage(batches))

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
        if isinstance(batches, tuple):
            stacked = [_as_input(b) for b in batches]
        else:
            seq = [b if isinstance(b, tuple) else (b,) for b in batches]
            if not seq:
                raise ValueError("run_scan needs at least one batch")
            stacked = [torch.stack([_as_input(b[i]) for b in seq]) for i in range(len(seq[0]))]
        return tuple(s.to(self._device) for s in stacked)

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
        for cg in self.groups:
            leader = self.members[cg[0]]
            for key in cg[1:]:
                member = self.members[key]
                member._update_count = leader._update_count
                member._computed = None
        if self._collection is not None:
            # members hold (or will lazily receive) leader state: the same
            # post-update invariant MetricCollection.update leaves behind
            self._collection._state_is_copy = False
