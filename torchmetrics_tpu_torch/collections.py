# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""``MetricCollection``: a dict of metrics with one call signature and
compute-group deduplication (counterpart of ``torchmetrics_tpu/collections.py``).

Compute groups dedupe metrics whose ``update`` writes identical states: only
the group leader updates, and the leader's state is copied into the members
right before they are computed or inspected. Groups are found by
observation, as in the JAX package: candidates are bucketed by their state
specs (names, kinds, shapes, dtypes, reductions), compared by value, and
merged only when the partitions seen at two separate updates agree. A
metric that wraps other metrics never joins a group: its own states (a
``MinMaxMetric``'s bounds) say nothing about its children's.

``MetricCollection.sliced`` fans the whole collection out over cohort cells
(:class:`~torchmetrics_tpu_torch.parallel.sliced.SlicedPlan`).
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import _flatten_dict, allclose
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn


def _rebuild_collection(cls, raw_metrics, attrs):
    obj = cls.__new__(cls)
    obj.__dict__.update(attrs)
    for k, v in raw_metrics.items():
        dict.__setitem__(obj, k, v)
    return obj


class MetricCollection(dict):
    """A dict of metrics updated/computed with a single call."""

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
    ) -> None:
        super().__init__()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._enable_compute_groups = compute_groups
        self._groups_checked: bool = False
        self._pending_groups: Optional[Dict[int, List[str]]] = None
        self._state_is_copy: bool = False
        self._groups: Dict[int, List[str]] = {}
        self.add_metrics(metrics, *additional_metrics)

    # --------------------------------------------------------------- plumbing
    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def __getitem__(self, key: str, copy_state: bool = True) -> Metric:
        if copy_state:
            self._compute_groups_create_state_ref(copy=True)
        if self.prefix:
            key = key.removeprefix(self.prefix)
        if self.postfix:
            key = key.removesuffix(self.postfix)
        return dict.__getitem__(self, key)

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __reduce__(self):
        # dict-subclass pickling would go through the overridden (prefixed)
        # ``items``; rebuild from the raw keys instead (pickle AND deepcopy)
        raw = {k: dict.__getitem__(self, k) for k in dict.keys(self)}
        return (_rebuild_collection, (self.__class__, raw, dict(self.__dict__)))

    def __repr__(self) -> str:
        repr_str = self.__class__.__name__ + "("
        if self.prefix:
            repr_str += f"\n  prefix={self.prefix}"
        if self.postfix:
            repr_str += f"\n  postfix={self.postfix}"
        for k in sorted(dict.keys(self)):
            repr_str += f"\n  ({k}): {dict.__getitem__(self, k)!r}"
        return repr_str + "\n)"

    # ------------------------------------------------------------ add metrics
    def add_metrics(self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric) -> None:
        """Add new metrics to the collection; grouping starts over."""
        # members of established groups hold stale state (they skip
        # leader-only updates): sync them from their leaders first
        self._compute_groups_create_state_ref(copy=True)
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                rank_zero_warn(f"You have passes extra arguments {remain} which are not `Metric` so they will be ignored.")
        elif additional_metrics:
            raise ValueError(
                f"You have passes extra arguments {additional_metrics} which are not compatible with first passed dictionary."
            )
        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of `Metric` or `MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    dict.__setitem__(self, name, metric)
                else:
                    for k, v in metric.items(keep_base=False):
                        dict.__setitem__(self, f"{name}_{k}", v)
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(f"Input {metric} to `MetricCollection` is not a instance of `Metric` or `MetricCollection`")
                if isinstance(metric, Metric):
                    name = metric.__class__.__name__
                    if dict.__contains__(self, name):
                        raise ValueError(f"Encountered two metrics both named {name}")
                    dict.__setitem__(self, name, metric)
                else:
                    for k, v in metric.items(keep_base=False):
                        dict.__setitem__(self, k, v)
        else:
            raise ValueError("Unknown input to MetricCollection.")
        self._groups_checked = False
        self._pending_groups = None
        if self._enable_compute_groups:
            self._init_compute_groups()
        else:
            self._groups = {}

    def _init_compute_groups(self) -> None:
        """User-specified groups are trusted; otherwise every metric starts in
        its own group and groups merge after two updates agree."""
        if isinstance(self._enable_compute_groups, list):
            self._groups = dict(enumerate(self._enable_compute_groups))
            for v in self._groups.values():
                for metric in v:
                    if not dict.__contains__(self, metric):
                        raise ValueError(
                            f"Input {metric} in `compute_groups` argument does not match a metric in the collection."
                        )
            self._groups_checked = True
        else:
            self._groups = {i: [str(k)] for i, k in enumerate(sorted(dict.keys(self)))}

    # ---------------------------------------------------------------- update
    @property
    def _base_metrics(self) -> Dict[str, Metric]:
        return {k: dict.__getitem__(self, k) for k in sorted(dict.keys(self))}

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update each metric; only group leaders update once groups are formed."""
        if self._state_is_copy:
            self._compute_groups_create_state_ref(copy=False)
            self._state_is_copy = False
        if self._enable_compute_groups and self._groups_checked:
            for cg in self._groups.values():
                m0 = dict.__getitem__(self, cg[0])
                m0.update(*args, **m0._filter_kwargs(**kwargs))
                for k in cg[1:]:
                    m = dict.__getitem__(self, k)
                    m._update_count = m0._update_count
                    m._computed = None
        else:
            for m in self._base_metrics.values():
                m.update(*args, **m._filter_kwargs(**kwargs))
            if self._enable_compute_groups and not self._groups_checked:
                # merge only when TWO separate update events agree on which
                # metrics hold identical states (the intersection survives
                # reset(), so update/compute/reset loops still group)
                current = self._value_groups()
                if self._pending_groups is None:
                    self._pending_groups = current
                else:
                    self._groups = self._intersect_groups(self._pending_groups, current)
                    self._pending_groups = None
                    self._groups_checked = True

    def _value_groups(self) -> Dict[int, List[str]]:
        """Partition the metrics by current state equality, candidates
        pre-bucketed by state-spec signature."""
        groups: List[List[str]] = []
        reps: Dict[tuple, List[int]] = {}
        for key in sorted(dict.keys(self)):
            metric = dict.__getitem__(self, key)
            sig = self._state_spec_signature(metric)
            for gi in reps.get(sig, []):
                if self._equal_metric_states(dict.__getitem__(self, groups[gi][0]), metric):
                    groups[gi].append(key)
                    break
            else:
                reps.setdefault(sig, []).append(len(groups))
                groups.append([key])
        return dict(enumerate(groups))

    @staticmethod
    def _intersect_groups(g1: Dict[int, List[str]], g2: Dict[int, List[str]]) -> Dict[int, List[str]]:
        """Coarsest common refinement: metrics stay grouped only if BOTH partitions co-grouped them."""
        label1 = {k: i for i, members in g1.items() for k in members}
        label2 = {k: i for i, members in g2.items() for k in members}
        buckets: Dict[tuple, List[str]] = {}
        for k in sorted(label1):
            buckets.setdefault((label1[k], label2.get(k)), []).append(k)
        return dict(enumerate(buckets.values()))

    @staticmethod
    def _state_spec_signature(metric: Metric) -> tuple:
        """Hashable (name, kind, shape, dtype, reduction) spec of a metric's current states."""
        parts = []
        for key in sorted(metric._defaults):
            val = getattr(metric, key)
            red = metric._reductions.get(key)
            red_tok = red if isinstance(red, (str, type(None))) else getattr(red, "__name__", repr(red))
            if isinstance(val, list):
                parts.append((key, "list", tuple((tuple(v.shape), str(v.dtype)) for v in val), red_tok))
            else:
                parts.append((key, "array", tuple(val.shape), str(val.dtype), red_tok))
        return tuple(parts)

    @staticmethod
    def _equal_metric_states(metric1: Metric, metric2: Metric) -> bool:
        """True when two metrics have identical state values.

        False for a metric that wraps others: two ``MinMaxMetric`` over
        different bases hold equal bounds until their first compute, and a
        group would then feed the batches to the leader's base alone (the
        JAX package's ``collections.py:300-328`` does so; the reference's
        wrappers hold no states of their own, so they never group).
        """
        from torchmetrics_tpu_torch.parallel.sharded import _walk_metrics

        if not metric1._defaults or not metric2._defaults:
            return False
        if len(_walk_metrics(metric1)) > 1 or len(_walk_metrics(metric2)) > 1:
            return False
        if metric1._defaults.keys() != metric2._defaults.keys():
            return False
        for key in metric1._defaults:
            state1 = getattr(metric1, key)
            state2 = getattr(metric2, key)
            if type(state1) != type(state2):  # noqa: E721
                return False
            if isinstance(state1, list):
                if len(state1) != len(state2) or not all(allclose(s1, s2) for s1, s2 in zip(state1, state2)):
                    return False
            elif not allclose(state1, state2):
                return False
        return True

    def _compute_groups_create_state_ref(self, copy: bool = False) -> None:
        """Copy each leader's state into its group members."""
        if self._groups_checked:
            for cg in self._groups.values():
                m0 = dict.__getitem__(self, cg[0])
                for k in cg[1:]:
                    mi = dict.__getitem__(self, k)
                    mi.load_state_tree(m0._copy_state_dict())
                    mi._update_count = m0._update_count
        self._state_is_copy = copy

    # ------------------------------------------------------------- fwd/compute
    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Call forward on each metric (compute groups do not apply)."""
        res = {k: m(*args, **m._filter_kwargs(**kwargs)) for k, m in self._base_metrics.items()}
        res = _flatten_dict(res)[0]
        return {self._set_name(k): v for k, v in res.items()}

    def __call__(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return self.forward(*args, **kwargs)

    def compute(self) -> Dict[str, Any]:
        """Compute every metric and flatten the results."""
        self._compute_groups_create_state_ref()
        result = {k: m.compute() for k, m in self._base_metrics.items()}
        _, duplicates = _flatten_dict(result)
        flattened_results = {}
        for k, res in result.items():
            if isinstance(res, dict):
                for sub_k, sub_v in res.items():
                    flattened_results[f"{k}_{sub_k}" if duplicates else sub_k] = sub_v
            else:
                flattened_results[k] = res
        return {self._set_name(k): v for k, v in flattened_results.items()}

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def reset(self) -> None:
        """Reset all metrics; observed group evidence survives."""
        for m in self._base_metrics.values():
            m.reset()
        if self._enable_compute_groups and self._groups_checked:
            self._state_is_copy = False

    def fused(
        self,
        *,
        cat_capacity: Optional[int] = None,
        example_batch: Optional[Tuple[Any, ...]] = None,
        donate: bool = True,
        mesh: Optional[Any] = None,
        axis_name: str = "data",
    ) -> Any:
        """This collection's whole update as ONE step, updated in place.

        Returns a :class:`~torchmetrics_tpu_torch.parallel.fused.FusedCollectionPlan`:
        on the card its ``update(*batch)`` is one replay of a captured CUDA
        graph however many metrics are attached (compute-group leaders run;
        members keep riding the state-ref propagation), ``run_scan`` replays
        one graph per chunk of batches, and ``fold_back()`` puts the totals
        back into the members so ``compute()`` and checkpointing are
        unchanged; on the CPU the same step runs eagerly::

            suite.update(p, t); suite.update(p, t)   # let groups form
            plan = suite.fused()
            for batch in stream:
                plan.update(*batch)
            plan.fold_back()
            values = suite.compute()

        ``cat_capacity``/``example_batch`` are required when any member has
        list ("cat") states (they become fixed-capacity CatBuffer carries).
        ``mesh``/``axis_name`` build the sharded variant over a
        ``torch.distributed`` ``DeviceMesh`` dim: every rank drives the plan
        with its local shard of each batch and every rank's carry holds the
        whole batch's totals (see :mod:`~torchmetrics_tpu_torch.parallel.fused`).
        Fusion-ineligible members raise with a per-member report; see
        :func:`~torchmetrics_tpu_torch.parallel.fused.fusion_report`.
        """
        from torchmetrics_tpu_torch.parallel.fused import FusedCollectionPlan

        return FusedCollectionPlan(
            self,
            cat_capacity=cat_capacity,
            example_batch=example_batch,
            donate=donate,
            mesh=mesh,
            axis_name=axis_name,
        )

    def sliced(self, *, num_cells: int, **kwargs: Any) -> Any:
        """Fan the whole collection out over cohort cells: ONE step per batch
        updates every member for every cohort (compute-group leaders run;
        members ride the group assignment, as with :meth:`fused`). Let the
        compute groups form first (two eager updates), then ``reset()`` — the
        collection must be a pristine per-cell TEMPLATE when the plan builds.
        See :class:`~torchmetrics_tpu_torch.parallel.sliced.SlicedPlan`::

            plan = suite.sliced(num_cells=1024)
            plan.update(cohort_ids, preds, target)
            per_cohort = plan.results()    # {(cohort,): {member: value}}
        """
        from torchmetrics_tpu_torch.parallel.sliced import SlicedPlan

        return SlicedPlan(self, num_cells=num_cells, **kwargs)

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        """Deep copy with optional new prefix/postfix."""
        mc = deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        for m in self._base_metrics.values():
            m.persistent(mode)

    # -------------------------------------------------------------- dict API
    def keys(self, keep_base: bool = False):  # type: ignore[override]
        if keep_base:
            return sorted(dict.keys(self))
        return [self._set_name(k) for k in sorted(dict.keys(self))]

    def items(self, keep_base: bool = False, copy_state: bool = True):  # type: ignore[override]
        """(name, metric) pairs; group state is propagated first."""
        if copy_state:
            self._compute_groups_create_state_ref(copy=True)
        if keep_base:
            return [(k, dict.__getitem__(self, k)) for k in sorted(dict.keys(self))]
        return [(self._set_name(k), dict.__getitem__(self, k)) for k in sorted(dict.keys(self))]

    def values(self, copy_state: bool = True):  # type: ignore[override]
        if copy_state:
            self._compute_groups_create_state_ref(copy=True)
        return [dict.__getitem__(self, k) for k in sorted(dict.keys(self))]

    # ---------------------------------------------------------- serialization
    def state_dict(self) -> Dict[str, Any]:
        self._compute_groups_create_state_ref(copy=True)
        destination: Dict[str, Any] = {}
        for k, m in self._base_metrics.items():
            m.state_dict(destination=destination, prefix=f"{k}.")
        return destination

    def load_state_dict(self, state_dict: Dict[str, Any], strict: bool = True) -> None:
        for k, m in self._base_metrics.items():
            m.load_state_dict(state_dict, strict=strict, prefix=f"{k}.")

    def set_dtype(self, dst_type: torch.dtype) -> "MetricCollection":
        """Cast every member's floating states to ``dst_type`` (``Metric.set_dtype``)."""
        for m in self._base_metrics.values():
            m.set_dtype(dst_type)
        return self

    def to(self, device) -> "MetricCollection":
        for m in self._base_metrics.values():
            m.to(device)
        return self

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        """Current compute-group assignment."""
        return self._groups

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None, together: bool = False) -> Any:
        """Plot every metric of the collection, one figure each, or all values together."""
        from torchmetrics_tpu_torch.utilities.plot import _get_plt, plot_single_or_multi_val

        _get_plt()
        if together:
            val = val or self.compute()
            return [plot_single_or_multi_val(val, ax=ax)]
        vals = val or self.compute()
        figaxs = []
        for k, m in self.items(copy_state=True):
            f, a = m.plot(vals[k] if isinstance(vals, dict) else None)
            figaxs.append((f, a))
        return figaxs
