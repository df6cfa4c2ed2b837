# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""StateGuard: input sanitization and poison detection inside the update step
(counterpart of ``torchmetrics_tpu/robustness/guard.py``).

Eager host validation (``_input_validation``) reads the batch back to the
host, which a captured step (``suite.fused()``, ``make_jit_update``, a
``SlicedPlan``) cannot afford: one NaN/Inf or out-of-range label in a single
``update()`` batch silently poisons an elementwise state forever. This module
runs each family's **domain contract** (finite, probs in [0, 1], labels <
num_classes) inside the update as fixed-shape device masks, under one of three
policies:

``propagate``
    The batch is applied untouched; the guard only counts invalid rows and
    latches the poison probe if a state goes non-finite.
``mask``
    Only valid rows are accumulated: the sliced plane's cell fold with one
    cell, invalid rows spilled. A member whose update has a kernel route
    (``_sliced_fresh_states``: K2s for ``MulticlassStatScores``, K1s for the
    binned curves) takes it with ``cells = where(invalid_row, -1, 0)`` and
    ``num_cells = 1``, so the hand kernels drop the invalid rows; any other
    member folds one fresh update per row (``parallel/sliced.py::_row_states``,
    ``torch.func.vmap``) with ``_segment_reduce``. Invalid rows are counted,
    never applied.
``reject``
    Whole-batch veto: the candidate state is computed, then every leaf is
    ``where(batch_ok, new, old)``-selected, so an invalid batch leaves the
    state bitwise untouched.

Every check is a fixed-shape device reduction and every choice a device
select (``where(batch_ok, new, old)``, ``where(any_valid, merged, saved)``):
nothing reads the device from the host, so a guarded update captures into a
CUDA graph like any other. The verdict counters ride the metric's own state
registry (``guard_*`` states registered with ``add_state``), so they
checkpoint, sync, fold and slice like any other state, and the registry
fingerprint equals the JAX package's for the same guarded metric.

The **poison probe** is one finiteness reduction over the float state leaves,
folded into the guarded update: corruption is detected at the batch that
caused it, not at ``compute()``. A runner's ``snapshot_gate`` can read the
``guard_poisoned`` latch (:func:`guard_counters`, a host read outside any
capture) and veto snapshots after it.
"""
from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from torchmetrics_tpu_torch.utilities.data import _to_tensor

Tensor = torch.Tensor

#: guard verdict counters registered on the metric by :func:`enable_guard`.
#: All scalars: int32 "sum" states except the "max" latch ``guard_poisoned``.
GUARD_STATES: Tuple[str, ...] = (
    "guard_nan_rows",
    "guard_inf_rows",
    "guard_domain_rows",
    "guard_masked_rows",
    "guard_rejected_batches",
    "guard_poisoned",
)

GUARD_POLICIES: Tuple[str, ...] = ("propagate", "mask", "reject")

#: array reductions the mask policy can fold row-decomposed states with
#: (the sliced plane's reductions minus "merge")
_MASKABLE_REDUCTIONS = frozenset({"sum", "max", "min"})


class ArgSpec(NamedTuple):
    """Domain contract for one positional ``update`` argument.

    Checks are dtype-aware so one spec covers both prob/logit *and* label
    encodings of the same argument: ``lo``/``hi`` range checks apply only to
    floating inputs, ``values``/``num_classes`` membership checks only to
    integer inputs. Elements equal to ``ignore_index`` are exempt from the
    domain checks (they are sentinels, not data). Non-finite elements are
    flagged by ``finite`` and excluded from the domain count, so a NaN is
    never double-billed.
    """

    name: str = "arg"
    finite: bool = False
    lo: Optional[float] = None
    hi: Optional[float] = None
    num_classes: Optional[int] = None
    values: Optional[Tuple[int, ...]] = None
    ignore_index: Optional[int] = None


class GuardVerdict(NamedTuple):
    """Fixed-shape per-batch verdict: int32/bool device scalars, read on the
    host only by :func:`batch_verdict_host`."""

    nan_rows: Tensor
    inf_rows: Tensor
    domain_rows: Tensor
    invalid_rows: Tensor
    batch_ok: Tensor


def _batch_tensors(batch: Tuple[Any, ...]) -> Tuple[Tensor, ...]:
    """The batch as tensors beside its first tensor (numpy inputs with no
    tensor beside them go to the card, as a functional's do)."""
    device = next((a.device for a in batch if isinstance(a, Tensor)), None)
    return tuple(_to_tensor(a, device) for a in batch)


def _verdict(nan_any: Tensor, inf_any: Tensor, dom_any: Tensor) -> GuardVerdict:
    invalid = nan_any | inf_any | dom_any
    return GuardVerdict(
        nan_rows=nan_any.sum(dtype=torch.int32),
        inf_rows=inf_any.sum(dtype=torch.int32),
        domain_rows=dom_any.sum(dtype=torch.int32),
        invalid_rows=invalid.sum(dtype=torch.int32),
        batch_ok=~invalid.any(),
    )


class DomainContract(NamedTuple):
    """Per-family input-domain contract: one :class:`ArgSpec` per positional
    ``update`` argument (extra arguments are unchecked)."""

    args: Tuple[ArgSpec, ...]
    family: str = ""

    def row_invalid(self, *batch: Any) -> Tuple[Tensor, Tensor, Tensor]:
        """Per-row (nan, inf, domain) violation masks, each bool ``(rows,)``.

        A "row" is an index along dim 0 of the batched arguments; trailing
        dims are flattened per row, so a single bad class score invalidates
        its whole sample.
        """
        batch = _batch_tensors(batch)
        first = next((a for a in batch if a.ndim >= 1), None)
        if first is None:
            raise ValueError("guard contract needs at least one batched (ndim >= 1) input")
        zeros = torch.zeros((first.shape[0],), dtype=torch.bool, device=first.device)
        nan_any, inf_any, dom_any = zeros, zeros, zeros
        for spec, a in zip(self.args, batch):
            if a.ndim == 0:
                continue
            flat = a.reshape((a.shape[0], -1))
            # elementwise passes only for the checks the spec asks for (JAX's
            # all-false masks fold away under XLA; eager torch would run them)
            exempt = None if spec.ignore_index is None else flat == spec.ignore_index

            def rows(mask: Tensor) -> Tensor:
                return (mask if exempt is None else mask & ~exempt).any(dim=1)

            checks = []
            if flat.is_floating_point():
                if spec.finite:
                    nan_any = nan_any | rows(torch.isnan(flat))
                    inf_any = inf_any | rows(torch.isinf(flat))
                if spec.lo is not None:
                    checks.append(flat < spec.lo)
                if spec.hi is not None:
                    checks.append(flat > spec.hi)
                # integer membership checks also apply to float-encoded labels
                # (a JSON frame with one NaN floats the whole target array)
                if spec.values is not None and spec.lo is None and spec.hi is None:
                    checks.append(~_member_of(flat, spec.values))
                if spec.num_classes is not None and a.ndim == 1:
                    checks.append((flat < 0) | (flat >= spec.num_classes))
                if checks:
                    dom_any = dom_any | rows(functools.reduce(torch.logical_or, checks) & torch.isfinite(flat))
            else:
                if spec.values is not None:
                    checks.append(~_member_of(flat, spec.values))
                elif spec.num_classes is not None:
                    checks.append((flat < 0) | (flat >= spec.num_classes))
                if checks:
                    dom_any = dom_any | rows(checks[0])
        return nan_any, inf_any, dom_any

    def check_batch(self, *batch: Any) -> GuardVerdict:
        """Run the contract over one batch into a :class:`GuardVerdict`."""
        return _verdict(*self.row_invalid(*batch))


def _member_of(flat: Tensor, values: Tuple[int, ...]) -> Tensor:
    ok = torch.zeros_like(flat, dtype=torch.bool)
    for v in values:
        ok = ok | (flat == v)
    return ok


def check_batch(contract: DomainContract, *batch: Any) -> GuardVerdict:
    """Pure functional form of :meth:`DomainContract.check_batch`."""
    return contract.check_batch(*batch)


# --------------------------------------------------------------- eligibility
def guard_ineligibility(metric: Any, policy: str) -> Optional[str]:
    """Why ``metric`` cannot run under ``policy``, or ``None`` if it can.

    A *reason string* rather than a bool, as ``parallel.sliced_ineligibility``
    gives, so the refusal can name the offending state. ``propagate`` never
    rewrites the update and is always eligible.
    """
    if policy not in GUARD_POLICIES:
        raise ValueError(f"unknown guard policy {policy!r}; expected one of {GUARD_POLICIES}")
    if policy == "propagate":
        return None
    name = type(metric).__name__
    if getattr(metric, "_sharded_update_unsupported", None):
        return f"{name}.update cannot run traced: {metric._sharded_update_unsupported}"
    if getattr(metric, "_host_counters", ()):
        return f"{name} keeps host-side counters {metric._host_counters} the traced guard cannot restore"
    for state, default in metric._defaults.items():
        if state in GUARD_STATES:
            continue
        if isinstance(default, list):
            return f"state {state!r} is a list ('cat') state — rows cannot be unappended in-graph"
        red = metric._reductions.get(state)
        if policy == "mask" and not (isinstance(red, str) and red in _MASKABLE_REDUCTIONS):
            return (
                f"state {state!r} has reduction {red!r}; mask-policy row folding supports"
                f" {sorted(_MASKABLE_REDUCTIONS)} only"
            )
    if policy == "mask" and getattr(metric, "full_state_update", False):
        return f"{name} declares full_state_update=True; per-row decomposition from defaults is unsound"
    return None


# ------------------------------------------------------------------- install
def enable_guard(
    metric: Any,
    policy: str = "mask",
    contract: Optional[DomainContract] = None,
    probe: bool = True,
) -> Any:
    """Install the StateGuard on ``metric`` in place and return it.

    Registers the ``guard_*`` counter states and re-binds the instance
    ``update`` with the guarded closure (through ``Metric._rewrap``, so
    pickling, deep copies and ``__setstate__`` install it again). ``contract``
    defaults to the metric's own :meth:`~torchmetrics_tpu_torch.metric.Metric.domain_contract`.
    """
    if policy not in GUARD_POLICIES:
        raise ValueError(f"unknown guard policy {policy!r}; expected one of {GUARD_POLICIES}")
    if getattr(metric, "_guard_policy", None) is not None:
        raise ValueError(f"{type(metric).__name__} is already guarded (policy={metric._guard_policy!r})")
    contract = contract if contract is not None else metric.domain_contract()
    if contract is None:
        raise ValueError(
            f"{type(metric).__name__} declares no domain contract (see metriclint ML013);"
            " pass contract= explicitly or implement domain_contract()"
        )
    reason = guard_ineligibility(metric, policy)
    if reason is not None:
        raise ValueError(f"metric ineligible for guard policy {policy!r}: {reason}")
    for state in GUARD_STATES:
        if state in metric._defaults:
            raise ValueError(f"state name {state!r} is reserved for the StateGuard plane")
    for state in GUARD_STATES[:-1]:
        metric.add_state(state, torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
    # the poison latch merges as max so a tripped shard or cell taints the fold
    metric.add_state("guard_poisoned", torch.zeros((), dtype=torch.int32), dist_reduce_fx="max")
    metric._guard_policy = policy
    metric._guard_contract = contract
    metric._guard_probe = bool(probe)
    if hasattr(metric, "validate_args"):
        # the contract subsumes eager host validation, which would both read
        # the device per batch and raise on the very batches the mask and
        # reject policies exist to absorb
        metric.validate_args = False
    metric._rewrap()
    return metric


def _raw_update(metric: Any) -> Callable[..., None]:
    return metric.__class__.update.__get__(metric)


def _guard_wrap_update(metric: Any) -> Callable[..., None]:
    """The guarded raw update, installed by ``Metric._rewrap`` *inside* the
    transactional ``_wrap_update`` wrapper, so the count and state rollback
    on an exception covers the guard counters too."""
    raw = _raw_update(metric)
    sig = inspect.signature(metric.__class__.update)
    policy: str = metric._guard_policy
    contract: DomainContract = metric._guard_contract

    @functools.wraps(metric.__class__.update)
    def guarded(*args: Any, **kwargs: Any) -> None:
        bound = sig.bind(metric, *args, **kwargs)
        if bound.kwargs:
            raise TypeError(f"guarded update of {type(metric).__name__} accepts positionally-bindable arguments only")
        batch = tuple(_to_tensor(a, metric.device) for a in bound.args[1:])
        nan_any, inf_any, dom_any = contract.row_invalid(*batch)
        verdict = _verdict(nan_any, inf_any, dom_any)
        if policy == "mask":
            _mask_apply(metric, raw, batch, nan_any | inf_any | dom_any)
        elif policy == "reject":
            _reject_apply(metric, raw, batch, verdict)
        else:
            raw(*batch)
        _accumulate_verdict(metric, verdict, policy)
        if metric._guard_probe:
            bad = ~state_finiteness(metric)
            metric.guard_poisoned = torch.maximum(metric.guard_poisoned, bad.to(torch.int32))

    return guarded


def _plain_states(metric: Any) -> Tuple[str, ...]:
    return tuple(k for k in metric._defaults if k not in GUARD_STATES)


def _select(ok: Tensor, new: Any, old: Any) -> Any:
    """``where(ok, new, old)`` on a tensor or leaf by leaf on a sketch state."""
    if isinstance(new, Tensor):
        return torch.where(ok, new, old)
    return type(new)(*[torch.where(ok, n, o) for n, o in zip(new, old)])


def _reject_apply(metric: Any, raw: Callable[..., None], batch: Tuple[Tensor, ...], verdict: GuardVerdict) -> None:
    """Whole-batch veto: compute the candidate state, then select old/new per
    leaf on ``batch_ok``; an invalid batch leaves the state bitwise untouched
    (``where(False, new, old)`` is elementwise ``old``)."""
    prior = {k: getattr(metric, k) for k in _plain_states(metric)}
    raw(*batch)
    for k, old in prior.items():
        setattr(metric, k, _select(verdict.batch_ok, getattr(metric, k), old))


def _combine(red: str, saved: Tensor, fresh: Tensor) -> Tensor:
    if red == "sum":
        return saved + fresh
    if red == "max":
        return torch.maximum(saved, fresh)
    return torch.minimum(saved, fresh)


def _is_float_state(default: Any) -> bool:
    return isinstance(default, Tensor) and (default.is_floating_point() or default.is_complex())


def _kernel_fresh(metric: Any, cells: Tensor, num_cells: int, batch: Tuple[Tensor, ...]) -> Optional[Dict[str, Tensor]]:
    """The member's kernel route (``_sliced_fresh_states``: K2s, K1s), or
    ``None`` where it has none for this batch. Taken only by members whose
    plain states are all integer: their per-row poison latch is 0 by
    construction, so the route needs no per-row states."""
    hook = getattr(metric, "_sliced_fresh_states", None)
    if hook is None or any(_is_float_state(metric._defaults[k]) for k in _plain_states(metric)):
        return None
    return hook(cells, num_cells, *batch)


def _mask_apply(metric: Any, raw: Callable[..., None], batch: Tuple[Tensor, ...], invalid_row: Tensor) -> None:
    """Accumulate only valid rows: the sliced plane's cell fold with one cell,
    where invalid rows carry the spill segment and fall off. A kernel route
    gets ``cells = where(invalid_row, -1, 0)`` (the kernels drop cell
    ``-1``); otherwise one fresh update per row (``vmap``) is reduced with
    ``_segment_reduce``: exact for integer count states, reassociated
    summation for float ones."""
    from torchmetrics_tpu_torch.parallel.sliced import _row_states, _segment_reduce

    states = _plain_states(metric)
    saved = {k: getattr(metric, k) for k in states}
    cells = torch.where(invalid_row, -1, 0).to(torch.int32)
    per_cell = _kernel_fresh(metric, cells, 1, batch)
    if per_cell is not None:
        fresh = {k: per_cell[k][0] for k in states}
    else:
        rows = _row_states(metric, batch, update=raw)
        seg = invalid_row.to(torch.int64)  # valid rows -> cell 0, invalid -> spill
        fresh = {k: _segment_reduce(metric._reductions[k], rows[k], seg, 1)[0] for k in states}
    any_valid = (~invalid_row).any()
    for k in states:
        merged = _combine(metric._reductions[k], saved[k], fresh[k])
        # all-invalid batch: segment identities never leak into the state
        setattr(metric, k, torch.where(any_valid, merged, saved[k]))


def _accumulate_verdict(metric: Any, verdict: GuardVerdict, policy: str) -> None:
    metric.guard_nan_rows = metric.guard_nan_rows + verdict.nan_rows
    metric.guard_inf_rows = metric.guard_inf_rows + verdict.inf_rows
    metric.guard_domain_rows = metric.guard_domain_rows + verdict.domain_rows
    if policy == "mask":
        metric.guard_masked_rows = metric.guard_masked_rows + verdict.invalid_rows
    elif policy == "reject":
        metric.guard_rejected_batches = metric.guard_rejected_batches + (~verdict.batch_ok).to(torch.int32)


# ------------------------------------------------------ the sliced plan's rows
class RowVerdict(NamedTuple):
    """Per-row verdicts of a guarded member in a sliced plan: each row is
    the guarded update of a one-row batch, as JAX's per-row ``vmap`` runs it."""

    nan: Tensor
    inf: Tensor
    domain: Tensor
    invalid: Tensor


def row_verdict(metric: Any, batch: Tuple[Tensor, ...]) -> RowVerdict:
    nan_any, inf_any, dom_any = metric._guard_contract.row_invalid(*batch)
    return RowVerdict(nan_any, inf_any, dom_any, nan_any | inf_any | dom_any)


def kernel_cells(metric: Any, cells: Tensor, verdict: RowVerdict) -> Tensor:
    """The cells a kernel route gets: invalid rows dropped (cell ``-1``)
    unless the policy is ``propagate``."""
    if metric._guard_policy == "propagate":
        return cells
    return torch.where(verdict.invalid, -1, cells).to(cells.dtype)


def _row_counters(metric: Any, verdict: RowVerdict, poisoned: Tensor) -> Dict[str, Tensor]:
    policy = metric._guard_policy
    zeros = torch.zeros_like(verdict.invalid, dtype=torch.int32)
    return {
        "guard_nan_rows": verdict.nan.to(torch.int32),
        "guard_inf_rows": verdict.inf.to(torch.int32),
        "guard_domain_rows": verdict.domain.to(torch.int32),
        "guard_masked_rows": verdict.invalid.to(torch.int32) if policy == "mask" else zeros,
        "guard_rejected_batches": verdict.invalid.to(torch.int32) if policy == "reject" else zeros,
        "guard_poisoned": poisoned if metric._guard_probe else zeros,
    }


def guard_rows(metric: Any, rows: Dict[str, Any], verdict: RowVerdict) -> Dict[str, Any]:
    """Per-row states of the raw update (``_row_states``) made into the
    per-row states of the guarded update: under ``mask`` and ``reject`` an
    invalid row keeps the defaults (``mask`` merges a valid row into them),
    and the ``guard_*`` rows hold each row's verdict and poison latch."""
    policy = metric._guard_policy
    out = dict(rows)
    for k in _plain_states(metric):
        if policy == "propagate" or isinstance(metric._defaults[k], list):
            continue
        value, default = rows[k], metric._defaults[k]
        if policy == "mask":
            value = _combine(metric._reductions[k], default, value)
        out[k] = _select(verdict.invalid.reshape((-1,) + (1,) * (_leaf(value).ndim - 1)), _broadcast(default, value), value)
    ok = torch.ones_like(verdict.invalid)
    for k in _plain_states(metric):
        for leaf in _leaves(out[k]):
            if leaf.is_floating_point() or leaf.is_complex():
                ok = ok & torch.isfinite(leaf).reshape(leaf.shape[0], -1).all(dim=1)
    out.update(_row_counters(metric, verdict, (~ok).to(torch.int32)))
    return out


def guard_cell_counters(metric: Any, verdict: RowVerdict, seg: Tensor, num_cells: int) -> Dict[str, Tensor]:
    """The ``guard_*`` partials of a kernel route's cells: the segment sums
    (the latch: maxima) of the row verdicts."""
    from torchmetrics_tpu_torch.parallel.sliced import _segment_reduce

    zero = torch.zeros_like(verdict.invalid, dtype=torch.int32)
    return {
        k: _segment_reduce(metric._reductions[k], v, seg, num_cells)
        for k, v in _row_counters(metric, verdict, zero).items()
    }


def _leaf(value: Any) -> Tensor:
    return value if isinstance(value, Tensor) else value[0]


def _broadcast(default: Any, rows: Any) -> Any:
    if isinstance(default, Tensor):
        return default.expand(rows.shape)
    return type(default)(*[d.expand(r.shape) for d, r in zip(default, rows)])


def _leaves(value: Any) -> List[Tensor]:
    if isinstance(value, Tensor):
        return [value]
    if value is None:
        return []
    return [leaf for v in value for leaf in _leaves(v)]


# --------------------------------------------------------------- poison probe
def state_finiteness(metric: Any) -> Tensor:
    """One finiteness reduction over the float state leaves: scalar bool
    ``True`` iff no float leaf carries NaN/Inf. Integer leaves are finite by
    construction and skipped; guard counters are excluded."""
    ok = torch.ones((), dtype=torch.bool, device=metric.device)
    for k in _plain_states(metric):
        for leaf in _leaves(getattr(metric, k)):
            if leaf.is_floating_point() or leaf.is_complex():
                ok = ok & torch.isfinite(leaf).all()
    return ok


# ----------------------------------------------------------- host-side reads
def guarded_policy(metric: Any) -> Optional[str]:
    """The installed guard policy, or ``None`` when unguarded: the serve
    plane's feature probe (no isinstance, works through wrappers)."""
    return getattr(metric, "_guard_policy", None)


def guard_counters(metric: Any) -> Dict[str, int]:
    """Host snapshot of the cumulative guard counters (reads the device:
    serve plane, gauges and snapshot gates only, never inside a capture)."""
    return {
        "nan_rows": int(metric.guard_nan_rows),
        "inf_rows": int(metric.guard_inf_rows),
        "domain_rows": int(metric.guard_domain_rows),
        "masked_rows": int(metric.guard_masked_rows),
        "rejected_batches": int(metric.guard_rejected_batches),
        "poisoned": int(metric.guard_poisoned),
    }


def batch_verdict_host(metric: Any, batch: Tuple[Any, ...]) -> Optional[Dict[str, int]]:
    """Re-run the contract over a batch and return the verdict as plain ints:
    the dead-letter ledger's poison-quarantine record. ``None`` when the
    metric is unguarded or the batch cannot be checked."""
    contract = getattr(metric, "_guard_contract", None)
    if contract is None:
        return None
    try:
        v = contract.check_batch(*(_to_tensor(a, metric.device) for a in batch))
        return {
            "nan_rows": int(v.nan_rows),
            "inf_rows": int(v.inf_rows),
            "domain_rows": int(v.domain_rows),
            "invalid_rows": int(v.invalid_rows),
            "batch_ok": bool(v.batch_ok),
        }
    except Exception:  # malformed batch: the quarantine must still land
        return None
