# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's StateGuard (``robustness/guard.py``) against the JAX package's,
on the CPU: the counterpart of ``tests/unittests/bases/test_guard.py``.

Every case of JAX's ``CASES`` plus the flagship suite's two kernel members:
macro F1 (``MulticlassStatScores``' route through K2s' plain version) and the
binned macro AUROC guarded with ``contract=`` (K1s' plain version; JAX's
binned AUROC declares no contract). Each runs under the three policies,
eagerly, under ``make_jit_update``, in a fused plan and in a ``SlicedPlan``,
and is held against JAX's guarded metric on the same numpy batches.

Budgets: integer states and every ``guard_*`` counter bitwise. Float sums
(the MSE squared-error sum, the calibration bins' confidence and accuracy
sums) within ``rtol=2e-6, atol=1e-6``: the mask policy folds the valid rows
one fresh row-update at a time and adds them in a segment sum, whose order
differs between XLA's ``segment_sum`` and torch's ``index_add`` (float32
addition is not associative), and the fused and jit paths add one batch to
the carry where eager adds in place; a NaN is equal to a NaN.
"""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as JC
import torchmetrics_tpu.regression as JR
import torchmetrics_tpu_torch.classification as TC
import torchmetrics_tpu_torch.regression as TR
from torchmetrics_tpu.classification.calibration_error import BinaryCalibrationError as JBinaryCalibrationError
from torchmetrics_tpu.classification.stat_scores import MultilabelStatScores as JMultilabelStatScores
from torchmetrics_tpu.parallel import SlicedPlan as JSliced
from torchmetrics_tpu.parallel.sharded import fold_jit_state as j_fold_jit_state
from torchmetrics_tpu.parallel.sharded import make_jit_update as j_make_jit_update
from torchmetrics_tpu.robustness import guard as jguard
from torchmetrics_tpu_torch import Metric
from torchmetrics_tpu_torch.classification.calibration_error import BinaryCalibrationError as TBinaryCalibrationError
from torchmetrics_tpu_torch.classification.stat_scores import MultilabelStatScores as TMultilabelStatScores
from torchmetrics_tpu_torch.parallel import FusedCollectionPlan, SlicedPlan, fold_jit_state, make_jit_update
from torchmetrics_tpu_torch.robustness import CheckpointStore, StreamingEvaluator
from torchmetrics_tpu_torch.robustness import guard as tguard

NAN, INF = float("nan"), float("inf")
CPU = {"device": "cpu"}
RTOL, ATOL = 2e-6, 1e-6


def _f32(*rows):
    return np.array(rows, dtype=np.float32)


def _i32(*rows):
    return np.array(rows, dtype=np.int32)


# Every batch is fixed-shape (6 rows), so one schedule drives every path;
# each keeps at least one valid row. The JAX test's batches, as float32/int32.
_BINARY = [
    (_f32(0.9, 0.2, NAN, 0.7, 0.4, 0.6), _i32(1, 0, 1, 1, 0, 1)),
    (_f32(0.8, INF, 0.1, 0.3, 1.5, 0.2), _i32(1, 1, 0, 0, 1, 0)),
    (_f32(0.6, 0.4, 0.2, 0.9, 0.5, 0.1), _i32(1, 7, 0, 1, 0, 0)),
]
_MULTICLASS = [
    (
        _f32([2.0, 1.0, 0.5], [NAN, 0.0, 1.0], [0.1, 3.0, 0.2], [1.0, 1.0, 4.0], [0.5, 0.5, 0.5], [2.0, 0.1, 0.1]),
        _i32(0, 1, 1, 2, 5, 0),
    ),
    (
        _f32([1.0, 2.0, 3.0], [0.0, INF, 0.0], [4.0, 0.0, 0.0], [0.2, 0.3, 0.4], [1.0, 0.0, 2.0], [0.0, 1.0, 0.0]),
        _i32(2, 1, 0, -1, 2, 1),
    ),
]
_MULTILABEL = [
    (
        _f32([0.9, 0.1], [NAN, 0.5], [0.3, 0.8], [0.7, 3.0], [0.2, 0.6], [0.5, 0.5]),
        _i32([1, 0], [1, 1], [0, 1], [1, 0], [0, 2], [1, 1]),
    ),
]
_MSE = [
    (_f32(0.1, NAN, 0.3, 0.4, 0.5, 0.6), _f32(0.0, 1.0, 0.5, 0.25, 1.0, 0.0)),
    (_f32(0.9, 0.8, INF, 0.2, 0.1, 0.4), _f32(1.0, 1.0, 0.0, NAN, 0.0, 0.5)),
]


def _multiclass_contract(pkg_stat_scores, **kwargs):
    return pkg_stat_scores(num_classes=3, **kwargs).domain_contract()


#: case -> (JAX factory, port factory, batches, contract factories or None)
CASES = {
    "binary_accuracy": (lambda: JC.BinaryAccuracy(), lambda: TC.BinaryAccuracy(**CPU), _BINARY, None),
    "multiclass_accuracy": (
        lambda: JC.MulticlassAccuracy(num_classes=3, average="micro"),
        lambda: TC.MulticlassAccuracy(num_classes=3, average="micro", **CPU),
        _MULTICLASS,
        None,
    ),
    "multilabel_stat_scores": (
        lambda: JMultilabelStatScores(num_labels=2, average="micro"),
        lambda: TMultilabelStatScores(num_labels=2, average="micro", **CPU),
        _MULTILABEL,
        None,
    ),
    "binary_calibration_error": (
        lambda: JBinaryCalibrationError(n_bins=5),
        lambda: TBinaryCalibrationError(n_bins=5, **CPU),
        _BINARY,
        None,
    ),
    "mean_squared_error": (lambda: JR.MeanSquaredError(), lambda: TR.MeanSquaredError(**CPU), _MSE, None),
    # the flagship suite's kernel members
    "multiclass_f1_macro": (
        lambda: JC.MulticlassF1Score(num_classes=3, average="macro"),
        lambda: TC.MulticlassF1Score(num_classes=3, average="macro", **CPU),
        _MULTICLASS,
        None,
    ),
    "binned_auroc_macro": (
        lambda: JC.MulticlassAUROC(num_classes=3, average="macro", thresholds=8),
        lambda: TC.MulticlassAUROC(num_classes=3, average="macro", thresholds=8, **CPU),
        _MULTICLASS,
        (lambda: _multiclass_contract(JC.MulticlassStatScores), lambda: _multiclass_contract(TC.MulticlassStatScores, **CPU)),
    ),
}
POLICIES = ("mask", "reject", "propagate")


def _guarded(case, policy, pkg):
    jf, tf, _batches, contracts = CASES[case]
    metric = jf() if pkg == "jax" else tf()
    contract = None if contracts is None else contracts[0 if pkg == "jax" else 1]()
    guard = jguard if pkg == "jax" else tguard
    return guard.enable_guard(metric, policy=policy, contract=contract)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _assert_states_equal(got, want, where):
    """Two state dicts (names -> arrays): same names and dtypes, integers
    bitwise, floats within the stated budget."""
    assert sorted(got) == sorted(want), where
    for name in want:
        g, w = _np(got[name]), _np(want[name])
        assert g.shape == w.shape and g.dtype == w.dtype, (where, name, g.shape, w.shape, g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"{where}: {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{where}: {name}")


def _states(metric):
    return {k: getattr(metric, k) for k in metric._defaults}


_JAX_EAGER = {}


def _jax_eager(case, policy):
    """JAX's guarded metric fed every batch eagerly (computed once per case)."""
    if (case, policy) not in _JAX_EAGER:
        metric = _guarded(case, policy, "jax")
        for batch in CASES[case][2]:
            metric.update(*(jnp.asarray(a) for a in batch))
        _JAX_EAGER[(case, policy)] = {k: np.asarray(v) for k, v in _states(metric).items()}
    return _JAX_EAGER[(case, policy)]


def _batches_t(case):
    return [tuple(torch.from_numpy(a) for a in batch) for batch in CASES[case][2]]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_guard_eager_equals_jax(case, policy):
    metric = _guarded(case, policy, "torch")
    for batch in _batches_t(case):
        metric.update(*batch)
    _assert_states_equal(_states(metric), _jax_eager(case, policy), f"{case}/{policy}")
    assert tguard.guarded_policy(metric) == policy


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_guard_jit_and_fused_equal_jax(case, policy):
    """The guarded update under ``make_jit_update`` and inside a fused plan
    (eager on the CPU, the same step the card captures)."""
    want = _jax_eager(case, policy)
    metric = _guarded(case, policy, "torch")
    step, state = make_jit_update(metric)
    for batch in _batches_t(case):
        state = step(state, *batch)
    fold_jit_state(metric, state)
    _assert_states_equal(_states(metric), want, f"{case}/{policy}/jit")

    metric = _guarded(case, policy, "torch")
    plan = FusedCollectionPlan(metric)
    for batch in _batches_t(case):
        plan.update(*batch)
    plan.fold_back()
    _assert_states_equal(_states(metric), want, f"{case}/{policy}/fused")


@pytest.mark.parametrize("case", ["binary_accuracy", "mean_squared_error"])
def test_guard_jit_equals_jax_jit(case):
    """The port's step against JAX's own jitted step (not only its eager path)."""
    jm = _guarded(case, "mask", "jax")
    jstep, jstate = j_make_jit_update(jm)
    for batch in CASES[case][2]:
        jstate = jstep(jstate, *(jnp.asarray(a) for a in batch))
    j_fold_jit_state(jm, jstate)
    tm = _guarded(case, "mask", "torch")
    step, state = make_jit_update(tm)
    for batch in _batches_t(case):
        state = step(state, *batch)
    fold_jit_state(tm, state)
    _assert_states_equal(_states(tm), {k: np.asarray(v) for k, v in _states(jm).items()}, case)


_KEYS = np.array([0, 1, 2, 0, 1, 2], dtype=np.int32)


def _payload_states(payload):
    members = payload["members"]
    return {f"{m}.{k}": v for m, tree in members.items() for k, v in tree.items()}


@pytest.mark.parametrize(
    "case,policy",
    [
        ("binary_accuracy", "mask"),
        ("multiclass_accuracy", "reject"),
        ("mean_squared_error", "propagate"),
        ("multiclass_f1_macro", "mask"),
        ("multiclass_f1_macro", "reject"),
        ("multiclass_f1_macro", "propagate"),
        ("binned_auroc_macro", "mask"),
    ],
)
def test_guard_sliced_plan_equals_jax(case, policy):
    """A guarded template in a ``SlicedPlan``: each row is its guarded update
    of a one-row batch, as JAX's per-row vmap runs it, so the rows mask per
    row and the ``guard_*`` counters are summed per cell. F1 and the binned
    AUROC take the kernel routes (K2s, K1s plain) with the invalid rows as
    cell ``-1``; the others the ``vmap`` route."""
    jp = JSliced(_guarded(case, policy, "jax"), num_cells=8)
    tp = SlicedPlan(_guarded(case, policy, "torch"), num_cells=8)
    for batch in CASES[case][2]:
        jp.update(jnp.asarray(_KEYS), *(jnp.asarray(a) for a in batch))
        tp.update(torch.from_numpy(_KEYS), *(torch.from_numpy(a) for a in batch))
    want, got = jp.save_checkpoint(), tp.save_checkpoint()
    np.testing.assert_array_equal(got["table"]["keys"], want["table"]["keys"])
    _assert_states_equal(_payload_states(got), _payload_states(want), f"{case}/{policy}/sliced")
    counters = _payload_states(got)
    if policy == "mask":
        assert counters[f"{next(iter(got['members']))}.guard_masked_rows"].sum() > 0


def test_guard_sliced_mask_equals_host_filtered_cohorts():
    """JAX's ``test_mask_matches_host_filtered_rows_under_sliced_plan``: each
    cohort's masked value equals the unguarded metric fed only that cohort's
    valid rows."""
    plan = SlicedPlan(_guarded("binary_accuracy", "mask", "torch"), num_cells=8)
    for batch in CASES["binary_accuracy"][2]:
        plan.update(torch.from_numpy(_KEYS), *(torch.from_numpy(a) for a in batch))
    results = plan.results()
    for cohort in (0, 1, 2):
        ref = TC.BinaryAccuracy(validate_args=False, **CPU)
        for preds, target in CASES["binary_accuracy"][2]:
            rows = (_KEYS == cohort) & np.isfinite(preds) & (preds >= 0) & (preds <= 1) & ((target == 0) | (target == 1))
            if rows.any():
                ref.update(torch.from_numpy(preds[rows]), torch.from_numpy(target[rows]))
        assert torch.equal(results[(cohort,)], ref.compute())


@pytest.mark.parametrize("case", ["binary_accuracy", "multiclass_f1_macro", "mean_squared_error"])
def test_mask_equals_host_filtered_rows(case):
    """The mask policy equals the unguarded metric fed only the valid rows
    (integer states bitwise; the float sum within the budget)."""
    metric = _guarded(case, "mask", "torch")
    ref = CASES[case][1]()
    ref.validate_args = False
    invalid = 0
    for batch in _batches_t(case):
        metric.update(*batch)
        nan, inf, dom = metric._guard_contract.row_invalid(*batch)
        keep = ~(nan | inf | dom)
        invalid += int((~keep).sum())
        ref.update(*(a[keep] for a in batch))
    want = {k: v for k, v in _states(ref).items()}
    got = {k: v for k, v in _states(metric).items() if k in want}
    _assert_states_equal(got, want, case)
    counters = tguard.guard_counters(metric)
    assert counters["masked_rows"] == invalid and counters["poisoned"] == 0


def test_reject_vetoes_bad_batch_bitwise():
    guarded = tguard.enable_guard(TC.BinaryAccuracy(**CPU), policy="reject")
    clean = (torch.tensor([0.9, 0.2, 0.7]), torch.tensor([1, 0, 1], dtype=torch.int32))
    guarded.update(*clean)
    before = {k: v.clone() for k, v in _states(guarded).items() if not k.startswith("guard_")}
    guarded.update(*(torch.from_numpy(a) for a in _BINARY[0]))  # a NaN row: the whole batch is vetoed
    for name, prior in before.items():
        assert torch.equal(prior, getattr(guarded, name))
    counters = tguard.guard_counters(guarded)
    assert counters["rejected_batches"] == 1 and counters["nan_rows"] == 1
    ref = TC.BinaryAccuracy(validate_args=False, **CPU)
    ref.update(*clean)
    assert torch.equal(guarded.compute(), ref.compute())


def test_propagate_probe_latches_at_offending_batch():
    guarded = tguard.enable_guard(TR.MeanSquaredError(**CPU), policy="propagate")
    guarded.update(torch.tensor([0.1, 0.2]), torch.tensor([0.0, 1.0]))
    assert tguard.guard_counters(guarded)["poisoned"] == 0
    guarded.update(torch.tensor([NAN, 0.5]), torch.tensor([1.0, 0.0]))
    counters = tguard.guard_counters(guarded)  # at the batch that poisoned the state, no compute() needed
    assert counters["poisoned"] == 1 and counters["nan_rows"] == 1
    guarded.update(torch.tensor([0.3, 0.4]), torch.tensor([0.0, 0.0]))
    assert tguard.guard_counters(guarded)["poisoned"] == 1  # the latch holds


# ------------------------------------------------------------- refusals


class _FullState:
    """A full_state_update metric with a contract, in either package."""

    @staticmethod
    def build(pkg_metric, zeros):
        class FullStateSum(pkg_metric):
            full_state_update = True

            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                self.add_state("total", zeros(), dist_reduce_fx="sum")

            def update(self, x):
                self.total = self.total + x.sum()

            def compute(self):
                return self.total

            def domain_contract(self):
                guard = jguard if pkg_metric.__module__.startswith("torchmetrics_tpu.") else tguard
                return guard.DomainContract(args=(guard.ArgSpec(name="x", finite=True),))

        return FullStateSum


def _reserved(pkg_metric, zeros, **kwargs):
    class Reserved(pkg_metric):
        def __init__(self):
            super().__init__(**kwargs)
            self.add_state("guard_nan_rows", zeros(), dist_reduce_fx="sum")

        def update(self, x):
            pass

        def compute(self):
            return self.guard_nan_rows

    return Reserved()


def _refusals(pkg):
    import torchmetrics_tpu as J

    if pkg == "jax":
        guard, C, metric_cls, zeros, kw = jguard, JC, J.Metric, (lambda: jnp.zeros((), jnp.float32)), {}
    else:
        guard, C, metric_cls, zeros, kw = tguard, TC, Metric, (lambda: torch.zeros(())), CPU
    contract = C.BinaryAccuracy(**kw).domain_contract()
    return {
        "missing_contract": lambda: guard.enable_guard(C.BinaryPrecisionRecallCurve(thresholds=None, **kw), policy="propagate"),
        "cat_state": lambda: guard.enable_guard(C.BinaryPrecisionRecallCurve(thresholds=None, **kw), policy="mask", contract=contract),
        "reserved_name": lambda: guard.enable_guard(_reserved(metric_cls, zeros, **kw), policy="propagate", contract=contract),
        "guarded_twice": lambda: guard.enable_guard(guard.enable_guard(C.BinaryAccuracy(**kw), policy="mask"), policy="mask"),
        "full_state_mask": lambda: guard.enable_guard(_FullState.build(metric_cls, zeros)(**kw), policy="mask"),
        "unknown_policy": lambda: guard.enable_guard(C.BinaryAccuracy(**kw), policy="drop"),
    }


@pytest.mark.parametrize("which", ["missing_contract", "cat_state", "reserved_name", "guarded_twice", "full_state_mask", "unknown_policy"])
def test_refusals_raise_as_jax(which):
    caught = {}
    for pkg in ("jax", "torch"):
        with pytest.raises(Exception) as info:
            _refusals(pkg)[which]()
        caught[pkg] = info.value
    assert type(caught["torch"]) is type(caught["jax"]) is ValueError
    assert str(caught["torch"]) == str(caught["jax"])


def test_ineligibility_reason_equals_jax():
    assert tguard.guard_ineligibility(TC.BinaryPrecisionRecallCurve(thresholds=None, **CPU), "mask") == (
        jguard.guard_ineligibility(JC.BinaryPrecisionRecallCurve(thresholds=None), "mask")
    )
    assert tguard.guard_ineligibility(TC.BinaryAccuracy(**CPU), "propagate") is None


# --------------------------------------------------- transactions, pickle, checkpoints


def test_counters_roll_back_when_an_update_raises(monkeypatch):
    guarded = tguard.enable_guard(TR.MeanSquaredError(**CPU), policy="mask")
    guarded.update(torch.tensor([0.1, NAN]), torch.tensor([0.0, 1.0]))
    before = {k: v.clone() for k, v in _states(guarded).items()}

    def broken_probe(metric):
        raise RuntimeError("probe failed")

    # the probe runs after the counters moved: the transactional wrapper
    # must roll them back with the states and the update count
    monkeypatch.setattr(tguard, "state_finiteness", broken_probe)
    with pytest.raises(RuntimeError, match="probe failed"):
        guarded.update(torch.tensor([NAN, 0.2]), torch.tensor([0.0, 1.0]))
    for name, prior in before.items():
        assert torch.equal(prior, getattr(guarded, name)), name
    assert guarded._update_count == 1


def test_pickle_and_deepcopy_keep_the_guard():
    guarded = tguard.enable_guard(TC.BinaryAccuracy(**CPU), policy="mask")
    for copy in (pickle.loads(pickle.dumps(guarded)), guarded.clone()):
        assert tguard.guarded_policy(copy) == "mask"
        copy.update(*(torch.from_numpy(a) for a in _BINARY[0]))
        assert tguard.guard_counters(copy)["masked_rows"] == 1


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_guarded_checkpoints_read_across(direction):
    from torchmetrics_tpu.robustness.checkpoint import checkpoint_fingerprint as jfp
    from torchmetrics_tpu_torch.robustness.checkpoint import checkpoint_fingerprint as tfp

    jm, tm = _guarded("multiclass_f1_macro", "mask", "jax"), _guarded("multiclass_f1_macro", "mask", "torch")
    assert tfp(tm) == jfp(jm)  # the guard_* states are registered states: same registry
    src, dst = (jm, tm) if direction == "jax_to_torch" else (tm, jm)
    batches = CASES["multiclass_f1_macro"][2]
    for batch in batches:
        src.update(*(jnp.asarray(a) for a in batch) if src is jm else (torch.from_numpy(a) for a in batch))
    dst.load_checkpoint(src.save_checkpoint())
    _assert_states_equal(
        {k: _np(v) for k, v in _states(dst).items()}, {k: _np(v) for k, v in _states(src).items()}, direction
    )


def test_runner_gate_vetoes_snapshots_after_poison(tmp_path):
    guarded = tguard.enable_guard(TR.MeanSquaredError(**CPU), policy="propagate")
    store = CheckpointStore(str(tmp_path / "store"))
    runner = StreamingEvaluator(guarded, store=store, snapshot_every_n=1)
    runner.snapshot_gate = lambda: tguard.guard_counters(guarded)["poisoned"] == 0
    clean = (torch.tensor([0.1, 0.2]), torch.tensor([0.0, 1.0]))
    poison = (torch.tensor([NAN, 0.2]), torch.tensor([0.0, 1.0]))
    assert runner.serve_open() == 0
    for batch in (clean, clean, poison, clean):
        runner.serve_step(batch)
    assert [s for s, *_ in _steps(store)] == [1, 2]  # no cadence snapshot after the poison
    assert tguard.guard_counters(guarded)["poisoned"] == 1


def _steps(store):
    from torchmetrics_tpu_torch.robustness import store_format

    manifest = store_format.read_manifest(store.directory)
    return [(int(e["step"]),) for e in manifest["snapshots"]]


def test_batch_verdict_host_and_check_batch():
    guarded = tguard.enable_guard(TC.MulticlassAccuracy(num_classes=3, **CPU), policy="mask")
    batch = tuple(torch.from_numpy(a) for a in _MULTICLASS[0])
    verdict = tguard.batch_verdict_host(guarded, batch)
    want = jguard.batch_verdict_host(_guarded("multiclass_accuracy", "mask", "jax"), _MULTICLASS[0])
    assert verdict == want == {"nan_rows": 1, "inf_rows": 0, "domain_rows": 1, "invalid_rows": 2, "batch_ok": False}
    assert tguard.batch_verdict_host(TC.MulticlassAccuracy(num_classes=3, **CPU), batch) is None
    v = tguard.check_batch(guarded._guard_contract, *batch)
    assert int(v.invalid_rows) == 2 and not bool(v.batch_ok)
