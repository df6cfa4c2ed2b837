# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The fixed-point curve families of the port against the JAX package's:
recall at fixed precision, precision at fixed recall, sensitivity at
specificity and specificity at sensitivity; functional, dispatched and
module forms, binary, multiclass and multilabel, binned and exact.

The same seeded numpy inputs go through both packages on the CPU. Budgets:

- the PR-curve state (the int32 ``confmat`` kernel K1 writes, or the exact
  mode's lists) is bitwise equal, dtype included;
- the chosen value and the chosen threshold are bitwise equal, binned and
  exact: the selection is compares, masks, maxima and one first-maximum
  argmax over curves that are themselves bitwise. This covers the
  empty-constraint sentinel ``(0, 1e6)``, the zero-primary sentinel ``1e6``,
  ties in the primary value, a ``min_*`` equal to a curve value in float32
  (0.1 and 0.7, which float32 rounds up and down), and ``ignore_index``;
- the inputs are probabilities (on a coarse grid, so curve values tie); a
  sigmoid or softmax of logits differs from XLA's by ulps, which can move a
  probability across a threshold, so logits are held to the curve's
  resolution in one test of their own.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu.classification as JC
import torchmetrics_tpu.functional.classification as JF
import torchmetrics_tpu_torch as T
import torchmetrics_tpu_torch.classification as TC
import torchmetrics_tpu_torch.functional.classification as TF
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy

N, C, L, THR = 240, 5, 4, 11
# family -> (functional stem, module stem, name of the constraint argument, JAX/port module of the selection)
FAMILIES = {
    "recall_fixed_precision": ("recall_at_fixed_precision", "RecallAtFixedPrecision", "min_precision"),
    "precision_fixed_recall": ("precision_at_fixed_recall", "PrecisionAtFixedRecall", "min_recall"),
    "sensitivity_specificity": ("sensitivity_at_specificity", "SensitivityAtSpecificity", "min_specificity"),
    "specificity_sensitivity": ("specificity_at_sensitivity", "SpecificityAtSensitivity", "min_sensitivity"),
}
KINDS = ["binary", "multiclass", "multilabel"]
GRIDS = {"binned": THR, "exact": None, "list": [0.0, 0.1, 0.25, 0.5, 0.7, 0.9, 1.0]}
MIN_VALUES = [0.5, 0.1, 0.7, 0.0, 1.0]


def _kind_args(kind):
    return {"multiclass": {"num_classes": C}, "multilabel": {"num_labels": L}}.get(kind, {})


def _data(kind, seed, ignore=None, n=N):
    """Seeded probabilities on a 0.05 grid (many tied curve values and points on
    the thresholds) and their targets; about a tenth of the targets set to
    ``ignore`` where given."""
    rng = np.random.default_rng(seed)
    if kind == "binary":
        preds = rng.integers(0, 21, n) / 20
        target = (rng.random(n) < 0.3 + 0.5 * preds).astype(np.int64)
    elif kind == "multiclass":
        raw = rng.integers(1, 9, (n, C)).astype(np.float64)
        preds = np.round(raw / raw.sum(1, keepdims=True), 2)
        target = rng.integers(0, C, n)
    else:
        preds = rng.integers(0, 21, (n, L)) / 20
        target = (rng.random((n, L)) < 0.2 + 0.6 * preds).astype(np.int64)
    if ignore is not None:
        target = np.where(rng.random(target.shape) < 0.1, ignore, target)
    return preds.astype(np.float32), target.astype(np.int32)


def _bitwise(got, want, what=""):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8)), (what, got, want)


def _assert_pair_bitwise(got, want, what=""):
    assert isinstance(got, tuple) and len(got) == 2
    _bitwise(got[0], want[0], f"{what} value")
    _bitwise(got[1], want[1], f"{what} threshold")


def _functional(pkg, family, kind):
    stem = FAMILIES[family][0]
    return getattr(pkg, f"{kind}_{stem}")


def _call_both(family, kind, preds, target, min_value, **kw):
    arg = FAMILIES[family][2]
    want = _functional(JF, family, kind)(jnp.asarray(preds), jnp.asarray(target), **_kind_args(kind), **{arg: min_value}, **kw)
    got = _functional(TF, family, kind)(torch.from_numpy(preds), torch.from_numpy(target), **_kind_args(kind), **{arg: min_value}, **kw)
    return got, want


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_functional_bitwise(family, kind, grid):
    """Values and thresholds equal JAX's bit for bit at every constraint level,
    including levels equal to float32 curve values and the two ends."""
    preds, target = _data(kind, seed=len(family) + KINDS.index(kind))
    for min_value in MIN_VALUES:
        got, want = _call_both(family, kind, preds, target, min_value, thresholds=GRIDS[grid])
        _assert_pair_bitwise(got, want, f"{family} {kind} {grid} {min_value}")


@pytest.mark.parametrize("grid", ["binned", "exact"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_functional_ignore_index_bitwise(family, kind, grid):
    preds, target = _data(kind, seed=40 + KINDS.index(kind), ignore=-1)
    got, want = _call_both(family, kind, preds, target, 0.5, thresholds=GRIDS[grid], ignore_index=-1)
    _assert_pair_bitwise(got, want, f"{family} {kind} {grid}")


def _constructed_binary():
    """Ten samples at 0.95 with one positive (precision 1/10 there), seven
    positives among ten at 0.75 (a precision of exactly 0.7 once both groups
    are above the threshold: 8/20 no; the 0.75 group alone is 7/10), and
    negatives below."""
    preds = np.array([0.95] * 10 + [0.75] * 10 + [0.25] * 10, np.float32)
    target = np.array([1] + [0] * 9 + [1] * 7 + [0] * 3 + [0] * 10, np.int32)
    return preds, target


@pytest.mark.parametrize("grid", ["binned", "exact"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sentinels_ties_and_float32_levels(family, grid):
    """The empty-constraint sentinel (no point meets min 1.0 for precision or
    sensitivity), the zero-primary sentinel (no positive at all: recall 0
    everywhere), tied primaries and constraints equal to curve values."""
    preds, target = _constructed_binary()
    thresholds = GRIDS[grid]
    for min_value in (0.1, 0.7, 1.0, 0.0, 0.4):
        got, want = _call_both(family, "binary", preds, target, min_value, thresholds=thresholds)
        _assert_pair_bitwise(got, want, f"constructed {min_value}")
    got, want = _call_both(family, "binary", preds, np.zeros_like(target), 0.0, thresholds=thresholds)
    _assert_pair_bitwise(got, want, "no positives")


def test_sentinel_values_are_the_documented_ones():
    """The sentinels themselves: ``(0, 1e6)`` when no point meets the
    constraint; ``1e6`` as the threshold of a zero best recall."""
    preds, target = _constructed_binary()
    value, thr = TF.binary_recall_at_fixed_precision(torch.from_numpy(preds), torch.from_numpy(target), 1.0, thresholds=THR)
    assert (float(value), float(thr)) == (0.0, 1e6)
    value, thr = TF.binary_recall_at_fixed_precision(
        torch.from_numpy(preds), torch.from_numpy(np.zeros_like(target)), 0.0, thresholds=THR
    )
    assert (float(value), float(thr)) == (0.0, 1e6)
    value, thr = TF.binary_sensitivity_at_specificity(torch.from_numpy(preds), torch.from_numpy(target), 1.0, thresholds=THR)
    # the ROC family has no zero-value sentinel: only threshold 1 keeps every
    # negative out, and it reports that point's own threshold
    assert (float(value), float(thr)) == (0.0, 1.0)
    assert value.dtype == thr.dtype == torch.float32


def test_min_value_compares_in_float32():
    """A precision of 7/10 is float32(0.7), below the double 0.7: JAX compares in
    float32 (the scalar is weakly typed), so the point meets ``min_precision=0.7``."""
    tm = importlib.import_module("torchmetrics_tpu_torch.functional.classification.recall_fixed_precision")
    precision = torch.tensor([0.7, 0.5], dtype=torch.float32)
    recall = torch.tensor([0.3, 0.9], dtype=torch.float32)
    best, thr = tm._recall_at_precision(precision, recall, torch.tensor([0.2, 0.1]), 0.7)
    assert float(best) == float(np.float32(0.3)) and float(thr) == float(np.float32(0.2))


def _lexargmax(x: np.ndarray) -> int:
    """The reference's host ``_lexargmax``: the oracle of the device selection."""
    idx = None
    for k in range(x.shape[1]):
        col = x[idx, k] if idx is not None else x[:, k]
        z = np.where(col == col.max())[0]
        idx = z if idx is None else idx[z]
        if len(idx) < 2:
            break
    return int(idx[0])


def test_device_selection_equals_the_lexargmax_oracle():
    """The masked-maxima selection picks ``_lexargmax``'s row over the points
    meeting the constraint, on rows built with many ties, per row of a batch."""
    tm = importlib.import_module("torchmetrics_tpu_torch.functional.classification.recall_fixed_precision")
    rng = np.random.default_rng(3)
    primary = rng.integers(0, 4, (64, 12)).astype(np.float32) / 4
    constraint = rng.integers(0, 4, (64, 12)).astype(np.float32) / 4
    thresholds = np.sort(rng.integers(0, 6, 12).astype(np.float32) / 5)
    best, thr = tm._lex_best_at_constraint_device(
        torch.from_numpy(primary), torch.from_numpy(constraint), torch.from_numpy(thresholds), 0.5
    )
    for r in range(64):
        keep = np.where(constraint[r] >= 0.5)[0]
        if not len(keep):
            assert (float(best[r]), float(thr[r])) == (0.0, 1e6)
            continue
        i = keep[_lexargmax(np.stack([primary[r, keep], constraint[r, keep], thresholds[keep]], 1))]
        assert float(best[r]) == primary[r, i]
        assert float(thr[r]) == (thresholds[i] if primary[r, i] != 0 else 1e6)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_within_the_curve_resolution(family):
    """From logits (sigmoid/softmax ulps apart from XLA's) the chosen values
    agree within one grid step's worth of curve change, and the thresholds
    are grid points of both."""
    rng = np.random.default_rng(5)
    preds = rng.standard_normal((N, C)).astype(np.float32)
    target = rng.integers(0, C, N).astype(np.int32)
    got, want = _call_both(family, "multiclass", preds, target, 0.5, thresholds=THR)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=5e-2)
    grid = set(np.asarray(jnp.linspace(0, 1, THR)).tolist()) | {1e6}
    assert set(got[1].numpy().tolist()) <= grid


# ------------------------------------------------------------------ dispatch


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_task_dispatch_bitwise(family, kind):
    stem, _, arg = FAMILIES[family]
    preds, target = _data(kind, seed=9)
    kw = {"task": kind, arg: 0.5, "thresholds": THR, **_kind_args(kind)}
    want = getattr(JF, stem)(jnp.asarray(preds), jnp.asarray(target), **kw)
    got = getattr(TF, stem)(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    _assert_pair_bitwise(got, want, stem)


def _raised(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


BAD = [
    {"task": "multiclass", "num_classes": None},
    {"task": "multilabel", "num_labels": 4.0},
    {"task": "Binary"},
    {"task": "regression"},
    {"task": "binary", "thresholds": 1},
    {"task": "binary", "min": 1.5},
    {"task": "binary", "min": 1},
    {"task": "multiclass", "num_classes": 1},
    {"task": "multilabel", "num_labels": 4, "ignore_index": 0.5},
]


@pytest.mark.parametrize("bad", BAD, ids=lambda b: "-".join(f"{k}={v}" for k, v in b.items()))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dispatch_and_argument_errors_match_jax(family, bad):
    """The dispatchers, the task wrappers and the module classes refuse what
    JAX's refuse, with its messages."""
    stem, klass, arg = FAMILIES[family]
    kw = dict(bad)
    kw[arg] = kw.pop("min", 0.5)
    preds, target = _data("binary", seed=1)
    want = _raised(getattr(JF, stem), jnp.asarray(preds), jnp.asarray(target), **kw)
    assert _raised(getattr(TF, stem), torch.from_numpy(preds), torch.from_numpy(target), **kw) == want
    assert _raised(getattr(T, klass), device="cpu", **kw) == _raised(getattr(J, klass), **kw)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_task_wrapper_builds_the_task_class(family):
    _, klass, arg = FAMILIES[family]
    for kind in KINDS:
        metric = getattr(T, klass)(task=kind, device="cpu", **{arg: 0.5}, **_kind_args(kind))
        want = getattr(J, klass)(task=kind, **{arg: 0.5}, **_kind_args(kind))
        assert type(metric).__name__ == type(want).__name__ == f"{kind.capitalize()}{klass}"
        assert isinstance(metric, getattr(TC, f"{kind.capitalize()}PrecisionRecallCurve"))


# ------------------------------------------------------------------- modules


def _tree(jm):
    return {k: ([np.array(a) for a in v] if isinstance(v, list) else np.asarray(v)) for k, v in jm.state_tree(include_count=True).items()}


def _assert_states_equal(jm, tm):
    want, got = _tree(jm), state_to_numpy(tm, include_count=True)
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        g = got[name]
        if name == "_update_count":
            assert int(g) == int(w)
        elif isinstance(w, list):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and np.array_equal(a, b), name
        else:
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("grid", ["binned", "exact"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_module_parity_and_state_trees(family, kind, grid):
    """Three updates: the states (K1's int32 ``confmat`` or the exact lists)
    and the registry fingerprint equal JAX's; the value and threshold are
    bitwise; a JAX state tree loads into the port and the port's into JAX,
    each giving the same result."""
    _, klass, arg = FAMILIES[family]
    name = f"{kind.capitalize()}{klass}"
    kw = {arg: 0.5, "thresholds": GRIDS[grid], "ignore_index": -1, **_kind_args(kind)}
    jm, tm = getattr(JC, name)(**kw), getattr(TC, name)(device="cpu", **kw)
    for seed in range(3):
        preds, target = _data(kind, seed=60 + seed, ignore=-1)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_states_equal(jm, tm)
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    want = jm.compute()
    _assert_pair_bitwise(tm.compute(), want, name)

    fresh = getattr(TC, name)(device="cpu", **kw)
    state_from_numpy(fresh, _tree(jm), fingerprint=jm.state_spec()["fingerprint"])
    _assert_pair_bitwise(fresh.compute(), want, f"{name} from JAX's tree")
    jfresh = getattr(JC, name)(**kw)
    back = state_to_numpy(tm, include_count=True)
    jfresh.load_state_tree({k: ([jnp.asarray(a) for a in v] if isinstance(v, list) else v) for k, v in back.items()})
    _assert_pair_bitwise(tm.compute(), jfresh.compute(), f"{name} into JAX")


def _points_suite(pkg, grid=THR):
    cls = pkg.classification
    kw = {} if pkg is J else {"device": "cpu"}
    members = {"auroc": cls.MulticlassAUROC(num_classes=C, thresholds=grid, **kw)}
    for family, (_, klass, arg) in FAMILIES.items():
        members[family] = getattr(cls, f"Multiclass{klass}")(num_classes=C, thresholds=grid, **{arg: 0.5}, **kw)
    return pkg.MetricCollection(members)


@pytest.mark.parametrize("grid", ["binned", "exact"])
def test_compute_groups_equal_jax(grid):
    """``MulticlassAUROC`` and the four fixed-point classes on one grid share
    the PR-curve state: one compute group in both packages (one K1 launch per
    batch on the card); in the exact mode they share the cat lists."""
    jcol, tcol = _points_suite(J, GRIDS[grid]), _points_suite(T, GRIDS[grid])
    for seed in range(3):
        preds, target = _data("multiclass", seed=seed)
        jcol.update(jnp.asarray(preds), jnp.asarray(target))
        tcol.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert sorted(map(sorted, tcol.compute_groups.values())) == sorted(map(sorted, jcol.compute_groups.values()))
    assert len(tcol.compute_groups) == 1
    jvals, tvals = jcol.compute(), tcol.compute()
    for key in FAMILIES:
        _assert_pair_bitwise(tvals[key], jvals[key], key)
    np.testing.assert_allclose(tvals["auroc"].numpy(), np.asarray(jvals["auroc"]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["update", "scan"])
def test_fused_plan_equals_the_eager_fold(mode):
    """The five through ``suite.fused()`` on the CPU: the carried ``confmat``
    equals the eager fold's bitwise, and so do the values after ``fold_back``."""
    batches = [_data("multiclass", seed=70 + i) for i in range(4)]
    eager, fused = _points_suite(T), _points_suite(T)
    for p, t in batches[:2]:
        eager.update(torch.from_numpy(p), torch.from_numpy(t))
        fused.update(torch.from_numpy(p), torch.from_numpy(t))
    plan = fused.fused()
    rest = [(torch.from_numpy(p), torch.from_numpy(t)) for p, t in batches[2:]]
    for p, t in rest:
        eager.update(p, t)
    if mode == "update":
        for b in rest:
            plan.update(*b)
    else:
        plan.run_scan(rest)
    plan.fold_back()
    leader = dict.__getitem__(fused, "auroc")
    assert torch.equal(leader.confmat, dict.__getitem__(eager, "auroc").confmat)
    ev, fv = eager.compute(), fused.compute()
    for key in FAMILIES:
        assert torch.equal(fv[key][0], ev[key][0]) and torch.equal(fv[key][1], ev[key][1]), key
