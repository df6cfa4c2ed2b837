# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The stat-scores families of the port (precision, recall, negative
predictive value, specificity, Hamming distance) and exact match, against
the JAX package's, functional and module forms.

The same seeded numpy inputs go through both packages on the CPU. Budgets:

- integer states (tp/fp/tn/fn, exact match's correct/total) are bitwise
  equal, dtype included;
- a value that is one division of counts per entry (``average`` binary,
  micro or none, and exact match) is bitwise equal;
- a macro or weighted average sums float32 scores in another order than
  XLA: ``rtol=1e-6, atol=1e-7``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as JC
import torchmetrics_tpu.functional.classification as JF
import torchmetrics_tpu_torch as T
import torchmetrics_tpu_torch.functional.classification as TF
from torchmetrics_tpu_torch.interop import state_to_numpy

C, L, N, X = 5, 4, 240, 3
RTOL, ATOL = 1e-6, 1e-7
FAMILIES = {
    "precision": "Precision",
    "recall": "Recall",
    "negative_predictive_value": "NegativePredictiveValue",
    "specificity": "Specificity",
    "hamming_distance": "HammingDistance",
}


def _data(kind, seed, samplewise=False, ignore=None, logits=True):
    """Seeded (preds, target): binary and multilabel logits (or probabilities)
    with {0, 1} targets, multiclass (N, C[, X]) scores with labels; about a
    tenth of the targets set to ``ignore`` where given."""
    rng = np.random.default_rng(seed)
    extra = (X,) if samplewise else ()
    if kind == "binary":
        preds = rng.standard_normal((N,) + extra).astype(np.float32) * 2
        target = rng.integers(0, 2, (N,) + extra)
    elif kind == "multiclass":
        preds = rng.standard_normal((N, C) + extra).astype(np.float32)
        target = rng.integers(0, C, (N,) + extra)
    else:
        preds = rng.standard_normal((N, L) + extra).astype(np.float32) * 2
        target = rng.integers(0, 2, (N, L) + extra)
    if not logits:
        preds = (1 / (1 + np.exp(-preds))).astype(np.float32)
    if ignore is not None:
        target = np.where(rng.random(target.shape) < 0.1, ignore, target)
    return preds, target.astype(np.int32)


def _both(jfn, tfn, preds, target, **kw):
    want = np.asarray(jfn(jnp.asarray(preds), jnp.asarray(target), **kw))
    got = tfn(torch.from_numpy(preds.copy()), torch.from_numpy(target.copy()), **kw)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    return got.numpy(), want


def _assert_value(got, want, exact):
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if exact:
        np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8))
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _exact(average):
    return average in ("binary", "micro", "none", None)


# (kind, arguments) of the functional cases every family runs
CASES = [
    ("binary", {}),
    ("binary", {"multidim_average": "samplewise", "ignore_index": -1}),
    ("binary", {"zero_division": 1, "threshold": 0.3}),
    ("multiclass", {"average": "micro"}),
    ("multiclass", {"average": "macro"}),
    ("multiclass", {"average": "weighted", "ignore_index": 1}),
    ("multiclass", {"average": "none", "zero_division": 1}),
    ("multiclass", {"average": None, "ignore_index": -1}),
    ("multiclass", {"average": "macro", "top_k": 2}),
    ("multiclass", {"average": "micro", "top_k": 3, "ignore_index": 0}),
    ("multiclass", {"average": "macro", "multidim_average": "samplewise"}),
    ("multiclass", {"average": "none", "multidim_average": "samplewise", "ignore_index": 2}),
    ("multilabel", {"average": "micro"}),
    ("multilabel", {"average": "macro", "ignore_index": -1}),
    ("multilabel", {"average": "weighted"}),
    ("multilabel", {"average": "none", "threshold": 0.7, "zero_division": 1}),
    ("multilabel", {"average": "micro", "multidim_average": "samplewise"}),
]


def _case_id(case):
    kind, kw = case
    return "-".join([kind] + [f"{k}={v}" for k, v in kw.items()])


def _kind_args(kind):
    return {"multiclass": {"num_classes": C}, "multilabel": {"num_labels": L}}.get(kind, {})


@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_functional_parity(family, case):
    """``binary_*``/``multiclass_*``/``multilabel_*`` of every family == JAX's."""
    kind, kw = case
    samplewise = kw.get("multidim_average") == "samplewise"
    ignore = kw.get("ignore_index")
    preds, target = _data(kind, seed=len(family) + CASES.index(case), samplewise=samplewise, ignore=ignore)
    name = f"{kind}_{family}"
    got, want = _both(getattr(JF, name), getattr(TF, name), preds, target, **_kind_args(kind), **kw)
    average = "binary" if kind == "binary" else kw.get("average", "macro")
    _assert_value(got, want, _exact(average))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_task_dispatch_parity(family):
    """The task dispatcher routes like JAX's, to the same values."""
    for kind, kw in (("binary", {}), ("multiclass", {"average": "none"}), ("multilabel", {"average": "micro"})):
        preds, target = _data(kind, seed=7)
        got, want = _both(getattr(JF, family), getattr(TF, family), preds, target, task=kind, **_kind_args(kind), **kw)
        _assert_value(got, want, exact=True)


def _raised(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


DISPATCH_ERRORS = [
    {"task": "multiclass", "num_classes": None},
    {"task": "multiclass", "num_classes": C, "top_k": 1.5},
    {"task": "multilabel", "num_labels": "4"},
    {"task": "regression"},
]


@pytest.mark.parametrize("bad", DISPATCH_ERRORS, ids=lambda b: "-".join(f"{k}={v}" for k, v in b.items()))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_task_dispatch_errors_match_jax(family, bad):
    """The dispatchers and the task wrappers refuse what JAX's refuse, with its messages."""
    preds, target = _data("multiclass", seed=1)
    want = _raised(getattr(JF, family), jnp.asarray(preds), jnp.asarray(target), **bad)
    assert _raised(getattr(TF, family), torch.from_numpy(preds), torch.from_numpy(target), **bad) == want
    klass = FAMILIES[family]
    want = _raised(getattr(JC, klass), **bad)
    assert _raised(getattr(T, klass), device="cpu", **bad) == want


@pytest.mark.parametrize("bad", [{"average": "mean"}, {"multidim_average": "all"}, {"zero_division": 2}, {"top_k": 9}])
def test_argument_errors_match_jax(bad):
    preds, target = _data("multiclass", seed=2)
    want = _raised(JF.multiclass_precision, jnp.asarray(preds), jnp.asarray(target), num_classes=C, **bad)
    assert _raised(TF.multiclass_precision, torch.from_numpy(preds), torch.from_numpy(target), num_classes=C, **bad) == want


# ---------------------------------------------------------------- modules

MODULE_CASES = [
    ("Binary", {"ignore_index": -1}),
    ("Binary", {"multidim_average": "samplewise"}),
    ("Multiclass", {"average": "macro"}),
    ("Multiclass", {"average": "micro"}),
    ("Multiclass", {"average": "weighted", "ignore_index": 0}),
    ("Multiclass", {"average": "none", "top_k": 2}),
    ("Multiclass", {"average": "macro", "multidim_average": "samplewise"}),
    ("Multilabel", {"average": "macro", "ignore_index": -1}),
    ("Multilabel", {"average": "micro", "multidim_average": "samplewise"}),
]


def _assert_states_equal(jm, tm):
    js = {k: np.concatenate([np.atleast_1d(np.asarray(x)) for x in v]) if isinstance(v, list) else np.asarray(v)
          for k, v in jm.state_tree().items()}
    ts = state_to_numpy(tm)
    assert sorted(js) == sorted(ts)
    for name, want in js.items():
        got = np.concatenate([np.atleast_1d(x) for x in ts[name]]) if isinstance(ts[name], list) else ts[name]
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("case", MODULE_CASES, ids=lambda c: "-".join([c[0]] + [f"{k}={v}" for k, v in c[1].items()]))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_module_parity(family, case):
    """Three updates of every family's module class: states bitwise (and the
    registry fingerprint) equal to JAX's, the value within the budget."""
    prefix, kw = case
    kind = prefix.lower()
    args = {"multiclass": {"num_classes": C}, "multilabel": {"num_labels": L}}.get(kind, {})
    klass = f"{prefix}{FAMILIES[family]}"
    jm, tm = getattr(JC, klass)(**args, **kw), getattr(T, klass)(**args, device="cpu", **kw)
    assert type(tm).__name__ == klass and tm.higher_is_better == jm.higher_is_better
    samplewise = kw.get("multidim_average") == "samplewise"
    for seed in range(3):
        preds, target = _data(kind, seed=seed, samplewise=samplewise, ignore=kw.get("ignore_index"), logits=seed != 1)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_states_equal(jm, tm)
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    average = "binary" if kind == "binary" else kw.get("average")
    _assert_value(tm.compute().numpy(), np.asarray(jm.compute()), _exact(average))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_task_wrapper_builds_the_task_class(family):
    for task, args, prefix in (
        ("binary", {}, "Binary"),
        ("multiclass", {"num_classes": C}, "Multiclass"),
        ("multilabel", {"num_labels": L}, "Multilabel"),
    ):
        metric = getattr(T, FAMILIES[family])(task=task, device="cpu", **args)
        assert type(metric).__name__ == f"{prefix}{FAMILIES[family]}"


def test_stat_scores_families_share_one_compute_group():
    """Precision, recall, NPV, specificity and Hamming over one C form one
    compute group (one K2 launch per batch on the card), as in JAX."""
    def members(pkg, **kw):
        return {k: getattr(pkg, f"Multiclass{v}")(num_classes=C, average="macro", **kw) for k, v in FAMILIES.items()}

    jcol = __import__("torchmetrics_tpu").MetricCollection(members(JC))
    tcol = T.MetricCollection(members(T, device="cpu"))
    for seed in range(2):
        preds, target = _data("multiclass", seed=seed)
        jcol.update(jnp.asarray(preds), jnp.asarray(target))
        tcol.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert sorted(map(sorted, tcol.compute_groups.values())) == sorted(map(sorted, jcol.compute_groups.values()))
    assert len(tcol.compute_groups) == 1
    jvals, tvals = jcol.compute(), tcol.compute()
    for key in jvals:
        _assert_value(tvals[key].numpy(), np.asarray(jvals[key]), exact=False)


# ------------------------------------------------------------- exact match

EXACT_CASES = [
    ("multiclass", {}),
    ("multiclass", {"ignore_index": 1}),
    ("multiclass", {"multidim_average": "samplewise"}),
    ("multiclass", {"multidim_average": "samplewise", "ignore_index": -1}),
    ("multilabel", {}),
    ("multilabel", {"ignore_index": -1, "threshold": 0.4}),
    ("multilabel", {"multidim_average": "samplewise"}),
]


def _exact_match_data(kind, seed, samplewise, ignore):
    """Inputs where whole samples often match: few classes and entries per sample."""
    rng = np.random.default_rng(seed)
    extra = (X,) if samplewise else (2,)
    if kind == "multiclass":
        target = rng.integers(0, 3, (N,) + extra)
        preds = np.where(rng.random(target.shape) < 0.8, target, rng.integers(0, C, target.shape)).astype(np.int32)
    else:
        target = rng.integers(0, 2, (N, 2) + extra)
        preds = np.where(rng.random(target.shape) < 0.9, target, 1 - target).astype(np.int32)
    if ignore is not None:
        target = np.where(rng.random(target.shape) < 0.1, ignore, target)
    return preds, target.astype(np.int32)


@pytest.mark.parametrize("case", EXACT_CASES, ids=_case_id)
def test_exact_match_parity(case):
    """Functional, task-dispatched and module exact match == JAX's: values and
    states bitwise (int32 counters; a samplewise multiclass ``correct`` is bool)."""
    kind, kw = case
    samplewise = kw.get("multidim_average") == "samplewise"
    args = {"num_classes": C} if kind == "multiclass" else {"num_labels": 2}
    preds, target = _exact_match_data(kind, 5, samplewise, kw.get("ignore_index"))
    got, want = _both(getattr(JF, f"{kind}_exact_match"), getattr(TF, f"{kind}_exact_match"), preds, target, **args, **kw)
    _assert_value(got, want, exact=True)
    got, want = _both(JF.exact_match, TF.exact_match, preds, target, task=kind, **args, **kw)
    _assert_value(got, want, exact=True)

    klass = f"{kind.capitalize()}ExactMatch"
    jm, tm = getattr(JC, klass)(**args, **kw), getattr(T, klass)(**args, device="cpu", **kw)
    for seed in range(3):
        preds, target = _exact_match_data(kind, seed, samplewise, kw.get("ignore_index"))
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_states_equal(jm, tm)
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    _assert_value(tm.compute().numpy(), np.asarray(jm.compute()), exact=True)
    assert type(T.ExactMatch(task=kind, device="cpu", **args, **kw)).__name__ == klass


@pytest.mark.parametrize("bad", [{"task": "binary"}, {"task": "multiclass"}, {"task": "multilabel", "num_labels": 2.0}])
def test_exact_match_dispatch_errors_match_jax(bad):
    preds, target = _exact_match_data("multiclass", 0, False, None)
    want = _raised(JF.exact_match, jnp.asarray(preds), jnp.asarray(target), **bad)
    assert _raised(TF.exact_match, torch.from_numpy(preds), torch.from_numpy(target), **bad) == want
    assert _raised(T.ExactMatch, device="cpu", **bad) == _raised(JC.ExactMatch, **bad)
