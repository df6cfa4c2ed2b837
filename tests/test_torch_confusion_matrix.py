# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The confusion-matrix families of the port (confusion matrix, Jaccard
index, Matthews correlation coefficient, Cohen's kappa) against the JAX
package's, functional and module forms, and the count under them.

The same seeded numpy inputs go through both packages on the CPU. Budgets:

- ``confmat`` states and un-normalized matrices are bitwise equal int32,
  out-of-range labels included: ``target * C + preds`` wraps in int32 and
  is counted with ``jnp.bincount``'s rules (a negative index in bin 0, one
  past the end dropped);
- normalized matrices and per-class Jaccard indices are divisions of
  exactly summed counts: bitwise;
- a macro or weighted Jaccard average sums float32 scores in another order
  than XLA: ``rtol=1e-6, atol=1e-7``;
- MCC and kappa square and multiply float32 counts and reduce them in
  another order than XLA: ``rtol=1e-5, atol=1e-6``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu
import torchmetrics_tpu.classification as JC
import torchmetrics_tpu.functional.classification as JF
import torchmetrics_tpu_torch as T
import torchmetrics_tpu_torch.functional.classification as TF
from torchmetrics_tpu.functional.classification.matthews_corrcoef import _matthews_corrcoef_reduce as jax_mcc_reduce
from torchmetrics_tpu_torch.functional.classification.matthews_corrcoef import _matthews_corrcoef_reduce
from torchmetrics_tpu_torch.interop import state_to_numpy
from torchmetrics_tpu_torch.utilities.data import _bincount

C, L, N = 6, 4, 300
AVG = (1e-6, 1e-7)
MCC_KAPPA = (1e-5, 1e-6)


def _data(kind, seed, ignore=None, logits=True, labels=False):
    """Seeded (preds, target) of ``kind``: binary (N,) and multilabel (N, L, 2)
    logits with {0, 1} targets, multiclass (N, C) scores (or (N,) labels)
    with (N,) labels; about a tenth of the targets set to ``ignore``."""
    rng = np.random.default_rng(seed)
    if kind == "binary":
        preds = rng.standard_normal(N).astype(np.float32) * 2
        target = rng.integers(0, 2, N)
    elif kind == "multiclass":
        target = rng.integers(0, C, N)
        preds = rng.integers(0, C, N).astype(np.int32) if labels else rng.standard_normal((N, C)).astype(np.float32)
    else:
        preds = rng.standard_normal((N, L, 2)).astype(np.float32) * 2
        target = rng.integers(0, 2, (N, L, 2))
    if not logits and not labels:
        preds = (1 / (1 + np.exp(-preds))).astype(np.float32)
    if ignore is not None:
        target = np.where(rng.random(target.shape) < 0.1, ignore, target)
    return preds, target.astype(np.int32)


def _both(jfn, tfn, preds, target, **kw):
    want = np.asarray(jfn(jnp.asarray(preds), jnp.asarray(target), **kw))
    got = tfn(torch.from_numpy(preds.copy()), torch.from_numpy(target.copy()), **kw)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    return got.numpy(), want


def _assert_value(got, want, budget=None):
    """Bitwise (dtype included) without a budget, else within ``(rtol, atol)``."""
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape, got.dtype, want.dtype)
    if budget is None:
        np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8))
    else:
        np.testing.assert_allclose(got, want, rtol=budget[0], atol=budget[1])


def _kind_args(kind):
    return {"multiclass": {"num_classes": C}, "multilabel": {"num_labels": L}}.get(kind, {})


def _raised(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


# ------------------------------------------------------------ the count


def test_capture_safe_count_equals_bincount():
    """``_bincount`` (int32 ones added into minlength + 1 fixed bins, the last
    a trash bin) equals ``torch.bincount`` of the clipped values and
    ``jnp.bincount`` bitwise, on negatives, values past the end and the
    trash bin's own index."""
    rng = np.random.default_rng(0)
    n = 37
    x = np.concatenate([rng.integers(-50, 2 * n, 4000), [-(2**31), 2**31 - 1, n, n, n - 1, 0, -1]]).astype(np.int32)
    got = _bincount(torch.from_numpy(x), minlength=n)
    want = torch.bincount(torch.from_numpy(x).to(torch.int64).clamp(0, n), minlength=n + 1)[:n].to(torch.int32)
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.bincount(jnp.asarray(x), length=n)))


# ------------------------------------------------------- confusion matrix

CM_CASES = [
    (kind, normalize, ignore)
    for kind, ignores in (("binary", (None, -1)), ("multiclass", (None, 2, -1)), ("multilabel", (None, -1)))
    for ignore in ignores
    for normalize in (None, "true", "pred", "all")
]


@pytest.mark.parametrize("kind,normalize,ignore", CM_CASES)
def test_confusion_matrix_functional_parity(kind, normalize, ignore):
    """``*_confusion_matrix`` and the dispatcher == JAX's bitwise, every ``normalize``."""
    preds, target = _data(kind, seed=len(CM_CASES) + CM_CASES.index((kind, normalize, ignore)), ignore=ignore)
    kw = {"normalize": normalize, "ignore_index": ignore, **_kind_args(kind)}
    got, want = _both(getattr(JF, f"{kind}_confusion_matrix"), getattr(TF, f"{kind}_confusion_matrix"), preds, target, **kw)
    _assert_value(got, want)
    got, want = _both(JF.confusion_matrix, TF.confusion_matrix, preds, target, task=kind, **kw)
    _assert_value(got, want)


def _out_of_range(seed):
    """int32 label pairs outside [0, C): negatives, values past C, and targets
    whose ``target * C`` wraps around int32."""
    rng = np.random.default_rng(seed)
    target = rng.integers(-3, C + 3, N)
    target[:6] = [2**30, -(2**30), 2**31 - 1, -(2**31), 715827883, -715827882]
    preds = rng.integers(-3, C + 3, N)
    preds[6:9] = [2**31 - 1, -(2**31), C]
    return preds.astype(np.int32), target.astype(np.int32)


@pytest.mark.parametrize("ignore", [None, 3, -1, 2**20])
def test_confusion_matrix_out_of_range_labels_match_jnp_bincount(ignore):
    """Unvalidated out-of-range labels: with ``ignore_index`` the predictions
    clip into the classes and ignored entries drop; without it ``target * C +
    preds`` wraps in int32 and lands where JAX's lands, negatives in bin 0
    and indices past C*C dropped. The confusion-matrix family and the stat
    scores' matrix (K2's plain version) both."""
    preds, target = _out_of_range(abs(ignore or 0))
    kw = {"num_classes": C, "ignore_index": ignore, "validate_args": False}
    got, want = _both(JF.multiclass_confusion_matrix, TF.multiclass_confusion_matrix, preds, target, **kw)
    _assert_value(got, want)
    assert int(want.sum()) < N if ignore is None else True, "the case must drop some entries"
    for family in ("jaccard_index", "matthews_corrcoef", "cohen_kappa"):
        got, want = _both(getattr(JF, f"multiclass_{family}"), getattr(TF, f"multiclass_{family}"), preds, target, **kw)
        _assert_value(got, want, MCC_KAPPA)
    got, want = _both(JF.multiclass_precision, TF.multiclass_precision, preds, target, average="none", **kw)
    _assert_value(got, want)


def _hard_rows(c):
    """Score rows on which ``jnp.argmax``'s rule decides: ties, NaN, -inf, +-0."""
    scores = np.random.default_rng(4).standard_normal((16, c)).astype(np.float32)
    scores[0] = np.nan
    scores[1] = -np.inf
    scores[2] = 0.0
    scores[2, ::2] = -0.0
    scores[3] = 0.25
    scores[4, c // 2 :] = 1e9
    scores[5, c - 1] = np.nan
    scores[6, 1:] = np.inf
    scores[6, 3] = np.nan
    return scores


def test_confusion_matrix_argmax_hard_rows_match_jax():
    """The argmax before the count keeps ``jnp.argmax``'s rule: the first NaN, else the first maximum."""
    scores = _hard_rows(C)
    target = (np.arange(16) % C).astype(np.int32)
    got, want = _both(JF.multiclass_confusion_matrix, TF.multiclass_confusion_matrix, scores, target, num_classes=C, validate_args=False)
    _assert_value(got, want)


@pytest.mark.parametrize(
    "bad",
    [
        {"task": "multiclass"},
        {"task": "multilabel", "num_labels": 4.0},
        {"task": "other"},
        {"task": "binary", "normalize": "rows"},
        {"task": "binary", "threshold": 2},
        {"task": "multiclass", "num_classes": 1},
        {"task": "multiclass", "num_classes": C, "ignore_index": 1.5},
    ],
    ids=lambda b: "-".join(f"{k}={v}" for k, v in b.items()),
)
def test_confusion_matrix_errors_match_jax(bad):
    preds, target = _data("binary", seed=3)
    want = _raised(JF.confusion_matrix, jnp.asarray(preds), jnp.asarray(target), **bad)
    assert _raised(TF.confusion_matrix, torch.from_numpy(preds), torch.from_numpy(target), **bad) == want
    assert _raised(T.ConfusionMatrix, device="cpu", **bad) == _raised(JC.ConfusionMatrix, **bad)


@pytest.mark.parametrize(
    "kind,fn,bad",
    [
        ("binary", "binary_confusion_matrix", "preds"),
        ("binary", "binary_confusion_matrix", "target"),
        ("multiclass", "multiclass_confusion_matrix", "target"),
        ("multiclass", "multiclass_confusion_matrix", "preds"),
        ("multilabel", "multilabel_confusion_matrix", "target"),
    ],
)
def test_confusion_matrix_value_checks_match_jax(kind, fn, bad):
    """``validate_args`` refuses the values JAX's refuses, with the same error type and message head."""
    preds, target = _data(kind, seed=9, labels=kind == "multiclass")
    if bad == "target":
        target = target.copy()
        target.flat[0] = 7
    elif kind == "binary":
        preds = (preds > 0).astype(np.int32) * 3
    else:
        preds = preds.copy()
        preds[0] = C
    jt, jmsg = _raised(getattr(JF, fn), jnp.asarray(preds), jnp.asarray(target), **_kind_args(kind))
    tt, tmsg = _raised(getattr(TF, fn), torch.from_numpy(preds), torch.from_numpy(target), **_kind_args(kind))
    assert tt is jt and tmsg.split(":")[0] == jmsg.split(":")[0], (tmsg, jmsg)


# ------------------------------------------------------------------ jaccard

JACCARD_CASES = [
    ("binary", {}),
    ("binary", {"ignore_index": -1, "zero_division": 1}),
    *[("multiclass", {"average": a, "ignore_index": i}) for a in ("micro", "macro", "weighted", "none") for i in (None, 2)],
    ("multiclass", {"average": "macro", "ignore_index": -1}),
    *[("multilabel", {"average": a}) for a in ("micro", "macro", "weighted", "none")],
    ("multilabel", {"average": "macro", "ignore_index": -1, "threshold": 0.3}),
]


@pytest.mark.parametrize("kind,kw", JACCARD_CASES, ids=lambda c: str(c))
def test_jaccard_functional_parity(kind, kw):
    preds, target = _data(kind, seed=JACCARD_CASES.index((kind, kw)), ignore=kw.get("ignore_index"))
    got, want = _both(getattr(JF, f"{kind}_jaccard_index"), getattr(TF, f"{kind}_jaccard_index"), preds, target, **_kind_args(kind), **kw)
    _assert_value(got, want, None if kw.get("average") in ("micro", "none", None) else AVG)
    if kind != "binary":
        got, want = _both(JF.jaccard_index, TF.jaccard_index, preds, target, task=kind, **_kind_args(kind), **kw)
        _assert_value(got, want, None if kw.get("average") in ("micro", "none", None) else AVG)


def test_jaccard_zero_division_and_absent_classes():
    """Classes absent from both preds and target drop out of the macro
    average; a class with nothing in its union takes ``zero_division``."""
    preds = np.array([0, 0, 1, 1, 3], np.int32)
    target = np.array([0, 1, 1, 1, 3], np.int32)
    for zd in (0, 1):
        for average in ("macro", "none", "weighted", "micro"):
            got, want = _both(JF.multiclass_jaccard_index, TF.multiclass_jaccard_index, preds, target,
                              num_classes=C, average=average, zero_division=zd)
            _assert_value(got, want, None if average in ("none", "micro") else AVG)


# --------------------------------------------------------------------- MCC


@pytest.mark.parametrize("kind,ignore", [("binary", None), ("binary", -1), ("multiclass", None), ("multiclass", 1), ("multilabel", -1)])
def test_mcc_functional_parity(kind, ignore):
    preds, target = _data(kind, seed=21, ignore=ignore)
    kw = {"ignore_index": ignore, **_kind_args(kind)}
    got, want = _both(getattr(JF, f"{kind}_matthews_corrcoef"), getattr(TF, f"{kind}_matthews_corrcoef"), preds, target, **kw)
    _assert_value(got, want, MCC_KAPPA)
    got, want = _both(JF.matthews_corrcoef, TF.matthews_corrcoef, preds, target, task=kind, **kw)
    _assert_value(got, want, MCC_KAPPA)


# [[tn, fp], [fn, tp]] with a vanishing denominator: the four (a, b) branches
# of the special case, every entry right or every one wrong, and no entry
MCC_SPECIAL = {
    "tn=fn=0": [[0, 3], [0, 5]],
    "tn=fp=0": [[0, 0], [3, 5]],
    "tp=fn=0": [[5, 3], [0, 0]],
    "tp=fp=0": [[5, 0], [3, 0]],
    "all_right": [[4, 0], [0, 0]],
    "all_wrong": [[0, 2], [6, 0]],
    "empty": [[0, 0], [0, 0]],
    "regular": [[7, 2], [3, 9]],
}


@pytest.mark.parametrize("name", sorted(MCC_SPECIAL))
def test_mcc_binary_special_cases_match_jax(name):
    confmat = np.asarray(MCC_SPECIAL[name], np.int32)
    got = _matthews_corrcoef_reduce(torch.from_numpy(confmat)).numpy()
    want = np.asarray(jax_mcc_reduce(jnp.asarray(confmat)))
    _assert_value(got, want, MCC_KAPPA)
    multilabel = np.stack([confmat, np.zeros_like(confmat)])  # summed over labels first
    _assert_value(_matthews_corrcoef_reduce(torch.from_numpy(multilabel)).numpy(), want, MCC_KAPPA)


# ------------------------------------------------------------------- kappa


@pytest.mark.parametrize("weights", [None, "none", "linear", "quadratic"])
@pytest.mark.parametrize("kind,ignore", [("binary", None), ("binary", -1), ("multiclass", None), ("multiclass", 0)])
def test_cohen_kappa_functional_parity(kind, ignore, weights):
    preds, target = _data(kind, seed=31, ignore=ignore)
    kw = {"ignore_index": ignore, "weights": weights, **_kind_args(kind)}
    got, want = _both(getattr(JF, f"{kind}_cohen_kappa"), getattr(TF, f"{kind}_cohen_kappa"), preds, target, **kw)
    _assert_value(got, want, MCC_KAPPA)
    got, want = _both(JF.cohen_kappa, TF.cohen_kappa, preds, target, task=kind, **kw)
    _assert_value(got, want, MCC_KAPPA)


@pytest.mark.parametrize(
    "fn,bad",
    [
        ("cohen_kappa", {"task": "multilabel", "num_classes": C}),
        ("cohen_kappa", {"task": "multiclass"}),
        ("cohen_kappa", {"task": "binary", "weights": "cubic"}),
        ("matthews_corrcoef", {"task": "multiclass", "num_classes": "6"}),
        ("matthews_corrcoef", {"task": "multilabel"}),
        ("jaccard_index", {"task": "multiclass", "num_classes": C, "average": "samples"}),
        ("jaccard_index", {"task": "multilabel"}),
    ],
    ids=lambda v: v if isinstance(v, str) else "-".join(f"{k}={x}" for k, x in v.items()),
)
def test_family_dispatch_errors_match_jax(fn, bad):
    preds, target = _data("multiclass", seed=5)
    want = _raised(getattr(JF, fn), jnp.asarray(preds), jnp.asarray(target), **bad)
    assert _raised(getattr(TF, fn), torch.from_numpy(preds), torch.from_numpy(target), **bad) == want
    klass = {"cohen_kappa": "CohenKappa", "matthews_corrcoef": "MatthewsCorrCoef", "jaccard_index": "JaccardIndex"}[fn]
    assert _raised(getattr(T, klass), device="cpu", **bad) == _raised(getattr(JC, klass), **bad)


# ----------------------------------------------------------------- modules

MODULE_CASES = [
    ("BinaryConfusionMatrix", "binary", {"ignore_index": -1, "normalize": "true"}, None),
    ("MulticlassConfusionMatrix", "multiclass", {"normalize": "pred"}, None),
    ("MulticlassConfusionMatrix", "multiclass", {"ignore_index": 2, "normalize": "all"}, None),
    ("MultilabelConfusionMatrix", "multilabel", {"ignore_index": -1}, None),
    ("BinaryJaccardIndex", "binary", {"zero_division": 1}, None),
    ("MulticlassJaccardIndex", "multiclass", {"average": "macro", "ignore_index": 2}, AVG),
    ("MulticlassJaccardIndex", "multiclass", {"average": "none"}, None),
    ("MultilabelJaccardIndex", "multilabel", {"average": "weighted"}, AVG),
    ("BinaryMatthewsCorrCoef", "binary", {}, MCC_KAPPA),
    ("MulticlassMatthewsCorrCoef", "multiclass", {"ignore_index": -1}, MCC_KAPPA),
    ("MultilabelMatthewsCorrCoef", "multilabel", {}, MCC_KAPPA),
    ("BinaryCohenKappa", "binary", {"weights": "linear"}, MCC_KAPPA),
    ("MulticlassCohenKappa", "multiclass", {"weights": "quadratic"}, MCC_KAPPA),
    ("MulticlassCohenKappa", "multiclass", {"ignore_index": 0}, MCC_KAPPA),
]


@pytest.mark.parametrize("klass,kind,kw,budget", MODULE_CASES, ids=lambda v: v if isinstance(v, str) else None)
def test_module_parity(klass, kind, kw, budget):
    """Three updates (logits, then probabilities, then labels where the kind
    takes them): the int32 ``confmat`` bitwise and the fingerprint equal to
    JAX's, the value within the budget."""
    jm, tm = getattr(JC, klass)(**_kind_args(kind), **kw), getattr(T, klass)(**_kind_args(kind), device="cpu", **kw)
    assert tm.higher_is_better == jm.higher_is_better
    for seed in range(3):
        preds, target = _data(kind, seed=seed, ignore=kw.get("ignore_index"), logits=seed != 1, labels=seed == 2 and kind == "multiclass")
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    got, want = state_to_numpy(tm)["confmat"], np.asarray(jm.confmat)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    _assert_value(tm.compute().numpy(), np.asarray(jm.compute()), budget)


@pytest.mark.parametrize(
    "wrapper,task,args,klass",
    [
        ("ConfusionMatrix", "multilabel", {"num_labels": L}, "MultilabelConfusionMatrix"),
        ("JaccardIndex", "multiclass", {"num_classes": C}, "MulticlassJaccardIndex"),
        ("MatthewsCorrCoef", "binary", {}, "BinaryMatthewsCorrCoef"),
        ("CohenKappa", "multiclass", {"num_classes": C, "weights": "linear"}, "MulticlassCohenKappa"),
    ],
)
def test_task_wrappers_build_the_task_class(wrapper, task, args, klass):
    assert type(getattr(T, wrapper)(task=task, device="cpu", **args)).__name__ == klass


def test_confusion_matrix_families_share_one_compute_group():
    """ConfusionMatrix, Jaccard, MCC and kappa over one C form one compute
    group with one C x C ``confmat``, as in JAX."""
    def members(pkg, **kw):
        return {
            "cm": pkg.MulticlassConfusionMatrix(num_classes=C, **kw),
            "jaccard": pkg.MulticlassJaccardIndex(num_classes=C, **kw),
            "mcc": pkg.MulticlassMatthewsCorrCoef(num_classes=C, **kw),
            "kappa": pkg.MulticlassCohenKappa(num_classes=C, **kw),
        }

    jcol = torchmetrics_tpu.MetricCollection(members(JC))
    tcol = T.MetricCollection(members(T, device="cpu"))
    for seed in range(2):
        preds, target = _data("multiclass", seed=seed)
        jcol.update(jnp.asarray(preds), jnp.asarray(target))
        tcol.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert [sorted(g) for g in tcol.compute_groups.values()] == [sorted(g) for g in jcol.compute_groups.values()]
    assert len(tcol.compute_groups) == 1
    jvals, tvals = jcol.compute(), tcol.compute()
    _assert_value(tvals["cm"].numpy(), np.asarray(jvals["cm"]))
    for key in ("jaccard", "mcc", "kappa"):
        _assert_value(tvals[key].numpy(), np.asarray(jvals[key]), MCC_KAPPA)
