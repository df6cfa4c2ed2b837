# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's multilabel classification against the JAX package's.

The same seeded numpy batches go through both packages on the CPU. The
multilabel tp/fp/tn/fn are elementwise compares and sums in both: held
bitwise and int32, globally and samplewise, for every ``average`` and with
``ignore_index``. The binned multilabel curve state is K1's matrix mode
(here its plain version): held bitwise. Values from probabilities agree
within ``rtol=1e-6, atol=1e-7``; from logits a sigmoid ulp can flip a
``pred > threshold`` compare, so only the final values are held, within the
budget each test states.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as J
import torchmetrics_tpu.functional.classification as JF
import torchmetrics_tpu_torch as T
import torchmetrics_tpu_torch.functional.classification as TF
from torchmetrics_tpu import MetricCollection as JMetricCollection
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy

jss = importlib.import_module("torchmetrics_tpu.functional.classification.stat_scores")
tss = importlib.import_module("torchmetrics_tpu_torch.functional.classification.stat_scores")
jprc = importlib.import_module("torchmetrics_tpu.functional.classification.precision_recall_curve")
tprc = importlib.import_module("torchmetrics_tpu_torch.functional.classification.precision_recall_curve")

N, L = 300, 6
RTOL, ATOL = 1e-6, 1e-7


def _batch(seed, n=N, logits=False, ignore=False, extra=None):
    """(preds float32, target int32) of shape (n, L) or (n, L, extra); probabilities hit 0.5 exactly now and then."""
    rng = np.random.default_rng(seed)
    shape = (n, L) if extra is None else (n, L, extra)
    if logits:
        p = (rng.standard_normal(shape) * 2).astype(np.float32)
    else:
        p = np.round(rng.random(shape), 2).astype(np.float32)
    t = rng.integers(0, 2, shape).astype(np.int32)
    if ignore:
        t.reshape(-1)[rng.integers(0, t.size, t.size // 10)] = -1
    return p, t


def _bitwise_int32(got, want):
    want = np.asarray(want)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got), np.asarray(want), rtol=rtol, atol=atol)


# --------------------------------------------------------------- stat scores


@pytest.mark.parametrize("ignore_index", [None, -1, 0])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
def test_multilabel_update_bitwise_int32(multidim_average, ignore_index):
    p, t = _batch(1, extra=3 if multidim_average == "samplewise" else None, ignore=ignore_index == -1)
    jp, jt = jss._multilabel_stat_scores_format(jnp.asarray(p), jnp.asarray(t), L, 0.5, ignore_index)
    want = jss._multilabel_stat_scores_update(jp, jt, multidim_average)
    tp_, tt = tss._multilabel_stat_scores_format(torch.from_numpy(p), torch.from_numpy(t), L, 0.5, ignore_index)
    _bitwise_int32(tp_, jp)
    _bitwise_int32(tt, jt)
    for g, w in zip(tss._multilabel_stat_scores_update(tp_, tt, multidim_average), want):
        _bitwise_int32(g, w)


@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none", None])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
def test_multilabel_stat_scores_every_average(average, multidim_average):
    p, t = _batch(2, extra=2 if multidim_average == "samplewise" else None, ignore=True)
    kw = dict(num_labels=L, average=average, multidim_average=multidim_average, ignore_index=-1)
    want = np.asarray(JF.multilabel_stat_scores(jnp.asarray(p), jnp.asarray(t), **kw))
    got = TF.multilabel_stat_scores(torch.from_numpy(p), torch.from_numpy(t), **kw)
    if want.dtype == np.int32:
        _bitwise_int32(got, want)
    else:
        assert got.dtype == torch.float32
        _close(got, want)


def _functional_cases():
    """(name, kwargs, ignore entries in the target)."""
    return [
        ("multilabel_accuracy", {"num_labels": L}, False),
        ("multilabel_accuracy", {"num_labels": L, "average": "micro", "ignore_index": -1}, True),
        ("multilabel_accuracy", {"num_labels": L, "average": None, "threshold": 0.3}, False),
        ("multilabel_f1_score", {"num_labels": L, "average": "macro", "ignore_index": -1}, True),
        ("multilabel_f1_score", {"num_labels": L, "average": "weighted"}, False),
        ("multilabel_fbeta_score", {"beta": 2.0, "num_labels": L, "average": "micro"}, False),
        ("multilabel_fbeta_score", {"beta": 0.5, "num_labels": L, "average": "none", "zero_division": 1}, False),
        ("multilabel_auroc", {"num_labels": L, "thresholds": 21}, False),
        ("multilabel_auroc", {"num_labels": L, "thresholds": 21, "average": "micro", "ignore_index": -1}, True),
        ("multilabel_average_precision", {"num_labels": L, "thresholds": [0.0, 0.3, 0.5, 0.8, 1.0], "average": "weighted"}, False),
        ("multilabel_roc", {"num_labels": L, "thresholds": 11}, False),
        ("multilabel_precision_recall_curve", {"num_labels": L, "thresholds": 11, "ignore_index": -1}, True),
        ("accuracy", {"task": "multilabel", "num_labels": L}, False),
        ("f1_score", {"task": "multilabel", "num_labels": L, "average": "macro"}, False),
        ("fbeta_score", {"task": "multilabel", "beta": 2.0, "num_labels": L}, False),
        ("stat_scores", {"task": "multilabel", "num_labels": L}, False),
    ]


@pytest.mark.parametrize("case", range(len(_functional_cases())), ids=lambda i: f"{_functional_cases()[i][0]}-{i}")
def test_multilabel_functional_parity(case):
    name, kwargs, ignore = _functional_cases()[case]
    p, t = _batch(100 + case, ignore=ignore)
    want = getattr(JF, name)(jnp.asarray(p), jnp.asarray(t), **kwargs)
    got = getattr(TF, name)(torch.from_numpy(p), torch.from_numpy(t), **kwargs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == np.int32:
            _bitwise_int32(g, w)
        else:
            _close(g, w)


# ------------------------------------------------------------- binned curve


@pytest.mark.parametrize("thresholds", [5, 128, [0.0, 0.25, 0.5, 0.5, 1.0]], ids=["T5", "T128", "list"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_binned_multilabel_state_is_k1_matrix_mode_bitwise(thresholds, ignore_index):
    """The (T, L, 2, 2) state of one update equals JAX's bit for bit; the port
    computes it with K1 in matrix mode (its plain version on the CPU)."""
    p, t = _batch(3, ignore=ignore_index is not None)
    p[:4, 0] = [np.nan, np.inf, -0.0, 1.0]
    jp, jt, jthr = jprc._multilabel_precision_recall_curve_format(jnp.asarray(p), jnp.asarray(t), L, thresholds, ignore_index)
    want = jprc._multilabel_precision_recall_curve_update(jp, jt, L, jthr)
    tp_, tt, tthr = tprc._multilabel_precision_recall_curve_format(torch.from_numpy(p), torch.from_numpy(t), L, thresholds, ignore_index)
    ascending = isinstance(thresholds, int)
    got = tprc._multilabel_precision_recall_curve_update(tp_, tt, L, tthr, ascending, tprc._uniform_grid(thresholds) if ascending else None)
    _bitwise_int32(got, want)


# ------------------------------------------------------------------ modules


def _module_pairs():
    return {
        "stat_scores_macro": (
            lambda: J.MultilabelStatScores(num_labels=L, average="macro", ignore_index=-1),
            lambda: T.MultilabelStatScores(num_labels=L, average="macro", ignore_index=-1, device="cpu"),
        ),
        "stat_scores_samplewise": (
            lambda: J.MultilabelStatScores(num_labels=L, average="none", multidim_average="samplewise"),
            lambda: T.MultilabelStatScores(num_labels=L, average="none", multidim_average="samplewise", device="cpu"),
        ),
        "accuracy": (lambda: J.MultilabelAccuracy(num_labels=L), lambda: T.MultilabelAccuracy(num_labels=L, device="cpu")),
        "accuracy_wrapper_micro": (
            lambda: J.Accuracy(task="multilabel", num_labels=L, average="micro", ignore_index=-1),
            lambda: T.Accuracy(task="multilabel", num_labels=L, average="micro", ignore_index=-1, device="cpu"),
        ),
        "f1_macro": (
            lambda: J.MultilabelF1Score(num_labels=L, average="macro", ignore_index=-1),
            lambda: T.MultilabelF1Score(num_labels=L, average="macro", ignore_index=-1, device="cpu"),
        ),
        "fbeta_wrapper": (
            lambda: J.FBetaScore(task="multilabel", beta=2.0, num_labels=L, average="weighted"),
            lambda: T.FBetaScore(task="multilabel", beta=2.0, num_labels=L, average="weighted", device="cpu"),
        ),
        "auroc_binned": (
            lambda: J.MultilabelAUROC(num_labels=L, thresholds=33, ignore_index=-1),
            lambda: T.MultilabelAUROC(num_labels=L, thresholds=33, ignore_index=-1, device="cpu"),
        ),
        "auroc_wrapper_binned_micro": (
            lambda: J.AUROC(task="multilabel", num_labels=L, thresholds=17, average="micro"),
            lambda: T.AUROC(task="multilabel", num_labels=L, thresholds=17, average="micro", device="cpu"),
        ),
        "ap_binned": (
            lambda: J.MultilabelAveragePrecision(num_labels=L, thresholds=9),
            lambda: T.MultilabelAveragePrecision(num_labels=L, thresholds=9, device="cpu"),
        ),
        "prc_wrapper_binned": (
            lambda: J.PrecisionRecallCurve(task="multilabel", num_labels=L, thresholds=9),
            lambda: T.PrecisionRecallCurve(task="multilabel", num_labels=L, thresholds=9, device="cpu"),
        ),
        "roc_wrapper_binned": (
            lambda: J.ROC(task="multilabel", num_labels=L, thresholds=9),
            lambda: T.ROC(task="multilabel", num_labels=L, thresholds=9, device="cpu"),
        ),
    }


def _batches_for(tm, seed, logits=False):
    ignore = getattr(tm, "ignore_index", None) == -1
    extra = 2 if getattr(tm, "multidim_average", "global") == "samplewise" else None
    return [_batch(seed + i, logits=logits, ignore=ignore, extra=extra) for i in range(3)]


def _assert_states_equal(jm, tm):
    js, ts = jm.state_tree(), state_to_numpy(tm)
    assert sorted(js) == sorted(ts)
    for name, jv in js.items():
        jv = [np.asarray(a) for a in jv] if isinstance(jv, list) else [np.asarray(jv)]
        tv = ts[name] if isinstance(ts[name], list) else [ts[name]]
        assert len(jv) == len(tv)
        for a, b in zip(tv, jv):
            assert a.dtype == b.dtype == np.int32, (name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=name)


def _flat(out):
    out = out if isinstance(out, tuple) else (out,)
    return [x for part in out for x in (part if isinstance(part, list) else [part])]


@pytest.mark.parametrize("name", sorted(_module_pairs()))
def test_multilabel_module_parity_over_updates(name):
    jf, tf = _module_pairs()[name]
    jm, tm = jf(), tf()
    assert type(tm).__name__ == type(jm).__name__
    for p, t in _batches_for(tm, seed=10):
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    _assert_states_equal(jm, tm)
    for g, w in zip(_flat(tm.compute()), _flat(jm.compute())):
        _close(g, w)


@pytest.mark.parametrize("name", ["accuracy", "f1_macro", "auroc_binned"])
def test_multilabel_module_from_logits(name):
    """A sigmoid ulp can flip one ``pred > 0.5`` compare (or move one entry one
    bin): that moves accuracy or a label's F1 by about 1/(3N) and a binned
    AUROC by less. The budget, 2e-3, covers a few flips at N=3x300."""
    jf, tf = _module_pairs()[name]
    jm, tm = jf(), tf()
    for p, t in _batches_for(tm, seed=20, logits=True):
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    _close(tm.compute(), jm.compute(), rtol=0, atol=2e-3)


@pytest.mark.parametrize("name", sorted(_module_pairs()))
def test_multilabel_state_spec_fingerprint_equals_jax(name):
    jf, tf = _module_pairs()[name]
    jspec, tspec = jf().state_spec(), tf().state_spec()
    assert tspec["fingerprint"] == jspec["fingerprint"]
    assert {k: tuple(v) for k, v in tspec["states"].items()} == {k: tuple(v) for k, v in jspec["states"].items()}


@pytest.mark.parametrize("name", ["f1_macro", "auroc_binned", "stat_scores_samplewise"])
def test_multilabel_state_carried_both_ways(name):
    jf, tf = _module_pairs()[name]
    jm, tm = jf(), tf()
    for p, t in _batches_for(tm, seed=30):
        jm.update(jnp.asarray(p), jnp.asarray(t))
    tree = {k: ([np.array(a) for a in v] if isinstance(v, list) else (np.array(v) if k != "_update_count" else v))
            for k, v in jm.state_tree(include_count=True).items()}
    state_from_numpy(tm, tree, fingerprint=jm.state_spec()["fingerprint"])
    for g, w in zip(_flat(tm.compute()), _flat(jm.compute())):
        _close(g, w)
    back = state_to_numpy(tm, include_count=True)
    jm2 = jf()
    jm2.load_state_tree({k: ([jnp.asarray(a) for a in v] if isinstance(v, list) else (jnp.asarray(v) if k != "_update_count" else v))
                         for k, v in back.items()})
    for g, w in zip(_flat(tm.compute()), _flat(jm2.compute())):
        _close(g, w)


def test_derived_multilabel_class_is_bound_into_its_module():
    """The factory names and binds MultilabelAccuracy like the Binary and
    Multiclass classes, so pickling finds it and its fingerprint matches."""
    import pickle

    from torchmetrics_tpu_torch.classification import accuracy

    assert T.MultilabelAccuracy.__module__ == accuracy.__name__ and accuracy.MultilabelAccuracy is T.MultilabelAccuracy
    tm = T.MultilabelAccuracy(num_labels=L, device="cpu")
    p, t = _batch(40)
    tm.update(torch.from_numpy(p), torch.from_numpy(t))
    twin = pickle.loads(pickle.dumps(tm))
    assert type(twin) is T.MultilabelAccuracy and torch.equal(twin.tp, tm.tp)


def test_multilabel_collection_groups_match_jax():
    """Accuracy and F1 with one threshold and ignore_index hold equal counts:
    one compute group in both packages; the binned AUROC stays on its own."""
    jc = JMetricCollection({
        "acc": J.MultilabelAccuracy(num_labels=L, ignore_index=-1),
        "f1": J.MultilabelF1Score(num_labels=L, average="macro", ignore_index=-1),
        "auroc": J.MultilabelAUROC(num_labels=L, average="macro", thresholds=16, ignore_index=-1),
    })
    tc = T.MetricCollection({
        "acc": T.MultilabelAccuracy(num_labels=L, ignore_index=-1, device="cpu"),
        "f1": T.MultilabelF1Score(num_labels=L, average="macro", ignore_index=-1, device="cpu"),
        "auroc": T.MultilabelAUROC(num_labels=L, average="macro", thresholds=16, ignore_index=-1, device="cpu"),
    })
    for i in range(3):
        p, t = _batch(50 + i, logits=True, ignore=True)
        jc.update(jnp.asarray(p), jnp.asarray(t))
        tc.update(torch.from_numpy(p), torch.from_numpy(t))
    groups = sorted(sorted(g) for g in tc.compute_groups.values())
    assert groups == sorted(sorted(g) for g in jc.compute_groups.values()) == [["acc", "f1"], ["auroc"]]
    want, got = jc.compute(), tc.compute()
    for k in want:
        _close(got[k], want[k], rtol=0, atol=2e-3)


def test_multilabel_validation_refuses_bad_target():
    tm = T.MultilabelF1Score(num_labels=L, device="cpu")
    p, t = _batch(60)
    t[0, 0] = 2
    with pytest.raises(RuntimeError, match="Detected the following values"):
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    assert tm._update_count == 0
    with pytest.raises(ValueError, match="num_labels"):
        T.MultilabelAUROC(num_labels=1, device="cpu")
