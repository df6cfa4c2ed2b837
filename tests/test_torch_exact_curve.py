# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's exact (``thresholds=None``) curve family against the JAX package's.

The same seeded numpy batches go through both packages on the CPU.

- The padded curve (``fps``, ``tps``, thresholds, mask) and the compacted
  host curve are held bitwise, ties, NaN, signed zeros, infinities and
  ignored entries included; so are the curve tuples of the PR curve and the
  ROC (their rates are int counts divided in float64 and rounded once).
- Exact AUROC and AP are float32 sums whose order differs between XLA and
  PyTorch: held within ``atol=1e-6`` (N <= 2048 here).
- ``interp`` is held bitwise against ``jnp.interp`` on these inputs (XLA
  fuses an FMA that the port replays in float64; see its docstring for the
  one-ulp double-rounding case).
- Module metrics over several updates, their state trees carried both ways
  with equal fingerprints, and the compute groups of an exact collection.
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
from torchmetrics_tpu.utilities import compute as jcompute
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy
from torchmetrics_tpu_torch.utilities import compute as tcompute

jprc = importlib.import_module("torchmetrics_tpu.functional.classification.precision_recall_curve")
tprc = importlib.import_module("torchmetrics_tpu_torch.functional.classification.precision_recall_curve")
jauroc = importlib.import_module("torchmetrics_tpu.functional.classification.auroc")
tauroc = importlib.import_module("torchmetrics_tpu_torch.functional.classification.auroc")
jap = importlib.import_module("torchmetrics_tpu.functional.classification.average_precision")
tap = importlib.import_module("torchmetrics_tpu_torch.functional.classification.average_precision")

N = 512
C = 5
ATOL = 1e-6  # exact AUROC / AP: float32 sums in another order


def _bitwise(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), (what, got, want)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got), np.asarray(want), rtol=0, atol=atol)


def _curve_case(name):
    """(preds float32, target int32) of a named edge case of the padded curve."""
    rng = np.random.default_rng(len(name))
    nan, inf = np.nan, np.inf
    if name == "worked":  # NaN, +-0, +-inf, ignored entries (the JAX values are the test's expectation)
        return (np.array([0.5, nan, 0.0, -0.0, 0.5, inf, -inf, 0.3, 0.9], np.float32),
                np.array([1, 0, 1, 0, -1, 1, 0, -1, 1], np.int32))
    if name == "signed_zeros":
        return np.array([-0.0, 0.0, 0.0, -0.0], np.float32), np.array([1, 0, 1, 0], np.int32)
    if name == "empty":
        return np.zeros(0, np.float32), np.zeros(0, np.int32)
    if name == "all_ignored":
        return rng.random(7).astype(np.float32), np.full(7, -1, np.int32)
    p = np.round(rng.random(300), 1).astype(np.float32)  # eleven values: many ties
    t = rng.integers(0, 2, 300).astype(np.int32)
    if name == "ties":
        return p, t
    if name == "all_positive":
        return p, np.ones_like(t)
    if name == "all_negative":
        return p, np.zeros_like(t)
    specials = np.array([nan, -nan, inf, -inf, 0.0, -0.0, 1.0, 0.5], np.float32)
    p[rng.integers(0, 300, 60)] = specials[rng.integers(0, len(specials), 60)]
    if name == "specials":
        return p, t
    if name == "specials_ignored":
        t[rng.integers(0, 300, 50)] = -1
        t[: 5] = -1
        p[: 5] = [nan, -inf, inf, 0.0, -0.0]
        return p, t
    raise KeyError(name)


CURVE_CASES = ["worked", "signed_zeros", "empty", "all_ignored", "ties", "all_positive", "all_negative", "specials", "specials_ignored"]


@pytest.mark.parametrize("name", CURVE_CASES)
@pytest.mark.parametrize("pos_label", [1, 0])
def test_clf_curve_padded_bitwise(name, pos_label):
    p, t = _curve_case(name)
    want = jprc._binary_clf_curve_padded(jnp.asarray(p), jnp.asarray(t), pos_label)
    got = tprc._binary_clf_curve_padded(torch.from_numpy(p), torch.from_numpy(t), pos_label)
    for g, w, what in zip(got, want, ("fps", "tps", "thresholds", "mask")):
        _bitwise(g, w, f"{name}: {what}")


@pytest.mark.parametrize("name", CURVE_CASES)
def test_exact_auroc_and_ap_on_edge_cases(name):
    """The device AUROC and AP over the padded curve, ignored entries carrying no weight."""
    p, t = _curve_case(name)
    jp, jt, tp_, tt = jnp.asarray(p), jnp.asarray(t), torch.from_numpy(p), torch.from_numpy(t)
    _close(tauroc._binary_auroc_exact_device(tp_, tt), jauroc._binary_auroc_exact_device(jp, jt))
    _close(tap._binary_average_precision_exact_device(tp_, tt), jap._binary_average_precision_exact_device(jp, jt))


def test_worked_case_values():
    """The worked case: JAX sorts a valid NaN last, after the ignored entries."""
    p, t = _curve_case("worked")
    fps, tps, thr, mask = tprc._binary_clf_curve_padded(torch.from_numpy(p), torch.from_numpy(t))
    assert tps.tolist() == [1, 2, 3, 4, 4, 4, 4, 4, 4] and fps.tolist() == [0, 0, 0, 0, 1, 2, 2, 2, 3]
    assert mask.tolist() == [True, True, True, False, True, True, False, False, True]
    assert np.isnan(thr[-1].item()) and thr[:-1].tolist() == [np.inf, float(np.float32(0.9)), 0.5, 0.0, -0.0, -np.inf, -np.inf, -np.inf]
    want = float(jauroc._binary_auroc_exact_device(jnp.asarray(p), jnp.asarray(t)))
    assert want == pytest.approx(0.9583333, abs=1e-6)
    _close(tauroc._binary_auroc_exact_device(torch.from_numpy(p), torch.from_numpy(t)), want)


def test_signed_zero_group_reports_last_member():
    """+0 and -0 tie; the group's threshold is its last member's, here -0."""
    p, t = _curve_case("signed_zeros")
    _, _, thr, mask = tprc._binary_clf_curve_padded(torch.from_numpy(p), torch.from_numpy(t))
    assert mask.tolist() == [False, False, False, True]
    assert np.signbit(thr[3].item())


@pytest.mark.parametrize("name", ["ties", "specials", "all_positive", "signed_zeros"])
def test_clf_curve_host_float32_bitwise(name):
    p, t = _curve_case(name)
    keep = t >= 0
    want = jprc._binary_clf_curve_host(p[keep], t[keep])
    got = tprc._binary_clf_curve_host(torch.from_numpy(p[keep]), torch.from_numpy(t[keep]))
    for g, w in zip(got, want):
        _bitwise(g, w, name)


@pytest.mark.parametrize("case", ["sub_eps", "ties", "empty"])
def test_clf_curve_host_float64_keeps_sub_f32_gaps(case):
    """The float64 trap: predictions closer than float32's epsilon stay distinct
    thresholds in the float64 branch, as in JAX's NumPy branch."""
    rng = np.random.default_rng(5)
    if case == "empty":
        p, t = np.zeros(0), np.zeros(0, np.int32)
    elif case == "ties":
        p, t = np.round(rng.random(200), 2), rng.integers(0, 2, 200).astype(np.int32)
    else:
        p = 0.5 + np.arange(40) * 1e-10  # all one float32 value
        t = rng.integers(0, 2, 40).astype(np.int32)
    want = jprc._binary_clf_curve_host(p, t)
    got = tprc._binary_clf_curve_host(torch.from_numpy(p), torch.from_numpy(t))
    for g, w in zip(got, want):
        _bitwise(g, w, case)
    if case == "sub_eps":
        assert got[2].numel() == 40 and got[2].dtype == torch.float64
        f32 = tprc._binary_clf_curve_host(torch.from_numpy(p.astype(np.float32)), torch.from_numpy(t))
        assert f32[2].numel() == 1


# --------------------------------------------------------------- interp, auc


@pytest.mark.parametrize("seed", range(6))
def test_interp_bitwise_against_jnp_interp(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(2, 40))
    xp = np.sort(rng.random(m).astype(np.float32))
    xp[rng.integers(0, m, 4)] = xp[m // 2]  # repeated xp values, as on an ROC's fpr axis
    xp = np.sort(xp)
    fp = np.sort(rng.random(m).astype(np.float32))
    x = np.concatenate([rng.random(200) * 1.4 - 0.2, xp, [xp[0], xp[-1], -1.0, 2.0]]).astype(np.float32)
    want = jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp))
    _bitwise(tcompute.interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp)), want)


@pytest.mark.parametrize("order", ["ascending", "descending", "mixed", "reorder"])
def test_auc_matches_jax(order):
    rng = np.random.default_rng(11)
    x = np.sort(rng.random(50)).astype(np.float32)
    y = rng.random(50).astype(np.float32)
    if order == "descending":
        x = x[::-1].copy()
    elif order in ("mixed", "reorder"):
        rng.shuffle(x)
    want = jcompute.auc(jnp.asarray(x), jnp.asarray(y), reorder=order == "reorder")
    got = tcompute.auc(torch.from_numpy(x), torch.from_numpy(y), reorder=order == "reorder")
    _close(got, want)


# ---------------------------------------------------------------- functional


def _batch(kind, seed, n=N, logits=False, ignore=False):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        p = (rng.standard_normal(n) * 2).astype(np.float32) if logits else np.round(rng.random(n), 2).astype(np.float32)
        t = rng.integers(0, 2, n).astype(np.int32)
    elif kind == "multiclass":
        p = rng.standard_normal((n, C)).astype(np.float32)
        if not logits:
            p = (np.exp(p) / np.exp(p).sum(1, keepdims=True)).astype(np.float32)
            p[: n // 4] = np.round(p[: n // 4], 2)  # ties
        t = rng.integers(0, C, n).astype(np.int32)
    else:
        p = (rng.standard_normal((n, C)) * 2).astype(np.float32) if logits else np.round(rng.random((n, C)), 2).astype(np.float32)
        t = rng.integers(0, 2, (n, C)).astype(np.int32)
    if ignore:
        t.reshape(-1)[rng.integers(0, t.size, t.size // 10)] = -1
    return p, t


def _functional_cases():
    """(functional name, kwargs, input kind, ignore_index -1 in the target, bitwise)."""
    return [
        ("binary_auroc", {}, "binary", False, False),
        ("binary_auroc", {"ignore_index": -1}, "binary", True, False),
        ("binary_auroc", {"max_fpr": 0.3}, "binary", False, False),
        ("binary_average_precision", {"ignore_index": -1}, "binary", True, False),
        ("binary_roc", {"ignore_index": -1}, "binary", True, True),
        ("binary_precision_recall_curve", {}, "binary", False, True),
        ("multiclass_auroc", {"num_classes": C}, "multiclass", False, False),
        ("multiclass_auroc", {"num_classes": C, "average": "weighted", "ignore_index": -1}, "multiclass", True, False),
        ("multiclass_auroc", {"num_classes": C, "average": None}, "multiclass", False, False),
        ("multiclass_average_precision", {"num_classes": C}, "multiclass", False, False),
        ("multiclass_average_precision", {"num_classes": C, "average": "weighted"}, "multiclass", False, False),
        ("multiclass_average_precision", {"num_classes": C, "average": "none", "ignore_index": -1}, "multiclass", True, False),
        ("multiclass_roc", {"num_classes": C}, "multiclass", False, True),
        ("multiclass_roc", {"num_classes": C, "average": "micro"}, "multiclass", False, True),
        ("multiclass_roc", {"num_classes": C, "average": "macro", "ignore_index": -1}, "multiclass", True, True),
        ("multiclass_roc", {"num_classes": C, "average": "macro", "thresholds": 17}, "multiclass", False, True),
        ("multiclass_precision_recall_curve", {"num_classes": C}, "multiclass", False, True),
        ("multiclass_precision_recall_curve", {"num_classes": C, "average": "micro", "ignore_index": -1}, "multiclass", True, True),
        ("multilabel_auroc", {"num_labels": C, "average": "micro"}, "multilabel", False, False),
        ("multilabel_auroc", {"num_labels": C, "average": "macro", "ignore_index": -1}, "multilabel", True, False),
        ("multilabel_auroc", {"num_labels": C, "average": "weighted"}, "multilabel", False, False),
        ("multilabel_auroc", {"num_labels": C, "average": None, "ignore_index": -1}, "multilabel", True, False),
        ("multilabel_average_precision", {"num_labels": C, "average": "micro", "ignore_index": -1}, "multilabel", True, False),
        ("multilabel_average_precision", {"num_labels": C, "average": "macro"}, "multilabel", False, False),
        ("multilabel_average_precision", {"num_labels": C, "average": "weighted", "ignore_index": -1}, "multilabel", True, False),
        ("multilabel_average_precision", {"num_labels": C, "average": None}, "multilabel", False, False),
        ("multilabel_roc", {"num_labels": C, "ignore_index": -1}, "multilabel", True, True),
        ("multilabel_precision_recall_curve", {"num_labels": C}, "multilabel", False, True),
    ]


def _flat(out):
    """A functional's result as a flat list of arrays (curves may be lists per class)."""
    out = out if isinstance(out, tuple) else (out,)
    flat = []
    for part in out:
        flat.extend(part if isinstance(part, list) else [part])
    return flat


@pytest.mark.parametrize("case", range(len(_functional_cases())), ids=lambda i: f"{_functional_cases()[i][0]}-{i}")
def test_exact_functional_parity(case):
    name, kwargs, kind, ignore, bitwise = _functional_cases()[case]
    p, t = _batch(kind, seed=200 + case, ignore=ignore)
    want = _flat(getattr(JF, name)(jnp.asarray(p), jnp.asarray(t), **kwargs))
    got = _flat(getattr(TF, name)(torch.from_numpy(p), torch.from_numpy(t), **kwargs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if bitwise:
            _bitwise(g, w, name)
        else:
            _close(g, w)


@pytest.mark.parametrize(
    "name,kwargs,kind",
    [
        ("auroc", {"task": "binary"}, "binary"),
        ("average_precision", {"task": "multiclass", "num_classes": C}, "multiclass"),
        ("roc", {"task": "multilabel", "num_labels": C}, "multilabel"),
        ("precision_recall_curve", {"task": "multiclass", "num_classes": C, "average": "micro"}, "multiclass"),
    ],
)
def test_task_dispatchers(name, kwargs, kind):
    p, t = _batch(kind, seed=7)
    want = _flat(getattr(JF, name)(jnp.asarray(p), jnp.asarray(t), **kwargs))
    got = _flat(getattr(TF, name)(torch.from_numpy(p), torch.from_numpy(t), **kwargs))
    for g, w in zip(got, want):
        _close(g, w)


def test_batched_sort_equals_per_class_curves():
    """The multiclass exact AUROC's one batched sort gives each class's own curve."""
    p, t = _batch("multiclass", seed=3, ignore=True)
    preds, target = torch.from_numpy(p), torch.from_numpy(t)
    classes = torch.arange(C, dtype=torch.int32)[:, None]
    rows = tprc._clf_curve_padded_rows(preds.T, target, classes)
    for c in range(C):
        tgt = torch.where(target >= 0, (target == c).to(torch.int32), target)
        for got, want in zip(rows, tprc._binary_clf_curve_padded(preds[:, c], tgt)):
            _bitwise(got[c], want.numpy())


def test_float64_inputs_become_float32_on_public_paths():
    p, t = _batch("binary", seed=8)
    p64 = p.astype(np.float64) + 1e-12
    _bitwise(TF.binary_roc(torch.from_numpy(p64), torch.from_numpy(t))[2], JF.binary_roc(jnp.asarray(p64), jnp.asarray(t))[2])
    assert TF.binary_roc(torch.from_numpy(p64), torch.from_numpy(t))[2].dtype == torch.float32


# -------------------------------------------------------------------- modules


def _module_pairs():
    return {
        "binary_auroc": (lambda: J.BinaryAUROC(), lambda: T.BinaryAUROC(device="cpu"), "binary"),
        "binary_auroc_maxfpr": (lambda: J.BinaryAUROC(max_fpr=0.4), lambda: T.BinaryAUROC(max_fpr=0.4, device="cpu"), "binary"),
        "binary_ap": (lambda: J.BinaryAveragePrecision(ignore_index=-1), lambda: T.BinaryAveragePrecision(ignore_index=-1, device="cpu"), "binary"),
        "binary_roc": (lambda: J.BinaryROC(), lambda: T.BinaryROC(device="cpu"), "binary"),
        "binary_prc": (lambda: J.BinaryPrecisionRecallCurve(), lambda: T.BinaryPrecisionRecallCurve(device="cpu"), "binary"),
        "multiclass_auroc": (lambda: J.MulticlassAUROC(num_classes=C), lambda: T.MulticlassAUROC(num_classes=C, device="cpu"), "multiclass"),
        "multiclass_ap_weighted": (
            lambda: J.MulticlassAveragePrecision(num_classes=C, average="weighted", ignore_index=-1),
            lambda: T.MulticlassAveragePrecision(num_classes=C, average="weighted", ignore_index=-1, device="cpu"),
            "multiclass",
        ),
        "multiclass_roc_macro": (
            lambda: J.MulticlassROC(num_classes=C, average="macro"),
            lambda: T.MulticlassROC(num_classes=C, average="macro", device="cpu"),
            "multiclass",
        ),
        "multiclass_prc_micro": (
            lambda: J.MulticlassPrecisionRecallCurve(num_classes=C, average="micro"),
            lambda: T.MulticlassPrecisionRecallCurve(num_classes=C, average="micro", device="cpu"),
            "multiclass",
        ),
        "multilabel_auroc": (lambda: J.MultilabelAUROC(num_labels=C), lambda: T.MultilabelAUROC(num_labels=C, device="cpu"), "multilabel"),
        "multilabel_ap_micro": (
            lambda: J.MultilabelAveragePrecision(num_labels=C, average="micro", ignore_index=-1),
            lambda: T.MultilabelAveragePrecision(num_labels=C, average="micro", ignore_index=-1, device="cpu"),
            "multilabel",
        ),
        "multilabel_roc": (lambda: J.MultilabelROC(num_labels=C), lambda: T.MultilabelROC(num_labels=C, device="cpu"), "multilabel"),
    }


def _assert_tree_equal(js, ts):
    assert sorted(js) == sorted(ts)
    for name, jv in js.items():
        if isinstance(jv, list):
            assert len(jv) == len(ts[name])
            for a, b in zip(ts[name], jv):
                _bitwise(a, np.asarray(b), name)
        else:
            _bitwise(ts[name], np.asarray(jv), name)


@pytest.mark.parametrize("name", sorted(_module_pairs()))
def test_exact_module_parity_over_updates(name):
    jf, tf, kind = _module_pairs()[name]
    jm, tm = jf(), tf()
    for i in range(3):
        p, t = _batch(kind, seed=300 + i, n=200, ignore=tm.ignore_index is not None)
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    assert isinstance(tm.preds, list) and len(tm.preds) == 3
    _assert_tree_equal(jm.state_tree(), tm.state_tree())
    for g, w in zip(_flat(tm.compute()), _flat(jm.compute())):
        _close(g, w)


@pytest.mark.parametrize("name", ["binary_auroc", "multiclass_auroc", "multilabel_auroc"])
def test_exact_module_from_logits(name):
    """From logits the port's sigmoid/softmax can differ from XLA's by an ulp;
    an ulp can swap two ranks, which moves an AUROC by 1/(P*N) per swap.
    The budget, 1e-5, is several such swaps at N=3x200."""
    jf, tf, kind = _module_pairs()[name]
    jm, tm = jf(), tf()
    for i in range(3):
        p, t = _batch(kind, seed=400 + i, n=200, logits=True)
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    _close(tm.compute(), jm.compute(), atol=1e-5)


@pytest.mark.parametrize("name", sorted(_module_pairs()))
def test_exact_state_spec_fingerprint_equals_jax(name):
    jf, tf, _ = _module_pairs()[name]
    jspec, tspec = jf().state_spec(), tf().state_spec()
    assert tspec["fingerprint"] == jspec["fingerprint"]
    assert {k: tuple(v) for k, v in tspec["states"].items()} == {k: tuple(v) for k, v in jspec["states"].items()}


@pytest.mark.parametrize("name", ["binary_ap", "multiclass_auroc", "multilabel_auroc"])
def test_exact_state_carried_both_ways(name):
    """A JAX exact-mode state tree (lists of arrays) restores into the port and
    the port's into JAX, each checked against the writer's fingerprint."""
    jf, tf, kind = _module_pairs()[name]
    jm, tm = jf(), tf()
    for i in range(2):
        p, t = _batch(kind, seed=500 + i, n=150)
        jm.update(jnp.asarray(p), jnp.asarray(t))
    tree = {k: ([np.array(a) for a in v] if isinstance(v, list) else v) for k, v in jm.state_tree(include_count=True).items()}
    state_from_numpy(tm, tree, fingerprint=jm.state_spec()["fingerprint"])
    for arrays in (v for v in tree.values() if isinstance(v, list)):
        for a in arrays:
            a[...] = 0  # the port copied
    assert tm._update_count == 2 and len(tm.preds) == 2
    _close(tm.compute(), jm.compute())

    back = state_to_numpy(tm, include_count=True)
    jm2 = jf()
    assert jm2.state_spec()["fingerprint"] == tm.state_spec()["fingerprint"]
    jm2.load_state_tree({k: ([jnp.asarray(a) for a in v] if isinstance(v, list) else v) for k, v in back.items()})
    assert jm2._update_count == 2
    _close(tm.compute(), jm2.compute())


def test_exact_update_rolls_back_and_resets():
    tm = T.MulticlassAUROC(num_classes=C, device="cpu")
    p, t = _batch("multiclass", seed=9, n=64)
    tm.update(torch.from_numpy(p), torch.from_numpy(t))
    bad = t.copy()
    bad[0] = C + 3
    with pytest.raises(RuntimeError):
        tm.update(torch.from_numpy(p), torch.from_numpy(bad))
    assert tm._update_count == 1 and len(tm.preds) == len(tm.target) == 1
    tm.reset()
    assert tm.preds == [] and tm.target == [] and tm._update_count == 0


def test_exact_collection_compute_groups_match_jax():
    """AUROC and AP at their exact defaults share their cat states: one compute
    group in both packages; the binned AUROC stays on its own."""
    jc = JMetricCollection(
        {"auroc": J.MulticlassAUROC(num_classes=C), "ap": J.MulticlassAveragePrecision(num_classes=C),
         "binned": J.MulticlassAUROC(num_classes=C, thresholds=9)}
    )
    tc = T.MetricCollection(
        {"auroc": T.MulticlassAUROC(num_classes=C, device="cpu"), "ap": T.MulticlassAveragePrecision(num_classes=C, device="cpu"),
         "binned": T.MulticlassAUROC(num_classes=C, thresholds=9, device="cpu")}
    )
    for i in range(3):
        p, t = _batch("multiclass", seed=600 + i, n=128)
        jc.update(jnp.asarray(p), jnp.asarray(t))
        tc.update(torch.from_numpy(p), torch.from_numpy(t))
    groups = sorted(sorted(g) for g in tc.compute_groups.values())
    assert groups == sorted(sorted(g) for g in jc.compute_groups.values()) == [["ap", "auroc"], ["binned"]]
    want, got = jc.compute(), tc.compute()
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])
