# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Calibration error, hinge loss, Dice, the multilabel ranking metrics, group
fairness and ``to_onehot`` of the port against the JAX package's;
functional, dispatched and module forms.

The same seeded numpy inputs go through both packages on the CPU. Budgets:

- integer and count states are bitwise, dtype included: ``bin_count``,
  hinge's ``total``, Dice's ``tp``/``fp``/``fn``, fairness's
  ``tp``/``fp``/``tn``/``fn``, ranking's ``total``; so are the one-hots;
- coverage error is bitwise (sums of small integers, exact in float32), and
  so is every value that is one division of exact counts per entry (Dice
  micro and per class, the group rates, the fairness ratios);
- float sums that add in another order than XLA's: the calibration sums,
  hinge's measures, ranking AP and ranking loss, ECE (``l1``, ``l2`` with and
  without ``debias``, ``max``) and averages over classes:
  ``rtol=1e-6, atol=1e-7`` on probability inputs; on logits, where the
  sigmoid or softmax differs from XLA's by ulps, ``rtol=1e-5, atol=1e-6``;
- the ranking loss's inverse ranks equal JAX's as integers on rows with ties,
  signed zeros and NaN.
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
from torchmetrics_tpu.utilities.data import to_onehot as j_to_onehot
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy
from torchmetrics_tpu_torch.utilities.data import to_onehot

N, C, L, G = 240, 5, 4, 3
RTOL, ATOL = 1e-6, 1e-7
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6

jce = importlib.import_module("torchmetrics_tpu.functional.classification.calibration_error")
tce = importlib.import_module("torchmetrics_tpu_torch.functional.classification.calibration_error")
jrank = importlib.import_module("torchmetrics_tpu.functional.classification.ranking")
trank = importlib.import_module("torchmetrics_tpu_torch.functional.classification.ranking")


def _data(kind, seed, logits=False, ignore=None, extra=()):
    """Seeded (preds, target): binary and multilabel probabilities (or logits)
    with {0, 1} targets, multiclass (N, C, ...) probabilities (or logits) with
    labels; about a tenth of the targets set to ``ignore`` where given."""
    rng = np.random.default_rng(seed)
    if kind == "binary":
        preds = rng.standard_normal((N,) + extra) * 2
        target = rng.integers(0, 2, (N,) + extra)
        if not logits:
            preds = 1 / (1 + np.exp(-preds))
    elif kind == "multiclass":
        preds = rng.standard_normal((N, C) + extra) * 2
        target = rng.integers(0, C, (N,) + extra)
        if not logits:
            preds = np.exp(preds) / np.exp(preds).sum(1, keepdims=True)
    else:
        preds = rng.standard_normal((N, L) + extra) * 2
        target = rng.integers(0, 2, (N, L) + extra)
        if not logits:
            preds = 1 / (1 + np.exp(-preds))
    if ignore is not None:
        target = np.where(rng.random(target.shape) < 0.1, ignore, target)
    return preds.astype(np.float32), target.astype(np.int32)


def _np(x):
    return np.ascontiguousarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def _bitwise(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8)), (what, got, want)


def _close(got, want, logits=False, what=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    rtol, atol = (LOGIT_RTOL, LOGIT_ATOL) if logits else (RTOL, ATOL)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _both(jfn, tfn, *arrays, **kw):
    want = jfn(*[jnp.asarray(a) for a in arrays], **kw)
    got = tfn(*[torch.from_numpy(np.array(a)) for a in arrays], **kw)
    return got, want


def _raised(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


def _tree(jm):
    return {k: np.asarray(v) for k, v in jm.state_tree(include_count=True).items()}


def _check_module(jm, tm, exact_states, batches, value_check):
    """Fold ``batches`` into both: the states (bitwise for ``exact_states``,
    else within the budget), the registry fingerprint and the value."""
    for batch in batches:
        jm.update(*[jnp.asarray(a) for a in batch])
        tm.update(*[torch.from_numpy(np.array(a)) for a in batch])
    want, got = _tree(jm), state_to_numpy(tm, include_count=True)
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        if name == "_update_count":
            assert int(got[name]) == int(w)
        elif name in exact_states:
            _bitwise(got[name], w, name)
        else:
            _close(got[name], w, what=name)
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    value_check(tm.compute(), jm.compute())


def _carry_both_ways(jfactory, tfactory, jm, tm, value_check):
    """A JAX state tree into a fresh port metric, and the port's into a fresh
    JAX metric, each checked against the writer's fingerprint; the same values."""
    fresh = tfactory()
    state_from_numpy(fresh, _tree(jm), fingerprint=jm.state_spec()["fingerprint"])
    value_check(fresh.compute(), jm.compute())
    jfresh = jfactory()
    assert jfresh.state_spec()["fingerprint"] == tm.state_spec()["fingerprint"]
    back = state_to_numpy(tm, include_count=True)
    jfresh.load_state_tree({k: v if k == "_update_count" else jnp.asarray(v) for k, v in back.items()})
    value_check(tm.compute(), jfresh.compute())


# ------------------------------------------------------------------ to_onehot


@pytest.mark.parametrize("shape", [(7,), (3, 4), (2, 3, 5)])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_to_onehot_matches_jax(shape, dtype):
    """Negative labels and labels >= C give rows of zeros (``jax.nn.one_hot``;
    ``torch.nn.functional.one_hot`` raises there); the class dim is at 1; int32."""
    rng = np.random.default_rng(len(shape))
    labels = rng.integers(-2, C + 2, shape).astype(dtype)
    labels.reshape(-1)[:3] = [-1, C, C + 5]
    got = to_onehot(torch.from_numpy(labels), C)
    want = j_to_onehot(jnp.asarray(labels), C)
    _bitwise(got, want)
    assert got.shape[1] == C and got.dtype == torch.int32
    assert int(got.sum()) == int(((labels >= 0) & (labels < C)).sum())


# --------------------------------------------------------- calibration error

CE_CASES = [
    ("binary", {"norm": "l1"}),
    ("binary", {"norm": "l2", "n_bins": 10}),
    ("binary", {"norm": "max", "ignore_index": -1}),
    ("multiclass", {"norm": "l1"}),
    ("multiclass", {"norm": "l2", "ignore_index": 2}),
    ("multiclass", {"norm": "max", "n_bins": 7}),
]


def _case_id(case):
    kind, kw = case
    return "-".join([kind] + [f"{k}={v}" for k, v in kw.items()])


@pytest.mark.parametrize("logits", [False, True])
@pytest.mark.parametrize("case", CE_CASES, ids=_case_id)
def test_calibration_error_functional(case, logits):
    kind, kw = case
    preds, target = _data(kind, seed=3, logits=logits, ignore=kw.get("ignore_index"))
    args = {"num_classes": C} if kind == "multiclass" else {}
    got, want = _both(getattr(JF, f"{kind}_calibration_error"), getattr(TF, f"{kind}_calibration_error"), preds, target, **args, **kw)
    _close(got, want, logits)
    got, want = _both(JF.calibration_error, TF.calibration_error, preds, target, task=kind, **args, **kw)
    _close(got, want, logits)


@pytest.mark.parametrize("n_bins", [1, 3, 10, 15, 64, 100])
def test_calibration_bins_on_the_edges(n_bins):
    """A confidence exactly on a bin edge falls in JAX's bin: ``bin_count`` and
    the sums bitwise where every confidence sits on an edge (or outside [0, 1],
    the ignored sentinel)."""
    edges = np.asarray(jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32))
    rng = np.random.default_rng(n_bins)
    conf = np.concatenate([edges, rng.choice(edges, 200), np.nextafter(edges, 2).astype(np.float32), [2.0, -0.5, np.nan]]).astype(np.float32)
    acc = rng.integers(0, 2, conf.shape).astype(np.float32)
    got = tce._binning_update(torch.from_numpy(conf), torch.from_numpy(acc), n_bins)
    want = jce._binning_update(jnp.asarray(conf), jnp.asarray(acc), n_bins)
    _bitwise(got[2], want[2], "count")
    for g, w, what in zip(got[:2], want[:2], ("conf_sum", "acc_sum")):
        _close(g, w, what=what)
    _bitwise(tce._bin_edges(n_bins), edges, "edges")


def test_bin_edges_equal_jnp_linspace():
    """The calibration edges, built on the device, equal ``jnp.linspace(0, 1, n + 1)`` bitwise."""
    for n_bins in [*range(1, 33), 63, 100, 127, 128, 255, 1000, 1999]:
        want = np.asarray(jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32))
        got = tce._bin_edges(n_bins).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), n_bins


@pytest.mark.parametrize("debias", [False, True])
@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
def test_calibration_compute_from_bins(norm, debias):
    """ECE from per-bin sums (the module's compute) and from a whole stream (the
    functional's), with the ``l2`` debias term."""
    preds, target = _data("multiclass", seed=8)
    jconf, jacc = jce._multiclass_calibration_error_update(jnp.asarray(preds), jnp.asarray(target))
    tconf, tacc = tce._multiclass_calibration_error_update(torch.from_numpy(preds), torch.from_numpy(target))
    _bitwise(tconf, jconf, "confidences")
    _bitwise(tacc, jacc, "accuracies")
    jsums = jce._binning_update(jconf, jacc, 15)
    tsums = tce._binning_update(tconf, tacc, 15)
    _close(tce._ce_compute_binned(*tsums, norm=norm, debias=debias), jce._ce_compute_binned(*jsums, norm=norm, debias=debias))
    _close(tce._ce_compute(tconf, tacc, 15, norm, debias), jce._ce_compute(jconf, jacc, 15, norm, debias))


@pytest.mark.parametrize("case", CE_CASES, ids=_case_id)
def test_calibration_error_module(case):
    kind, kw = case
    args = {"num_classes": C} if kind == "multiclass" else {}
    name = f"{kind.capitalize()}CalibrationError"
    jm, tm = getattr(JC, name)(**args, **kw), getattr(TC, name)(device="cpu", **args, **kw)
    batches = [_data(kind, seed=20 + s, ignore=kw.get("ignore_index")) for s in range(3)]
    _check_module(jm, tm, {"bin_count"}, batches, _close)
    _carry_both_ways(lambda: getattr(JC, name)(**args, **kw), lambda: getattr(TC, name)(device="cpu", **args, **kw), jm, tm, _close)


# ----------------------------------------------------------------------- hinge

HINGE_CASES = [
    ("binary", {}),
    ("binary", {"squared": True, "ignore_index": -1}),
    ("multiclass", {}),
    ("multiclass", {"squared": True}),
    ("multiclass", {"multiclass_mode": "one-vs-all"}),
    ("multiclass", {"multiclass_mode": "one-vs-all", "squared": True, "ignore_index": 1}),
]


@pytest.mark.parametrize("logits", [False, True])
@pytest.mark.parametrize("case", HINGE_CASES, ids=_case_id)
def test_hinge_functional(case, logits):
    kind, kw = case
    preds, target = _data(kind, seed=4, logits=logits, ignore=kw.get("ignore_index"))
    args = {"num_classes": C} if kind == "multiclass" else {}
    got, want = _both(getattr(JF, f"{kind}_hinge_loss"), getattr(TF, f"{kind}_hinge_loss"), preds, target, **args, **kw)
    _close(got, want, logits)
    got, want = _both(JF.hinge_loss, TF.hinge_loss, preds, target, task=kind, **args, **kw)
    _close(got, want, logits)


def test_hinge_label_outside_the_classes():
    """Without validation, a label >= C one-hots to zeros in both packages."""
    preds, target = _data("multiclass", seed=5)
    target[:7] = C + 2
    for mode in ("crammer-singer", "one-vs-all"):
        got, want = _both(
            JF.multiclass_hinge_loss, TF.multiclass_hinge_loss, preds, target, num_classes=C, multiclass_mode=mode, validate_args=False
        )
        _close(got, want)


@pytest.mark.parametrize("case", HINGE_CASES, ids=_case_id)
def test_hinge_module(case):
    kind, kw = case
    args = {"num_classes": C} if kind == "multiclass" else {}
    name = f"{kind.capitalize()}HingeLoss"
    jm, tm = getattr(JC, name)(**args, **kw), getattr(TC, name)(device="cpu", **args, **kw)
    batches = [_data(kind, seed=30 + s, logits=s == 1, ignore=kw.get("ignore_index")) for s in range(3)]
    _check_module(jm, tm, {"total"}, batches, lambda g, w: _close(g, w, logits=True))
    assert tm.total.dtype == torch.int32 and tm.measures.dtype == torch.float32
    _carry_both_ways(lambda: getattr(JC, name)(**args, **kw), lambda: getattr(TC, name)(device="cpu", **args, **kw), jm, tm, _close)


# ------------------------------------------------------------------------ dice

DICE_CASES = [
    ("scores", {"average": "micro"}),
    ("scores", {"average": "macro"}),
    ("scores", {"average": "weighted", "ignore_index": 0}),
    ("scores", {"average": "none"}),
    ("scores", {"average": None, "ignore_index": 2}),
    ("scores", {"average": "samples"}),
    ("scores", {"average": "samples", "ignore_index": 1}),
    ("scores", {"average": "macro", "top_k": 2}),
    ("scores", {"average": "micro", "zero_division": 1.0}),
    ("scores3d", {"average": "macro"}),
    ("labels", {"average": "macro", "num_classes": C}),
    ("labels", {"average": "micro"}),
    ("binary", {"average": "micro", "threshold": 0.3}),
    ("binary", {"average": "none"}),
]


def _dice_data(kind, seed, logits=False):
    if kind == "scores":
        return _data("multiclass", seed, logits=logits)
    if kind == "scores3d":
        return _data("multiclass", seed, logits=logits, extra=(3,))
    if kind == "labels":
        rng = np.random.default_rng(seed)
        return rng.integers(0, C, N).astype(np.int32), rng.integers(0, C, N).astype(np.int32)
    return _data("binary", seed, logits=logits)


def _dice_exact(kw):
    return kw.get("average") in ("micro", "none", None)


@pytest.mark.parametrize("logits", [False, True])
@pytest.mark.parametrize("case", DICE_CASES, ids=_case_id)
def test_dice_functional(case, logits):
    kind, kw = case
    preds, target = _dice_data(kind, seed=6, logits=logits)
    got, want = _both(JF.dice, TF.dice, preds, target, **kw)
    if _dice_exact(kw):
        _bitwise(got, want)
    else:
        _close(got, want)


def test_dice_counts_on_softmax_ties():
    """Two logits one float32 ulp apart (0.3 and the next float) tie after the
    softmax; the argmax is taken on the softmax in both packages, so the tie
    goes to the first class in both, where an argmax of the raw logits would
    pick the second."""
    jdice = importlib.import_module("torchmetrics_tpu.functional.classification.dice")
    tdice = importlib.import_module("torchmetrics_tpu_torch.functional.classification.dice")
    preds, target = _data("multiclass", seed=7, logits=True)
    preds[:4, :] = -3.0
    preds[:4, 1] = 0.3
    preds[:4, 3] = np.nextafter(np.float32(0.3), np.float32(1.0))
    probs = torch.softmax(torch.from_numpy(preds[:4]), 1)
    assert torch.equal(probs[:, 1], probs[:, 3])
    tp_oh = tdice._dice_format(torch.from_numpy(preds), torch.from_numpy(target))[0]
    jp_oh = jdice._dice_format(jnp.asarray(preds), jnp.asarray(target))[0]
    _bitwise(tp_oh, jp_oh)
    assert tp_oh[:4, 1].all() and not tp_oh[:4, 3].any()
    _bitwise(*_both(JF.dice, TF.dice, preds, target, average="none"))


@pytest.mark.parametrize("case", DICE_CASES, ids=_case_id)
def test_dice_module(case):
    kind, kw = case
    jm, tm = J.Dice(**kw), T.Dice(device="cpu", **kw)
    batches = [_dice_data(kind, seed=40 + s, logits=s == 1 and kind != "labels") for s in range(3)]
    check = _bitwise if _dice_exact(kw) else _close
    _check_module(jm, tm, {"tp", "fp", "fn", "samples_count"}, batches, check)

    def sized(metric, to):
        # without num_classes a fresh Dice sizes its states on its first update
        metric.update(*[to(a) for a in batches[0]])
        return metric

    _carry_both_ways(
        lambda: sized(J.Dice(**kw), jnp.asarray),
        lambda: sized(T.Dice(device="cpu", **kw), lambda a: torch.from_numpy(np.array(a))),
        jm, tm, check,
    )


def test_dice_lazy_sizing_and_reset():
    """``num_classes=None`` sizes the states from the first update, and those
    sizes become the defaults ``reset()`` returns to, as in JAX."""
    jm, tm = J.Dice(average="none"), T.Dice(average="none", device="cpu")
    preds, target = _dice_data("scores", seed=1)
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert tuple(tm.tp.shape) == tuple(jm.tp.shape) == (C,)
    _bitwise(tm.compute(), jm.compute())
    jm.reset()
    tm.reset()
    assert tuple(tm.tp.shape) == tuple(jm.tp.shape) == (C,) and float(tm.tp.sum()) == 0
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    want = _raised(jm.update, jnp.asarray(preds[:, :3]), jnp.asarray(np.minimum(target, 2)))
    assert _raised(tm.update, torch.from_numpy(preds[:, :3]), torch.from_numpy(np.minimum(target, 2))) == want


# --------------------------------------------------------------------- ranking

RANKING = {
    "multilabel_coverage_error": "MultilabelCoverageError",
    "multilabel_ranking_average_precision": "MultilabelRankingAveragePrecision",
    "multilabel_ranking_loss": "MultilabelRankingLoss",
}


def _ranking_data(seed, logits=False, ignore=None):
    """Multilabel scores with ties in every row (a 0.1 grid), some all-relevant
    and all-irrelevant rows, and signed zeros."""
    preds, target = _data("multilabel", seed, logits=logits, ignore=ignore)
    if not logits:
        preds = np.round(preds, 1).astype(np.float32)
        preds[::7, 0] = -0.0
        preds[::7, 1] = 0.0
    target[5] = 1
    target[6] = 0
    return preds, target


@pytest.mark.parametrize("logits", [False, True])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("name", sorted(RANKING))
def test_ranking_functional(name, ignore_index, logits):
    preds, target = _ranking_data(9, logits=logits, ignore=ignore_index)
    got, want = _both(getattr(JF, name), getattr(TF, name), preds, target, num_labels=L, ignore_index=ignore_index)
    if name == "multilabel_coverage_error":
        _bitwise(got, want)
    else:
        _close(got, want, logits)


def test_inverse_ranks_match_jax_on_ties():
    """``jnp.argsort(jnp.argsort(x))`` is stable; the port's inverse ranks equal
    it as integers on rows of ties, signed zeros, NaN and infinities."""
    rng = np.random.default_rng(2)
    x = rng.integers(0, 4, (64, 9)).astype(np.float32) / 4
    x[::5, 2] = -0.0
    x[::5, 3] = 0.0
    x[::6, 4] = np.nan
    x[::6, 5] = np.nan
    x[::7, 6] = np.inf
    x[::7, 7] = -np.inf
    want = np.asarray(jnp.argsort(jnp.argsort(jnp.asarray(x), axis=1), axis=1))
    got = trank._inverse_ranks(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(RANKING))
def test_ranking_update_states(name):
    """Each update's (measure, total): total an int32 row count, measure within
    the budget (coverage bitwise)."""
    preds, target = _ranking_data(10)
    stem = name.replace("multilabel_", "_multilabel_") + "_update"
    got = getattr(trank, stem)(torch.from_numpy(preds), torch.from_numpy(target))
    want = getattr(jrank, stem)(jnp.asarray(preds), jnp.asarray(target))
    _bitwise(got[1], want[1], "total")
    (_bitwise if name == "multilabel_coverage_error" else _close)(got[0], want[0])


@pytest.mark.parametrize("name", sorted(RANKING))
def test_ranking_module(name):
    klass = RANKING[name]
    jm, tm = getattr(JC, klass)(num_labels=L, ignore_index=-1), getattr(TC, klass)(num_labels=L, ignore_index=-1, device="cpu")
    batches = [_ranking_data(50 + s, logits=s == 1, ignore=-1) for s in range(3)]
    exact = {"total", "measure"} if name == "multilabel_coverage_error" else {"total"}
    check = _bitwise if name == "multilabel_coverage_error" else _close
    _check_module(jm, tm, exact, batches, check)
    assert tm.measure.dtype == tm.total.dtype == torch.float32
    _carry_both_ways(
        lambda: getattr(JC, klass)(num_labels=L, ignore_index=-1),
        lambda: getattr(TC, klass)(num_labels=L, ignore_index=-1, device="cpu"),
        jm, tm, check,
    )


# -------------------------------------------------------------- group fairness


def _fair_data(seed, ignore=None, groups=G, logits=True):
    preds, target = _data("binary", seed, logits=logits, ignore=ignore)
    rng = np.random.default_rng(seed + 100)
    return preds, target, rng.integers(0, groups, N).astype(np.int32)


def _dict_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        _bitwise(got[k], want[k], k)


@pytest.mark.parametrize("ignore_index", [None, -1])
def test_group_fairness_functionals(ignore_index):
    preds, target, groups = _fair_data(11, ignore=ignore_index)
    kw = {"ignore_index": ignore_index, "threshold": 0.4}
    _dict_bitwise(*_both(JF.binary_groups_stat_rates, TF.binary_groups_stat_rates, preds, target, groups, num_groups=G, **kw))
    _dict_bitwise(*_both(JF.equal_opportunity, TF.equal_opportunity, preds, target, groups, **kw))
    _dict_bitwise(*_both(JF.demographic_parity, TF.demographic_parity, preds, groups, **kw))
    for task in ("all", "demographic_parity", "equal_opportunity"):
        _dict_bitwise(*_both(JF.binary_fairness, TF.binary_fairness, preds, target, groups, task=task, **kw))


def test_group_count_is_the_number_of_distinct_ids():
    """The functionals count groups with ``unique`` (not the largest id + 1), as JAX does."""
    preds, target, groups = _fair_data(12)
    groups = np.where(groups == 1, 0, groups)  # ids {0, 2}: two groups, the id 2 fails validation
    want = _raised(JF.binary_fairness, jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups))
    assert _raised(TF.binary_fairness, torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(groups)) == want
    _dict_bitwise(*_both(JF.binary_fairness, TF.binary_fairness, preds, target, groups, validate_args=False))


FAIR_ERRORS = [
    ("binary_fairness", {"task": "parity"}),
    ("binary_fairness", {"task": "equal_opportunity", "target": None}),
    ("binary_groups_stat_rates", {"num_groups": 2}),
    ("binary_groups_stat_rates", {"num_groups": G, "threshold": 2}),
]


@pytest.mark.parametrize("case", FAIR_ERRORS, ids=lambda c: c[0] + "-" + "-".join(f"{k}={v}" for k, v in c[1].items()))
def test_group_fairness_errors_match_jax(case):
    name, kw = case
    preds, target, groups = _fair_data(13)
    kw = dict(kw)
    tgt = kw.pop("target", target)
    want = _raised(getattr(JF, name), jnp.asarray(preds), None if tgt is None else jnp.asarray(tgt), jnp.asarray(groups), **kw)
    got = _raised(getattr(TF, name), torch.from_numpy(preds), None if tgt is None else torch.from_numpy(tgt), torch.from_numpy(groups), **kw)
    assert got == want


def test_groups_of_floats_are_refused_like_jax():
    preds, target, groups = _fair_data(14)
    want = _raised(JF.binary_groups_stat_rates, jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups.astype(np.float32)), G)
    got = _raised(TF.binary_groups_stat_rates, torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(groups.astype(np.float32)), G)
    assert got == want


@pytest.mark.parametrize("klass,kw", [
    ("BinaryGroupStatRates", {}),
    ("BinaryFairness", {"task": "all"}),
    ("BinaryFairness", {"task": "demographic_parity", "ignore_index": -1}),
    ("BinaryFairness", {"task": "equal_opportunity", "threshold": 0.3}),
])
def test_group_fairness_module(klass, kw):
    jm, tm = getattr(JC, klass)(G, **kw), getattr(TC, klass)(G, device="cpu", **kw)
    batches = [_fair_data(60 + s, ignore=kw.get("ignore_index"), logits=s != 1) for s in range(3)]
    _check_module(jm, tm, {"tp", "fp", "tn", "fn"}, batches, _dict_bitwise)
    assert tm.tp.dtype == torch.float32
    _carry_both_ways(lambda: getattr(JC, klass)(G, **kw), lambda: getattr(TC, klass)(G, device="cpu", **kw), jm, tm, _dict_bitwise)


def test_group_fairness_module_errors_match_jax():
    for args in ((1,), (G, "parity")):
        assert _raised(TC.BinaryFairness, *args, device="cpu") == _raised(JC.BinaryFairness, *args)
    assert _raised(TC.BinaryGroupStatRates, 1.5, device="cpu") == _raised(JC.BinaryGroupStatRates, 1.5)
    preds, target, groups = _fair_data(15)
    jm, tm = JC.BinaryFairness(G, task="all"), TC.BinaryFairness(G, task="all", device="cpu")
    assert _raised(tm.update, torch.from_numpy(preds), None, torch.from_numpy(groups)) == _raised(
        jm.update, jnp.asarray(preds), None, jnp.asarray(groups)
    )


# ---------------------------------------------------- dispatch, exports, groups


DISPATCH = {
    "CalibrationError": ("calibration_error", {}),
    "HingeLoss": ("hinge_loss", {}),
}
BAD_TASKS = [{"task": "multilabel", "num_classes": C}, {"task": "multiclass"}, {"task": "Binary"}, {"task": "multiclass", "num_classes": 2.0}]


@pytest.mark.parametrize("bad", BAD_TASKS, ids=lambda b: "-".join(f"{k}={v}" for k, v in b.items()))
@pytest.mark.parametrize("klass", sorted(DISPATCH))
def test_dispatch_errors_match_jax(klass, bad):
    fn = DISPATCH[klass][0]
    preds, target = _data("multiclass", seed=1)
    want = _raised(getattr(JF, fn), jnp.asarray(preds), jnp.asarray(target), **bad)
    assert _raised(getattr(TF, fn), torch.from_numpy(preds), torch.from_numpy(target), **bad) == want
    assert _raised(getattr(T, klass), device="cpu", **bad) == _raised(getattr(J, klass), **bad)


@pytest.mark.parametrize("klass", sorted(DISPATCH))
def test_task_wrapper_builds_the_task_class(klass):
    for task, args in (("binary", {}), ("multiclass", {"num_classes": C})):
        got, want = getattr(T, klass)(task=task, device="cpu", **args), getattr(J, klass)(task=task, **args)
        assert type(got).__name__ == type(want).__name__ == f"{task.capitalize()}{klass}"
        assert got.state_spec()["fingerprint"] == want.state_spec()["fingerprint"]


@pytest.mark.parametrize("name,bad", [
    ("BinaryCalibrationError", {"n_bins": 0}),
    ("BinaryCalibrationError", {"norm": "l3"}),
    ("MulticlassCalibrationError", {"num_classes": 1}),
    ("BinaryHingeLoss", {"squared": 1}),
    ("MulticlassHingeLoss", {"num_classes": C, "multiclass_mode": "ova"}),
    ("MultilabelRankingLoss", {"num_labels": 1}),
    ("MultilabelCoverageError", {"num_labels": L, "ignore_index": 0.5}),
])
def test_argument_errors_match_jax(name, bad):
    assert _raised(getattr(TC, name), device="cpu", **bad) == _raised(getattr(JC, name), **bad)
    assert _raised(T.Dice, average="mean", device="cpu") == _raised(J.Dice, average="mean")


def test_exports_equal_jax_but_generalized_dice_score():
    """The port's ``classification`` and ``functional.classification`` export
    JAX's names; ``generalized_dice_score`` (segmentation, ROADMAP A14) is the
    one exception."""
    import torchmetrics_tpu_torch.classification as port_classes

    assert sorted(port_classes.__all__) == sorted(JC.__all__)
    assert sorted(TF.__all__) == sorted(set(JF.__all__) - {"generalized_dice_score"})
    for name in port_classes.__all__:
        assert getattr(port_classes, name).__module__.startswith("torchmetrics_tpu_torch.")
    for name in TF.__all__:
        assert getattr(TF, name).__module__.startswith("torchmetrics_tpu_torch.")
    top = {"CalibrationError", "Dice", "HingeLoss", "PrecisionAtFixedRecall", "RecallAtFixedPrecision",
           "SensitivityAtSpecificity", "SpecificityAtSensitivity"}
    assert top <= set(J.__all__) and top <= set(T.__all__)


def _scores_suite(pkg):
    cls = pkg.classification
    kw = {} if pkg is J else {"device": "cpu"}
    return pkg.MetricCollection({
        "ece_l1": cls.MulticlassCalibrationError(C, n_bins=15, norm="l1", **kw),
        "ece_l2": cls.MulticlassCalibrationError(C, n_bins=15, norm="l2", **kw),
        "hinge_cs": cls.MulticlassHingeLoss(C, **kw),
        "hinge_ova": cls.MulticlassHingeLoss(C, multiclass_mode="one-vs-all", **kw),
        "dice": cls.Dice(num_classes=C, average="macro", **kw),
    })


def _ranking_suite(pkg):
    kw = {} if pkg is J else {"device": "cpu"}
    return pkg.MetricCollection({k: getattr(pkg.classification, v)(num_labels=L, **kw) for k, v in RANKING.items()})


def _fairness_suite(pkg):
    kw = {} if pkg is J else {"device": "cpu"}
    cls = pkg.classification
    return pkg.MetricCollection({"fair": cls.BinaryFairness(G, **kw), "rates": cls.BinaryGroupStatRates(G, **kw)})


SUITES = {
    "scores": (_scores_suite, lambda seed: _data("multiclass", seed=seed)),
    "ranking": (_ranking_suite, _ranking_data),
    "fairness": (_fairness_suite, _fair_data),
}


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_compute_groups_equal_jax(suite):
    """The same compute groups as JAX's: the two calibration errors share their
    bins, hinge's two modes and Dice stay apart; the ranking metrics stay
    apart; the two fairness metrics share their per-group counts. The values
    within the budget."""
    make, data = SUITES[suite]
    jcol, tcol = make(J), make(T)
    for seed in range(3):
        batch = data(seed)
        jcol.update(*[jnp.asarray(a) for a in batch])
        tcol.update(*[torch.from_numpy(np.array(a)) for a in batch])
    assert sorted(map(sorted, tcol.compute_groups.values())) == sorted(map(sorted, jcol.compute_groups.values()))
    jvals, tvals = jcol.compute(), tcol.compute()
    assert sorted(jvals) == sorted(tvals)
    for key in jvals:
        _close(tvals[key], jvals[key], what=key)


def _fused_equals_eager(make, batches, mode):
    eager, fused = make(), make()
    tb = [tuple(torch.from_numpy(np.array(a)) for a in b) for b in batches]
    for b in tb[:2]:
        eager.update(*b)
        fused.update(*b)
    plan = fused.fused()
    for b in tb[2:]:
        eager.update(*b)
    if mode == "update":
        for b in tb[2:]:
            plan.update(*b)
    else:
        plan.run_scan(tb[2:])
    plan.fold_back()
    for key in eager.keys(keep_base=True):
        a, b = state_to_numpy(dict.__getitem__(eager, key)), state_to_numpy(dict.__getitem__(fused, key))
        for name in a:
            _bitwise(b[name], a[name], f"{key}.{name}")


@pytest.mark.parametrize("mode", ["update", "scan"])
def test_fused_plan_equals_the_eager_fold(mode):
    """Calibration, hinge and Dice through ``suite.fused()``; the ranking
    metrics; group fairness (three batch arguments): the states equal the
    eager fold's bitwise."""
    _fused_equals_eager(lambda: _scores_suite(T), [_data("multiclass", seed=80 + i) for i in range(4)], mode)
    _fused_equals_eager(lambda: _ranking_suite(T), [_ranking_data(90 + i) for i in range(4)], mode)
    _fused_equals_eager(lambda: _fairness_suite(T), [_fair_data(95 + i) for i in range(4)], mode)


def test_fusion_report_of_the_new_families_matches_jax():
    from torchmetrics_tpu.parallel import fusion_report as j_fusion_report
    from torchmetrics_tpu_torch.parallel import fusion_report

    def members(pkg):
        kw = {} if pkg is J else {"device": "cpu"}
        cls = pkg.classification
        return pkg.MetricCollection({
            "ece": cls.BinaryCalibrationError(**kw), "hinge": cls.BinaryHingeLoss(**kw), "dice": cls.Dice(**kw),
            "cov": cls.MultilabelCoverageError(L, **kw), "fair": cls.BinaryFairness(G, **kw),
            "rates": cls.BinaryGroupStatRates(G, **kw),
        })

    assert fusion_report(members(T)) == j_fusion_report(members(J))
