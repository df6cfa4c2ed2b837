# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's hand CUDA kernels against their plain PyTorch versions, on a card,
and the exact curve path on the card against the same path on the CPU.

Marked ``cuda``: they need an NVIDIA GPU and ``nvcc`` (the kernels are built
from ``torchmetrics_tpu_torch/csrc`` at first use) and skip without them.
Run them on a machine with a card with ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest``.
Each dispatch path of each kernel is held bitwise (integer counts) against
its plain version on the same CUDA inputs, and its launch counter must move.
The exact curve has no hand kernel: its padded curve must equal the CPU's
bitwise (the sort's order on NaN, signed zeros and ignored entries) and its
AUROC and AP within 1e-6 (float32 sums in another order). The fused plan's
captured CUDA graphs must give the eager path's states and values bitwise,
capture a second graph for a new batch shape, and raise (never run eagerly)
where a capture fails; DeviceFeed stages pinned numpy batches on the card.
The confusion-matrix families count on the card what the CPU counts, out-of-range
labels included, and capture in a fused plan. The regression and aggregation
collection captures and equals its eager fold bitwise; Kendall's float32
census on the card stays within 2^-20 of its exact int64 recount.
Wrappers (MinMax, Classwise, BootStrapper, Multioutput, Multitask, the
tracker) and metric arithmetic on the card compute what they compute on the
CPU, with K1 and K2 launching under them; a card metric plots what a CPU
one plots (matplotlib, where installed).
The sketch plane on the card equals it on the CPU; K3 (the Count-Min
table's scan) equals its loop bitwise, and the one-metric step of
``make_jit_update`` captures and equals eager updates. K4 (the slice
table), K2s and K1s (the segmented stat counts and binned curve state) equal
their plain versions bitwise (also at the StateGuard's one-cell shape), and
a sliced plan captured on the card equals the same plan on the CPU; so does
the guarded flagship suite captured in a fused plan.
Two ranks of one gloo group share the card (this file run as a script is
their worker): ``gather_all_tensors`` carries CUDA tensors of uneven shapes,
and the sharded fused plan's graphs give the eager ``sharded_update``'s
states and values bitwise.
"""
import importlib
import sys
from pathlib import Path

import shutil

import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _uniform_grid
from torchmetrics_tpu_torch.functional.classification.auroc import _multiclass_auroc_compute, _multilabel_auroc_compute
from torchmetrics_tpu_torch.functional.classification.average_precision import (
    _multiclass_average_precision_compute,
    _multilabel_average_precision_compute,
)
import torchmetrics_tpu_torch as T
from torchmetrics_tpu_torch.ops import binned_curve_state, binned_curve_state_plain, stat_counts, stat_counts_plain
from torchmetrics_tpu_torch.parallel import DeviceFeed
from torchmetrics_tpu_torch.utilities.compute import _linspace_like_jax

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand kernels have no CPU or interpret mode")
    if shutil.which("nvcc") is None and not shutil.os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the hand kernels")
    return torch.device("cuda")


# T=5 and 128: histogram in shared memory; 6000 and 13000: tiles narrowed
# until it fits, else in global memory; 13000: thresholds in global memory
@pytest.mark.parametrize("uniform", [True, False], ids=["affine", "search"])
@pytest.mark.parametrize("k", [7, 64], ids=["scalar", "float4"])
@pytest.mark.parametrize("len_t", [5, 128, 6000, 13000])
@pytest.mark.parametrize("labels", [True, False], ids=["labels", "binary"])
def test_binned_curve_state_matches_plain(card, labels, len_t, k, uniform):
    rng = np.random.default_rng(41)
    n = 20000
    p = rng.random((n, k)).astype(np.float32)
    p[3, :] = np.nan  # an all-NaN row
    p.reshape(-1)[:6] = [np.nan, np.inf, -np.inf, -0.5, 1.5, -0.0]
    thr = _linspace_like_jax(0.0, 1.0, len_t, device=card)
    p.reshape(-1)[6 : 6 + min(len_t, 100)] = thr[: min(len_t, 100)].cpu().numpy()
    dtype = np.int64 if len_t == 128 else np.int32
    target = rng.integers(-1, k + 2, n if labels else (n, k)).astype(dtype)
    pc, tc = torch.from_numpy(p).to(card), torch.from_numpy(target).to(card)
    affine = _uniform_grid(len_t) if uniform else None
    assert (affine is not None) is uniform
    before = binned_curve_state.launches
    got = binned_curve_state(pc, thr, tc, labels, affine)
    torch.cuda.synchronize()
    assert binned_curve_state.launches == before + 1
    torch.testing.assert_close(got, binned_curve_state_plain(pc, thr, tc, labels), rtol=0, atol=0)


def test_binned_curve_state_irregular_grid(card):
    rng = np.random.default_rng(43)
    p = torch.from_numpy(rng.random((30000, 64)).astype(np.float32)).to(card)
    thr = torch.sort(torch.from_numpy(rng.random(97).astype(np.float32))).values.to(card)
    thr[10:13] = thr[10]  # repeated thresholds
    target = torch.from_numpy(rng.integers(0, 64, 30000).astype(np.int32)).to(card)
    got = binned_curve_state(p, thr, target, True, _uniform_grid(thr))
    torch.testing.assert_close(got, binned_curve_state_plain(p, thr, target, True), rtol=0, atol=0)


@pytest.mark.parametrize("ignore_index", [None, 3, -7])
@pytest.mark.parametrize(
    "mode,num_classes", [("scores", 64), ("scores", 7), ("scores", 4000), ("int32", 64), ("int64", 300)]
)
def test_stat_counts_matches_plain(card, mode, num_classes, ignore_index):
    rng = np.random.default_rng(42)
    n = 3001 if num_classes == 4000 else 70001
    if mode == "scores":
        scores = rng.standard_normal((n, num_classes)).astype(np.float32)
        scores[0, :] = np.nan
        scores[1, :] = -np.inf
        scores[2, :] = 0.0
        scores[2, ::2] = -0.0
        scores[3, 1:] = 1.0
        scores[4, num_classes - 1] = np.nan
        preds = torch.from_numpy(scores).to(card)
    else:
        preds = torch.from_numpy(rng.integers(-2, num_classes + 2, n).astype(np.int32 if mode == "int32" else np.int64))
        preds = preds.to(card)
    target = torch.from_numpy(rng.integers(-2, num_classes + 2, n).astype(np.int64)).to(card)
    if ignore_index is not None:
        target[::11] = ignore_index
    before = stat_counts.launches
    got = stat_counts(preds, target, num_classes, ignore_index)
    torch.cuda.synchronize()
    assert stat_counts.launches == before + 1
    torch.testing.assert_close(got, stat_counts_plain(preds, target, num_classes, ignore_index), rtol=0, atol=0)


def test_empty_batches_launch_nothing(card):
    """An empty batch comes back as a zeroed state; no kernel runs and no launch is counted."""
    before = (binned_curve_state.launches, stat_counts.launches)
    thr = _linspace_like_jax(0.0, 1.0, 9, device=card)
    state = binned_curve_state(torch.zeros(0, 4, device=card), thr, torch.zeros(0, dtype=torch.int32, device=card), True)
    empty = torch.zeros(0, dtype=torch.int32, device=card)
    counts = stat_counts(empty, empty, 4, None)
    scores = stat_counts(torch.zeros(0, 4, device=card), empty, 4, 2)
    torch.cuda.synchronize()
    assert (binned_curve_state.launches, stat_counts.launches) == before
    assert state.shape == (9, 4, 2, 2) and int(state.abs().sum()) == 0
    assert counts.shape == scores.shape == (4, 4) and int(counts.abs().sum()) == int(scores.abs().sum()) == 0


def test_binned_curve_state_matrix_mode_at_bench_width(card):
    """The multilabel path: K1's matrix mode at 65536x64, T=128, with -1 (ignored) entries."""
    rng = np.random.default_rng(44)
    n, k = 65536, 64
    p = torch.sigmoid(torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))).to(card)
    target = rng.integers(0, 2, (n, k)).astype(np.int32)
    target.reshape(-1)[rng.integers(0, n * k, n * k // 100)] = -1
    tc = torch.from_numpy(target).to(card)
    thr = _linspace_like_jax(0.0, 1.0, 128, device=card)
    before = binned_curve_state.launches
    got = binned_curve_state(p, thr, tc, False, _uniform_grid(128))
    torch.cuda.synchronize()
    assert binned_curve_state.launches == before + 1
    torch.testing.assert_close(got, binned_curve_state_plain(p, thr, tc, False), rtol=0, atol=0)


def test_exact_padded_curve_on_the_card_equals_cpu(card):
    """NaN last (after the ignored entries), +-0 tied in input order, +-inf, ties."""
    prc = importlib.import_module("torchmetrics_tpu_torch.functional.classification.precision_recall_curve")
    rng = np.random.default_rng(45)
    p = np.round(rng.random(100003), 3).astype(np.float32)
    specials = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)
    p[rng.integers(0, p.size, 3000)] = specials[rng.integers(0, specials.size, 3000)]
    t = rng.integers(-1, 2, p.size).astype(np.int32)
    cpu = prc._binary_clf_curve_padded(torch.from_numpy(p), torch.from_numpy(t))
    gpu = prc._binary_clf_curve_padded(torch.from_numpy(p).to(card), torch.from_numpy(t).to(card))
    for g, c in zip(gpu, cpu):
        assert torch.equal(g.cpu().view(torch.uint8) if g.is_floating_point() else g.cpu(), c.view(torch.uint8) if c.is_floating_point() else c)


@pytest.mark.parametrize("task", ["multiclass", "multilabel"])
def test_exact_auroc_and_ap_on_the_card_equal_cpu(card, task):
    rng = np.random.default_rng(46)
    n, c = 131072, 64
    logits = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32))
    if task == "multiclass":
        preds = torch.softmax(logits, dim=1)
        target = torch.from_numpy(rng.integers(-1, c, n).astype(np.int32))
        fns = (lambda s: _multiclass_auroc_compute(s, c, None), lambda s: _multiclass_average_precision_compute(s, c, None))
    else:
        preds = torch.sigmoid(logits)
        target = torch.from_numpy(rng.integers(-1, 2, (n, c)).astype(np.int32))
        fns = (lambda s: _multilabel_auroc_compute(s, c, None, None), lambda s: _multilabel_average_precision_compute(s, c, None, None))
    for fn in fns:
        want = fn((preds, target))
        got = fn((preds.to(card), target.to(card)))
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)


# ------------------------------------------------------------ the fused plan


def _fused_suite(card, validate_args=False, exact=False):
    c, kw = 16, {"validate_args": validate_args, "device": card}
    if exact:
        return T.MetricCollection({"auroc": T.MulticlassAUROC(num_classes=c, **kw), "ap": T.MulticlassAveragePrecision(num_classes=c, **kw)})
    return T.MetricCollection(
        {
            "acc": T.MulticlassAccuracy(num_classes=c, average="micro", **kw),
            "f1": T.MulticlassF1Score(num_classes=c, average="macro", **kw),
            "f2": T.MulticlassFBetaScore(beta=2.0, num_classes=c, average="macro", **kw),
            "auroc": T.MulticlassAUROC(num_classes=c, thresholds=64, **kw),
        }
    )


def _fused_batches(card, n_batches=5, n=4096, seed=47):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    return [
        (torch.randn((n, 16), generator=gen, device=card), torch.randint(0, 16, (n,), generator=gen, device=card, dtype=torch.int32))
        for _ in range(n_batches)
    ]


def _assert_collections_bitwise(ref, fus):
    for key in ref.keys(keep_base=True):
        a, b = dict.__getitem__(ref, key), dict.__getitem__(fus, key)
        assert a._update_count == b._update_count
        for name in a._defaults:
            x, y = getattr(a, name), getattr(b, name)
            if isinstance(x, list):
                x, y = torch.cat(x), torch.cat(y)
            assert torch.equal(x, y), f"{key}.{name}"
    want, got = ref.compute(), fus.compute()
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("mode", ["update", "scan"])
@pytest.mark.parametrize("validate_args", [False, True], ids=["plain", "validate_args"])
def test_fused_plan_graph_equals_eager(card, validate_args, mode):
    """Captured on the card: states and values bitwise equal to the eager
    collection; a validate_args=True suite captures (its value checks skip
    themselves under capture); the replays run K1 and K2 once each, as a
    profiler trace shows, and leave the wrappers' counters alone."""
    batches = _fused_batches(card)
    ref, fus = _fused_suite(card, validate_args), _fused_suite(card, validate_args)
    for b in batches:
        ref.update(*b)
    fus.update(*batches[0])
    fus.update(*batches[1])
    plan = fus.fused()
    if mode == "scan":
        plan.run_scan(batches[2:])
    else:
        plan.update(*batches[2])  # warm-up, capture, first replay
        before = (binned_curve_state.launches, stat_counts.launches)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            plan.update(*batches[3])
            plan.update(*batches[4])
            torch.cuda.synchronize()
        traced = {k: sum(e.count for e in prof.key_averages() if f"{k}_kernel" in e.key) for k in ("binned_curve_state", "stat_counts")}
        assert traced == {"binned_curve_state": 2, "stat_counts": 2}
        assert (binned_curve_state.launches, stat_counts.launches) == before
    assert len(plan._captured) == 1
    plan.fold_back()
    _assert_collections_bitwise(ref, fus)


def test_fused_plan_exact_group_on_the_card(card):
    batches = _fused_batches(card, n_batches=4)
    ref, fus = _fused_suite(card, exact=True), _fused_suite(card, exact=True)
    for b in batches:
        ref.update(*b)
    fus.update(*batches[0])
    fus.update(*batches[1])
    plan = fus.fused(cat_capacity=4 * 4096, example_batch=batches[0])
    plan.update(*batches[2])
    plan.update(*batches[3])
    plan.fold_back()
    _assert_collections_bitwise(ref, fus)


def test_fused_plan_new_batch_shape_captures_a_second_graph(card):
    batches = _fused_batches(card, n_batches=4)
    short = tuple(x[:1000] for x in batches[3])
    ref, fus = _fused_suite(card), _fused_suite(card)
    for b in batches[:3] + [short]:
        ref.update(*b)
    fus.update(*batches[0])
    fus.update(*batches[1])
    plan = fus.fused()
    plan.update(*batches[2])
    plan.update(*short)
    assert len(plan._captured) == 2
    plan.fold_back()
    _assert_collections_bitwise(ref, fus)


def test_fused_plan_capture_failure_raises(card):
    """A host read inside update cannot be captured: the plan raises naming
    the member, and the carry is left as it was (no eager run)."""

    class _HostRead(T.Metric):
        def __init__(self):
            super().__init__(device=card)
            self.add_state("total", torch.zeros((), device=card), dist_reduce_fx="sum")

        def update(self, preds, target):
            self.total = self.total + float(preds.sum())

        def compute(self):
            return self.total

    col = T.MetricCollection({"host": _HostRead()})
    plan = col.fused()
    with pytest.raises(RuntimeError, match=r"capturing the fused step .* member 'host' \(_HostRead.update\)"):
        plan.update(torch.ones(8, device=card), torch.ones(8, device=card))
    assert int(plan.state["_update_count"]) == 0 and float(plan.state["members"]["host"]["total"]) == 0.0


def _family_suite(device, ignore_index=None):
    """The stat-scores and confusion-matrix families over 64 classes: two compute groups."""
    kw = {"num_classes": 64, "ignore_index": ignore_index, "validate_args": False, "device": device}
    return T.MetricCollection(
        {
            "prec": T.MulticlassPrecision(average="macro", **kw),
            "rec": T.MulticlassRecall(average="macro", **kw),
            "ham": T.MulticlassHammingDistance(average="macro", **kw),
            "cm": T.MulticlassConfusionMatrix(**kw),
            "jac": T.MulticlassJaccardIndex(**kw),
            "mcc": T.MulticlassMatthewsCorrCoef(**kw),
            "kappa": T.MulticlassCohenKappa(weights="quadratic", **kw),
        }
    )


def _family_batches(card, ignore_index, n_batches=3):
    """65536 x 64 logits; labels over [-3, 67), so some lie outside the classes, a tenth set to ``ignore_index``."""
    gen = torch.Generator(device=card)
    gen.manual_seed(53)
    out = []
    for _ in range(n_batches):
        logits = torch.randn((65536, 64), generator=gen, device=card)
        labels = torch.randint(-3, 67, (65536,), generator=gen, device=card, dtype=torch.int32)
        if ignore_index is not None:
            labels[::10] = ignore_index
        out.append((logits, labels))
    return out


@pytest.mark.parametrize("ignore_index", [None, 5, -1])
def test_confusion_matrix_family_on_the_card_equals_cpu(card, ignore_index):
    """At 65536 x 64 with out-of-range labels: the card's int32 ``confmat``
    and tp/fp/tn/fn equal the CPU fold's bitwise (the capture-safe count
    keeps jnp.bincount's rules on the card), the values within 1e-5."""
    batches = _family_batches(card, ignore_index)
    on_card, on_cpu = _family_suite(card, ignore_index), _family_suite("cpu", ignore_index)
    for logits, labels in batches:
        on_card.update(logits, labels)
        on_cpu.update(logits.cpu(), labels.cpu())
    for key, name in (("cm", "confmat"), ("prec", "tp"), ("prec", "fp"), ("prec", "tn"), ("prec", "fn")):
        got, want = getattr(on_card[key], name), getattr(on_cpu[key], name)
        assert got.device.type == card.type and got.dtype == want.dtype == torch.int32
        assert torch.equal(got.cpu(), want), f"{key}.{name}"
    got, want = on_card.compute(), on_cpu.compute()
    for key in want:
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-5, atol=1e-6)


def test_confusion_matrix_family_fused_graph_equals_eager(card):
    """The families through ``suite.fused()``: the count captures (no host
    read), the replays' states and values equal the eager fold bitwise, and
    each replay runs K2 once for the stat-scores group."""
    batches = _family_batches(card, 5, n_batches=5)
    ref, fus = _family_suite(card, 5), _family_suite(card, 5)
    for b in batches:
        ref.update(*b)
    fus.update(*batches[0])
    fus.update(*batches[1])
    plan = fus.fused()
    plan.update(*batches[2])  # warm-up, capture, first replay
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        plan.update(*batches[3])
        plan.update(*batches[4])
        torch.cuda.synchronize()
    assert sum(e.count for e in prof.key_averages() if "stat_counts_kernel" in e.key) == 2
    assert len(plan._captured) == 1
    plan.fold_back()
    _assert_collections_bitwise(ref, fus)


def test_argmax_hard_rows_on_the_card_match_cpu(card):
    """``torch.argmax`` on the card keeps the CPU's (and ``jnp.argmax``'s) rule
    on ties, NaN, -inf and signed zeros; so does the confusion matrix built on it."""
    scores = torch.randn((64, 64))
    scores[0] = float("nan")
    scores[1] = float("-inf")
    scores[2] = 0.0
    scores[2, ::2] = -0.0
    scores[3] = 0.25
    scores[4, 32:] = 1e9
    scores[5, 63] = float("nan")
    scores[6, 1:] = float("inf")
    scores[6, 3] = float("nan")
    assert torch.equal(torch.argmax(scores.to(card), dim=1).cpu(), torch.argmax(scores, dim=1))
    target = torch.arange(64, dtype=torch.int32)
    got = T.functional.multiclass_confusion_matrix(scores.to(card), target.to(card), 64)
    assert torch.equal(got.cpu(), T.functional.multiclass_confusion_matrix(scores, target, 64))


def test_device_feed_stages_pinned_numpy_on_the_card(card):
    pinned = [torch.empty((1024, 16), pin_memory=True) for _ in range(3)]
    for i, t in enumerate(pinned):
        t.fill_(i)
    batches = [(t.numpy(), np.full(1024, i, np.int32)) for i, t in enumerate(pinned)]
    out = list(DeviceFeed(batches, depth=2))
    assert len(out) == 3
    for i, (x, y) in enumerate(out):
        assert x.device.type == "cuda" and y.device.type == "cuda"
        assert bool((x == i).all()) and bool((y == i).all())


# ------------------------------------ the rest of classification on the card


def _probability_batches(card, kind, n_batches=3, n=65536, c=64):
    """Seeded probabilities made on the CPU (so the card and the CPU bin the
    same values) with labels, or {0, 1} targets with some -1."""
    gen = torch.Generator().manual_seed(59)
    out = []
    for _ in range(n_batches):
        if kind == "multiclass":
            preds = torch.softmax(torch.randn((n, c), generator=gen), dim=1)
            target = torch.randint(0, c, (n,), generator=gen, dtype=torch.int32)
        else:
            preds = torch.rand((n, c), generator=gen)
            target = torch.randint(-1, 2, (n, c), generator=gen, dtype=torch.int32)
        out.append((preds, target))
    return out


@pytest.mark.parametrize("thresholds", [128, None], ids=["binned", "exact"])
@pytest.mark.parametrize("kind", ["multiclass", "multilabel"])
def test_fixed_point_families_on_the_card_equal_cpu(card, kind, thresholds):
    """The four fixed-point classes on the card: the curve state equals the
    CPU's bitwise, and so does every per-class value and threshold (the
    selection is compares, masks, maxima and a first-maximum argmax)."""
    prefix, size = ("Multiclass", {"num_classes": 64}) if kind == "multiclass" else ("Multilabel", {"num_labels": 64})
    families = {
        "RecallAtFixedPrecision": "min_precision",
        "PrecisionAtFixedRecall": "min_recall",
        "SensitivityAtSpecificity": "min_specificity",
        "SpecificityAtSensitivity": "min_sensitivity",
    }
    ignore = {} if kind == "multiclass" else {"ignore_index": -1}
    for name, arg in families.items():
        make = getattr(T.classification, f"{prefix}{name}")
        on_card = make(**size, **{arg: 0.05}, thresholds=thresholds, validate_args=False, device=card, **ignore)
        on_cpu = make(**size, **{arg: 0.05}, thresholds=thresholds, validate_args=False, device="cpu", **ignore)
        for preds, target in _probability_batches(card, kind, n_batches=2):
            on_card.update(preds.to(card), target.to(card))
            on_cpu.update(preds, target)
        if thresholds is not None:
            assert torch.equal(on_card.confmat.cpu(), on_cpu.confmat)
        for got, want in zip(on_card.compute(), on_cpu.compute()):
            assert got.device.type == "cuda" and torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)), name


def _scores_collections(device):
    kw = {"validate_args": False, "device": device}
    cls = T.classification
    return {
        "multiclass": T.MetricCollection({
            "ece": cls.MulticlassCalibrationError(64, n_bins=15, **kw),
            "hinge": cls.MulticlassHingeLoss(64, multiclass_mode="one-vs-all", **kw),
            "dice": cls.Dice(num_classes=64, average="none", device=device),
        }),
        "multilabel": T.MetricCollection({
            "coverage": cls.MultilabelCoverageError(64, ignore_index=-1, **kw),
            "rank_ap": cls.MultilabelRankingAveragePrecision(64, ignore_index=-1, **kw),
            "rank_loss": cls.MultilabelRankingLoss(64, ignore_index=-1, **kw),
        }),
    }


def test_scores_families_on_the_card_equal_cpu(card):
    """Calibration, hinge, Dice and the ranking metrics at 65536 x 64 on the
    card: the count states equal the CPU's bitwise, the float sums and the
    values within 1e-5 (float32 sums in another order)."""
    on_card, on_cpu = _scores_collections(card), _scores_collections("cpu")
    for kind in ("multiclass", "multilabel"):
        for preds, target in _probability_batches(card, kind):
            on_card[kind].update(preds.to(card), target.to(card))
            on_cpu[kind].update(preds, target)
        for key in on_cpu[kind].keys(keep_base=True):
            for name, want in on_cpu[kind][key].state_tree().items():
                got = getattr(on_card[kind][key], name).cpu()
                assert got.dtype == want.dtype and got.shape == want.shape, f"{key}.{name}"
                if name in ("bin_count", "total", "tp", "fp", "fn") or key == "coverage":
                    assert torch.equal(got, want), f"{key}.{name}"
                else:
                    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        got, want = on_card[kind].compute(), on_cpu[kind].compute()
        for key in want:
            torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-5, atol=1e-6)


def test_scores_and_fairness_fused_graphs_equal_eager(card):
    """The calibration, hinge, Dice, ranking and fairness updates capture (no
    host read with ``validate_args=False``; fairness takes three batch
    arguments); the replays' states equal the eager fold's bitwise."""
    gen = torch.Generator(device=card).manual_seed(61)
    fair = lambda: T.MetricCollection({  # noqa: E731
        "fair": T.classification.BinaryFairness(8, validate_args=False, device=card),
        "rates": T.classification.BinaryGroupStatRates(8, validate_args=False, device=card),
    })
    fair_batches = [
        (torch.randn(65536, generator=gen, device=card), torch.randint(0, 2, (65536,), generator=gen, device=card),
         torch.randint(0, 8, (65536,), generator=gen, device=card))
        for _ in range(4)
    ]
    cases = [
        (lambda: _scores_collections(card)["multiclass"], [tuple(x.to(card) for x in b) for b in _probability_batches(card, "multiclass", 4)]),
        (lambda: _scores_collections(card)["multilabel"], [tuple(x.to(card) for x in b) for b in _probability_batches(card, "multilabel", 4)]),
        (fair, fair_batches),
    ]
    for make, batches in cases:
        ref, fus = make(), make()
        for b in batches:
            ref.update(*b)
        fus.update(*batches[0])
        fus.update(*batches[1])
        plan = fus.fused()
        for b in batches[2:]:
            plan.update(*b)
        assert len(plan._captured) == 1
        plan.fold_back()
        for key in ref.keys(keep_base=True):
            for name, want in ref[key].state_tree().items():
                got = getattr(fus[key], name)
                assert torch.equal(got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8)), f"{key}.{name}"


# ---------------------------------------------- regression and aggregation


@pytest.fixture
def gpu():
    """A card, for paths that build no hand kernel (no nvcc needed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the path under test runs on the card")
    return torch.device("cuda")


def _regression_collection(card):
    kw = {"device": card}
    return T.MetricCollection({
        "mse": T.MeanSquaredError(**kw), "mae": T.MeanAbsoluteError(**kw), "msle": T.MeanSquaredLogError(**kw),
        "mape": T.MeanAbsolutePercentageError(**kw), "smape": T.SymmetricMeanAbsolutePercentageError(**kw),
        "wmape": T.WeightedMeanAbsolutePercentageError(**kw), "mink": T.MinkowskiDistance(p=3, **kw),
        "logcosh": T.LogCoshError(**kw), "tweedie": T.TweedieDevianceScore(power=1.5, **kw),
        "rse": T.RelativeSquaredError(**kw), "r2": T.R2Score(**kw), "ev": T.ExplainedVariance(**kw),
        "pearson": T.PearsonCorrCoef(**kw), "ccc": T.ConcordanceCorrCoef(**kw), "csi": T.CriticalSuccessIndex(0.5, **kw),
    })


def _aggregator_collection(card):
    kw = {"device": card}
    return T.MetricCollection({
        "sum": T.SumMetric(nan_strategy="ignore", **kw), "max": T.MaxMetric(nan_strategy="ignore", **kw),
        "min": T.MinMetric(nan_strategy=0.0, **kw), "mean": T.MeanMetric(nan_strategy=0.5, **kw),
    }, compute_groups=False)


def test_regression_fused_graph_equals_eager(gpu):
    """The regression and aggregation updates capture as one CUDA graph each
    (the tweedie domain check and the NaN probe skip under capture); the
    replays' states equal the eager fold's bitwise."""
    gen = torch.Generator(device=gpu).manual_seed(71)
    regression, aggregation = [], []
    for _ in range(4):
        preds = torch.rand(65536, generator=gen, device=gpu) * 3 + 0.05
        target = preds + torch.rand(65536, generator=gen, device=gpu) * 0.5
        regression.append((preds, target))
        values = (preds - target) ** 2
        values[::101] = float("nan")
        aggregation.append((values,))
    for make, batches in ((_regression_collection, regression), (_aggregator_collection, aggregation)):
        ref, fus = make(gpu), make(gpu)
        for b in batches:
            ref.update(*b)
        fus.update(*batches[0])
        fus.update(*batches[1])
        fus.reset()
        plan = fus.fused()
        for b in batches:
            plan.update(*b)
        assert len(plan._captured) == 1
        plan.fold_back()
        for key in ref.keys(keep_base=True):
            for name, want in ref[key].state_tree().items():
                got = getattr(fus[key], name)
                assert got.dtype == want.dtype and torch.equal(got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8)), f"{key}.{name}"


def test_python_scalar_to_mean_metric_lands_on_the_card(gpu):
    metric = T.MeanMetric()
    metric.update(2.5)
    metric.update(np.float32(1.5), weight=3)
    assert metric.mean_value.device.type == "cuda" and metric.weight.device.type == "cuda"
    assert float(metric.compute()) == (2.5 + 4.5) / 4


def test_kendall_float32_census_on_the_card_within_2e_20_of_int64(gpu):
    """Past 65536 rows the census accumulates in float32: within 2^-20
    relative of the same blocks' exact int64 counts, and equal to the CPU's
    census bitwise (the block counts are exact on both)."""
    kendall = importlib.import_module("torchmetrics_tpu_torch.functional.regression.kendall")
    gen = torch.Generator(device=gpu).manual_seed(5)
    x = torch.randn(70000, generator=gen, device=gpu)
    y = x + torch.randn(70000, generator=gen, device=gpu)
    con, dis = kendall._pair_census(x, y)
    assert con.dtype == torch.float32 and con.device.type == "cuda"
    exact = kendall._census_counts(x, y).sum(0)
    for got, want in zip((con, dis), exact.tolist()):
        assert abs(float(got) - want) <= 2**-20 * want, (float(got), want)
    cpu = kendall._pair_census(x.cpu(), y.cpu())
    assert torch.equal(con.cpu(), cpu[0]) and torch.equal(dis.cpu(), cpu[1])


# ------------------------------------------- wrappers, arithmetic, plotting


def _wrapper_set(device):
    kw = {"device": device}
    return {
        "minmax": T.MinMaxMetric(T.MulticlassAUROC(num_classes=64, thresholds=128, **kw)),
        "classwise": T.ClasswiseWrapper(T.MulticlassF1Score(num_classes=64, average=None, **kw)),
        "bootstrap": T.BootStrapper(T.MulticlassF1Score(num_classes=64, **kw), num_bootstraps=4, seed=3, quantile=0.5),
        "composed": (T.MulticlassF1Score(num_classes=64, **kw) + T.MulticlassAccuracy(num_classes=64, **kw)) / 2,
        "complement": 1 - T.MulticlassAUROC(num_classes=64, thresholds=128, **kw),
    }


def _value_leaves(value):
    return value.items() if isinstance(value, dict) else [("value", value)]


def test_wrappers_and_arithmetic_on_the_card_equal_cpu(card):
    """Each wrapper and composition on the card (K1 and K2 under them)
    computes what the same objects compute on the CPU: the wrapped int32
    states bitwise, the values within 1e-6."""
    batches = _probability_batches(card, "multiclass", n=8192)
    on_card, on_cpu = _wrapper_set(card), _wrapper_set("cpu")
    before = {name: fn.launches for name, fn in (("k1", binned_curve_state), ("k2", stat_counts))}
    for b in batches:
        for key in on_card:
            on_card[key].update(*(x.to(card) for x in b))
            on_cpu[key].update(*b)
    assert binned_curve_state.launches - before["k1"] == 2 * len(batches)  # MinMax's AUROC and the complement's
    assert stat_counts.launches - before["k2"] == (1 + 4 + 2) * len(batches)
    for key in on_card:
        got, want = on_card[key].compute(), on_cpu[key].compute()
        for (k, g), (_, w) in zip(_value_leaves(got), _value_leaves(want)):
            assert g.device.type == "cuda", (key, k)
            assert torch.allclose(g.cpu(), w, rtol=1e-6, atol=1e-6), (key, k, g, w)
    for tm, cm in zip(on_card["bootstrap"].metrics, on_cpu["bootstrap"].metrics):
        for name in cm._defaults:
            assert torch.equal(getattr(tm, name).cpu(), getattr(cm, name)), name
    assert on_card["complement"].metric_a.device.type == "cuda"


def test_multioutput_multitask_tracker_on_the_card_equal_cpu(gpu):
    rng = np.random.default_rng(12)
    preds = rng.standard_normal((4096, 8)).astype(np.float32)
    target = (preds + rng.standard_normal((4096, 8))).astype(np.float32)
    preds[rng.integers(0, 4096, 50), rng.integers(0, 8, 50)] = np.nan
    results = {}
    for device in (gpu, torch.device("cpu")):
        p, t = torch.from_numpy(preds).to(device), torch.from_numpy(target).to(device)
        multi = T.MultioutputWrapper(T.R2Score(device=device), num_outputs=8)
        multi.update(p, t)
        task = T.MultitaskWrapper({"a": T.MeanSquaredError(device=device), "b": T.MeanAbsoluteError(device=device)})
        tracker = T.MetricTracker(T.MeanSquaredError(device=device), maximize=False)
        for step in range(3):
            tracker.increment()
            tracker.update(torch.nan_to_num(p[:, step]), t[:, step])
        task.update({"a": torch.nan_to_num(p[:, 0]), "b": torch.nan_to_num(p[:, 1])}, {"a": t[:, 0], "b": t[:, 1]})
        results[device.type] = (multi.compute().cpu(), {k: v.cpu() for k, v in task.compute().items()}, tracker.best_metric(True))
    got, want = results["cuda"], results["cpu"]
    assert torch.allclose(got[0], want[0], rtol=1e-5), (got[0], want[0])
    assert all(torch.allclose(got[1][k], want[1][k], rtol=1e-6) for k in want[1])
    assert got[2][1] == want[2][1] and abs(got[2][0] - want[2][0]) <= 1e-6 * abs(want[2][0])


def test_plot_of_a_card_metric_equals_cpu(gpu):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    drawn = {}
    for device in (gpu, torch.device("cpu")):
        metric = T.MulticlassROC(num_classes=4, thresholds=11, device=device)
        g = torch.Generator().manual_seed(1)
        metric.update(torch.rand(512, 4, generator=g).to(device), torch.randint(0, 4, (512,), generator=g).to(device))
        _, ax = metric.plot()
        cm = T.MulticlassConfusionMatrix(num_classes=4, device=device)
        cm.update(torch.randint(0, 4, (512,), generator=g).to(device), torch.randint(0, 4, (512,), generator=g).to(device))
        _, cax = cm.plot()
        drawn[device.type] = ([line.get_xydata() for line in ax.lines], np.asarray(cax.images[0].get_array()),
                              [t.get_text() for t in cax.texts])
    plt.close("all")
    assert all(np.array_equal(a, b) for a, b in zip(drawn["cuda"][0], drawn["cpu"][0]))
    assert np.array_equal(drawn["cuda"][1], drawn["cpu"][1]) and drawn["cuda"][2] == drawn["cpu"][2]


# ------------------------------------------------- two ranks on one card


def _dist_worker(argv) -> None:
    """One of two gloo ranks on ``cuda:0``: the gathers and the sharded plan."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from torchmetrics_tpu_torch.parallel import sharded_update
    from torchmetrics_tpu_torch.utilities.distributed import gather_all_objects, gather_all_tensors

    rank, world, addr = int(argv[1]), int(argv[2]), argv[3]
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=addr, world_size=world, rank=rank)
    try:
        card = torch.device("cuda", 0)
        # uneven shapes, ndim > 8, and an empty rank's (0,) float32 beside int32 rows
        local = torch.arange(3 + 4 * rank, dtype=torch.float32, device=card).reshape(1, -1) + 10 * rank
        got = gather_all_tensors(local)
        assert [tuple(g.shape) for g in got] == [(1, 3), (1, 7)] and all(g.device == card for g in got), got
        assert torch.equal(got[1], torch.arange(7, dtype=torch.float32, device=card).reshape(1, -1) + 10)
        deep = gather_all_tensors(torch.full((1,) * 9 + (2 + rank,), float(rank), device=card))
        assert [tuple(g.shape) for g in deep] == [(1,) * 9 + (2,), (1,) * 9 + (3,)]
        rows = torch.arange(6, dtype=torch.int32, device=card) if rank == 0 else torch.zeros(0, device=card)
        got = gather_all_tensors(rows)
        assert got[0].dtype == got[1].dtype == torch.int32 and tuple(got[1].shape) == (0,), got
        assert gather_all_objects(("x" * (3 + rank), rank))[1] == ("xxxx", 1)

        # the sharded fused plan (graphs around the collectives) == eager sharded_update
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
        batches = _fused_batches(card, n_batches=4)
        local_batches = [tuple(x[rank * 2048 : (rank + 1) * 2048] for x in b) for b in batches]
        for exact in (False, True):
            ref, fus = _fused_suite(card, exact=exact), _fused_suite(card, exact=exact)
            for b in local_batches:
                for m in ref.values(copy_state=False):
                    sharded_update(m, mesh, *b)
            opts = {"cat_capacity": 4 * 4096, "example_batch": local_batches[0]} if exact else {}
            plan = fus.fused(mesh=mesh, **opts)
            for b in local_batches:
                plan.update(*b)
            assert len(plan._sharded) == 1 and next(iter(plan._sharded.values())).fold_graph is not None
            plan.fold_back()
            _assert_collections_bitwise(ref, fus)
        dist.barrier()
        print(f"rank {rank}: card sync checks passed", flush=True)
    finally:
        dist.destroy_process_group()


def test_two_ranks_share_the_card_through_gloo(card, tmp_path):
    """Two gloo ranks on one card: CUDA tensors gather with uneven shapes, and
    the sharded fused plan's graphs equal the eager sharded update bitwise."""
    from tests.test_torch_sync import run_workers

    for rank, (rc, out) in enumerate(run_workers(Path(__file__), "cuda", tmp_path, timeout=300)):
        assert rc == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank}: card sync checks passed" in out, out


@pytest.mark.parametrize("n", [1, 33, 5000])
@pytest.mark.parametrize("k", [1, 8, 32, 33, 1024])
def test_cm_track_matches_plain(card, k, n):
    """K3 against the scan as a loop, bitwise, on Zipf-like tags (hot keys
    that get tracked, a long tail that competes for the minimum slot), from a
    table that already holds some keys; the launch counter moves."""
    from torchmetrics_tpu_torch.ops import cm_track, cm_track_plain

    rng = np.random.default_rng(k * 7 + n)
    tags = torch.from_numpy((rng.zipf(1.3, n) % 5000).astype(np.int32) - 2500)
    ests = torch.from_numpy(rng.integers(0, 60, n).astype(np.int32))
    keys = torch.from_numpy(rng.integers(0, 2**32, k, dtype=np.int64)).to(torch.uint32)
    counts = torch.from_numpy(rng.integers(0, 3, k).astype(np.int32))
    want = cm_track_plain(tags, ests, keys, counts)
    before = cm_track.launches
    got = cm_track(tags.to(card), ests.to(card), keys.to(card), counts.to(card))
    torch.cuda.synchronize()
    assert cm_track.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu().to(torch.int64), w.to(torch.int64))


def test_sketch_plane_on_the_card_equals_cpu(card):
    """Every sketch updated and merged on the card equals the same on the
    CPU: integer leaves, the histogram, HLL, Count-Min (K3 inside) and the
    reservoir bitwise; KLL items as floats (a radix sort may order -0 and +0
    apart); quantiles bitwise; the moments within rtol 1e-5 (sums in another order)."""
    from torchmetrics_tpu_torch import sketch as sk

    rng = np.random.default_rng(5)
    x = rng.standard_normal(20000).astype(np.float32)
    x[::97] = 0.0
    x[1::97] = -0.0
    tags = (rng.zipf(1.3, 20000) % 100000).astype(np.int32)
    cases = [
        (lambda d: sk.kll_init(256, 14, device=d), sk.kll_update, sk.kll_merge, x),
        (lambda d: sk.hist_init(64, -3.0, 3.0, device=d), sk.hist_update, sk.hist_merge, x),
        (lambda d: sk.hll_init(12, device=d), sk.hll_update, sk.hll_merge, tags),
        (lambda d: sk.cm_init(4, 1024, 32, device=d), sk.cm_update, sk.cm_merge, tags),
        (lambda d: sk.reservoir_init(512, seed=3, rank=1, device=d), sk.reservoir_update, sk.reservoir_merge, x),
        (lambda d: sk.moments_init((), device=d), sk.moments_update, sk.moments_merge, x),
    ]
    for init, update, merge, data in cases:
        halves = np.split(data, 2)
        out = {}
        for dev in ("cpu", card):
            a = update(init(dev), torch.from_numpy(halves[0]).to(dev))
            b = update(init(dev), torch.from_numpy(halves[1]).to(dev))
            out[str(dev)] = merge(a, b)
        cpu, gpu = out["cpu"], out[str(card)]
        for field, c, g in zip(cpu._fields, cpu, gpu):
            g = g.cpu()
            assert g.dtype == c.dtype and g.shape == c.shape, (type(cpu).__name__, field)
            if type(cpu).__name__ == "MomentsSketch" and c.dtype.is_floating_point:
                assert torch.allclose(g, c, rtol=1e-5, atol=1e-6), field
            elif c.dtype.is_floating_point:
                assert torch.equal(g, c), (type(cpu).__name__, field)  # float equality: -0 == +0
            else:
                assert torch.equal(g.to(torch.int64), c.to(torch.int64)), (type(cpu).__name__, field)
        if type(cpu).__name__ == "KLLSketch":
            qs = torch.tensor([0.01, 0.5, 0.99])
            assert torch.equal(sk.kll_quantile(gpu, qs.to(card)).cpu(), sk.kll_quantile(cpu, qs))


def test_jit_update_step_captures_and_equals_eager(card):
    """make_jit_update on the card: the first call runs eagerly, the second
    captures a CUDA graph and later calls replay it; the folded state equals
    eager updates bitwise, and a donated carry is updated in place."""
    from torchmetrics_tpu_torch.parallel import fold_jit_state, make_jit_update

    rng = np.random.default_rng(6)
    batches = [torch.from_numpy(rng.standard_normal(4096).astype(np.float32)).to(card) for _ in range(6)]
    eager = T.Quantile(q=[0.5, 0.99], device=card)
    for b in batches:
        eager.update(b)
    for donate in (False, True):
        metric = T.Quantile(q=[0.5, 0.99], device=card)
        step, state = make_jit_update(metric, donate=donate)
        for b in batches:
            state = step(state, b)
        assert len(step._captured) == 1
        fold_jit_state(metric, state)
        for got, want in zip(metric.sketch, eager.sketch):
            assert torch.equal(got, want)
        assert metric._update_count == 6 and torch.equal(metric.compute(), eager.compute())


# last in the file: it makes one capture fail on purpose
def test_count_captures_where_torch_bincount_cannot(card):
    """``torch.bincount`` reads its input's max on the host, which a CUDA graph
    cannot capture; ``_bincount`` (fixed bins, no host read) captures, and its
    replay counts what ``torch.bincount`` counts eagerly."""
    from torchmetrics_tpu_torch.utilities.data import _bincount

    idx = torch.randint(0, 4096, (65536,), device=card, dtype=torch.int32)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _bincount(idx, 4096)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = _bincount(idx, 4096)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, torch.bincount(idx, minlength=4096).to(torch.int32))
    with pytest.raises(RuntimeError):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side):
            torch.bincount(idx, minlength=4096)
    torch.cuda.synchronize()


# ------------------------------------------------------- the sliced plane


# 24 cells: claims in shared memory; 13000: in global scratch; more cohorts
# than cells spill
@pytest.mark.parametrize(("num_cells", "key_width", "cohorts"), [(24, 1, 7), (24, 2, 60), (13000, 1, 9000), (5, 3, 4)])
def test_slice_assign_matches_plain(card, num_cells, key_width, cohorts):
    """K4 against its plain version (JAX's while_loop as a host loop):
    table and cells bitwise, batch after batch, spills included."""
    from torchmetrics_tpu_torch.ops import slice_assign, slice_assign_plain

    rng = np.random.default_rng(43)
    tables = [
        (torch.zeros((num_cells, key_width), dtype=torch.int32, device=dev), torch.zeros(num_cells, dtype=torch.bool, device=dev),
         torch.zeros((), dtype=torch.int32, device=dev))
        for dev in (card, torch.device("cpu"))
    ]
    for batch in (4096, 1, 20000):
        kmat = torch.from_numpy(rng.integers(-cohorts, cohorts, (batch, key_width)).astype(np.int32))
        before = slice_assign.launches
        got = slice_assign(*tables[0], kmat.to(card))
        want = slice_assign_plain(*tables[1], kmat)
        torch.cuda.synchronize()
        assert slice_assign.launches == before + 1
        assert torch.equal(got.cpu(), want)
        for a, b in zip(tables[0], tables[1]):
            assert torch.equal(a.cpu(), b)
    before = slice_assign.launches
    assert slice_assign(*tables[0], torch.zeros((0, key_width), dtype=torch.int32, device=card)).shape == (0,)
    assert slice_assign.launches == before


@pytest.mark.parametrize("ignore_index", [None, 3, -7])
@pytest.mark.parametrize(("mode", "num_classes"), [("float4", 64), ("scalar", 7), ("int32", 64), ("int64", 5)])
def test_stat_counts_segmented_matches_plain(card, mode, num_classes, ignore_index):
    """K2s against its plain version, cells of -1 dropped, out-of-range and
    ignored labels, bitwise."""
    from torchmetrics_tpu_torch.ops import stat_counts_segmented, stat_counts_segmented_plain

    rng = np.random.default_rng(44)
    n, num_cells = 30001, 257
    if mode in ("float4", "scalar"):
        preds = torch.from_numpy(rng.standard_normal((n, num_classes)).astype(np.float32))
    else:
        preds = torch.from_numpy(rng.integers(-2, num_classes + 2, n).astype(np.int32 if mode == "int32" else np.int64))
    target = torch.from_numpy(rng.integers(-3, num_classes + 3, n).astype(np.int64))
    target[::11] = 3
    cells = torch.from_numpy(rng.integers(-1, num_cells, n).astype(np.int32))
    before = stat_counts_segmented.launches
    got = stat_counts_segmented(preds.to(card), target.to(card), cells.to(card), num_cells, num_classes, ignore_index)
    want = stat_counts_segmented_plain(preds, target, cells, num_cells, num_classes, ignore_index)
    torch.cuda.synchronize()
    assert stat_counts_segmented.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("len_t", [5, 128, 13000])
@pytest.mark.parametrize("labels", [True, False], ids=["labels", "matrix"])
def test_binned_curve_state_segmented_matches_plain(card, labels, len_t):
    """K1s against its plain version: NaN/inf probabilities, masked targets,
    cells of -1 dropped; thresholds in shared and in global memory; bitwise."""
    from torchmetrics_tpu_torch.ops import binned_curve_state_segmented, binned_curve_state_segmented_plain

    rng = np.random.default_rng(45)
    n, k, num_cells = 3001, 7, 33
    p = rng.random((n, k)).astype(np.float32)
    p.reshape(-1)[:5] = [np.nan, np.inf, -np.inf, -0.5, 1.5]
    thr = _linspace_like_jax(0.0, 1.0, len_t, device=card)
    target = rng.integers(-1, k + 1, n if labels else (n, k)).astype(np.int32)
    cells = rng.integers(-1, num_cells, n).astype(np.int32)
    args = [torch.from_numpy(a) for a in (p, target, cells)]
    before = binned_curve_state_segmented.launches
    got = binned_curve_state_segmented(args[0].to(card), thr, args[1].to(card), labels, args[2].to(card), num_cells)
    want = binned_curve_state_segmented_plain(args[0], thr.cpu(), args[1], labels, args[2], num_cells)
    torch.cuda.synchronize()
    assert binned_curve_state_segmented.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kernel", ["k2s", "k1s"])
def test_guard_mask_one_cell_matches_plain(card, kernel):
    """The StateGuard's mask shape: ``num_cells=1``, invalid rows as cell -1
    (``where(invalid_row, -1, 0)``), at the flagship width; K2s and K1s
    bitwise against their plain versions."""
    from torchmetrics_tpu_torch.ops import (
        binned_curve_state_segmented,
        binned_curve_state_segmented_plain,
        stat_counts_segmented,
        stat_counts_segmented_plain,
    )

    rng = np.random.default_rng(47)
    n, c = 65536, 64
    preds = rng.standard_normal((n, c)).astype(np.float32)
    target = rng.integers(0, c, n).astype(np.int64)
    invalid = rng.random(n) < 0.015
    cells = torch.from_numpy(np.where(invalid, -1, 0).astype(np.int32))
    if kernel == "k2s":
        args = (torch.from_numpy(preds), torch.from_numpy(target))
        before = stat_counts_segmented.launches
        got = stat_counts_segmented(args[0].to(card), args[1].to(card), cells.to(card), 1, c, None)
        want = stat_counts_segmented_plain(*args, cells, 1, c, None)
        launches = stat_counts_segmented.launches - before
    else:
        probs = torch.softmax(torch.from_numpy(preds), dim=1)
        thr = _linspace_like_jax(0.0, 1.0, 128, device=card)
        tgt = torch.from_numpy(target.astype(np.int32))
        before = binned_curve_state_segmented.launches
        got = binned_curve_state_segmented(probs.to(card), thr, tgt.to(card), True, cells.to(card), 1)
        want = binned_curve_state_segmented_plain(probs, thr.cpu(), tgt, True, cells, 1)
        launches = binned_curve_state_segmented.launches - before
    torch.cuda.synchronize()
    assert launches == 1
    assert torch.equal(got.cpu(), want)


def test_guarded_suite_captures_and_equals_cpu(card):
    """The guarded flagship suite (mask) on the card: the guard's K2s/K1s
    route and the vmap route captured in a fused plan, equal to the same
    guarded suite on the CPU; the counters bitwise."""
    from torchmetrics_tpu_torch.robustness import enable_guard, guard_counters

    rng = np.random.default_rng(48)
    c, b = 8, 4096

    def suite(device):
        kw = dict(device=device)
        members = {
            "acc": enable_guard(T.MulticlassAccuracy(num_classes=c, average="micro", **kw), "mask"),
            "f1": enable_guard(T.MulticlassF1Score(num_classes=c, average="macro", **kw), "mask"),
            "auroc": enable_guard(
                T.MulticlassAUROC(num_classes=c, thresholds=32, **kw), "mask",
                contract=T.MulticlassStatScores(num_classes=c, **kw).domain_contract(),
            ),
        }
        return T.MetricCollection(members, compute_groups=False)

    batches = []
    for i in range(3):
        preds = rng.standard_normal((b, c)).astype(np.float32)
        target = rng.integers(0, c, b).astype(np.int64)
        preds[rng.random(b) < 0.01, 0] = np.nan
        target[rng.random(b) < 0.005] = c
        batches.append((torch.from_numpy(preds), torch.from_numpy(target)))
    cpu, gpu = suite("cpu"), suite(card)
    plan = gpu.fused()
    for p, t in batches:
        cpu.update(p, t)
        plan.update(p.to(card), t.to(card))
    plan.fold_back()
    for key in ("acc", "f1", "auroc"):
        for name in cpu[key]._defaults:
            assert torch.equal(getattr(gpu[key], name).cpu(), getattr(cpu[key], name)), (key, name)
        assert guard_counters(gpu[key]) == guard_counters(cpu[key])
    assert guard_counters(cpu["f1"])["masked_rows"] > 0


def test_sliced_plan_on_the_card_equals_cpu(card):
    """A sliced suite on the card (K4, K2s and K1s in its captured step; a
    histogram sketch; exact AUROC's cat rows) equals the same plan on the
    CPU bitwise, through update and run_scan; a window ring over the card
    suite answers what the CPU ring answers."""
    from torchmetrics_tpu_torch import drift
    from torchmetrics_tpu_torch.ops import binned_curve_state_segmented, slice_assign, stat_counts_segmented
    from torchmetrics_tpu_torch.parallel import SlicedPlan, WindowRing

    rng = np.random.default_rng(46)
    c, b = 8, 2048

    def suite(device):
        kw = dict(validate_args=False, device=device)
        return T.MetricCollection(
            {
                "acc": T.MulticlassAccuracy(num_classes=c, average="micro", **kw),
                "f1": T.MulticlassF1Score(num_classes=c, average="macro", **kw),
                "auroc": T.MulticlassAUROC(num_classes=c, thresholds=32, **kw),
                "exact": T.MulticlassAUROC(num_classes=c, thresholds=None, **kw),
                "drift": drift.DriftScore(reference=torch.rand(4096, generator=torch.Generator().manual_seed(0)), bins=16, device=device),
            },
            compute_groups=False,
        )

    def probs():  # probabilities: the update's softmax is the identity on the card and on the CPU
        x = rng.standard_normal((b, c))
        e = np.exp(x - x.max(-1, keepdims=True))
        return torch.from_numpy((e / e.sum(-1, keepdims=True)).astype(np.float32))

    batches = [(torch.from_numpy(rng.integers(0, 40, b).astype(np.int32)), probs(), torch.from_numpy(rng.integers(0, c, b).astype(np.int32)))
               for _ in range(4)]
    drift_batches = [torch.from_numpy(rng.random(b).astype(np.float32)) for _ in range(4)]
    plans = {}
    counts = {}
    for device in (card, torch.device("cpu")):
        members = suite(device)
        drift_metric = dict.__getitem__(members, "drift")
        del members["drift"]
        plan = SlicedPlan(members, num_cells=64, cat_capacity=4 * b, example_batch=tuple(x.to(device) for x in batches[0][1:]))
        drift_plan = drift_metric.sliced(num_cells=64)
        for w in (slice_assign, stat_counts_segmented, binned_curve_state_segmented):
            w.launches = 0
        for (keys, preds, target), values in zip(batches[:2], drift_batches[:2]):
            plan.update(keys.to(device), preds.to(device), target.to(device))
            drift_plan.update(keys.to(device), values.to(device))
        plan.run_scan([x[0].to(device) for x in batches[2:]], [tuple(t.to(device) for t in x[1:]) for x in batches[2:]])
        drift_plan.run_scan([x[0].to(device) for x in batches[2:]], [(v.to(device),) for v in drift_batches[2:]])
        counts[device.type] = {w.__name__: w.launches for w in (slice_assign, stat_counts_segmented, binned_curve_state_segmented)}
        plans[device.type] = (plan, drift_plan)
    assert all(v > 0 for v in counts["cuda"].values()), counts
    for got, want in zip(plans["cuda"], plans["cpu"]):
        a, b_ = got.save_checkpoint(), want.save_checkpoint()
        flat = lambda t, pre="": {k2: v2 for k, v in t.items() for k2, v2 in (flat(v, f"{pre}{k}.").items() if isinstance(v, dict) else [(f"{pre}{k}", v)])}  # noqa: E731
        fa, fb = flat(a), flat(b_)
        assert set(fa) == set(fb)
        for key in fb:
            assert np.array_equal(np.asarray(fa[key]), np.asarray(fb[key])), key
    ring_card_metric = T.MulticlassAccuracy(num_classes=c, device=card)
    ring_cpu_metric = T.MulticlassAccuracy(num_classes=c, device="cpu")
    rings = [WindowRing(ring_card_metric, slots=2, every_n=2), WindowRing(ring_cpu_metric, slots=2, every_n=2)]
    for i, (_, preds, target) in enumerate(batches):
        ring_card_metric.update(preds.to(card), target.to(card))
        ring_cpu_metric.update(preds, target)
        for r in rings:
            r.observe(i + 1)
    assert torch.equal(rings[0].query(last=2).cpu(), rings[1].query(last=2))


if __name__ == "__main__":
    _dist_worker(sys.argv)
