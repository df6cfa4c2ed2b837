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
where a capture fails; a fused or sliced plan rebuilt over the same target
replays the cached graphs with no new CUDA graph, and a live plan whose entry
moved keeps its own results; DeviceFeed stages pinned numpy batches on the card.
The confusion-matrix families count on the card what the CPU counts, out-of-range
labels included, and capture in a fused plan. The regression and aggregation
collection captures and equals its eager fold bitwise; Kendall's float32
census on the card stays within 2^-20 of its exact int64 recount.
Wrappers (MinMax, Classwise, BootStrapper, Multioutput, Multitask, the
tracker) and metric arithmetic on the card compute what they compute on the
CPU, with K1 and K2 launching under them; a card metric plots what a CPU
one plots (matplotlib, where installed).
The sketch plane on the card equals it on the CPU; K3 (the Count-Min
table's scan) equals its loop bitwise, filtered or not, with its counters
equal to the host's trace of its filters, and the one-metric step of
``make_jit_update`` captures and equals eager updates. K4 (the slice
table), K2s and K1s (the segmented stat counts and binned curve state) equal
their plain versions bitwise (also at the StateGuard's one-cell shape), and
a sliced plan captured on the card equals the same plan on the CPU; so does
the guarded flagship suite captured in a fused plan. K5 (SRMR's biquad
cascade) equals its plain loop bitwise for both banks, at lengths around
a turn of its rings, row counts around its 32-row block, one row alone,
silence, an impulse decaying through the denormals and a NaN; SRMR launches it
twice a call, gives the same bits with cuDNN's TF32 on and off and is
refused by a fused plan's capture, naming the member; the clustering and
audio classes on the card compute what they compute on the CPU. K6 (COCO's
greedy matcher) equals its plain loop bitwise through each of its five
instantiations (the matched set in 1-4 register words, or masks and sets in
a scratch), on ties, crowds, NaN IoUs, candidate IoUs of -1, -2 and +-0,
rows without a -1.0 column outside the candidates, and edge thresholds; the mAP on the card has
the CPU's tables bitwise and its summaries within 1e-6, launching K6 once
a compute; the IoU classes and panoptic quality on the card equal the CPU.
K7 (the image domain's windowed moments) equals its plain route bitwise for
Gaussian, uniform and VIF factors, odd, even and unequal sides, a window as
large as the image, row pitches off a multiple of 4 floats, outputs ending
mid-tile, tiles shrunk by a wide window and more planes than a grid's z
extent; its refusal of a staged tile too large holds on the card, its
autograd route matches autograd through the plain loop, and the image
convolutions stay float32 with cuDNN's global TF32 flag on. K8 (Perplexity's
token log-likelihood) equals its plain route within a stated per-row budget
in float32, bfloat16 and float16, at V = 1 to 50,257 and row pitches off a
multiple of 4, on ignored, wrapped and out-of-range targets and rows of
+-inf and NaN; its gradient matches autograd through the plain route, it
captures in a CUDA graph, and Perplexity launches it once an update.
CLIPScore's and CLIP-IQA's towers on the card (a seeded small CLIP) give the
CPU's values with TF32 turned on globally, and leave the flags as they were.
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
from torchmetrics_tpu_torch.ops.biquad import RING as BIQUAD_RING, TILE as BIQUAD_TILE
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


def _cache_plans(card, kind, suite):
    """``(build, drive)`` of a fused or a sliced plan over ``suite``."""
    keys = (torch.arange(4096, device=card, dtype=torch.int32) * 7) % 19
    if kind == "fused":
        return (lambda: suite.fused()), (lambda plan, b: plan.update(*b))
    return (lambda: suite.sliced(num_cells=32)), (lambda plan, b: plan.update(keys, *b))


def _carry_leaves(plan):
    from torch.utils._pytree import tree_flatten

    return tree_flatten(plan.state)[0]


@pytest.mark.parametrize("kind", ["fused", "sliced"])
def test_plan_cache_hit_replays_without_a_new_graph(card, kind, monkeypatch):
    """A plan rebuilt over the same target adopts the cached entry: its updates
    replay the first plan's graph (no new ``torch.cuda.CUDAGraph``), and its
    carry equals a freshly captured plan's bitwise."""
    from torchmetrics_tpu_torch.parallel.sharded import _SHARDED_FN_CACHE

    batches = _fused_batches(card)
    made = []
    real = torch.cuda.CUDAGraph

    def counting(*args, **kwargs):
        made.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", counting)
    ref_build, ref_drive = _cache_plans(card, kind, _fused_suite(card))
    ref = ref_build()
    for b in batches[2:]:
        ref_drive(ref, b)
    suite = _fused_suite(card)
    build, drive = _cache_plans(card, kind, suite)
    first = build()
    for b in batches[:2]:
        drive(first, b)
    entry = first._entry
    del first
    captured = len(made)
    assert captured >= 2
    second = build()
    assert second._entry is entry
    for b in batches[2:]:
        drive(second, b)
    torch.cuda.synchronize()
    assert len(made) == captured, "a cache hit captured a new graph"
    assert all(torch.equal(x, y) for x, y in zip(_carry_leaves(second), _carry_leaves(ref)))
    _SHARDED_FN_CACHE.clear()


@pytest.mark.parametrize("kind", ["fused", "sliced"])
def test_plan_cache_handover_after_replays(card, kind):
    """A live plan whose entry a new plan adopted keeps its carry (a copy in
    fresh buffers) and captures anew; old and new plans driven in turns after
    replays equal two plans built with the cache cleared, bitwise."""
    from torchmetrics_tpu_torch.parallel.sharded import _SHARDED_FN_CACHE

    batches = _fused_batches(card, n_batches=6)

    def run(clear):
        _SHARDED_FN_CACHE.clear()
        build, drive = _cache_plans(card, kind, _fused_suite(card))
        plan_a = build()
        for b in batches[:3]:
            drive(plan_a, b)  # a capture, then replays
        if clear:
            _SHARDED_FN_CACHE.clear()
        entry = plan_a._entry
        plan_b = build()
        if clear:
            assert plan_b._entry is not entry
        else:
            assert plan_b._entry is entry and plan_a._captured == {}
        for b_a, b_b in zip(batches[3:], batches[:3]):
            drive(plan_a, b_a)
            drive(plan_b, b_b)
        torch.cuda.synchronize()
        return _carry_leaves(plan_a), _carry_leaves(plan_b)

    got, want = run(False), run(True)
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(torch.equal(x, y) for x, y in zip(g, w))
    _SHARDED_FN_CACHE.clear()


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


def _cm_track_case(case, n, k, rng):
    """Tags, estimates and a starting table for K3. ``random``: Zipf-like
    tags with an estimate drawn per occurrence (a tag with two estimates:
    the kernel keeps every tag); ``zipf_empty``/``zipf_filled``: the sketch
    stream's shape, one estimate per tag (the filters keep first occurrences
    above the minimum); ``adversarial``: every tag distinct, estimates
    strictly increasing, so every tag is admitted; ``live_duplicate`` and
    ``negative_count``: tables that break the filter's preconditions."""
    if case == "random":
        tags = (rng.zipf(1.3, n) % 5000).astype(np.int32) - 2500
        ests = rng.integers(0, 60, n).astype(np.int32)
    elif case == "adversarial":
        tags = rng.permutation(n).astype(np.int32) * 7919 - 2**30
        ests = np.arange(1, n + 1, dtype=np.int32)
    else:
        tags = (np.floor(np.exp(rng.random(n) * np.log(1e6))) - 1).astype(np.int32)
        ests = (np.bincount(tags, minlength=1_000_000)[tags] + rng.integers(0, 3, 1_000_000)[tags]).astype(np.int32)
    keys = rng.integers(0, 2**32, k, dtype=np.int64)
    counts = rng.integers(0, 3, k).astype(np.int32)
    if case == "zipf_empty":
        keys[:], counts[:] = 0, 0
    elif case in ("zipf_filled", "live_duplicate", "negative_count"):
        keys[: min(k, 8)] = np.argsort(-np.bincount(tags))[: min(k, 8)]  # the hottest keys already tracked
        counts = rng.integers(1, 40, k).astype(np.int32)
        if case == "live_duplicate" and k > 1:
            keys[k - 1] = keys[0]
        if case == "negative_count":
            counts[k // 2] = -1
    return [torch.from_numpy(tags), torch.from_numpy(ests), torch.from_numpy(keys).to(torch.uint32), torch.from_numpy(counts)]


@pytest.mark.parametrize(
    "n, case",
    [(1, "random"), (33, "random"), (5000, "random")]
    + [(65536, c) for c in ("zipf_empty", "zipf_filled", "adversarial", "live_duplicate", "negative_count")],
)
@pytest.mark.parametrize("k", [1, 8, 32, 33, 1024])
def test_cm_track_matches_plain(card, k, n, case):
    """K3 against the scan as a loop, bitwise: Zipf-like tags (hot keys that
    get tracked, a long tail that competes for the minimum slot), from an
    empty table and from one that already holds keys; every tag admitted;
    tables and estimates that break the filter's preconditions. The kernel's
    counters (the mode, the tile filters' survivors, the steps run) equal
    the host's trace of the same filters; one launch a call."""
    from torchmetrics_tpu_torch.ops import cm_track
    from torchmetrics_tpu_torch.ops.cm_track import cm_track_stats

    rng = np.random.default_rng(k * 7 + n)
    n = min(n, 16384) if k == 1024 else n  # the host loop is O(n k)
    args = _cm_track_case(case, n, k, rng)
    if case == "live_duplicate" and k == 1:
        args[3][0] = -1  # one slot holds no duplicate: break the other precondition
    *want, want_stats = cm_track_stats(*args)  # on the host: cm_track_plain, and the filters' trace
    before = cm_track.launches
    *got, stats = cm_track_stats(*(a.to(card) for a in args))
    torch.cuda.synchronize()
    assert cm_track.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu().to(torch.int64), w.to(torch.int64))
    assert stats.cpu().tolist() == want_stats.tolist()
    if case in ("live_duplicate", "negative_count") or (case == "random" and n > 1):
        assert stats[0].item() == 0 and stats[2].item() == n  # the unfiltered mode steps every tag
    if case in ("zipf_empty", "zipf_filled"):
        assert stats[0].item() == 1 and stats[1].item() < n
    got = cm_track(*(a.to(card) for a in args))
    torch.cuda.synchronize()
    assert cm_track.launches == before + 2
    assert all(torch.equal(g.cpu().to(torch.int64), w.to(torch.int64)) for g, w in zip(got, want))


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


# 24 cells: the table staged in shared memory; 13000: in global memory, and
# more than 2048 new keys (their state in global scratch); more cohorts than
# cells spill. Then the main path's shapes (keys over 2 x cohorts values):
# the suite's first batch (65,536 keys, 200 new cohorts into 256 cells), the
# fan-out's (8,192 keys, 1,024 cohorts into 1,024 cells, a full table), a
# spill batch (8,192 keys over 2,048 cohorts into 1,024 cells), each
# followed by a steady batch.
@pytest.mark.parametrize(
    ("num_cells", "key_width", "cohorts", "batches"),
    [(24, 1, 7, (4096, 1, 20000)), (24, 2, 60, (4096, 1, 20000)), (13000, 1, 9000, (4096, 1, 20000)), (5, 3, 4, (4096, 1, 20000)),
     (256, 1, 100, (65536, 65536)), (1024, 1, 512, (8192, 8192)), (1024, 1, 1024, (8192, 8192))],
)
def test_slice_assign_matches_plain(card, num_cells, key_width, cohorts, batches):
    """K4 against its plain version (JAX's while_loop as a host loop):
    table and cells bitwise, batch after batch, spills included; one launch a
    call; the kernel's count of new keys and rounds equals the host's route."""
    from torchmetrics_tpu_torch.ops import slice_assign, slice_assign_plain
    from torchmetrics_tpu_torch.ops.slice_assign import slice_assign_reps_plain, slice_assign_stats

    rng = np.random.default_rng(43)
    tables = [
        (torch.zeros((num_cells, key_width), dtype=torch.int32, device=dev), torch.zeros(num_cells, dtype=torch.bool, device=dev),
         torch.zeros((), dtype=torch.int32, device=dev))
        for dev in (card, torch.device("cpu"), torch.device("cpu"))
    ]
    for batch in batches:
        kmat = torch.from_numpy(rng.integers(-cohorts, cohorts, (batch, key_width)).astype(np.int32))
        before = slice_assign.launches
        got = slice_assign(*tables[0], kmat.to(card))
        want = slice_assign_plain(*tables[1], kmat)
        stats = {}
        slice_assign_reps_plain(*tables[2], kmat, stats=stats)
        torch.cuda.synchronize()
        assert slice_assign.launches == before + 1
        assert torch.equal(got.cpu(), want)
        for a, b, c in zip(*tables):
            assert torch.equal(a.cpu(), b)
            assert torch.equal(c, b)
        assert slice_assign_stats(tables[0][0]) == stats
    before = slice_assign.launches
    assert slice_assign(*tables[0], torch.zeros((0, key_width), dtype=torch.int32, device=card)).shape == (0,)
    assert slice_assign.launches == before


@pytest.mark.parametrize("layout", ["random", "all_dropped", "none_dropped", "skewed", "big_cell"])
@pytest.mark.parametrize("num_cells", [1, 257, 1024])
@pytest.mark.parametrize("ignore_index", [None, 3, -7])
@pytest.mark.parametrize(("mode", "num_classes"), [("float4", 64), ("scalar", 7), ("int32", 64), ("int64", 5)])
def test_stat_counts_segmented_matches_plain(card, mode, num_classes, ignore_index, num_cells, layout):
    """K2s against its plain version, cells of -1 dropped, out-of-range and
    ignored labels, bitwise: one cell (K2 with a row mask) and many (cell
    counters in shared memory, and global atomics at 1024 cells of 64
    classes, whose counters do not fit); all, no and 90% of the rows in one
    cell, and 131,072 rows in one cell; one launch a call."""
    from torchmetrics_tpu_torch.ops import stat_counts_segmented, stat_counts_segmented_plain

    rng = np.random.default_rng(44)
    n = 140000 if layout == "big_cell" else 30001
    if mode in ("float4", "scalar"):
        preds = torch.from_numpy(rng.standard_normal((n, num_classes)).astype(np.float32))
    else:
        preds = torch.from_numpy(rng.integers(-2, num_classes + 2, n).astype(np.int32 if mode == "int32" else np.int64))
    target = torch.from_numpy(rng.integers(-3, num_classes + 3, n).astype(np.int64))
    target[::11] = 3
    cells = torch.from_numpy(_segmented_cells(layout, n, num_cells, rng))
    before = stat_counts_segmented.launches
    got = stat_counts_segmented(preds.to(card), target.to(card), cells.to(card), num_cells, num_classes, ignore_index)
    want = stat_counts_segmented_plain(preds, target, cells, num_cells, num_classes, ignore_index)
    torch.cuda.synchronize()
    assert stat_counts_segmented.launches == before + 1
    assert torch.equal(got.cpu(), want)


def _segmented_cells(layout, n, num_cells, rng):
    """(n,) int32 cells: ``random`` (a few rows dropped), ``all_dropped``,
    ``none_dropped``, ``skewed`` (one cell holds 90% of the rows), ``big_cell``
    (131,072 rows, more than a 16-bit count, in cell 0)."""
    if layout == "random":
        return rng.integers(-1, num_cells, n).astype(np.int32)
    if layout == "all_dropped":
        return np.full(n, -1, np.int32)
    if layout == "none_dropped":
        return rng.integers(0, num_cells, n).astype(np.int32)
    if layout == "skewed":
        return np.where(rng.random(n) < 0.9, num_cells // 2, rng.integers(-1, num_cells, n)).astype(np.int32)
    cells = rng.integers(-1, num_cells, n).astype(np.int32)
    cells[:131072] = 0
    return cells


@pytest.mark.parametrize("layout", ["random", "all_dropped", "none_dropped", "skewed", "big_cell"])
@pytest.mark.parametrize("num_cells", [1, 33])
@pytest.mark.parametrize("len_t", [5, 128, 13000])
@pytest.mark.parametrize("labels", [True, False], ids=["labels", "matrix"])
def test_binned_curve_state_segmented_matches_plain(card, labels, len_t, num_cells, layout):
    """K1s against its plain version: NaN/inf probabilities, masked targets,
    cells of -1 dropped; one cell (K1 with a row mask) and many (the sort
    and the cell-run count); all, no and 90% of the rows in one cell, and
    131,072 rows in one cell; thresholds in shared and in global memory,
    with and without the affine bin index; bitwise, one launch a call."""
    from torchmetrics_tpu_torch.ops import binned_curve_state_segmented, binned_curve_state_segmented_plain

    rng = np.random.default_rng(45)
    n = 140000 if layout == "big_cell" else 3001
    k = 7 if len_t == 5 else 8
    p = rng.random((n, k)).astype(np.float32)
    p.reshape(-1)[:5] = [np.nan, np.inf, -np.inf, -0.5, 1.5]
    thr = _linspace_like_jax(0.0, 1.0, len_t, device=card)
    target = rng.integers(-1, k + 1, n if labels else (n, k)).astype(np.int32)
    cells = _segmented_cells(layout, n, num_cells, rng)
    args = [torch.from_numpy(a) for a in (p, target, cells)]
    want = binned_curve_state_segmented_plain(args[0], thr.cpu(), args[1], labels, args[2], num_cells)
    for affine in (None, _uniform_grid(len_t)):
        before = binned_curve_state_segmented.launches
        got = binned_curve_state_segmented(args[0].to(card), thr, args[1].to(card), labels, args[2].to(card), num_cells, affine)
        torch.cuda.synchronize()
        assert binned_curve_state_segmented.launches == before + 1
        assert torch.equal(got.cpu(), want), affine


@pytest.mark.parametrize("rows", ["guard", "all_dropped", "none_dropped", "rows_131072"])
@pytest.mark.parametrize("kernel", ["k2s", "k1s"])
def test_guard_mask_one_cell_matches_plain(card, kernel, rows):
    """The StateGuard's mask shape: ``num_cells=1``, invalid rows as cell -1
    (``where(invalid_row, -1, 0)``), at the flagship width: 1.5% of the rows
    invalid, all of them, none, and 131,072 rows (more than a 16-bit count);
    K2s and K1s bitwise against their plain versions."""
    from torchmetrics_tpu_torch.ops import (
        binned_curve_state_segmented,
        binned_curve_state_segmented_plain,
        stat_counts_segmented,
        stat_counts_segmented_plain,
    )

    rng = np.random.default_rng(47)
    n, c = 131072 if rows == "rows_131072" else 65536, 64
    preds = rng.standard_normal((n, c)).astype(np.float32)
    target = rng.integers(0, c, n).astype(np.int64)
    invalid = {"all_dropped": np.ones(n, bool), "none_dropped": np.zeros(n, bool)}.get(rows, rng.random(n) < 0.015)
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
        got = binned_curve_state_segmented(probs.to(card), thr, tgt.to(card), True, cells.to(card), 1, _uniform_grid(128))
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
    # the closed windows' integer states, bitwise, before any float compute
    assert len(rings[0]._ring) == len(rings[1]._ring) == 2
    for got, want in zip(rings[0]._ring, rings[1]._ring):
        for name, state in want["members"]["MulticlassAccuracy"].items():
            assert torch.equal(torch.as_tensor(got["members"]["MulticlassAccuracy"][name]).cpu(), torch.as_tensor(state)), name
    # the macro average's float sum runs in one order on both devices (utilities/compute.py::_sum_last_in_xla_order)
    assert torch.equal(rings[0].query(last=2).cpu(), rings[1].query(last=2))


def _k5_bank(bank):
    """``(num, den)`` of one of SRMR's two banks at 16 kHz: the gammatone's 4 stages over 23 coefficient
    sets, or the modulation bank's one stage over 8."""
    from torchmetrics_tpu_torch.functional.audio import srmr as ts

    if bank == "gammatone":
        num, den, _ = ts._gammatone_banks(ts._make_erb_filters(16000, 23, 125))
        return num, den
    _, mf_b, mf_a, _, _ = ts._modulation_filterbank_and_cutoffs(4, 128, 8, 16000.0, 2)
    return torch.tensor(mf_b, dtype=torch.float32)[:, None], torch.tensor(mf_a, dtype=torch.float32)[:, None]


def _k5_bitwise(x, num, den):
    """K5 on ``x`` against its plain loop on the same CUDA inputs: the same bits (NaNs included) and one
    launch, none for the plain loop."""
    from torchmetrics_tpu_torch.ops import biquad_cascade, biquad_cascade_plain

    before = biquad_cascade.launches
    got = biquad_cascade(x, num, den)
    assert biquad_cascade.launches == before + 1
    want = biquad_cascade_plain(x, num, den)
    torch.cuda.synchronize()
    assert biquad_cascade.launches == before + 1
    assert got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32))
    return got


# a whole turn of the kernel's rings in samples (ops/biquad.py mirrors csrc/biquad.cu): lengths just short
# of, at and past it, where a barrier's phase or a slot index would slip
_K5_TURN = BIQUAD_RING * BIQUAD_TILE


@pytest.mark.parametrize("length", [1, 31, 32, 33, 2017, _K5_TURN - 1, _K5_TURN, _K5_TURN + 1, 16000])
@pytest.mark.parametrize("bank", ["gammatone", "modulation"])
def test_biquad_matches_plain(card, bank, length):
    """K5 against its plain loop on the same CUDA inputs, bitwise: the
    gammatone's 4 stages over 23 coefficient sets (3 input rows: 69 rows,
    the last block 5 rows) and the modulation bank's one stage over 8 (37
    input rows: 296 rows, the last block 8), ragged tails, lengths around a
    turn of the kernel's rings; a launch per call, none for the plain loop."""
    num, den = _k5_bank(bank)
    gen = torch.Generator(device=card)
    gen.manual_seed(71)
    if bank == "gammatone":
        x = torch.randn((3, length), generator=gen, device=card)
    else:
        x = torch.rand((37, length), generator=gen, device=card)
    _k5_bitwise(x, num, den)


@pytest.mark.parametrize("bank,inputs", [("gammatone", 1), ("gammatone", 2), ("modulation", 4), ("modulation", 5), ("single", 1)])
def test_biquad_partial_blocks_and_a_single_row(card, bank, inputs):
    """Row counts around the kernel's 32-row block: 23 and 46 gammatone rows
    (one partial block; a whole one and a partial one), 32 and 40 modulation
    rows (exactly one block; a whole one and 8 rows), and one row alone
    (group 1, one stage: a block of 31 idle lanes); bitwise, one launch."""
    num, den = _k5_bank("modulation" if bank == "single" else bank)
    if bank == "single":
        num, den = num[:1], den[:1]
    gen = torch.Generator(device=card)
    gen.manual_seed(73)
    x = torch.randn((inputs, _K5_TURN + 1), generator=gen, device=card)
    assert _k5_bitwise(x, num, den).shape[0] == inputs * num.shape[0]


@pytest.mark.parametrize("case", ["zeros", "impulse", "nan"])
@pytest.mark.parametrize("bank", ["gammatone", "modulation"])
def test_biquad_silence_impulse_and_nan(card, bank, case):
    """Inputs that reach the corners of float32, at T = 16,000: all zeros;
    an impulse then 15,999 silent samples, whose tails decay through the
    denormals (the kernel is built without flush-to-zero, as the plain loop
    runs); a NaN sample mid-row, which poisons the same outputs, bit for
    bit, as in the plain loop. Bitwise, one launch."""
    num, den = _k5_bank(bank)
    x = torch.zeros((3, 16000), device=card)
    if case == "impulse":
        x[:, 0] = 1.0
    elif case == "nan":
        gen = torch.Generator(device=card)
        gen.manual_seed(74)
        x = torch.randn((3, 16000), generator=gen, device=card)
        x[1, 7000] = float("nan")
    got = _k5_bitwise(x, num, den)
    if case == "impulse":
        mag = got.abs()
        assert bool(((mag > 0) & (mag < torch.finfo(torch.float32).tiny)).any())  # the tails passed through denormals
    if case == "nan":
        group = num.shape[0]
        assert bool(got[group : 2 * group, 7000:].isnan().all()) and not bool(got[:, :7000].isnan().any())


def test_srmr_on_the_card_two_launches_tf32_invariant_and_refused_by_a_capture(card):
    """SRMR on the card launches K5 twice a call, gives the same bits with
    cuDNN's TF32 on and off, lies within the CPU's budget, and a fused plan
    refuses it at capture, naming the member (its K* check reads the host)."""
    from torchmetrics_tpu_torch.ops import biquad_cascade

    gen = torch.Generator(device=card)
    gen.manual_seed(72)
    wave = torch.randn((2, 8000), generator=gen, device=card)
    saved = torch.backends.cudnn.allow_tf32
    try:
        values = []
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            before = biquad_cascade.launches
            values.append(T.functional.speech_reverberation_modulation_energy_ratio(wave, 8000))
            assert biquad_cascade.launches == before + 2
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert torch.equal(values[0], values[1])
    cpu = T.functional.speech_reverberation_modulation_energy_ratio(wave.cpu(), 8000)
    # K5 is bitwise its plain loop; cuFFT and pocketfft differ in the envelope's last bits, which re-roll the
    # modulation bank's float32 rounding noise (chip_smoke.py: SRMR_CPU_RTOL)
    assert torch.allclose(values[0].cpu(), cpu, rtol=1e-3, atol=0)
    plan = T.MetricCollection({"srmr": T.SpeechReverberationModulationEnergyRatio(fs=8000, device=card)}).fused()
    with pytest.raises(RuntimeError, match=r"member 'srmr'"):
        plan.update(wave)


def test_clustering_and_audio_on_the_card_equal_cpu(card):
    """The clustering classes and the SNR family on the card against the
    same stream on the CPU: integer contingency tables bitwise, values within
    1e-5 (sums in another order); STOI bitwise (the same host numpy)."""
    from torchmetrics_tpu_torch.functional.clustering.utils import calculate_contingency_matrix

    gen = torch.Generator(device="cpu")
    gen.manual_seed(73)
    preds, target = torch.randint(0, 40, (5000,), generator=gen), torch.randint(0, 50, (5000,), generator=gen)
    assert torch.equal(calculate_contingency_matrix(preds.to(card), target.to(card)).cpu(), calculate_contingency_matrix(preds, target))
    data = torch.randn((5000, 16), generator=gen) + 3 * (preds % 5)[:, None]
    for name in ("MutualInfoScore", "AdjustedMutualInfoScore", "AdjustedRandScore", "FowlkesMallowsIndex", "VMeasureScore",
                 "CalinskiHarabaszScore", "DaviesBouldinScore", "DunnIndex"):
        a, b = (data, preds % 5) if name in ("CalinskiHarabaszScore", "DaviesBouldinScore", "DunnIndex") else (preds, target)
        m_card, m_cpu = getattr(T, name)(device=card), getattr(T, name)(device="cpu")
        for part in range(2):
            m_card.update(a[part::2].to(card), b[part::2].to(card))
            m_cpu.update(a[part::2], b[part::2])
        assert torch.allclose(m_card.compute().cpu(), m_cpu.compute(), rtol=1e-5, atol=1e-6), name
    sig = torch.randn((4, 2, 4000), generator=gen)
    noisy = sig + 0.3 * torch.randn((4, 2, 4000), generator=gen)
    for name in ("SignalNoiseRatio", "ScaleInvariantSignalDistortionRatio", "SignalDistortionRatio",
                 "SourceAggregatedSignalDistortionRatio"):
        m_card, m_cpu = getattr(T, name)(device=card), getattr(T, name)(device="cpu")
        m_card.update(noisy.to(card), sig.to(card))
        m_cpu.update(noisy, sig)
        assert torch.allclose(m_card.compute().cpu(), m_cpu.compute(), rtol=1e-5, atol=1e-3), name
    stoi = T.functional.short_time_objective_intelligibility
    assert torch.equal(stoi(noisy[:, 0].to(card), sig[:, 0].to(card), 8000).cpu(), stoi(noisy[:, 0], sig[:, 0], 8000))


def _coco_case(gen, n, d, g, a, classes=3, nan=0.0):
    """Seeded K6 inputs on the CPU: IoUs on a 0.05 grid (ties), padding, crowds, NaNs."""
    iou = torch.round(torch.rand((n, d, g), generator=gen) * 20) / 20
    if nan:
        iou[torch.rand((n, d, g), generator=gen) < nan] = float("nan")
    return (iou, torch.randint(0, classes, (n, d), generator=gen, dtype=torch.int32),
            torch.rand((n, d), generator=gen) < 0.9, torch.randint(0, classes, (n, g), generator=gen, dtype=torch.int32),
            torch.rand((n, g), generator=gen) < 0.9, torch.rand((n, g), generator=gen) < 0.1,
            torch.rand((n, a, g), generator=gen) < 0.25)


def _coco_special(gen, n, d, g, a):
    """K6 inputs whose candidate IoUs are -1.0, -2.0, -0.0 and +0.0 (ties), several NaNs a row, and
    1.0; one class, so most ground truths are candidates."""
    values = torch.tensor([-1.0, -2.0, -0.0, 0.0, float("nan"), 1.0, 0.5])
    iou = values[torch.randint(0, len(values), (n, d, g), generator=gen)]
    args = list(_coco_case(gen, n, d, g, a, classes=1))
    args[0] = iou
    return tuple(args)


def _coco_cover(gen, n, d, g, a):
    """Every ground truth valid, a candidate of every detection and never ignored, with IoUs at or below
    -1.0: stage 1's candidates cover the row, so no -1.0 column outside them (no filler) takes part."""
    values = torch.tensor([-1.0, -2.0, -1.5, -0.0])
    iou = values[torch.randint(0, len(values), (n, d, g), generator=gen)]
    return (iou, torch.zeros((n, d), dtype=torch.int32), torch.ones((n, d), dtype=torch.bool),
            torch.zeros((n, g), dtype=torch.int32), torch.ones((n, g), dtype=torch.bool),
            torch.zeros((n, g), dtype=torch.bool), torch.zeros((n, a, g), dtype=torch.bool))


# (n, d, g, a[, inputs]): the matched set in 1-4 registers (G 32, 63, 64, 65, 127, 128) or past them (G 129,
# 1,100, 1,500: the scratch instantiation); a block's masks and staged IoUs past 48 KB at 32 threads (200
# detections, one area range: the scratch instantiation at 8 and 10 thresholds, 64 threads a block at 37);
# special candidate values; candidates covering the row
_COCO_SHAPES = {
    "coco": (64, 104, 64, 4), "scratch": (3, 5, 1100, 2), "unstaged": (4, 200, 70, 4), "unstaged-scratch": (2, 12, 1500, 1),
    "one": (5, 1, 1, 3), "g32": (6, 40, 32, 4), "g63": (6, 40, 63, 4), "g64": (6, 40, 64, 4), "g65": (6, 40, 65, 4),
    "g127": (4, 40, 127, 2), "g128": (4, 40, 128, 2), "g129": (4, 40, 129, 2), "scratch-masks": (6, 200, 100, 1),
    "special": (8, 50, 45, 4, _coco_special), "special-g129": (3, 30, 129, 2, _coco_special),
    "cover": (4, 20, 37, 2, _coco_cover),
}


@pytest.mark.parametrize("shape", list(_COCO_SHAPES.values()), ids=list(_COCO_SHAPES))
@pytest.mark.parametrize("thrs", ["coco", "edges", "many"])
def test_coco_match_matches_plain(card, shape, thrs):
    from torchmetrics_tpu_torch.ops import coco_match, coco_match_plain

    gen = torch.Generator().manual_seed(sum(shape[:4]))
    make = shape[4] if len(shape) > 4 else None
    if make is None:
        args = _coco_case(gen, *shape, nan=0.02)
        args[0][:, ::7] = 1.0
    else:
        args = make(gen, *shape[:4])
    bar = {"coco": torch.linspace(0.5, 0.95, 10),
           "edges": torch.tensor([1.0, 0.0, -0.0, -1.0, float("nan"), 0.5, -2.0, -1.5]),
           "many": torch.rand(37, generator=gen)}[thrs]
    want = coco_match_plain(*args, bar)
    before = coco_match.launches
    got = coco_match(*(x.to(card) for x in args), bar.to(card))
    torch.cuda.synchronize()
    assert coco_match.launches == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


def test_coco_match_shapes_reach_every_instantiation(card):
    """The shapes above reach each of K6's five instantiations (1-4 register words, the scratch)."""
    from torchmetrics_tpu_torch.ops.coco_match import coco_match_instantiation

    reached = {coco_match_instantiation(n, d, g, a, t) for n, d, g, a, *_ in _COCO_SHAPES.values() for t in (10, 8, 37)}
    assert reached == {0, 1, 2, 3, 4}
    assert coco_match_instantiation(6, 200, 100, 1, 8) == 0  # the masks overflow shared memory
    assert coco_match_instantiation(64, 104, 64, 4, 10) == 2
    assert coco_match_instantiation(0, 104, 64, 4, 10) == -1


def _detections(seed, n_imgs=12, classes=5):
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for i in range(n_imgs):
        n_g, n_d = int(rng.integers(0, 9)), int(rng.integers(0, 14))
        xy = rng.uniform(0, 300, (n_g, 2))
        gt = np.concatenate([xy, xy + rng.uniform(4, 150, (n_g, 2))], 1)
        xy = rng.uniform(0, 300, (n_d, 2))
        det = np.concatenate([xy, xy + rng.uniform(4, 150, (n_d, 2))], 1)
        k = min(n_g, n_d)
        det[:k] = gt[:k] + rng.normal(0, 5, (k, 4))
        preds.append({"boxes": torch.tensor(det, dtype=torch.float32), "scores": torch.tensor(rng.random(n_d), dtype=torch.float32),
                      "labels": torch.tensor(rng.integers(0, classes, n_d))})
        target.append({"boxes": torch.tensor(gt, dtype=torch.float32), "labels": torch.tensor(rng.integers(0, classes, n_g)),
                       "iscrowd": torch.tensor(rng.random(n_g) < 0.1)})
    return preds, target


def test_detection_on_the_card_equals_cpu(card):
    from torchmetrics_tpu_torch.ops import coco_match

    preds, target = _detections(81)
    on = lambda items: [{k: v.to(card) for k, v in it.items()} for it in items]  # noqa: E731
    kw = {"class_metrics": True, "extended_summary": True}
    m_card, m_cpu = T.MeanAveragePrecision(device=card, **kw), T.MeanAveragePrecision(device="cpu", **kw)
    for i in range(0, 12, 4):
        m_card.update(on(preds[i:i + 4]), on(target[i:i + 4]))
        m_cpu.update(preds[i:i + 4], target[i:i + 4])
    before = coco_match.launches
    got, want = m_card.compute(), m_cpu.compute()
    assert coco_match.launches == before + 1
    for key, w in want.items():
        g = got[key]
        assert g.device.type == "cuda", key
        if key in ("precision", "recall", "scores", "classes"):
            assert torch.equal(g.cpu(), w), key
        else:
            assert torch.allclose(g.cpu(), w, atol=1e-6, rtol=0), key
    for name in ("IntersectionOverUnion", "GeneralizedIntersectionOverUnion", "DistanceIntersectionOverUnion",
                 "CompleteIntersectionOverUnion"):
        i_card, i_cpu = getattr(T, name)(device=card, class_metrics=True), getattr(T, name)(device="cpu", class_metrics=True)
        i_card.update(on(preds), on(target))
        i_cpu.update(preds, target)
        got, want = i_card.compute(), i_cpu.compute()
        assert sorted(got) == sorted(want), name
        for key in want:
            assert torch.allclose(got[key].cpu(), want[key], atol=1e-6, rtol=1e-6), (name, key)
    gen = torch.Generator().manual_seed(82)
    cats = torch.tensor([0, 1, 2, 6, 7])
    target_pq = torch.stack([cats[torch.randint(0, 5, (4, 24, 32), generator=gen)], torch.randint(0, 3, (4, 24, 32), generator=gen)], -1)
    preds_pq = target_pq.clone()
    preds_pq[..., 0] = torch.where(torch.rand((4, 24, 32), generator=gen) < 0.3, cats[torch.randint(0, 5, (4, 24, 32), generator=gen)], preds_pq[..., 0])
    for name in ("PanopticQuality", "ModifiedPanopticQuality"):
        p_card = getattr(T, name)(things={0, 1, 2}, stuffs={6, 7}, return_sq_and_rq=True, device=card)
        p_cpu = getattr(T, name)(things={0, 1, 2}, stuffs={6, 7}, return_sq_and_rq=True, device="cpu")
        p_card.update(preds_pq.to(card), target_pq.to(card))
        p_cpu.update(preds_pq, target_pq)
        for key in ("iou_sum", "true_positives", "false_positives", "false_negatives"):
            assert torch.equal(getattr(p_card, key).cpu(), getattr(p_cpu, key)), (name, key)
        assert torch.equal(p_card.compute().cpu(), p_cpu.compute()), name


def _k7_factors(kind, kh, kw):
    """K7's ``(col, row)``: the Gaussian (sigma 1.5 x 1.2), the uniform window's or VIF's (square)."""
    from torchmetrics_tpu_torch.functional.image.helpers import _gaussian_factors, _uniform_factors
    from torchmetrics_tpu_torch.functional.image.metrics import _vif_factor

    if kind == "gaussian":
        return _gaussian_factors((kh, kw), (1.5, 1.2))
    if kind == "vif":
        return _vif_factor(float(kh), kh / 5), _vif_factor(float(kw), kw / 5)
    return _uniform_factors((kh, kw), float(kh * kw))


K7_CASES = [  # (id, shape, window, factors, the tile height the wrapper picks)
    ("ssim11", (2, 3, 70, 90), (11, 11), "gaussian", 48), ("ssim11-uniform", (2, 3, 70, 90), (11, 11), "uniform", 48),
    ("window-as-image", (1, 1, 17, 17), (17, 17), "gaussian", 32), ("window-as-image-uniform", (2, 3, 33, 33), (33, 33), "uniform", 48),
    ("non-square-pitch-33", (3, 2, 40, 33), (7, 5), "gaussian", 48), ("one-row", (2, 1, 9, 300), (1, 9), "uniform", 48),
    ("one-by-one", (1, 2, 5, 6), (1, 1), "uniform", 48), ("mid-tile-pitch-2050", (2, 3, 61, 2050), (11, 11), "gaussian", 48),
    ("mid-tile-uniform-8", (2, 2, 100, 131), (8, 8), "uniform", 48), ("tile-h-8", (1, 2, 200, 250), (80, 80), "uniform", 8),
    ("tile-h-1", (1, 1, 120, 130), (90, 90), "gaussian", 1), ("many-planes", (70000, 1, 12, 12), (8, 8), "uniform", 48),
    ("vif17-valid", (2, 3, 100, 99), (17, 17), "vif", 32), ("vif9-valid", (2, 3, 42, 43), (9, 9), "vif", 48),
]


@pytest.mark.parametrize(("shape", "window", "kind", "tile_h"), [c[1:] for c in K7_CASES], ids=[c[0] for c in K7_CASES])
def test_window_moments_matches_plain(card, shape, window, kind, tile_h):
    """K7 against its plain route on the same CUDA inputs, bitwise: Gaussian,
    uniform and VIF factors, odd, even and unequal sides, 1 x 1, a window as
    large as the image, row pitches that are not a multiple of 4 floats,
    outputs that end mid-tile in both axes, every tile height from 48 rows
    (two blocks an SM) through 32 (VIF's 17 x 17) to 8 and 1 (wide windows),
    more planes than a grid's z extent; a launch per call, none for the
    plain route."""
    from torchmetrics_tpu_torch.ops import window_moments, window_moments_plain
    from torchmetrics_tpu_torch.ops.window_moments import tile_height

    gen = torch.Generator(device=card)
    gen.manual_seed(91)
    x = torch.rand(shape, generator=gen, device=card)
    y = torch.rand(shape, generator=gen, device=card) * 2 - 0.5
    col, row = (f.to(card) for f in _k7_factors(kind, *window))
    assert tile_height(*window) == tile_h
    before = window_moments.launches
    got = window_moments(x, y, col, row)
    assert window_moments.launches == before + 1
    want = window_moments_plain(x, y, col, row)
    torch.cuda.synchronize()
    assert window_moments.launches == before + 1
    assert got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_window_moments_constant_images_and_refusal(card):
    """Constant images give the plain route's bits; a window whose staged tile does not fit is refused on the card."""
    from torchmetrics_tpu_torch.ops import window_moments, window_moments_plain

    x = torch.full((2, 3, 40, 40), 0.3, device=card)
    y = torch.full((2, 3, 40, 40), -1.7, device=card)
    col, row = (f.to(card) for f in _k7_factors("gaussian", 11, 11))
    assert torch.equal(window_moments(x, y, col, row), window_moments_plain(x, y, col, row))
    big = torch.ones((2, 2, 300, 300), device=card)
    with pytest.raises(ValueError, match="staged tile needs"):
        window_moments(big, big, torch.ones(201, device=card), torch.ones(201, device=card))


def test_window_moments_gradient_equals_plain_autograd(card):
    """K7's autograd route (the plain adjoint) against autograd through the plain loop, for SSIM's gradient."""
    from torchmetrics_tpu_torch.functional.image import helpers as thelpers

    gen = torch.Generator(device=card)
    gen.manual_seed(92)
    p = torch.rand((2, 3, 48, 40), generator=gen, device=card)
    t = torch.rand((2, 3, 48, 40), generator=gen, device=card)
    grads = []
    for plain in (False, True):
        leaf = p.clone().requires_grad_(True)
        if plain:
            from torchmetrics_tpu_torch.ops import window_moments_plain

            saved = thelpers.window_moments
            thelpers.window_moments = window_moments_plain
        try:
            T.functional.structural_similarity_index_measure(leaf, t).backward()
        finally:
            if plain:
                thelpers.window_moments = saved
        grads.append(leaf.grad)
    assert torch.allclose(grads[0], grads[1], rtol=1e-4, atol=1e-7)


def test_image_convolutions_stay_float32_under_the_global_tf32_flag(card):
    """With ``torch.backends.cudnn.allow_tf32`` True (PyTorch's default), the
    port's convolutions (VIF's downsampling, the uniform filter, 3-D SSIM,
    the Inception tower) give their float32 values: the CPU's within float32
    rounding, where TF32's 10-bit mantissa would miss by about 1e-3."""
    saved = torch.backends.cudnn.allow_tf32
    gen = torch.Generator().manual_seed(93)
    p, t = torch.rand((2, 3, 64, 64), generator=gen), torch.rand((2, 3, 64, 64), generator=gen)
    v = torch.rand((1, 1, 20, 24, 28), generator=gen)
    imgs = torch.randint(0, 256, (2, 3, 299, 299), generator=gen, dtype=torch.uint8)
    try:
        torch.backends.cudnn.allow_tf32 = True
        card_vals = [
            T.functional.visual_information_fidelity(p.to(card), t.to(card)),
            T.functional.root_mean_squared_error_using_sliding_window(p.to(card), t.to(card)),
            T.functional.structural_similarity_index_measure(v.to(card), (0.9 * v + 0.05).to(card), kernel_size=5),
        ]
        tower = T.image.backbones.inception.InceptionFeatureExtractor(("2048",), device=card)
        feats = tower(imgs.to(card))
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    cpu_vals = [
        T.functional.visual_information_fidelity(p, t),
        T.functional.root_mean_squared_error_using_sliding_window(p, t),
        T.functional.structural_similarity_index_measure(v, 0.9 * v + 0.05, kernel_size=5),
    ]
    for got, want in zip(card_vals, cpu_vals):
        assert torch.allclose(got.cpu(), want, rtol=1e-5, atol=1e-6), (got, want)
    cpu_tower = T.image.backbones.inception.InceptionFeatureExtractor(("2048",), device="cpu")
    assert torch.allclose(feats.cpu(), cpu_tower(imgs), rtol=1e-4, atol=1e-5)


# K8 (Perplexity's token log-likelihood): per row, within these shares of max(1, |plain|) of the plain route
# (float32: another order of the sum of exponentials and the card's expf; 16-bit: the plain route rounds where
# XLA rounds, four times, the kernel once)
K8_BUDGET = {torch.float32: 2e-6, torch.bfloat16: 2 * 2.0**-7, torch.float16: 2 * 2.0**-10}


def _k8_case(card, n, v, dtype=torch.float32, seed=0, pitch=None):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = 3 * torch.randn((n, pitch or v), generator=gen, device=card)
    return x[:, :v].to(dtype), torch.randint(0, v, (n,), generator=gen, device=card)


def _k8_assert_close(got, want, what):
    (nll, valid), (pnll, pvalid) = got, want
    assert nll.dtype == pnll.dtype and torch.equal(valid, pvalid), what
    a, b = nll.float().cpu(), pnll.float().cpu()
    assert torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(torch.isinf(a), torch.isinf(b)), what
    fin = torch.isfinite(b)
    err = ((a[fin] - b[fin]).abs() / b[fin].abs().clamp(min=1)).max() if fin.any() else torch.tensor(0.0)
    assert float(err) <= K8_BUDGET[nll.dtype], (what, float(err))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,v,pitch", [(64, 1, None), (33, 7, None), (256, 32000, None), (96, 1000, 1003), (17, 50257, None),
                                       (8, 50257, 50261)])
def test_token_nll_matches_plain(card, dtype, n, v, pitch):
    from torchmetrics_tpu_torch.ops import token_nll, token_nll_plain

    x, t = _k8_case(card, n, v, dtype, seed=n + v, pitch=pitch)
    before = token_nll.launches
    _k8_assert_close(token_nll(x, t, None), token_nll_plain(x, t, None), f"{n} x {v} {dtype}")
    assert token_nll.launches == before + 1


def test_token_nll_targets_and_special_rows_as_plain(card):
    """Ignored rows, targets -1 and -V (wrapped), >= V and < -V (NaN), rows of +-inf and NaN logits."""
    from torchmetrics_tpu_torch.ops import token_nll, token_nll_plain

    x, _ = _k8_case(card, 12, 50, seed=5)
    x[0, 3] = float("inf")
    x[1] = float("-inf")
    x[2, 4] = float("nan")
    x[3, 9] = float("-inf")
    t = torch.tensor([1, 1, 1, 9, -1, -50, 50, -51, -100, -100, 0, 49], device=card)
    for ignore in (None, -100, 0):
        _k8_assert_close(token_nll(x, t, ignore), token_nll_plain(x, t, ignore), f"ignore_index={ignore}")
    nll, valid = token_nll(x, torch.full((12,), -100, device=card), -100)
    assert not bool(valid.any()) and bool((nll == 0).all())


def test_token_nll_gradient_matches_autograd_through_plain(card):
    from torchmetrics_tpu_torch.ops import token_nll, token_nll_plain

    x, t = _k8_case(card, 64, 3000, seed=7)
    t[::5] = -100
    w = torch.linspace(0.5, 1.5, 64, device=card)
    xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    (token_nll(xk, t, -100)[0] * w).sum().backward()
    (token_nll_plain(xp, t, -100)[0] * w).sum().backward()
    assert torch.allclose(xk.grad, xp.grad, rtol=1e-5, atol=1e-7)


def test_token_nll_captures_in_a_cuda_graph(card):
    from torchmetrics_tpu_torch.ops import token_nll

    x, t = _k8_case(card, 128, 50257, seed=9)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        token_nll(x, t, -100)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = token_nll(x, t, -100)
    x.copy_(_k8_case(card, 128, 50257, seed=10)[0])
    graph.replay()
    eager = token_nll(x, t, -100)
    assert torch.equal(captured[0].view(torch.int32), eager[0].view(torch.int32)) and torch.equal(captured[1], eager[1])


def test_perplexity_launches_k8_once_an_update_and_equals_cpu(card):
    from torchmetrics_tpu_torch.ops import token_nll

    gen = torch.Generator().manual_seed(11)
    batches = [(3 * torch.randn((2, 16, 1000), generator=gen), torch.randint(0, 1000, (2, 16), generator=gen)) for _ in range(3)]
    on_card, on_cpu = T.Perplexity(ignore_index=-100), T.Perplexity(ignore_index=-100, device="cpu")
    before = token_nll.launches
    for x, t in batches:
        t[0, :3] = -100
        on_card.update(x.to(card), t.to(card))
        on_cpu.update(x, t)
    assert token_nll.launches == before + 3
    assert torch.equal(on_card.count.cpu(), on_cpu.count)
    assert torch.allclose(on_card.compute().cpu(), on_cpu.compute(), rtol=1e-6)



def test_perplexity_in_a_fused_plan_equals_eager(card):
    """The update captures in the fused plan's CUDA graph (K8 and the XLA-order sum, no host check): the
    replays' states equal the eager collection's bitwise, K8 traced once a replay."""
    from torchmetrics_tpu_torch.ops import token_nll

    gen = torch.Generator(device=card).manual_seed(13)
    batches = []
    for _ in range(4):
        t = torch.randint(0, 2000, (4, 64), generator=gen, device=card)
        t[:, ::9] = -100
        batches.append((3 * torch.randn((4, 64, 2000), generator=gen, device=card), t))
    ref, fus = (T.MetricCollection({"ppl": T.Perplexity(ignore_index=-100)}) for _ in range(2))
    for b in batches:
        ref.update(*b)
    fus.update(*batches[0])
    fus.update(*batches[1])
    plan = fus.fused()
    plan.update(*batches[2])  # warm-up, capture, first replay
    before = token_nll.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        plan.update(*batches[3])
        torch.cuda.synchronize()
    assert sum(e.count for e in prof.key_averages() if "token_nll_kernel" in e.key) == 1
    assert token_nll.launches == before and len(plan._captured) == 1
    plan.fold_back()
    _assert_collections_bitwise(ref, fus)


def test_clip_towers_on_the_card_equal_cpu_under_the_global_tf32_flags(gpu):
    """CLIPScore's and CLIP-IQA's towers (transformers' ``CLIPModel``, seeded, at a small width) with TF32
    turned on globally for cuDNN and the float32 matmuls: the metric runs them in float32 (the CPU's scores
    within 1e-4 of 100, its probabilities within 1e-5) and leaves both flags as they were."""
    pytest.importorskip("transformers")
    from transformers import CLIPConfig, CLIPModel

    from torchmetrics_tpu_torch.functional.multimodal.clip_iqa import clip_image_quality_assessment
    from torchmetrics_tpu_torch.functional.multimodal.clip_score import _clip_score_update

    class Processor:
        def __call__(self, text=None, images=None, return_tensors="np", padding=True, **kw):
            out = {}
            if text is not None:
                rows = [[49406] + [3 + sum(map(ord, w)) % 1000 for w in t.split()] + [49407] for t in text]
                width = max(map(len, rows))
                out["input_ids"] = np.array([r + [49407] * (width - len(r)) for r in rows], np.int64)
                out["attention_mask"] = np.array([[1] * len(r) + [0] * (width - len(r)) for r in rows], np.int64)
            if images is not None:
                out["pixel_values"] = np.stack([np.asarray(i, np.float32) for i in images])
            return out

    config = CLIPConfig(
        text_config={"hidden_size": 256, "intermediate_size": 1024, "num_attention_heads": 4, "num_hidden_layers": 4},
        vision_config={"hidden_size": 256, "intermediate_size": 1024, "num_attention_heads": 4, "num_hidden_layers": 4,
                       "image_size": 64, "patch_size": 8},
        projection_dim=128,
    )
    torch.manual_seed(7)
    cpu_model = CLIPModel(config).eval()
    card_model = CLIPModel(config).eval().to(gpu)
    card_model.load_state_dict(cpu_model.state_dict())
    images = torch.rand((4, 3, 64, 64), generator=torch.Generator().manual_seed(8))
    text = ["a photo of a cat", "a dog", "two birds in the sky", "an empty street"]
    saved = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        card, _ = _clip_score_update(images.to(gpu), text, card_model, Processor())
        card_iqa = clip_image_quality_assessment(images.to(gpu), prompts=("quality", "warm"), model=card_model, processor=Processor())
        assert (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()) == (True, "high")
    finally:
        torch.backends.cudnn.allow_tf32, precision = saved
        torch.set_float32_matmul_precision(precision)
    cpu, _ = _clip_score_update(images, text, cpu_model, Processor(), "cpu")
    cpu_iqa = clip_image_quality_assessment(images, prompts=("quality", "warm"), model=cpu_model, processor=Processor(), device="cpu")
    assert card.device.type == "cuda" and torch.allclose(card.cpu(), cpu, rtol=0, atol=1e-4), (card, cpu)
    for key in cpu_iqa:
        assert torch.allclose(card_iqa[key].cpu(), cpu_iqa[key], rtol=0, atol=1e-5), key


if __name__ == "__main__":
    _dist_worker(sys.argv)
