# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's sliced plane (``SlicedPlan``) against the JAX package's, on the
CPU: the counterparts of ``tests/unittests/bases/test_sliced.py`` and of
``tests/unittests/drift/test_drift.py::test_sliced_plan_scores_cohorts_in_one_dispatch``
on the same seeded numpy batches.

Budgets: the slice table (``keys``, ``occupied``, ``spills``), every int
cell state, every cat cell state and every sketch leaf bitwise equal to
JAX's (the whole ``save_checkpoint`` payloads compared leaf by leaf);
per-cohort values and float ``compute_all`` values within ``atol=1e-6``
(float divisions in another order). The batches feed probabilities (rows
that sum to 1), so the softmax of the update's format is the identity on
both packages and the cat rows compare bitwise; the kernel-route tests also
feed logits, whose per-row softmax/sigmoid decision is JAX's. The kernel
routes run here through K1s' and K2s' plain versions (the card's kernels
are held against them in ``tests/test_torch_kernels_cuda.py``).

JAX's ``test_sliced_step_rides_cache`` (the compiled-step cache) has no
counterpart until the step cache; ``publish_gauges``' gauges are held
against JAX's here and its attribution row in ``tests/test_torch_obs.py``.
The sharded variant is in ``tests/test_torch_sliced_ranks.py``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as T
from torchmetrics_tpu import drift as jdrift
from torchmetrics_tpu.parallel import SlicedPlan as JPlan
from torchmetrics_tpu.sketch import histogram as jhist
from torchmetrics_tpu.utilities.exceptions import StateRestoreError as JStateRestoreError
from torchmetrics_tpu_torch import drift as tdrift
from torchmetrics_tpu_torch.parallel import (
    SlicedPlan,
    slice_key_reason,
    slice_table_size_reason,
    sliced_ineligibility,
)
from torchmetrics_tpu_torch.parallel.sliced import _SEGMENTED_SKETCHES, _fold_sketch_, _merge_cells_, _sketch_partial
from torchmetrics_tpu_torch.robustness import CheckpointStore, StreamingEvaluator
from torchmetrics_tpu_torch.sketch import histogram as thist
from torchmetrics_tpu_torch.sketch import hll as thll
from torchmetrics_tpu_torch.utilities.exceptions import StateRestoreError

NUM_CLASSES = 5
BATCH = 48
NUM_CELLS = 32
NUM_COHORTS = 7
ATOL = 1e-6  # float values: divisions of the same int counts, in another order


def _jkw(**extra):
    return dict(validate_args=False, distributed_available_fn=lambda: False, **extra)


def _tkw(**extra):
    return dict(validate_args=False, distributed_available_fn=lambda: False, device="cpu", **extra)


def _hist_class(pkg):
    """JAX's ``_ScoreHistogram`` (an add-style sketch state over each row's
    top probability), for one package; both classes share the name, so the
    two plans' fingerprints agree."""
    sk = jhist if pkg is J else thist

    class _ScoreHistogram(pkg.Metric):
        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            extra = {} if pkg is J else {"device": self.device}
            self.add_state("hist", sk.hist_init(bins=8, lo=0.0, hi=1.0, **extra), dist_reduce_fx="merge")

        def update(self, preds, target):
            top = preds.max(-1) if pkg is J else preds.max(-1).values
            self.hist = sk.hist_update(self.hist, top)

        def compute(self):
            if pkg is J:
                return self.hist.counts.astype(jnp.float32) / jnp.maximum(self.hist.count, 1)
            return self.hist.counts.to(torch.float32) / torch.clamp(self.hist.count, min=1)

    return _ScoreHistogram


JHist, THist = _hist_class(J), _hist_class(T)


def _suite(pkg, with_exact=True):
    kw = _jkw() if pkg is J else _tkw()
    hist_kw = {"distributed_available_fn": lambda: False, **({} if pkg is J else {"device": "cpu"})}
    cls = J.classification if pkg is J else T
    members = {
        "acc": cls.MulticlassAccuracy(num_classes=NUM_CLASSES, **kw),
        "hist": (JHist if pkg is J else THist)(**hist_kw),
    }
    if with_exact:
        members["auroc_exact"] = cls.MulticlassAUROC(num_classes=NUM_CLASSES, thresholds=None, **kw)
    return pkg.MetricCollection(members, compute_groups=False)


def _probs(rng, shape):
    x = rng.standard_normal(shape).astype(np.float64)
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _batches(n, seed=0, cohorts=NUM_COHORTS):
    rng = np.random.default_rng(seed)
    return [
        (
            rng.integers(0, cohorts, BATCH).astype(np.int32),
            _probs(rng, (BATCH, NUM_CLASSES)),
            rng.integers(0, NUM_CLASSES, BATCH).astype(np.int32),
        )
        for _ in range(n)
    ]


def _j(batch):
    return tuple(jnp.asarray(a) for a in batch)


def _t(batch):
    return tuple(torch.from_numpy(np.asarray(a)) for a in batch)


def _pair(factory_j, factory_t, batches, drive=True, **kwargs):
    """The JAX plan and the port's over the same target and geometry, both
    driven through ``batches`` (``drive``)."""
    example = kwargs.pop("example", None)
    jp = JPlan(factory_j(), **kwargs, **({"example_batch": _j(example)} if example else {}))
    tp = SlicedPlan(factory_t(), **kwargs, **({"example_batch": _t(example)} if example else {}))
    if drive:
        for b in batches:
            jp.update(*_j(b))
            tp.update(*_t(b))
    return jp, tp


def _assert_payloads_equal(got, want, path="payload"):
    """Two ``save_checkpoint`` payloads (either package's) leaf for leaf:
    the same keys, shapes, dtypes and bits."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for key in want:
            _assert_payloads_equal(got[key], want[key], f"{path}.{key}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype, g.shape, w.shape)
    assert np.array_equal(g, w, equal_nan=g.dtype.kind == "f"), path


def _assert_plans_equal(jp, tp):
    _assert_payloads_equal(tp.save_checkpoint(), jp.save_checkpoint())


def _independent_refs(batches, factory):
    """One independent port metric per cohort, fed exactly that cohort's
    rows — the ground truth sliced(k=N) must match bitwise."""
    refs = {}
    for keys, preds, target in batches:
        for k in np.unique(keys):
            sel = keys == k
            refs.setdefault(int(k), factory()).update(torch.from_numpy(preds[sel]), torch.from_numpy(target[sel]))
    return refs


def _assert_metric_bitwise(m1, m2, context):
    assert m1._update_count == m2._update_count, context
    for name in m1._defaults:
        v1, v2 = getattr(m1, name), getattr(m2, name)
        if isinstance(v1, list):
            c1 = torch.cat([torch.atleast_1d(x) for x in v1]) if v1 else torch.zeros(0)
            c2 = torch.cat([torch.atleast_1d(x) for x in v2]) if v2 else torch.zeros(0)
            assert torch.equal(c1, c2), f"{context}: state {name}"
        else:
            for a, b in zip(v1 if isinstance(v1, tuple) else [v1], v2 if isinstance(v2, tuple) else [v2]):
                assert torch.equal(a, b), f"{context}: state {name}"


def _assert_exports_match_refs(plan, refs, context, member_keys=None):
    for k, ref in refs.items():
        exported = plan.export_cell(k)
        if member_keys is None:
            _assert_metric_bitwise(ref, exported, f"{context} cohort {k}")
        else:
            for key in member_keys:
                _assert_metric_bitwise(dict.__getitem__(ref, key), dict.__getitem__(exported, key), f"{context} {k} {key}")


def _close(got, want):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, np.asarray(want), atol=ATOL, rtol=0)


# ------------------------------------------------------------ bitwise parity


def test_sliced_k1_equals_plain_metric():
    """sliced(k=1): one cohort's cell == the plain eager metric, bitwise; the
    plan == JAX's plan."""
    batches = _batches(4, seed=0, cohorts=1)
    plain = T.MulticlassAccuracy(num_classes=NUM_CLASSES, **_tkw())
    jp, tp = _pair(lambda: J.classification.MulticlassAccuracy(num_classes=NUM_CLASSES, **_jkw()),
                   lambda: T.MulticlassAccuracy(num_classes=NUM_CLASSES, **_tkw()), batches, num_cells=1)
    for _, preds, target in batches:
        plain.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert tp.occupancy == 1.0 and tp.spills == 0
    exported = tp.export_cell(0)
    _assert_metric_bitwise(plain, exported, "k=1")
    assert torch.equal(plain.compute(), exported.compute())
    _assert_plans_equal(jp, tp)


def test_sliced_parity_full_suite():
    """sliced(k=N) == JAX's plan (table and every cell, bitwise) == N
    independent port metrics, for elementwise (K2s route) + cat + sketch
    states, a whole collection per cell."""
    batches = _batches(4, seed=1)
    jp, tp = _pair(lambda: _suite(J), lambda: _suite(T), batches, num_cells=NUM_CELLS,
                   cat_capacity=BATCH * 4 + 8, example=batches[0][1:])
    _assert_plans_equal(jp, tp)
    refs = _independent_refs(batches, lambda: _suite(T))
    assert tp.spills == 0 and set(tp.occupied_cells()) == {(k,) for k in refs}
    _assert_exports_match_refs(tp, refs, "suite", member_keys=["acc", "hist", "auroc_exact"])
    got = tp.results()
    assert set(got) == {(k,) for k in refs}
    for k, ref in refs.items():
        want = ref.compute()
        for member in want:
            assert torch.equal(got[(k,)][member], want[member]), (k, member)


def test_sliced_scan_parity():
    """run_scan == JAX's run_scan == per-batch update == independents."""
    batches = _batches(5, seed=2)
    jp, tp = _pair(lambda: J.classification.MulticlassAccuracy(num_classes=NUM_CLASSES, **_jkw()),
                   lambda: T.MulticlassAccuracy(num_classes=NUM_CLASSES, **_tkw()), batches, drive=False,
                   num_cells=NUM_CELLS)
    jp.run_scan([jnp.asarray(b[0]) for b in batches], [_j(b[1:]) for b in batches])
    tp.run_scan([b[0] for b in batches], [_t(b[1:]) for b in batches])
    _assert_plans_equal(jp, tp)
    refs = _independent_refs(batches, lambda: T.MulticlassAccuracy(num_classes=NUM_CLASSES, **_tkw()))
    _assert_exports_match_refs(tp, refs, "scan")
    assert tp.updates_applied == len(batches)
    stepped = T.MulticlassAccuracy(num_classes=NUM_CLASSES, **_tkw()).sliced(num_cells=NUM_CELLS)
    for b in batches:
        stepped.update(*_t(b))
    _assert_payloads_equal(stepped.save_checkpoint(), tp.save_checkpoint())


def test_sliced_kill_and_resume_parity(tmp_path):
    """Checkpoint mid-stream through CheckpointStore, die, rebuild a fresh
    plan, restore, finish: == the uninterrupted run, bitwise — cells, table
    and spill counter included; and == JAX's uninterrupted plan."""
    batches = _batches(6, seed=4)
    cap, example = BATCH * 6 + 8, batches[0][1:]

    def build():
        return SlicedPlan(_suite(T), num_cells=NUM_CELLS, cat_capacity=cap, example_batch=_t(example))

    uninterrupted = build()
    for b in batches:
        uninterrupted.update(*_t(b))
    store = CheckpointStore(os.path.join(str(tmp_path), "store"), keep_last=2)
    victim = build()
    for b in batches[:4]:
        victim.update(*_t(b))
    store.save(victim.save_checkpoint(), step=4)
    del victim  # the "kill"
    resumed = build()
    step, payload = CheckpointStore(os.path.join(str(tmp_path), "store"), keep_last=2).latest()
    assert step == 4
    resumed.load_checkpoint(payload)
    for b in batches[4:]:
        resumed.update(*_t(b))
    assert resumed.updates_applied == uninterrupted.updates_applied
    _assert_payloads_equal(resumed.save_checkpoint(), uninterrupted.save_checkpoint())
    jp = JPlan(_suite(J), num_cells=NUM_CELLS, cat_capacity=cap, example_batch=_j(example))
    for b in batches:
        jp.update(*_j(b))
    _assert_plans_equal(jp, resumed)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sliced_checkpoint_reads_across_packages(direction):
    """A plan saved by either package loads into the other (table, cat and
    sketch leaves) and keeps going: both end equal to an uninterrupted run."""
    batches = _batches(4, seed=14)
    cap, example = BATCH * 4 + 8, batches[0][1:]
    jp, tp = _pair(lambda: _suite(J), lambda: _suite(T), batches[:2], num_cells=NUM_CELLS,
                   cat_capacity=cap, example=example)
    assert tp.stable_fingerprint() == jp.stable_fingerprint()
    if direction == "jax_to_port":
        src, dst = jp, SlicedPlan(_suite(T), num_cells=NUM_CELLS, cat_capacity=cap, example_batch=_t(example))
    else:
        src, dst = tp, JPlan(_suite(J), num_cells=NUM_CELLS, cat_capacity=cap, example_batch=_j(example))
    dst.load_checkpoint(src.save_checkpoint())
    for b in batches[2:]:
        dst.update(*(_t(b) if isinstance(dst, SlicedPlan) else _j(b)))
        jp.update(*_j(b))
    _assert_payloads_equal(dst.save_checkpoint(), jp.save_checkpoint())


def test_sliced_compute_all_matches_export_and_jax():
    batches = _batches(3, seed=5)
    jp, tp = _pair(lambda: J.classification.MulticlassAccuracy(num_classes=NUM_CLASSES, **_jkw()),
                   lambda: T.MulticlassAccuracy(num_classes=NUM_CLASSES, **_tkw()), batches, num_cells=NUM_CELLS)
    values = tp.compute_all()["MulticlassAccuracy"]
    assert values.shape == (NUM_CELLS,)
    for key, cell in tp.occupied_cells().items():
        assert torch.equal(values[cell], tp.export_cell(key[0]).compute())
    _close(values, jp.compute_all()["MulticlassAccuracy"])


def test_sliced_compute_all_group_members_use_own_compute():
    """Compute-group members share the leader's STATE but each vmaps its OWN
    compute — precision and recall differ per cell."""
    batches = _batches(3, seed=13)

    def col(pkg, **groups):
        kw = _jkw() if pkg is J else _tkw()
        cls = J.classification if pkg is J else T
        return pkg.MetricCollection(
            {
                "prec": cls.MulticlassPrecision(num_classes=NUM_CLASSES, average="macro", **kw),
                "rec": cls.MulticlassRecall(num_classes=NUM_CLASSES, average="macro", **kw),
            },
            **groups,
        )

    plans = {}
    for pkg, conv, plan_cls in ((J, _j, JPlan), (T, _t, SlicedPlan)):
        c = col(pkg)
        c.update(*conv(batches[0][1:]))
        c.update(*conv(batches[1][1:]))
        c.reset()
        plans[pkg.__name__] = plan = plan_cls(c, num_cells=NUM_CELLS)
        assert len(plan._infos) == 1  # prec/rec share one leader
        for b in batches:
            plan.update(*conv(b))
    tp, jp = plans["torchmetrics_tpu_torch"], plans["torchmetrics_tpu"]
    _assert_plans_equal(jp, tp)
    values, jvalues = tp.compute_all(), jp.compute_all()
    refs = _independent_refs(batches, lambda: col(T, compute_groups=False))
    for k, ref in refs.items():
        cell, want = tp.lookup(k), ref.compute()
        assert torch.equal(values["prec"][cell], want["prec"]) and torch.equal(values["rec"][cell], want["rec"]), k
    for key in ("prec", "rec"):
        _close(values[key], jvalues[key])


def test_sliced_results_and_tuple_keys():
    """Multi-component cohort keys (key_width=2) hash as one cohort, in the
    same cells as JAX's; results() keys by the full tuple."""
    rng = np.random.default_rng(6)
    k1, k2 = rng.integers(0, 3, BATCH).astype(np.int32), rng.integers(0, 2, BATCH).astype(np.int32)
    preds, target = _probs(rng, (BATCH, NUM_CLASSES)), rng.integers(0, NUM_CLASSES, BATCH).astype(np.int32)
    jp = J.classification.MulticlassAccuracy(num_classes=NUM_CLASSES, **_jkw()).sliced(num_cells=NUM_CELLS, key_width=2)
    tp = T.MulticlassAccuracy(num_classes=NUM_CLASSES, **_tkw()).sliced(num_cells=NUM_CELLS, key_width=2)
    jp.update((jnp.asarray(k1), jnp.asarray(k2)), jnp.asarray(preds), jnp.asarray(target))
    tp.update(np.stack([k1, k2], 1), torch.from_numpy(preds), torch.from_numpy(target))  # the [B, K] matrix form
    _assert_plans_equal(jp, tp)
    res = tp.results()
    assert set(res) == {(int(a), int(b)) for a, b in zip(k1, k2)}
    for (a, b), value in res.items():
        sel = (k1 == a) & (k2 == b)
        ref = T.MulticlassAccuracy(num_classes=NUM_CLASSES, **_tkw())
        ref.update(torch.from_numpy(preds[sel]), torch.from_numpy(target[sel]))
        assert torch.equal(value, ref.compute())


# -------------------------------------------------------- the kernel routes


def _k2_batches(seed, logits=False, labels=False, extra_dim=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        keys = rng.integers(0, NUM_COHORTS, BATCH).astype(np.int32)
        shape = (BATCH, NUM_CLASSES, 3) if extra_dim else (BATCH, NUM_CLASSES)
        if labels:
            preds = rng.integers(0, NUM_CLASSES, (BATCH, 3) if extra_dim else BATCH).astype(np.int32)
        elif logits:
            preds = rng.standard_normal(shape).astype(np.float32)
        else:
            preds = _probs(rng, shape[:1] + shape[2:] + shape[1:2])
            preds = np.moveaxis(preds, -1, 1).copy() if extra_dim else preds
        target = rng.integers(-2, NUM_CLASSES + 2, (BATCH, 3) if extra_dim else BATCH).astype(np.int32)
        target[rng.random(target.shape) < 0.2] = 2  # the ignore_index of the ignore cases
        out.append((keys, preds, target))
    return out


@pytest.mark.parametrize(
    "case",
    [
        dict(average="macro", ignore_index=None),
        dict(average="macro", ignore_index=2),
        dict(average="macro", ignore_index=-1),
        dict(average="weighted", ignore_index=2, labels=True),
        dict(average="macro", ignore_index=None, extra_dim=True),
        dict(average="micro", ignore_index=2),
    ],
    ids=["macro", "ignore_2", "ignore_outside", "labels", "extra_dim", "micro_vmap_route"],
)
def test_k2s_route_ignore_index_and_out_of_range_labels(case):
    """The stat-scores kernel route (K2s; the micro case takes the vmap
    route) with ignored rows and out-of-range labels: every cell bitwise
    JAX's per-row updates segment-summed, and each exported cell bitwise an
    independent port metric fed that cohort's rows."""
    case = dict(case)
    labels, extra_dim = case.pop("labels", False), case.pop("extra_dim", False)
    batches = _k2_batches(7, labels=labels, extra_dim=extra_dim)
    jp, tp = _pair(lambda: J.classification.MulticlassStatScores(num_classes=NUM_CLASSES, **case, **_jkw()),
                   lambda: T.MulticlassStatScores(num_classes=NUM_CLASSES, **case, **_tkw()), batches, num_cells=NUM_CELLS)
    _assert_plans_equal(jp, tp)
    refs = _independent_refs(batches, lambda: T.MulticlassStatScores(num_classes=NUM_CLASSES, **case, **_tkw()))
    _assert_exports_match_refs(tp, refs, "k2s")


@pytest.mark.parametrize("family", ["multiclass", "multiclass_micro", "binary", "multilabel"])
@pytest.mark.parametrize("inputs", ["probs", "logits"])
def test_k1s_route_binned_curves(family, inputs):
    """The binned-curve kernel route (K1s: labels mode, and matrix mode for
    the micro curve, binary and multilabel): every cell bitwise JAX's
    per-row updates (each row's softmax/sigmoid decided on its own)
    segment-summed; with probabilities, each cell also equals an independent
    port metric."""
    rng = np.random.default_rng(8)
    thresholds = 16
    batches = []
    for _ in range(3):
        keys = rng.integers(0, NUM_COHORTS, BATCH).astype(np.int32)
        if family == "binary":
            preds = rng.random(BATCH).astype(np.float32) if inputs == "probs" else rng.standard_normal(BATCH).astype(np.float32)
            target = rng.integers(-1, 2, BATCH).astype(np.int32)
        elif family == "multilabel":
            x = rng.random((BATCH, NUM_CLASSES)) if inputs == "probs" else rng.standard_normal((BATCH, NUM_CLASSES))
            preds, target = x.astype(np.float32), rng.integers(-1, 2, (BATCH, NUM_CLASSES)).astype(np.int32)
        else:
            preds = _probs(rng, (BATCH, NUM_CLASSES)) if inputs == "probs" else rng.standard_normal((BATCH, NUM_CLASSES)).astype(np.float32)
            target = rng.integers(-1, NUM_CLASSES, BATCH).astype(np.int32)
        batches.append((keys, preds, target))
    kw = dict(thresholds=thresholds, ignore_index=-1)
    if family == "multiclass_micro":
        kw.update(num_classes=NUM_CLASSES, average="micro")
        jcls, tcls = J.classification.MulticlassPrecisionRecallCurve, T.MulticlassPrecisionRecallCurve
    elif family == "multiclass":
        kw.update(num_classes=NUM_CLASSES, average="macro")
        jcls, tcls = J.classification.MulticlassAUROC, T.MulticlassAUROC
    elif family == "binary":
        jcls, tcls = J.classification.BinaryAUROC, T.BinaryAUROC
    else:
        kw.update(num_labels=NUM_CLASSES)
        jcls, tcls = J.classification.MultilabelAUROC, T.MultilabelAUROC
    jp, tp = _pair(lambda: jcls(**kw, **_jkw()), lambda: tcls(**kw, **_tkw()), batches, num_cells=NUM_CELLS)
    _assert_plans_equal(jp, tp)
    for got, want in zip(*[jax.tree_util.tree_leaves(plan.compute_all()[cls.__name__]) for plan, cls in ((tp, tcls), (jp, jcls))]):
        _close(got, want)
    if inputs == "probs":
        refs = _independent_refs(batches, lambda: tcls(**kw, **_tkw()))
        _assert_exports_match_refs(tp, refs, "k1s")


# -------------------------------------------------------- the sketch folds


@pytest.mark.parametrize("kind", ["histogram", "hll"])
def test_serial_sketch_fold_equals_segmented(kind):
    """The private segmented fold of HistogramSketch / HLLSketch equals the
    serial merge fold in row order (JAX's ``_fold_sketch``), leaf for leaf,
    spilled rows included."""
    rng = np.random.default_rng(9)
    rows, cells_n = 40, 6
    if kind == "histogram":
        init = thist.hist_init(8, 0.0, 1.0, device="cpu")
        row_states = [thist.hist_update(init, torch.from_numpy(rng.random(3).astype(np.float32))) for _ in range(rows)]
    else:
        init = thll.hll_init(6, device="cpu")
        row_states = [thll.hll_update(init, torch.from_numpy(rng.integers(0, 1000, 5).astype(np.int32))) for _ in range(rows)]
    stacked = type(init)(*[torch.stack(leaves) for leaves in zip(*row_states)])
    cells = torch.from_numpy(rng.integers(-1, cells_n, rows).astype(np.int32))
    cells[cells == 3] = 4  # cell 3 receives nothing: its carry stays bitwise
    carry0 = type(init)(*[torch.stack([leaf] * cells_n).clone() for leaf in thist.hist_update(init, torch.tensor([0.5]))]) \
        if kind == "histogram" else type(init)(*[torch.stack([leaf] * cells_n).clone() for leaf in thll.hll_update(init, torch.tensor([7]))])
    serial = type(init)(*[leaf.clone() for leaf in carry0])
    _fold_sketch_(serial, stacked, cells)
    segmented = type(init)(*[leaf.clone() for leaf in carry0])
    seg = torch.where(cells >= 0, cells, cells_n).to(torch.int64)
    recv = torch.zeros(cells_n + 1, dtype=torch.bool).index_fill(0, seg, True)[:cells_n]
    part = _sketch_partial(type(init), stacked, seg, cells_n)
    leaves = dict(zip(type(init)._fields, segmented))
    for field, red in _SEGMENTED_SKETCHES[type(init)].items():
        _merge_cells_(red, leaves[field], part[field], recv)
    for field, a, b in zip(type(init)._fields, serial, segmented):
        assert torch.equal(a, b), field


def test_drift_sliced_plan_scores_cohorts_in_one_dispatch():
    """The bench leg's shape: one DriftScore sliced over cohort cells; the
    live histograms bitwise JAX's, drifted cohorts score high while
    in-distribution ones stay low, PSI within 1e-6 of JAX's."""
    rng = np.random.default_rng(10)
    reference = rng.normal(size=20_000).astype(np.float32)
    cells, per = 8, 512
    kw = dict(bins=32, lo=-4.0, hi=4.0, patience=1, distributed_available_fn=lambda: False)
    jp = JPlan(jdrift.DriftScore(reference=reference, **kw), num_cells=cells)
    tp = SlicedPlan(tdrift.DriftScore(reference=torch.from_numpy(reference), device="cpu", **kw), num_cells=cells)
    keys = np.arange(cells, dtype=np.int32)
    vals = (np.where(keys[:, None] < 4, 0.0, 3.0) + rng.normal(size=(cells, per))).astype(np.float32)
    jp.run_scan([np.repeat(keys, per)], [(jnp.asarray(vals.reshape(-1)),)])
    tp.run_scan([np.repeat(keys, per)], [(torch.from_numpy(vals.reshape(-1)),)])
    _assert_plans_equal(jp, tp)
    psi = tp.compute_all()["DriftScore"].psi
    assert psi.shape == (cells,)
    by_key = np.asarray([float(psi[tp.lookup(int(k))]) for k in keys])
    assert (by_key[4:] > 0.25).all()
    assert by_key[:4].max() * 10 < by_key[4:].min()
    np.testing.assert_allclose(psi.numpy(), np.asarray(jp.compute_all()["DriftScore"].psi), rtol=1e-5, atol=ATOL)


# -------------------------------------------------------- overflow and spill


def test_sliced_overflow_spills_and_preserves_residents():
    """More cohorts than cells: overflow rows DROP and count as spills (the
    same rows as JAX's); resident cells stay exact."""
    batches = _batches(2, seed=7, cohorts=12)
    jp, tp = _pair(lambda: J.classification.MulticlassAccuracy(num_classes=NUM_CLASSES, **_jkw()),
                   lambda: T.MulticlassAccuracy(num_classes=NUM_CLASSES, **_tkw()), batches, num_cells=4)
    _assert_plans_equal(jp, tp)
    assert tp.occupancy == 1.0 and tp.spills > 0 and tp.spills == jp.spills
    refs = _independent_refs(batches, lambda: T.MulticlassAccuracy(num_classes=NUM_CLASSES, **_tkw()))
    resident = tp.occupied_cells()
    assert len(resident) == 4
    for (k,) in resident:
        _assert_metric_bitwise(refs[k], tp.export_cell(k), f"resident {k}")
    spilled = sorted(set(refs) - {k for (k,) in resident})[0]
    with pytest.raises(KeyError, match="spilled or never seen"):
        tp.export_cell(spilled)


def test_sliced_cat_per_cell_overflow_raises_on_export():
    batches = _batches(3, seed=8, cohorts=2)
    jp, tp = _pair(lambda: J.classification.MulticlassAUROC(num_classes=NUM_CLASSES, thresholds=None, **_jkw()),
                   lambda: T.MulticlassAUROC(num_classes=NUM_CLASSES, thresholds=None, **_tkw()), batches,
                   num_cells=4, cat_capacity=8, example=batches[0][1:])
    _assert_plans_equal(jp, tp)  # the kept rows, counts and overflow latches
    with pytest.raises(RuntimeError, match="overflow"):
        tp.export_cell(0)


# ------------------------------------------------------------- eligibility


def _mean_state_class(pkg):
    class _MeanState(pkg.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("avg", jnp.zeros(()) if pkg is J else torch.zeros(()), dist_reduce_fx="mean")

        def update(self, preds, target):
            self.avg = preds.mean()

        def compute(self):
            return self.avg

    return _MeanState


def test_sliced_eligibility_refusals():
    jmean, tmean = _mean_state_class(J)(), _mean_state_class(T)(device="cpu")
    assert sliced_ineligibility(tmean) == J.parallel.sliced_ineligibility(jmean)
    assert "mean" in sliced_ineligibility(tmean)
    with pytest.raises(ValueError, match="mean") as t_err:
        tmean.sliced(num_cells=8)
    with pytest.raises(ValueError, match="mean") as j_err:
        jmean.sliced(num_cells=8)
    assert str(t_err.value) == str(j_err.value)
    assert sliced_ineligibility(T.MulticlassAccuracy(num_classes=3, **_tkw())) is None


def test_sliced_table_sizing_and_key_predicates():
    for bad, match in ((8.0, "static positive python int"), (0, ">= 1"), (True, "static positive python int")):
        with pytest.raises(ValueError, match=match) as t_err:
            SlicedPlan(T.MulticlassAccuracy(num_classes=3, **_tkw()), num_cells=bad)
        with pytest.raises(ValueError, match=match) as j_err:
            JPlan(J.classification.MulticlassAccuracy(num_classes=3, **_jkw()), num_cells=bad)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="integer"):
        SlicedPlan(T.MulticlassAccuracy(num_classes=3, **_tkw()), num_cells=8, example_keys=torch.tensor([1.5, 2.5]))
    plan = T.MulticlassAccuracy(num_classes=3, **_tkw()).sliced(num_cells=8)
    with pytest.raises(ValueError, match="integer"):
        plan.update(torch.tensor([0.5]), torch.zeros((1, 3)), torch.zeros((1,), dtype=torch.int32))
    assert slice_table_size_reason(16) is None
    assert slice_key_reason(torch.int32) is None and slice_key_reason(np.int64) is None
    assert slice_key_reason(np.float32) == J.parallel.slice_key_reason(jnp.float32)
    assert slice_key_reason(torch.float32) == J.parallel.slice_key_reason(jnp.float32)


def test_sliced_refuses_truncating_64bit_keys():
    """int64 cohort ids past int32 would silently ALIAS cohorts mod 2^32 —
    refused; in-range 64-bit host inputs (numpy, CPU tensors) still work."""
    plan = T.MulticlassAccuracy(num_classes=3, **_tkw()).sliced(num_cells=8)
    preds, target = torch.zeros((2, 3)), torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="alias"):
        plan.update(np.array([1, 2**32 + 1], dtype=np.int64), preds, target)
    with pytest.raises(ValueError, match="alias"):
        plan.update(torch.tensor([1, -(2**31) - 1]), preds, target)
    assert plan.updates_applied == 0
    plan.update(np.array([1, 2]), preds, target)
    plan.update(torch.tensor([3, 2]), preds, target)
    assert set(plan.occupied_cells()) == {(1,), (2,), (3,)}


def test_sliced_run_scan_validates_key_width():
    """A stacked scan key array gets the SAME key_width validation update()
    enforces — width-1 keys into a key_width=2 plan raise."""
    plan = T.MulticlassAccuracy(num_classes=3, **_tkw()).sliced(num_cells=8, key_width=2)
    batches = [(torch.zeros((4, 3)), torch.zeros((4,), dtype=torch.int32))]
    with pytest.raises(ValueError, match="key_width|component"):
        plan.run_scan(np.full((1, 4), 5, np.int32), batches)
    assert plan.updates_applied == 0


def test_sliced_refuses_dirty_template():
    metric = T.MulticlassAccuracy(num_classes=3, **_tkw())
    metric.update(torch.zeros((2, 3)), torch.zeros((2,), dtype=torch.int32))
    with pytest.raises(ValueError, match="pristine"):
        metric.sliced(num_cells=8)
    metric.reset()
    metric.sliced(num_cells=8)  # clean again: fine


def test_sliced_example_keys_infers_width():
    plan = T.MulticlassAccuracy(num_classes=3, **_tkw()).sliced(
        num_cells=8, example_keys=(torch.tensor([1, 2]), torch.tensor([3, 4]))
    )
    assert plan.key_width == 2
    with pytest.raises(ValueError, match="disagrees"):
        T.MulticlassAccuracy(num_classes=3, **_tkw()).sliced(num_cells=8, key_width=2, example_keys=torch.tensor([1, 2]))


def test_sliced_donate_false_state_is_a_copy():
    """donate=False: a read of plan.state is a copy later updates leave
    alone; donate=True: the carry itself (it aliases the next state)."""
    batches = _batches(2, seed=12)
    for donate in (True, False):
        plan = T.MulticlassAccuracy(num_classes=NUM_CLASSES, **_tkw()).sliced(num_cells=8, donate=donate)
        plan.update(*_t(batches[0]))
        before = plan.state
        snapshot = before["members"]["MulticlassAccuracy"]["tp"].clone()
        plan.update(*_t(batches[1]))
        moved = not torch.equal(before["members"]["MulticlassAccuracy"]["tp"], snapshot)
        assert moved == donate


# ---------------------------------------------------- durability negatives


def test_sliced_checkpoint_refuses_mismatches():
    """Each refusal of JAX's, with JAX's message; a failed restore touches
    nothing (validate-all-then-apply)."""
    batches = _batches(2, seed=9)

    def acc(pkg, classes=NUM_CLASSES):
        return (J.classification if pkg is J else T).MulticlassAccuracy(num_classes=classes, **(_jkw() if pkg is J else _tkw()))

    plan = acc(T).sliced(num_cells=NUM_CELLS)
    for b in batches:
        plan.update(*_t(b))
    payload = plan.save_checkpoint()
    corrupt = dict(payload, members={k: dict(v) for k, v in payload["members"].items()})
    corrupt["members"]["MulticlassAccuracy"]["tp"] = np.zeros((3, 3), np.float64)
    cases = [
        (lambda pkg: acc(pkg).sliced(num_cells=8), payload, "fingerprint"),
        (lambda pkg: acc(pkg, NUM_CLASSES + 1).sliced(num_cells=NUM_CELLS), payload, "fingerprint"),
        (lambda pkg: acc(pkg).sliced(num_cells=NUM_CELLS), dict(payload, sliced_format=99), "format"),
        (lambda pkg: acc(pkg).sliced(num_cells=NUM_CELLS), corrupt, "shape|leaf"),
    ]
    for build, bad, match in cases:
        target = build(T)
        before = target.save_checkpoint()
        with pytest.raises(StateRestoreError, match=match) as t_err:
            target.load_checkpoint(bad)
        with pytest.raises(JStateRestoreError, match=match) as j_err:
            build(J).load_checkpoint(bad)
        assert str(t_err.value).split(" expected")[0] == str(j_err.value).split(" expected")[0]
        _assert_payloads_equal(target.save_checkpoint(), before)


def test_sliced_live_probe_and_gauges_wait_for_a12():
    batches = _batches(1, seed=12)
    jp, plan = _pair(lambda: _suite(J), lambda: _suite(T), batches, num_cells=8, cat_capacity=64, example=batches[0][1:])
    probe = plan.live_probe()
    assert probe == jp.live_probe()
    assert 0.0 < probe["slice.table.occupancy"] <= 1.0 and probe["slice.table.MetricCollection.spills"] == 0.0
    assert plan.state_byte_sizes() == jp.state_byte_sizes()
    # the build identity: JAX's parts (process-local object ids among them), so it moves with the geometry
    assert plan._fingerprint() == plan._fingerprint() != SlicedPlan(_suite(T), num_cells=16, cat_capacity=64,
                                                                    example_batch=_t(batches[0][1:]))._fingerprint()
    # the name is kept from when publish_gauges refused: off, it publishes
    # nothing; under tracing its slice.table.* gauges equal JAX's
    from torchmetrics_tpu import obs as jobs
    from torchmetrics_tpu_torch import obs as tobs

    tobs.counter_clear()
    plan.publish_gauges()
    assert tobs.snapshot()["gauges"] == {}
    gauges = {}
    for pkg, p in ((jobs, jp), (tobs, plan)):
        with pkg.tracing():
            p.publish_gauges()
            gauges[pkg] = {k: v for k, v in pkg.snapshot()["gauges"].items() if k.startswith("slice.table")}
    assert gauges[tobs] == gauges[jobs] and gauges[tobs]["slice.table.cells"] == 8


# -------------------------------------------------------- the runner drive


def test_runner_sliced_target_kill_and_resume(tmp_path):
    """A SlicedPlan target through StreamingEvaluator: kind "sliced", the
    plan's stable fingerprint in the store, killed after batch 3 and resumed
    in a fresh plan: the carry bitwise the uninterrupted run's, compute_all
    the result, within ATOL of JAX's uninterrupted run."""
    batches = [(b[0], b[1], b[2]) for b in _batches(6, seed=11)]
    tbatches = [_t(b) for b in batches]

    def build():
        return T.MulticlassAccuracy(num_classes=NUM_CLASSES, **_tkw()).sliced(num_cells=NUM_CELLS)

    ref = build()
    want = StreamingEvaluator(ref).run(tbatches)
    store_dir = os.path.join(str(tmp_path), "s")
    victim = build()
    with pytest.raises(Exception):
        StreamingEvaluator(victim, store=CheckpointStore(store_dir, keep_last=3), snapshot_every_n=2).run(tbatches[:3] + [None])
    resumed = build()
    ev = StreamingEvaluator(resumed, store=CheckpointStore(store_dir, keep_last=3))
    got = ev.resume(tbatches)
    assert ev._kind() == "sliced" and ev.store.fingerprint == resumed.stable_fingerprint()
    _assert_payloads_equal(resumed.save_checkpoint(), ref.save_checkpoint())
    assert torch.equal(got["MulticlassAccuracy"], want["MulticlassAccuracy"])
    jp = J.classification.MulticlassAccuracy(num_classes=NUM_CLASSES, **_jkw()).sliced(num_cells=NUM_CELLS)
    for b in batches:
        jp.update(*_j(b))
    _close(got["MulticlassAccuracy"], jp.compute_all()["MulticlassAccuracy"])
