# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Retrieval of the port (the ten functions and the eleven module classes)
against the JAX package's: the cases of
``tests/unittests/retrieval/test_retrieval.py``, every ``top_k``,
``adaptive_k``, ``max_k`` and ``max_fpr`` branch, every
``empty_target_action`` and ``aggregation``, ``ignore_index``, and scores
with ties, signed zeros and NaN.

The same seeded numpy inputs go through both packages on the CPU. Budgets:

- the rank order is JAX's exactly (a stable descending sort: ties keep their
  column order, -0 ties +0, NaN sorts after every number);
- the list states are bitwise, dtypes included (int32 indexes, float32
  preds and targets); counts of hits are integers and exact;
- per-query values add float32 terms along each row (AP's precisions,
  DCG's discounted gains) in torch's order, and the aggregate mean over the
  queries in torch's: ``rtol=1e-6, atol=1e-6``. The curves' mean over the
  queries adds in XLA's CPU order, so a recall at a fixed precision picks
  JAX's k.

This file run as a script is the worker of the two-rank gloo test
(``python tests/test_torch_retrieval.py <rank> 2 <addr> retrieval
<out_dir>``); the worker imports no JAX.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np


def _stream(seed=3, n_queries=8, docs=16, round_to=0.1):
    """Flat (indexes, preds, target): queries of 4 to ``docs`` documents,
    scores rounded (ties), some zeros of either sign, queries in shuffled
    order, one query with no relevant document and one with no irrelevant."""
    rng = np.random.RandomState(seed)
    idx, preds, tgt = [], [], []
    for q in range(n_queries):
        n = rng.randint(4, docs)
        p = np.round(rng.rand(n) / round_to) * round_to
        p[rng.rand(n) < 0.15] = 0.0
        p[rng.rand(n) < 0.15] = -0.0
        t = (rng.rand(n) < 0.4).astype(np.int64)
        if q == 1:
            t[:] = 0
        if q == 2:
            t[:] = 1
        idx += [q * 7 % n_queries + 10] * n
        preds += list(p)
        tgt += list(t)
    order = rng.permutation(len(idx))
    return np.array(idx)[order], np.array(preds, dtype=np.float32)[order], np.array(tgt)[order]


def _worker(argv) -> None:
    """One rank: fold its queries (rank 0 the even ones, rank 1 the odd),
    compute (the list states gather across the group) and save the value
    and the gathered states."""
    import torch
    import torch.distributed as dist

    import torchmetrics_tpu_torch as T

    rank, world, addr, out_dir = int(argv[1]), int(argv[2]), argv[3], Path(argv[5])
    dist.init_process_group("gloo", init_method=addr, world_size=world, rank=rank)
    try:
        idx, preds, target = _stream(seed=8, n_queries=12)
        mine = (idx % 2) == rank
        metric = T.RetrievalMAP(device="cpu")
        for part in np.array_split(np.flatnonzero(mine), 2):
            metric.update(torch.from_numpy(preds[part]), torch.from_numpy(target[part]), indexes=torch.from_numpy(idx[part]))
        value = metric.compute()
        with metric.sync_context():
            gathered = {k: torch.cat(getattr(metric, k)).numpy() for k in ("indexes", "preds", "target")}
        np.savez(out_dir / f"rank{rank}.npz", value=value.numpy(), **gathered)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv)
    raise SystemExit(0)

# ------------------------------------------------------------------ the tests

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import sklearn.metrics as skm  # noqa: E402
import torch  # noqa: E402

import torchmetrics_tpu as J  # noqa: E402
import torchmetrics_tpu.functional as JFA  # noqa: E402
import torchmetrics_tpu.functional.retrieval as JF  # noqa: E402
import torchmetrics_tpu_torch as T  # noqa: E402
import torchmetrics_tpu_torch.functional as TFA  # noqa: E402
import torchmetrics_tpu_torch.functional.retrieval as TF  # noqa: E402
from torchmetrics_tpu.parallel.fused import fusion_ineligibility as j_fusion_ineligibility  # noqa: E402
from torchmetrics_tpu_torch.functional.retrieval.metrics import _rank_order  # noqa: E402
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402
from torchmetrics_tpu_torch.parallel.fused import fusion_ineligibility  # noqa: E402
from tests.test_torch_sync import run_workers  # noqa: E402

RTOL, ATOL = 1e-6, 1e-6
CLASSES = ["RetrievalMAP", "RetrievalMRR", "RetrievalPrecision", "RetrievalRecall", "RetrievalHitRate",
           "RetrievalFallOut", "RetrievalRPrecision", "RetrievalNormalizedDCG", "RetrievalAUROC",
           "RetrievalPrecisionRecallCurve", "RetrievalRecallAtFixedPrecision"]


def _np(x):
    return np.ascontiguousarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def _bitwise(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8), err_msg=what)


def _close(got, want, what=""):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]")
        return
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _raised(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


def _query(seed=0, n=20, nan=False):
    """One query: rounded scores (ties), signed zeros, a NaN where asked."""
    rng = np.random.RandomState(seed)
    preds = (np.round(rng.rand(n) * 5) / 5).astype(np.float32)
    preds[rng.rand(n) < 0.2] = 0.0
    preds[rng.rand(n) < 0.2] = -0.0
    if nan:
        preds[3] = np.nan
    target = (rng.rand(n) < 0.3).astype(np.int64)
    target[0], target[1] = 1, 0
    return preds, target


def test_rank_order_is_jnp_argsort_on_ties_zeros_and_nan():
    rows = [np.array([0.5, 0, -0.0, 0.5, np.nan, 0.2, -0.0, 0], np.float32)]
    rows += [_query(seed=s, n=40, nan=True)[0] for s in range(5)]
    rows += [np.array([-np.inf, 1.0, -np.inf, np.nan, 0.0, -0.0, np.nan, 1.0], np.float32)]
    for row in rows:
        want = np.asarray(jnp.argsort(-jnp.asarray(row)))
        np.testing.assert_array_equal(_np(_rank_order(torch.from_numpy(row))), want)


FUNCTIONAL_CASES = [
    ("retrieval_average_precision", {}), ("retrieval_average_precision", {"top_k": 4}),
    ("retrieval_average_precision", {"top_k": 50}),
    ("retrieval_reciprocal_rank", {}), ("retrieval_reciprocal_rank", {"top_k": 2}),
    ("retrieval_precision", {}), ("retrieval_precision", {"top_k": 5}), ("retrieval_precision", {"top_k": 50}),
    ("retrieval_precision", {"top_k": 50, "adaptive_k": True}), ("retrieval_precision", {"top_k": 3, "adaptive_k": True}),
    ("retrieval_recall", {}), ("retrieval_recall", {"top_k": 3}),
    ("retrieval_hit_rate", {}), ("retrieval_hit_rate", {"top_k": 1}),
    ("retrieval_fall_out", {}), ("retrieval_fall_out", {"top_k": 6}),
    ("retrieval_r_precision", {}),
    ("retrieval_normalized_dcg", {}), ("retrieval_normalized_dcg", {"top_k": 5}),
    ("retrieval_auroc", {}), ("retrieval_auroc", {"top_k": 8}), ("retrieval_auroc", {"max_fpr": 0.5}),
    ("retrieval_auroc", {"top_k": 12, "max_fpr": 0.3}),
    ("retrieval_precision_recall_curve", {}), ("retrieval_precision_recall_curve", {"max_k": 5}),
    ("retrieval_precision_recall_curve", {"max_k": 30}), ("retrieval_precision_recall_curve", {"max_k": 30, "adaptive_k": True}),
]


@pytest.mark.parametrize("name,kw", FUNCTIONAL_CASES, ids=lambda c: str(c))
def test_functional_matches_jax(name, kw):
    """One query with tied scores, signed zeros and a NaN."""
    preds, target = _query(seed=1, nan=True)
    want = getattr(JF, name)(preds, target, **kw)
    got = getattr(TF, name)(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    _close(got, want, name)


def test_graded_relevance_ndcg_matches_jax_and_sklearn():
    rng = np.random.RandomState(4)
    preds = np.round(rng.rand(25), 1).astype(np.float32)
    target = rng.randint(0, 4, 25)
    for kw in ({}, {"top_k": 7}):
        want = JF.retrieval_normalized_dcg(preds, target, **kw)
        got = TF.retrieval_normalized_dcg(torch.from_numpy(preds), torch.from_numpy(target), **kw)
        _close(got, want, "ndcg")
        np.testing.assert_allclose(float(got), skm.ndcg_score(target[None], preds[None], k=kw.get("top_k")), rtol=1e-5)


def test_functional_oracles():
    """JAX's oracles: sklearn's AP and AUROC on untied scores."""
    rng = np.random.RandomState(0)
    preds, target = rng.rand(30).astype(np.float32), (rng.rand(30) < 0.3).astype(np.int64)
    target[0] = 1
    tp, tt = torch.from_numpy(preds), torch.from_numpy(target)
    np.testing.assert_allclose(float(TF.retrieval_average_precision(tp, tt)), skm.average_precision_score(target, preds), rtol=1e-5)
    np.testing.assert_allclose(float(TF.retrieval_auroc(tp, tt)), skm.roc_auc_score(target, preds), rtol=1e-5)


@pytest.mark.parametrize("bad", [
    ("retrieval_recall", "shapes", {}), ("retrieval_recall", "empty", {}), ("retrieval_recall", "int_preds", {}),
    ("retrieval_recall", "non_binary", {}), ("retrieval_recall", "ok", {"top_k": 0}),
    ("retrieval_precision", "ok", {"adaptive_k": 1}), ("retrieval_precision_recall_curve", "ok", {"max_k": -1}),
    ("retrieval_auroc", "ok", {"top_k": 1.5}),
])
def test_functional_errors_match_jax(bad):
    name, kind, kw = bad
    preds, target = _query(seed=2)
    if kind == "shapes":
        preds = preds[:-1]
    elif kind == "empty":
        preds, target = preds[:0], target[:0]
    elif kind == "int_preds":
        preds = (preds * 10).astype(np.int32)
    elif kind == "non_binary":
        target = target * 3
    want = _raised(getattr(JF, name), preds, target, **kw)
    assert _raised(getattr(TF, name), torch.from_numpy(preds), torch.from_numpy(target), **kw) == want


def _module(pkg, name, **kw):
    extra = {} if pkg is J else {"device": "cpu"}
    return getattr(pkg, name)(**kw, **extra)


def _callable_agg(values, dim=None):
    """A custom aggregation both packages can call: the sum."""
    return values.sum() if dim is None else values.sum(dim)


def _class_kw(name):
    return {"RetrievalPrecision": {"top_k": 3}, "RetrievalRecall": {"top_k": 4}, "RetrievalHitRate": {"top_k": 2},
            "RetrievalFallOut": {"top_k": 3}, "RetrievalNormalizedDCG": {"top_k": 5}, "RetrievalMRR": {"top_k": 6},
            "RetrievalPrecisionRecallCurve": {"max_k": 6},
            "RetrievalRecallAtFixedPrecision": {"min_precision": 0.3, "max_k": 8}}.get(name, {})


MODULE_CASES = [(name, action, "mean") for name in CLASSES for action in ("neg", "pos", "skip")]
MODULE_CASES += [(name, "skip", agg) for name in CLASSES for agg in ("median", "min", "max", "callable")]


@pytest.mark.parametrize("name,action,agg", MODULE_CASES)
def test_module_matches_jax(name, action, agg):
    """Two batches of a shuffled stream into both: the list states bitwise,
    the fingerprint, the value; each state tree into a fresh metric of the
    other package, the same value."""
    kw = dict(_class_kw(name), empty_target_action=action, aggregation=_callable_agg if agg == "callable" else agg)
    jm, tm = _module(J, name, **kw), _module(T, name, **kw)
    idx, preds, target = _stream(seed=5)
    for part in np.array_split(np.arange(idx.size), 2):
        jm.update(preds[part], target[part], indexes=idx[part])
        tm.update(torch.from_numpy(preds[part]), torch.from_numpy(target[part]), indexes=torch.from_numpy(idx[part]))
    got_tree = state_to_numpy(tm)
    for state in ("indexes", "preds", "target"):
        _bitwise(np.concatenate([_np(x) for x in got_tree[state]]), np.concatenate([np.asarray(x) for x in jm.state_tree()[state]]), state)
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    want = jm.compute()
    _close(tm.compute(), want, name)

    fresh, jfresh = _module(T, name, **kw), _module(J, name, **kw)
    jtree = jm.state_tree(include_count=True)
    state_from_numpy(fresh, {k: v if k == "_update_count" else [np.asarray(x) for x in v] for k, v in jtree.items()},
                     fingerprint=jm.state_spec()["fingerprint"])
    _close(fresh.compute(), want, "JAX tree into the port")
    ttree = state_to_numpy(tm, include_count=True)
    jfresh.load_state_tree({k: v if k == "_update_count" else [jnp.asarray(x) for x in v] for k, v in ttree.items()})
    _close(tm.compute(), jfresh.compute(), "port tree into JAX")


@pytest.mark.parametrize("name", CLASSES)
def test_error_action_raises_as_jax(name):
    kw = dict(_class_kw(name), empty_target_action="error")
    idx, preds, target = _stream(seed=6)
    results = []
    for pkg in (J, T):
        metric = _module(pkg, name, **kw)
        conv = (lambda a: a) if pkg is J else torch.from_numpy
        metric.update(conv(preds), conv(target), indexes=conv(idx))
        results.append(_raised(metric.compute))
    assert results[0] == results[1] and results[1][0] is ValueError


def test_max_fpr_host_loop_matches_jax():
    idx, preds, target = _stream(seed=7, n_queries=6)
    for kw in ({"max_fpr": 0.5}, {"max_fpr": 0.2, "top_k": 6}, {"max_fpr": 1.0, "empty_target_action": "skip"}):
        jm, tm = _module(J, "RetrievalAUROC", **kw), _module(T, "RetrievalAUROC", **kw)
        jm.update(preds, target, indexes=idx)
        tm.update(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(idx))
        _close(tm.compute(), jm.compute(), str(kw))


def test_ignore_index_filters_before_the_emptiness_check():
    idx, preds, target = _stream(seed=9)
    target = np.where(np.random.RandomState(9).rand(target.size) < 0.2, -100, target)
    jm, tm = _module(J, "RetrievalMAP", ignore_index=-100), _module(T, "RetrievalMAP", ignore_index=-100)
    jm.update(preds, target, indexes=idx)
    tm.update(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(idx))
    _bitwise(_np(tm.indexes[0]), np.asarray(jm.indexes[0]), "indexes")
    _close(tm.compute(), jm.compute(), "ignore_index")
    allignored = np.full_like(target, -100)
    want = _raised(_module(J, "RetrievalMAP", ignore_index=-100).update, preds, allignored, indexes=idx)
    got = _raised(_module(T, "RetrievalMAP", ignore_index=-100).update, torch.from_numpy(preds),
                  torch.from_numpy(allignored), indexes=torch.from_numpy(idx))
    assert got == want and got[0] is ValueError


@pytest.mark.parametrize("kind", ["none_indexes", "float_indexes", "shapes", "scalar", "non_binary", "int_preds"])
def test_update_errors_match_jax(kind):
    idx, preds, target = _stream(seed=10)
    args = {"preds": preds, "target": target, "indexes": idx}
    if kind == "none_indexes":
        args["indexes"] = None
    elif kind == "float_indexes":
        args["indexes"] = idx.astype(np.float32)
    elif kind == "shapes":
        args["indexes"] = idx[:-1]
    elif kind == "scalar":
        args = {"preds": preds[0], "target": target[0], "indexes": idx[0]}
    elif kind == "non_binary":
        args["target"] = target * 2
    else:
        args["preds"] = (preds * 10).astype(np.int32)
    want = _raised(_module(J, "RetrievalMAP").update, **args)
    targs = {k: None if v is None else torch.from_numpy(np.array(v)) for k, v in args.items()}
    assert _raised(_module(T, "RetrievalMAP").update, **targs) == want


@pytest.mark.parametrize("kw", [
    {"empty_target_action": "drop"}, {"ignore_index": 1.5}, {"aggregation": "mode"}, {"top_k": -1},
])
def test_constructor_errors_match_jax(kw):
    assert _raised(_module, T, "RetrievalMAP", **kw) == _raised(_module, J, "RetrievalMAP", **kw)


@pytest.mark.parametrize("name,kw", [
    ("RetrievalAUROC", {"max_fpr": 1.5}), ("RetrievalPrecision", {"adaptive_k": "no"}),
    ("RetrievalPrecisionRecallCurve", {"max_k": 0}), ("RetrievalRecallAtFixedPrecision", {"min_precision": 2.0}),
])
def test_class_argument_errors_match_jax(name, kw):
    assert _raised(_module, T, name, **kw) == _raised(_module, J, name, **kw)


def test_fused_plan_equals_eager_bitwise():
    """Every retrieval class fuses in JAX and in the port (list states with a
    ``cat_capacity``); the port's fused fold equals its eager fold bitwise."""
    for name in CLASSES:
        assert fusion_ineligibility(_module(T, name)) == j_fusion_ineligibility(_module(J, name)) is None

    def suite():
        return T.MetricCollection({"map": _module(T, "RetrievalMAP"), "ndcg": _module(T, "RetrievalNormalizedDCG", top_k=5),
                                   "curve": _module(T, "RetrievalPrecisionRecallCurve", max_k=4)})

    idx, preds, target = _stream(seed=11, n_queries=12)
    parts = [np.arange(i * 24, (i + 1) * 24) for i in range(idx.size // 24)]
    batches = [(torch.from_numpy(preds[p]), torch.from_numpy(target[p]), torch.from_numpy(idx[p])) for p in parts]
    eager, fused = suite(), suite()
    for b in batches[:2]:
        fused.update(*b)
    fused.reset()
    plan = fused.fused(cat_capacity=24 * len(batches), example_batch=batches[0])
    for b in batches:
        eager.update(*b)
        plan.update(*b)
    plan.fold_back()
    want, got = eager.compute(), fused.compute()
    for key in want:
        w, g = (want[key], got[key]) if isinstance(want[key], tuple) else ((want[key],), (got[key],))
        for a, b in zip(g, w):
            _bitwise(a, b, key)


def test_two_rank_gather_equals_one_process(tmp_path):
    """Two gloo ranks, each with its half of the queries: ``compute`` gathers
    the list states and the value equals the port's and JAX's single-process
    fold of every query."""
    results = run_workers(Path(__file__), "retrieval", tmp_path, timeout=240)
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank}:\n{out}"
    idx, preds, target = _stream(seed=8, n_queries=12)
    alone, jalone = _module(T, "RetrievalMAP"), _module(J, "RetrievalMAP")
    alone.update(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(idx))
    jalone.update(preds, target, indexes=idx)
    for rank in range(2):
        saved = np.load(tmp_path / f"rank{rank}.npz")
        _bitwise(saved["value"], alone.compute(), f"rank {rank} value")
        _close(saved["value"], jalone.compute(), f"rank {rank} vs JAX")
        assert sorted(saved["indexes"].tolist()) == sorted(idx.tolist())
        assert saved["indexes"].dtype == np.int32 and saved["preds"].dtype == saved["target"].dtype == np.float32


def test_exports_equal_jax():
    import torchmetrics_tpu.retrieval as JR
    import torchmetrics_tpu_torch.retrieval as TR

    assert sorted(TR.__all__) == sorted(JR.__all__)
    assert sorted(TF.__all__) == sorted(JF.__all__)
    for name in TF.__all__:
        assert getattr(TFA, name) is getattr(TF, name) and name in JFA.__all__
    for name in CLASSES:
        assert getattr(T, name) is getattr(TR, name)
        for attr in ("higher_is_better", "is_differentiable", "full_state_update"):
            assert getattr(getattr(T, name), attr) == getattr(getattr(J, name), attr), (name, attr)
