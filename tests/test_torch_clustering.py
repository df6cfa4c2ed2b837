# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Clustering of the port (the nine label-pair scores, the three intrinsic
scores, their helpers and the twelve module classes) against the JAX
package's: the clustering half of
``tests/unittests/clustering/test_clustering_and_nominal.py``, with its
sklearn oracles, and every argument branch.

The same seeded numpy inputs go through both packages on the CPU. Budgets:

- the contingency tables are int32 counts, bitwise; the pair confusion
  matrices and the expected mutual information are the same host numpy
  (int64, float64) on the same counts, bitwise; so are the cat states;
- the label-pair scores are float32 sums of logs over the table in another
  order than XLA's: ``rtol=1e-5, atol=1e-6``;
- the intrinsic scores sum over samples and features (the centroids are a
  one-hot product) in another order: ``rtol=1e-5, atol=1e-6``.
"""
from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import sklearn.metrics as skm
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu.functional as JFA
import torchmetrics_tpu.functional.clustering as JF
import torchmetrics_tpu_torch as T
import torchmetrics_tpu_torch.functional as TFA
import torchmetrics_tpu_torch.functional.clustering as TF
from torchmetrics_tpu.functional.clustering import utils as JU
from torchmetrics_tpu.parallel.fused import fusion_ineligibility as j_fusion_ineligibility
from torchmetrics_tpu_torch.functional.clustering import utils as TU
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy
from torchmetrics_tpu_torch.parallel.fused import fusion_ineligibility

RTOL, ATOL = 1e-5, 1e-6
N = 128
PAIR = ["mutual_info_score", "adjusted_mutual_info_score", "normalized_mutual_info_score", "rand_score",
        "adjusted_rand_score", "fowlkes_mallows_index", "homogeneity_score", "completeness_score", "v_measure_score"]
INTRINSIC = ["calinski_harabasz_score", "davies_bouldin_score", "dunn_index"]
ORACLES = {"mutual_info_score": skm.mutual_info_score, "adjusted_mutual_info_score": skm.adjusted_mutual_info_score,
           "normalized_mutual_info_score": skm.normalized_mutual_info_score, "rand_score": skm.rand_score,
           "adjusted_rand_score": skm.adjusted_rand_score, "fowlkes_mallows_index": skm.fowlkes_mallows_score,
           "homogeneity_score": skm.homogeneity_score, "completeness_score": skm.completeness_score,
           "v_measure_score": skm.v_measure_score}
CLASSES = {"mutual_info_score": "MutualInfoScore", "adjusted_mutual_info_score": "AdjustedMutualInfoScore",
           "normalized_mutual_info_score": "NormalizedMutualInfoScore", "rand_score": "RandScore",
           "adjusted_rand_score": "AdjustedRandScore", "fowlkes_mallows_index": "FowlkesMallowsIndex",
           "homogeneity_score": "HomogeneityScore", "completeness_score": "CompletenessScore",
           "v_measure_score": "VMeasureScore", "calinski_harabasz_score": "CalinskiHarabaszScore",
           "davies_bouldin_score": "DaviesBouldinScore", "dunn_index": "DunnIndex"}
METHODS = ["min", "geometric", "arithmetic", "max"]


def _np(x):
    return np.ascontiguousarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def _t(x):
    return torch.from_numpy(np.array(x))


def _bitwise(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8), err_msg=what)


def _close(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _raised(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


def _labels(seed=0, n=N, k=5, dtype=np.int32):
    """Two associated clusterings (the target a noisy copy of the preds, one more cluster)."""
    rng = np.random.RandomState(seed)
    preds = rng.randint(0, k, n)
    target = np.where(rng.rand(n) < 0.5, preds, rng.randint(0, k + 1, n))
    return preds.astype(dtype), target.astype(dtype)


def _blobs(seed=7, n=N, d=4, k=3, dtype=np.float32):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, k, n)
    data = rng.randn(n, d) + 3 * labels[:, None] + rng.randint(0, 2, (n, 1))
    return data.astype(dtype), labels.astype(np.int32)


def _pair_inputs(kind):
    if kind == "int32":
        return _labels(3)
    if kind == "int64":
        return _labels(4, dtype=np.int64)
    if kind == "float_whole":  # float labels holding whole numbers, negative and sparse ids
        preds, target = _labels(5)
        return (preds * 7 - 3).astype(np.float32), (target * 2 + 10).astype(np.float64)
    if kind == "identical":
        preds, _ = _labels(6)
        return preds, preds.copy()
    if kind == "one_cluster":  # a single predicted cluster: MI 0, completeness 1
        _, target = _labels(7)
        return np.zeros(N, np.int32), target
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["int32", "int64", "float_whole", "identical", "one_cluster"])
@pytest.mark.parametrize("name", PAIR)
def test_pair_scores_match_jax_and_sklearn(name, kind):
    preds, target = _pair_inputs(kind)
    want = getattr(JF, name)(preds, target)
    got = getattr(TF, name)(_t(preds), _t(target))
    _close(got, want, f"{name} {kind}")
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), ORACLES[name](target, preds), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", ["adjusted_mutual_info_score", "normalized_mutual_info_score"])
def test_average_methods_match_jax_and_sklearn(name, method):
    preds, target = _labels(11)
    _close(getattr(TF, name)(_t(preds), _t(target), method), getattr(JF, name)(preds, target, method), name)
    np.testing.assert_allclose(float(getattr(TF, name)(_t(preds), _t(target), method)),
                               ORACLES[name](target, preds, average_method=method), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("beta", [0.5, 1.0, 3.0])
def test_v_measure_beta_matches_jax_and_sklearn(beta):
    preds, target = _labels(12)
    got = TF.v_measure_score(_t(preds), _t(target), beta=beta)
    _close(got, JF.v_measure_score(preds, target, beta=beta), f"beta {beta}")
    np.testing.assert_allclose(float(got), skm.v_measure_score(target, preds, beta=beta), rtol=1e-4)


@pytest.mark.parametrize("eps", [None, 0.5])
@pytest.mark.parametrize("kind", ["int32", "float_whole", "one_cluster"])
def test_contingency_pair_matrix_and_emi_bitwise(kind, eps):
    """The contingency table (int32, or float32 with ``eps``), the 2 x 2
    pair confusion matrix and the expected MI equal JAX's bit for bit."""
    preds, target = _pair_inputs(kind)
    want = JU.calculate_contingency_matrix(jnp.asarray(preds), jnp.asarray(target), eps)
    got = TU.calculate_contingency_matrix(TU._f32(_t(preds)) if kind == "float_whole" else _t(preds),
                                          _t(target).to(torch.float32) if kind == "float_whole" else _t(target), eps)
    _bitwise(got, want, "contingency")
    if eps is None:
        _bitwise(TU.calculate_pair_cluster_confusion_matrix(contingency=got),
                 JU.calculate_pair_cluster_confusion_matrix(contingency=want), "pair matrix")
        _bitwise(TU.calculate_pair_cluster_confusion_matrix(_t(preds), _t(target)),
                 JU.calculate_pair_cluster_confusion_matrix(jnp.asarray(preds), jnp.asarray(target)), "pair matrix (labels)")
        from torchmetrics_tpu.functional.clustering.adjusted_mutual_info_score import expected_mutual_info_score as j_emi
        from torchmetrics_tpu_torch.functional.clustering.adjusted_mutual_info_score import expected_mutual_info_score as t_emi

        _bitwise(t_emi(got, preds.size), j_emi(want, preds.size), "expected MI")


def test_expected_mi_chunks_large_clusters_bitwise():
    """Clusters large enough that the nij axis runs in several chunks (the
    (R, C, chunk) grid's 2^24 bound), bitwise against JAX."""
    from torchmetrics_tpu.functional.clustering.adjusted_mutual_info_score import expected_mutual_info_score as j_emi
    from torchmetrics_tpu_torch.functional.clustering.adjusted_mutual_info_score import expected_mutual_info_score as t_emi

    rng = np.random.RandomState(13)
    cont = rng.randint(0, 20, (64, 64)).astype(np.int32)
    cont[0, 0] = 4200  # max_nij a little above the chunk, 2^24 / (64 * 64) = 4096: two chunks
    _bitwise(t_emi(_t(cont), int(cont.sum())), j_emi(jnp.asarray(cont), int(cont.sum())), "expected MI chunked")


@pytest.mark.parametrize("x", [[0, 0, 1, 1, 1, 5], [3, 3, 3], [], [2.0, -1.0, 2.0, 7.0]], ids=["ints", "one", "empty", "floats"])
def test_entropy_matches_jax(x):
    arr = np.asarray(x, np.float32 if any(isinstance(v, float) for v in x) else np.int32)
    _close(TU.calculate_entropy(_t(arr)), JU.calculate_entropy(jnp.asarray(arr)), "entropy")


@pytest.mark.parametrize("p", ["min", "geometric", "arithmetic", "max", 2, 0.5, -1.0])
def test_generalized_mean_matches_jax(p):
    x = np.array([0.3, 1.7, 0.9], np.float32)
    _close(TU.calculate_generalized_mean(_t(x), p), JU.calculate_generalized_mean(jnp.asarray(x), p), str(p))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", INTRINSIC)
def test_intrinsic_scores_match_jax_and_oracles(name, dtype):
    data, labels = _blobs(dtype=dtype)
    want = getattr(JF, name)(data, labels)
    got = getattr(TF, name)(_t(data), _t(labels))
    _close(got, want, name)
    if name == "dunn_index":  # JAX's oracle: centroid distances by hand
        cents = np.stack([data[labels == k].mean(0) for k in range(3)])
        inter = [np.linalg.norm(cents[a] - cents[b]) for a in range(3) for b in range(a + 1, 3)]
        intra = [np.linalg.norm(data[labels == k] - cents[k], axis=1).max() for k in range(3)]
        expected = min(inter) / max(intra)
    else:
        expected = getattr(skm, name)(data, labels)
    np.testing.assert_allclose(float(got), expected, rtol=1e-4)


@pytest.mark.parametrize("p", [1, 2, 3, 2.0, 0.5])
def test_dunn_index_p_matches_jax(p):
    data, labels = _blobs(seed=8, k=4)
    _close(TF.dunn_index(_t(data), _t(labels), p), JF.dunn_index(data, labels, p), f"p={p}")


def test_dunn_update_parts_match_jax():
    """The upper-triangle inter-centroid distances and the per-cluster max
    (``scatter_reduce`` for JAX's ``(N, K)`` masked max: the same values)."""
    from torchmetrics_tpu.functional.clustering.dunn_index import _dunn_index_update as j_update
    from torchmetrics_tpu_torch.functional.clustering.dunn_index import _dunn_index_update as t_update

    data, labels = _blobs(seed=9, k=5)
    for got, want in zip(t_update(_t(data), _t(labels), 2), j_update(jnp.asarray(data), jnp.asarray(labels), 2)):
        _close(got, want, "dunn parts")


@pytest.mark.parametrize("case", ["ch_zero_within", "db_zero_intra", "db_coincident_centroids"])
def test_intrinsic_degenerate_cases_match_jax(case):
    rng = np.random.RandomState(10)
    if case == "ch_zero_within":  # every sample on its centroid: 1.0
        labels = np.repeat(np.arange(3), 4).astype(np.int32)
        data = np.repeat(rng.randn(3, 2), 4, axis=0).astype(np.float32)
        name = "calinski_harabasz_score"
    elif case == "db_zero_intra":  # every intra distance 0: 0.0
        labels = np.repeat(np.arange(3), 4).astype(np.int32)
        data = np.repeat(rng.randn(3, 2), 4, axis=0).astype(np.float32)
        name = "davies_bouldin_score"
    else:  # two clusters with one centroid: their distance is inf in the max, the rest stands
        data = np.array([[0, 0], [2, 2], [1, 1], [1, 1], [5, 5], [6, 6]], np.float32)
        labels = np.array([0, 0, 1, 1, 2, 2], np.int32)
        name = "davies_bouldin_score"
    _close(getattr(TF, name)(_t(data), _t(labels)), getattr(JF, name)(data, labels), case)


def test_homogeneity_of_empty_labels_is_zero_as_in_jax():
    empty = np.zeros(0, np.int32)
    for name in ("homogeneity_score", "completeness_score"):
        _close(getattr(TF, name)(_t(empty), _t(empty)), getattr(JF, name)(empty, empty), name)


ERROR_CASES = [
    ("mutual_info_score", lambda: (np.zeros(4, np.int32), np.zeros(5, np.int32)), {}),
    ("rand_score", lambda: (np.zeros((2, 3), np.int32), np.zeros((2, 3), np.int32)), {}),
    ("adjusted_rand_score", lambda: (np.array([0.5, 1.0], np.float32), np.array([0, 1], np.int32)), {}),
    ("normalized_mutual_info_score", lambda: _labels(1), {"average_method": "median"}),
    ("adjusted_mutual_info_score", lambda: _labels(1), {"average_method": "harmonic"}),
    ("calinski_harabasz_score", lambda: (np.zeros(6, np.float32), np.zeros(6, np.int32)), {}),
    ("davies_bouldin_score", lambda: (np.zeros((6, 2), np.int32), np.zeros(6, np.int32)), {}),
    ("calinski_harabasz_score", lambda: (np.zeros((6, 2), np.float32), np.zeros((6, 1), np.int32)), {}),
    ("davies_bouldin_score", lambda: (np.ones((6, 2), np.float32), np.zeros(6, np.int32)), {}),
    ("calinski_harabasz_score", lambda: (np.ones((4, 2), np.float32), np.arange(4, dtype=np.int32)), {}),
]


@pytest.mark.parametrize("name,make,kw", ERROR_CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(ERROR_CASES)])
def test_argument_errors_match_jax(name, make, kw):
    args = make()
    want = _raised(getattr(JF, name), *args, **kw)
    assert _raised(getattr(TF, name), *map(_t, args), **kw) == want


def test_helper_errors_match_jax():
    for kw in ({}, {"preds": jnp.zeros(3), "target": jnp.zeros(3), "contingency": jnp.zeros((2, 2))}, {"preds": jnp.zeros(3)}):
        tkw = {k: _t(np.asarray(v)) for k, v in kw.items()}
        assert _raised(TU.calculate_pair_cluster_confusion_matrix, **tkw) == _raised(JU.calculate_pair_cluster_confusion_matrix, **kw)
    neg = np.array([0.5, -1.0], np.float32)
    assert _raised(TU.calculate_generalized_mean, _t(neg), "min") == _raised(JU.calculate_generalized_mean, jnp.asarray(neg), "min")
    x = np.array([0.5, 1.0], np.float32)
    assert _raised(TU.calculate_generalized_mean, _t(x), "mode") == _raised(JU.calculate_generalized_mean, jnp.asarray(x), "mode")


def _module(pkg, cls, **kw):
    extra = {} if pkg is J else {"device": "cpu"}
    return getattr(pkg, cls)(**kw, **extra)


MODULE_CASES = [(name, {}) for name in PAIR] + [
    ("adjusted_mutual_info_score", {"average_method": "max"}),
    ("normalized_mutual_info_score", {"average_method": "geometric"}),
    ("v_measure_score", {"beta": 2.0}),
] + [(name, {}) for name in INTRINSIC] + [("dunn_index", {"p": 3})]


@pytest.mark.parametrize("name,kw", MODULE_CASES, ids=[f"{n}-{'-'.join(map(str, k.values())) or 'default'}" for n, k in MODULE_CASES])
def test_module_states_values_and_checkpoints(name, kw):
    """Four batches into both: the cat states bitwise, the value within the
    budget; the fingerprint; each state tree into a fresh metric of the other package."""
    cls = CLASSES[name]
    jm, tm = _module(J, cls, **kw), _module(T, cls, **kw)
    if name in INTRINSIC:
        a, b = _blobs(seed=20, dtype=np.float64)
    else:
        a, b = _labels(21, dtype=np.int64)
    for i in range(4):
        part = slice(i * 32, (i + 1) * 32)
        jm.update(a[part], b[part])
        tm.update(_t(a[part]), _t(b[part]))
    jstates, tstates = jm.state_tree(), state_to_numpy(tm)
    for key in jstates:
        _bitwise(np.concatenate([_np(v) for v in tstates[key]]), np.concatenate([np.asarray(v) for v in jstates[key]]), key)
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    want = jm.compute()
    _close(tm.compute(), want, cls)
    np.testing.assert_allclose(float(want), float(getattr(JF, name)(a, b, *kw.values())), rtol=1e-6)
    fresh, jfresh = _module(T, cls, **kw), _module(J, cls, **kw)
    state_from_numpy(fresh, dict(jm.state_tree(include_count=True)), fingerprint=jm.state_spec()["fingerprint"])
    _close(fresh.compute(), want, "JAX tree into the port")
    jfresh.load_state_tree({k: v if k == "_update_count" else [jnp.asarray(x) for x in v]
                            for k, v in state_to_numpy(tm, include_count=True).items()})
    _close(tm.compute(), jfresh.compute(), "port tree into JAX")


@pytest.mark.parametrize("cls,kw", [("VMeasureScore", {"beta": 1}), ("VMeasureScore", {"beta": -1.0}),
                                    ("AdjustedMutualInfoScore", {"average_method": "mean"}),
                                    ("NormalizedMutualInfoScore", {"average_method": 3})])
def test_module_argument_errors_match_jax(cls, kw):
    assert _raised(_module, T, cls, **kw) == _raised(_module, J, cls, **kw)


@pytest.mark.parametrize("cls", sorted(set(CLASSES.values())))
def test_class_attributes_and_fusion_eligibility_equal_jax(cls):
    jm, tm = _module(J, cls), _module(T, cls)
    for attr in ("is_differentiable", "higher_is_better", "full_state_update", "plot_lower_bound", "plot_upper_bound"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert fusion_ineligibility(tm) == j_fusion_ineligibility(jm)


def test_exports_equal_jax():
    import torchmetrics_tpu.clustering as JC
    import torchmetrics_tpu_torch.clustering as TC

    assert sorted(TC.__all__) == sorted(JC.__all__)
    assert sorted(TF.__all__) == sorted(JF.__all__)
    for name in TF.__all__:
        assert getattr(TFA, name) is getattr(TF, name) and name in JFA.__all__
    for name in TC.__all__:
        assert getattr(T, name) is getattr(TC, name) and name in T.__all__


def test_sklearn_oracles_through_the_module_as_in_jax():
    """JAX's own test: each label-pair class over four batches of 32 equals sklearn's score on the whole stream."""
    preds, target = _labels(3, k=5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, cls in CLASSES.items():
            if name in INTRINSIC:
                continue
            m = _module(T, cls)
            for i in range(4):
                m.update(_t(preds[i * 32 : (i + 1) * 32]), _t(target[i * 32 : (i + 1) * 32]))
            np.testing.assert_allclose(float(m.compute()), ORACLES[name](target, preds), rtol=1e-4, atol=1e-6)
