# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Nominal association of the port (Cramér's V, Pearson's contingency
coefficient, Theil's U, Tschuprow's T, each with its ``*_matrix``, and Fleiss'
kappa; the five module classes) against the JAX package's: the nominal half
of ``tests/unittests/clustering/test_clustering_and_nominal.py``, with its
oracles, and every argument branch.

The same seeded numpy inputs go through both packages on the CPU. Budgets:

- the contingency tables are integer counts, bitwise (int32 per batch, the
  float32 ``confmat`` state adding them); so are Fleiss' count tables;
- the statistics are float32 sums over the table (chi squared, entropies)
  in another order than XLA's, and ``log`` and ``sqrt`` of their own
  libraries: ``rtol=1e-5, atol=1e-6``.
"""
from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu.functional as JFA
import torchmetrics_tpu.functional.nominal as JF
import torchmetrics_tpu_torch as T
import torchmetrics_tpu_torch.functional as TFA
import torchmetrics_tpu_torch.functional.nominal as TF
from torchmetrics_tpu.parallel.fused import fusion_ineligibility as j_fusion_ineligibility
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy
from torchmetrics_tpu_torch.parallel.fused import fusion_ineligibility

RTOL, ATOL = 1e-5, 1e-6
K = 5
STATS = ["cramers_v", "pearsons_contingency_coefficient", "theils_u", "tschuprows_t"]
BIASED = {"cramers_v", "tschuprows_t"}
CLASSES = {"cramers_v": "CramersV", "pearsons_contingency_coefficient": "PearsonsContingencyCoefficient",
           "theils_u": "TheilsU", "tschuprows_t": "TschuprowsT"}


def _np(x):
    return np.ascontiguousarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def _bitwise(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8), err_msg=what)


def _close(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _raised(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


def _labels(seed, n=300, k=K, dtype=np.int32):
    """Two associated categorical variables (the target a noisy copy of the preds)."""
    rng = np.random.RandomState(seed)
    preds = rng.randint(0, k, n)
    target = np.where(rng.rand(n) < 0.6, preds, rng.randint(0, k, n))
    return preds.astype(dtype), target.astype(dtype)


def _with_nans(seed):
    """Float labels with arbitrary category ids (7, 3.5, -2, ...) and NaNs in a tenth of each."""
    preds, target = _labels(seed, dtype=np.float32)
    ids = np.array([7.0, 3.5, -2.0, 0.0, 11.0], np.float32)
    preds, target = ids[preds.astype(int)], ids[target.astype(int)]
    rng = np.random.RandomState(seed + 1)
    preds[rng.rand(preds.size) < 0.1] = np.nan
    target[rng.rand(target.size) < 0.1] = np.nan
    return preds, target


def _call(pkg, name, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return getattr(pkg, name)(*args, **kw)


FUNCTIONAL_CASES = [(name, bias) for name in STATS for bias in ((True, False) if name in BIASED else (None,))]


@pytest.mark.parametrize("name,bias", FUNCTIONAL_CASES)
@pytest.mark.parametrize("inputs", ["labels", "float_nan_replace", "float_nan_drop", "replace_value", "logits"])
def test_functional_matches_jax(name, bias, inputs):
    kw = {} if bias is None else {"bias_correction": bias}
    if inputs == "labels":
        preds, target = _labels(1)
    elif inputs == "logits":  # 2-D inputs are argmaxed; their width is the class count
        rng = np.random.RandomState(2)
        preds = rng.randn(300, K).astype(np.float32)
        target = _labels(2)[1]
    else:
        preds, target = _with_nans(3)
        kw["nan_strategy"] = "drop" if inputs == "float_nan_drop" else "replace"
        if inputs == "replace_value":
            kw["nan_replace_value"] = 7
    want = _call(JF, name, preds, target, **kw)
    got = _call(TF, name, torch.from_numpy(preds), torch.from_numpy(target), **kw)
    _close(got, want, name)


@pytest.mark.parametrize("name", STATS)
def test_matrix_forms_match_jax(name):
    rng = np.random.RandomState(17)
    matrix = rng.randint(0, 3, (64, 4))
    matrix[:, 2] = (matrix[:, 0] + rng.randint(0, 2, 64)) % 3  # one associated pair
    want = _call(JF, f"{name}_matrix", matrix)
    got = _call(TF, f"{name}_matrix", torch.from_numpy(matrix))
    _close(got, want, f"{name}_matrix")
    assert np.all(np.diag(_np(got)) == 1.0)


@pytest.mark.parametrize("name", ["cramers_v", "tschuprows_t"])
def test_degenerate_bias_correction_warns_and_is_nan(name):
    """A 2 x 2 table of 2 samples: the corrected counts reach 1; both
    packages warn and answer NaN."""
    preds, target = np.array([0, 1], np.int32), np.array([0, 1], np.int32)
    with pytest.warns(UserWarning, match="Unable to compute"):
        want = getattr(JF, name)(preds, target, bias_correction=True)
    with pytest.warns(UserWarning, match="Unable to compute"):
        got = getattr(TF, name)(torch.from_numpy(preds), torch.from_numpy(target), bias_correction=True)
    assert np.isnan(float(got)) and np.isnan(float(want))


def test_oracles():
    """JAX's own oracles: chi-squared (scipy) for V, P and T, the reference
    formula for U, the Wikipedia worked example for Fleiss' kappa."""
    from scipy.stats import chi2_contingency

    preds, target = _labels(11, k=4)
    cm = np.zeros((4, 4))
    for a, b in zip(preds, target):
        cm[b, a] += 1
    chi2 = chi2_contingency(cm, correction=False)[0]
    n, r, c = cm.sum(), 4, 4
    phi2 = chi2 / n
    tp, tt = torch.from_numpy(preds), torch.from_numpy(target)
    np.testing.assert_allclose(float(TF.cramers_v(tp, tt, bias_correction=False)), np.sqrt(phi2 / min(r - 1, c - 1)), rtol=1e-4)
    np.testing.assert_allclose(float(TF.pearsons_contingency_coefficient(tp, tt)), np.sqrt(phi2 / (1 + phi2)), rtol=1e-4)
    np.testing.assert_allclose(float(TF.tschuprows_t(tp, tt, bias_correction=False)),
                               np.sqrt(phi2 / np.sqrt((r - 1) * (c - 1))), rtol=1e-4)
    p_xy, p_y = cm / n, cm.sum(1) / n
    with np.errstate(divide="ignore", invalid="ignore"):
        s_xy = np.nansum(p_xy * np.log(np.where(p_xy > 0, p_y[:, None] / p_xy, 1)))
    px = np.bincount(preds) / len(preds)
    s_x = -(px[px > 0] * np.log(px[px > 0])).sum()
    np.testing.assert_allclose(float(TF.theils_u(tp, tt)), (s_x - s_xy) / s_x, rtol=1e-4)
    counts = np.array([[0, 0, 0, 0, 14], [0, 2, 6, 4, 2], [0, 0, 3, 5, 6], [0, 3, 9, 2, 0], [2, 2, 8, 1, 1],
                       [7, 7, 0, 0, 0], [3, 2, 6, 3, 0], [2, 5, 3, 2, 2], [6, 5, 2, 1, 0], [0, 2, 2, 3, 7]], np.int32)
    np.testing.assert_allclose(float(TF.fleiss_kappa(torch.from_numpy(counts))), 0.2099, atol=1e-3)


@pytest.mark.parametrize("mode", ["counts", "probs"])
def test_fleiss_kappa_matches_jax(mode):
    rng = np.random.RandomState(5)
    if mode == "counts":
        ratings = rng.multinomial(10, [0.1, 0.2, 0.3, 0.4], size=200).astype(np.int64)
    else:
        ratings = rng.rand(200, 4, 6).astype(np.float32)
    want = JF.fleiss_kappa(ratings, mode=mode)
    _close(TF.fleiss_kappa(torch.from_numpy(ratings), mode=mode), want, mode)
    if mode == "probs":  # the count table the probs mode builds
        from torchmetrics_tpu.functional.nominal.metrics import _fleiss_kappa_update as j_update
        from torchmetrics_tpu_torch.functional.nominal.metrics import _fleiss_kappa_update as t_update

        _bitwise(t_update(torch.from_numpy(ratings), mode), j_update(jnp.asarray(ratings), mode), "counts")


@pytest.mark.parametrize("call", [
    ("cramers_v", {"nan_strategy": "ignore"}),
    ("theils_u", {"nan_strategy": "replace", "nan_replace_value": "x"}),
    ("fleiss_kappa", {"mode": "votes"}),
    ("fleiss_kappa_counts_float", {}),
    ("fleiss_kappa_probs_2d", {}),
])
def test_argument_errors_match_jax(call):
    name, kw = call
    preds, target = _labels(6)
    if name == "fleiss_kappa_counts_float":
        args, name = (preds.reshape(-1, 5).astype(np.float32),), "fleiss_kappa"
    elif name == "fleiss_kappa_probs_2d":
        args, name, kw = (preds.reshape(-1, 5).astype(np.float32),), "fleiss_kappa", {"mode": "probs"}
    elif name == "fleiss_kappa":
        args = (preds.reshape(-1, 5),)
    else:
        args = (preds, target)
    want = _raised(getattr(JF, name), *args, **kw)
    assert _raised(getattr(TF, name), *map(torch.from_numpy, args), **kw) == want


def _module(pkg, cls, **kw):
    extra = {} if pkg is J else {"device": "cpu"}
    return getattr(pkg, cls)(**kw, **extra)


@pytest.mark.parametrize("name", STATS)
@pytest.mark.parametrize("inputs", ["labels", "logits", "float_nan_drop"])
def test_module_states_values_and_checkpoints(name, inputs):
    """Three batches into both: the float32 ``confmat`` state bitwise (it
    adds exact counts), the value within the budget; the fingerprint; each
    state tree into a fresh metric of the other package."""
    cls = CLASSES[name]
    kw = {"num_classes": K}
    if inputs == "float_nan_drop":
        kw["nan_strategy"] = "drop"
    jm, tm = _module(J, cls, **kw), _module(T, cls, **kw)
    for seed in range(3):
        if inputs == "logits":
            rng = np.random.RandomState(30 + seed)
            preds, target = rng.randn(120, K).astype(np.float32), _labels(30 + seed, n=120)[1]
        else:
            preds, target = _labels(30 + seed, n=120, dtype=np.float32 if inputs == "float_nan_drop" else np.int32)
            if inputs == "float_nan_drop":
                preds[::17] = np.nan
        jm.update(preds, target)
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    _bitwise(state_to_numpy(tm)["confmat"], np.asarray(jm.confmat), "confmat")
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jm.compute()
        _close(tm.compute(), want, cls)
        fresh, jfresh = _module(T, cls, **kw), _module(J, cls, **kw)
        state_from_numpy(fresh, dict(jm.state_tree(include_count=True)), fingerprint=jm.state_spec()["fingerprint"])
        _close(fresh.compute(), want, "JAX tree into the port")
        jfresh.load_state_tree({k: v if k == "_update_count" else jnp.asarray(v)
                                for k, v in state_to_numpy(tm, include_count=True).items()})
        _close(tm.compute(), jfresh.compute(), "port tree into JAX")


def test_module_out_of_range_labels_raise_jax_error():
    preds, target = _labels(8)
    target[3] = K
    want = _raised(_module(J, "CramersV", num_classes=K).update, preds, target)
    got = _raised(_module(T, "CramersV", num_classes=K).update, torch.from_numpy(preds), torch.from_numpy(target))
    assert got == want and got[0] is ValueError


@pytest.mark.parametrize("kw", [{"num_classes": 0}, {"num_classes": 2.0}, {"num_classes": 3, "nan_strategy": "mean"}])
def test_module_argument_errors_match_jax(kw):
    assert _raised(_module, T, "TheilsU", **kw) == _raised(_module, J, "TheilsU", **kw)


def test_fleiss_kappa_module_matches_jax():
    rng = np.random.RandomState(9)
    counts = rng.multinomial(6, [0.2, 0.3, 0.5], size=90).astype(np.int32)
    jm, tm = _module(J, "FleissKappa"), _module(T, "FleissKappa")
    for part in np.array_split(counts, 3):
        jm.update(part)
        tm.update(torch.from_numpy(part))
    got = state_to_numpy(tm)["counts"]
    _bitwise(np.concatenate([_np(c) for c in got]) if isinstance(got, list) else got,
             np.concatenate([np.asarray(c) for c in jm.counts]), "counts")
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    _close(tm.compute(), jm.compute(), "FleissKappa")
    jp, tp = _module(J, "FleissKappa", mode="probs"), _module(T, "FleissKappa", mode="probs")
    probs = rng.rand(40, 3, 5).astype(np.float32)
    jp.update(probs)
    tp.update(torch.from_numpy(probs))
    _close(tp.compute(), jp.compute(), "FleissKappa probs")


def test_fused_plans_equal_eager_bitwise():
    """Every nominal class fuses in JAX and in the port; the fused folds of
    the four contingency metrics (one compute group) and of Fleiss' kappa
    (a cat state) equal the eager folds bitwise."""

    def suite(pkg):
        return pkg.MetricCollection({n: _module(pkg, c, num_classes=K) for n, c in CLASSES.items()})

    for name in [*CLASSES.values(), "FleissKappa"]:
        kw = {} if name == "FleissKappa" else {"num_classes": K}
        assert fusion_ineligibility(_module(T, name, **kw)) == j_fusion_ineligibility(_module(J, name, **kw)) is None
    rng = np.random.RandomState(40)
    batches = [(rng.randn(64, K).astype(np.float32), rng.randint(0, K, 64).astype(np.int32)) for _ in range(4)]
    eager, fused = suite(T), suite(T)
    for p, t in batches[:2]:
        fused.update(torch.from_numpy(p), torch.from_numpy(t))
    fused.reset()
    plan = fused.fused()
    for p, t in batches:
        eager.update(torch.from_numpy(p), torch.from_numpy(t))
        plan.update(torch.from_numpy(p), torch.from_numpy(t))
    plan.fold_back()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, got = eager.compute(), fused.compute()  # a compute group's members read their leader's states
    for key in CLASSES:
        _bitwise(got[key], want[key], key)
        _bitwise(state_to_numpy(dict.__getitem__(fused, key))["confmat"], state_to_numpy(dict.__getitem__(eager, key))["confmat"], key)

    counts = [rng.multinomial(6, [0.2, 0.3, 0.5], size=32).astype(np.int32) for _ in range(3)]
    fk_eager, fk = T.MetricCollection({"fk": _module(T, "FleissKappa")}), T.MetricCollection({"fk": _module(T, "FleissKappa")})
    for c in counts[:2]:
        fk.update(torch.from_numpy(c))
    fk.reset()
    fk_plan = fk.fused(cat_capacity=128, example_batch=(torch.from_numpy(counts[0]),))
    for c in counts:
        fk_eager.update(torch.from_numpy(c))
        fk_plan.update(torch.from_numpy(c))
    fk_plan.fold_back()
    _bitwise(fk.compute()["fk"], fk_eager.compute()["fk"], "FleissKappa fused")


def test_exports_equal_jax():
    import torchmetrics_tpu.nominal as JN
    import torchmetrics_tpu_torch.nominal as TN

    assert sorted(TN.__all__) == sorted(JN.__all__)
    assert sorted(TF.__all__) == sorted(JF.__all__)
    for name in TF.__all__:
        assert getattr(TFA, name) is getattr(TF, name) and name in JFA.__all__
    for name in TN.__all__:
        assert getattr(T, name) is getattr(TN, name)
