# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Pairwise similarities and distances of the port against the JAX
package's (the pairwise half of
``tests/unittests/pairwise_segmentation/test_pairwise_segmentation.py``, with
its sklearn oracles, and every argument branch).

The same seeded numpy inputs go through both packages on the CPU. Budgets:

- cosine and linear are one matrix product, which XLA and torch add in
  their own orders: ``rtol=1e-5, atol=1e-6`` (the products are O(d) = O(8));
- euclidean expands ``‖x‖² + ‖y‖² - 2⟨x, y⟩``, which cancels where rows
  are close: the squared distances agree within ``1e-6 * (‖x‖² + ‖y‖²)``;
  the distances are held to that budget through the square root
  (``|a - b| <= sqrt(|a² - b²|)``);
- manhattan and minkowski reduce the broadcast ``(N, M, d)`` difference in
  another order: ``rtol=1e-5, atol=1e-6``;
- the zeroed diagonal is exactly zero in both.
"""
from __future__ import annotations

import numpy as np
import pytest
import sklearn.metrics.pairwise as skp
import torch

import torchmetrics_tpu.functional as JF
import torchmetrics_tpu.functional.pairwise as JP
import torchmetrics_tpu_torch.functional as TF
import torchmetrics_tpu_torch.functional.pairwise as TP
from torchmetrics_tpu_torch.utilities.compute import _safe_matmul

RTOL, ATOL = 1e-5, 1e-6
EUCLID_REL = 1e-6
FUNCTIONS = ["pairwise_cosine_similarity", "pairwise_euclidean_distance", "pairwise_linear_similarity",
             "pairwise_manhattan_distance", "pairwise_minkowski_distance"]


def _xy(seed=0, n=24, m=16, d=8):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d).astype(np.float32), rng.randn(m, d).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _check(name, got, want, x, y):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (name, got.dtype, want.dtype, got.shape, want.shape)
    if name == "pairwise_euclidean_distance":
        y = x if y is None else y
        scale = (x.astype(np.float64) ** 2).sum(1)[:, None] + (y.astype(np.float64) ** 2).sum(1)[None, :]
        if got.ndim == 2:
            assert np.all(np.abs(got.astype(np.float64) - want) <= np.sqrt(EUCLID_REL * scale) + 1e-6), name
        else:  # a reduction over the row: the mean or sum of budgets
            budget = np.sqrt(EUCLID_REL * scale).sum(-1) + 1e-6 * scale.shape[-1]
            assert np.all(np.abs(got.astype(np.float64) - want) <= budget), name
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)


def _kwargs(name, exponent):
    return {"exponent": exponent} if name == "pairwise_minkowski_distance" else {}


@pytest.mark.parametrize("name", FUNCTIONS)
@pytest.mark.parametrize("with_y", [True, False])
@pytest.mark.parametrize("zero_diagonal", [None, True, False])
@pytest.mark.parametrize("reduction", [None, "none", "mean", "sum"])
def test_matches_jax(name, with_y, zero_diagonal, reduction):
    x, y = _xy(seed=1)
    y = y if with_y else None
    kw = dict(_kwargs(name, 3), reduction=reduction, zero_diagonal=zero_diagonal)
    want = getattr(JP, name)(x, y, **kw)
    got = getattr(TP, name)(_t(x), _t(y), **kw)
    _check(name, got, want, x, y)
    if reduction in (None, "none") and (zero_diagonal or (zero_diagonal is None and not with_y)):
        assert np.all(np.diagonal(_np(got)) == 0)


@pytest.mark.parametrize("exponent", [1, 1.5, 2, 3, 4.0])
def test_minkowski_exponents_match_jax(exponent):
    x, y = _xy(seed=2)
    want = JP.pairwise_minkowski_distance(x, y, exponent=exponent)
    _check("pairwise_minkowski_distance", TP.pairwise_minkowski_distance(_t(x), _t(y), exponent=exponent), want, x, y)


@pytest.mark.parametrize("name,oracle,kwargs", [
    ("pairwise_cosine_similarity", skp.cosine_similarity, {}),
    ("pairwise_euclidean_distance", skp.euclidean_distances, {}),
    ("pairwise_linear_similarity", skp.linear_kernel, {}),
    ("pairwise_manhattan_distance", skp.manhattan_distances, {}),
    ("pairwise_minkowski_distance", lambda x, y: skp.distance_metrics()["manhattan"](x, y), {"exponent": 1}),
])
def test_sklearn_oracles(name, oracle, kwargs):
    """JAX's test of the same functions, against the same oracles."""
    x, y = _xy()
    fn = getattr(TF, name)
    np.testing.assert_allclose(_np(fn(_t(x), _t(y), **kwargs)), oracle(x, y), rtol=1e-4, atol=1e-4)
    expected = oracle(x, x)
    np.fill_diagonal(expected, 0)
    np.testing.assert_allclose(_np(fn(_t(x), **kwargs)), expected, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(fn(_t(x), _t(y), reduction="mean", **kwargs)), oracle(x, y).mean(-1), rtol=1e-4, atol=1e-4)


def test_close_rows_stay_within_the_euclidean_budget():
    """Rows a hair apart: the expansion cancels, in both packages alike, and
    the distance stays within the stated budget of the exact one."""
    x, _ = _xy(seed=3)
    y = x + np.float32(1e-3)
    want = JP.pairwise_euclidean_distance(x, y)
    got = TP.pairwise_euclidean_distance(_t(x), _t(y))
    _check("pairwise_euclidean_distance", got, want, x, y)
    exact = np.sqrt(((x[:, None, :].astype(np.float64) - y[None, :, :]) ** 2).sum(-1))
    _check("pairwise_euclidean_distance", got, exact.astype(np.float32), x, y)


@pytest.mark.parametrize("dtype", [np.float16, np.float64])
@pytest.mark.parametrize("name", ["pairwise_cosine_similarity", "pairwise_linear_similarity"])
def test_input_dtypes_match_jax(dtype, name):
    """Half precision multiplies in float32 and comes back half
    (``_safe_matmul``); float64 is narrowed to float32, as ``jnp.asarray``
    narrows it."""
    x, y = _xy(seed=4)
    x, y = x.astype(dtype), y.astype(dtype)
    want = _np(getattr(JP, name)(x, y))
    got = _np(getattr(TP, name)(_t(x), _t(y)))
    assert got.dtype == want.dtype
    tol = 2e-3 if dtype == np.float16 else RTOL
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), rtol=tol, atol=tol)


def test_safe_matmul_promotes_half_precision():
    a = torch.randn(3, 4, dtype=torch.bfloat16)
    b = torch.randn(5, 4, dtype=torch.bfloat16)
    out = _safe_matmul(a, b)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, (a.float() @ b.float().T).to(torch.bfloat16))
    assert torch.equal(_safe_matmul(a.float(), b.float()), a.float() @ b.float().T)


def test_the_port_leaves_tf32_off():
    """Importing the port switches no TF32 flag on (the products stay float32 on the card)."""
    import torchmetrics_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False


def _raised(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_input_errors_match_jax(name):
    x, y = _xy(seed=5)
    for args, kw in [((x[0],), {}), ((x, y[:, :3]), {}), ((x, y[None]), {}), ((x, y), {"reduction": "max"})]:
        want = _raised(getattr(JP, name), *args, **kw)
        got = _raised(getattr(TP, name), *map(_t, args), **kw)
        assert got[0] is want[0] and got[1].split(" but got")[0] == want[1].split(" but got")[0], (got, want)


@pytest.mark.parametrize("exponent", [0.5, -1, "2", None])
def test_minkowski_exponent_errors_match_jax(exponent):
    x, y = _xy(seed=6)
    want = _raised(JP.pairwise_minkowski_distance, x, y, exponent=exponent)
    assert _raised(TP.pairwise_minkowski_distance, _t(x), _t(y), exponent=exponent) == want


def test_exports_equal_jax():
    assert sorted(TP.__all__) == sorted(JP.__all__)
    for name in TP.__all__:
        assert getattr(TF, name) is getattr(TP, name) and name in TF.__all__ and name in JF.__all__
