# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The regression metrics of the port against the JAX package's: every
functional and module class, on the same seeded numpy inputs, on the CPU.

Budgets:

- integer count states are bitwise, dtype included (int32): every
  ``total``, ``num_observations``, CSI's hits, misses and false alarms;
  so are the float counts (Pearson's ``n_total``, explained variance's
  ``num_obs``, MAPE's ``total``: sums of whole numbers), the ``cat``
  states (the inputs as float32), the Kendall pair census in both of its
  accumulators, the tie-averaged Spearman ranks and the CSI value (one
  division of exact counts);
- float sums add in another order than XLA's (every ``jnp.sum``, the norm of
  ``jnp.linalg.norm``, the means of Spearman's Pearson-on-ranks), and
  ``torch.pow``, ``torch.log1p``, ``torch.logaddexp`` and ``torch.log`` may
  differ from XLA's by ulps: states and values within ``rtol=1e-6`` with
  ``atol=1e-6`` times the magnitude of the data they sum (``ATOL``), which
  covers sums that cancel to near zero;
- values derived through a difference of large sums (R², relative squared
  error and explained variance subtract the squared mean from the mean
  square; the Pearson merge of shards) amplify those ulps: ``rtol=1e-5``
  (``DERIVED_RTOL``);
- Kendall's p-values are ``1 + erf(t)`` through ``torch.special.erf``,
  which differs from XLA's by ulps: ``rtol=1e-5``, and ``atol=3e-7`` (five
  float32 ulps below 1.0) where ``erf(t)`` is near -1 and the sum cancels.

The JAX package's Kendall tau-b and tau-c raise ``OverflowError`` from about
620 rows, with or without ``t_test`` (``9 * m * (n - 2)``, a Python int
above the int32 range, meets a float32 array); the port computes them, so
comparisons with JAX stay below that and larger inputs are held against
``scipy.stats.kendalltau``.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu.functional as JFA
import torchmetrics_tpu.functional.regression as JF
import torchmetrics_tpu.regression as JR
import torchmetrics_tpu_torch as T
import torchmetrics_tpu_torch.functional as TFA
import torchmetrics_tpu_torch.functional.regression as TF
import torchmetrics_tpu_torch.regression as TR
from torchmetrics_tpu.utilities.exceptions import StateRestoreError as JStateRestoreError
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy
from torchmetrics_tpu_torch.utilities.exceptions import StateRestoreError

N, D, ROWS = 240, 3, 16
RTOL, ATOL = 1e-6, 1e-6
DERIVED_RTOL = 1e-5
P_RTOL, P_ATOL = 1e-5, 3e-7


def _jmod(name):
    return importlib.import_module(f"torchmetrics_tpu.functional.regression.{name}")


def _tmod(name):
    return importlib.import_module(f"torchmetrics_tpu_torch.functional.regression.{name}")


def _data(kind, seed, n=N):
    """Seeded float32 ``(preds, target)`` of a kind: ``single`` (N,), ``multi``
    (N, D), ``positive`` (N,) in (0.05, 3], ``rows`` (N, ROWS) positive rows,
    ``logrows`` (N, ROWS) log-probabilities, ``seq`` (4, N // 4) for CSI."""
    rng = np.random.default_rng(seed)
    if kind == "single":
        preds = rng.standard_normal(n) * 2
        target = preds + rng.standard_normal(n)
    elif kind == "multi":
        preds = rng.standard_normal((n, D)) * 2
        target = preds * np.array([1.0, -0.5, 0.1]) + rng.standard_normal((n, D))
    elif kind == "positive":
        preds = rng.uniform(0.05, 3, n)
        target = np.clip(preds + rng.standard_normal(n) * 0.3, 0.05, None)
    elif kind == "rows":
        preds = rng.uniform(0.01, 1, (n, ROWS))
        target = rng.uniform(0.01, 1, (n, ROWS))
    elif kind == "logrows":
        a, b = rng.standard_normal((n, ROWS)), rng.standard_normal((n, ROWS))
        preds = a - np.log(np.exp(a).sum(1, keepdims=True))
        target = b - np.log(np.exp(b).sum(1, keepdims=True))
    else:  # seq
        preds = rng.uniform(0, 1, (4, n // 4))
        target = rng.uniform(0, 1, (4, n // 4))
    return preds.astype(np.float32), target.astype(np.float32)


def _np(x):
    return np.ascontiguousarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def _flat(value):
    """A state as one array: list states concatenated."""
    if isinstance(value, list):
        return np.concatenate([np.atleast_1d(_np(v)) for v in value]) if value else np.zeros(0, np.float32)
    return _np(value)


def _bitwise(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8)), (what, got, want)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), (what, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, rtol, atol, f"{what}[{i}]")
        return
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _both(jfn, tfn, *arrays, **kw):
    want = jfn(*[jnp.asarray(a) for a in arrays], **kw)
    got = tfn(*[torch.from_numpy(np.array(a)) for a in arrays], **kw)
    return got, want


def _raised(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value).__name__, str(info.value)


# ---------------------------------------------------------------- functionals

FUNCTIONAL_CASES = [
    ("mean_squared_error", "single", {}),
    ("mean_squared_error", "single", {"squared": False}),
    ("mean_squared_error", "multi", {"num_outputs": D}),
    ("mean_absolute_error", "single", {}),
    ("mean_absolute_error", "multi", {"num_outputs": D}),
    ("mean_squared_log_error", "positive", {}),
    ("mean_absolute_percentage_error", "single", {}),
    ("symmetric_mean_absolute_percentage_error", "single", {}),
    ("weighted_mean_absolute_percentage_error", "single", {}),
    ("minkowski_distance", "single", {"p": 1}),
    ("minkowski_distance", "single", {"p": 3}),
    ("minkowski_distance", "single", {"p": 2.5}),
    ("log_cosh_error", "single", {}),
    ("log_cosh_error", "multi", {}),
    ("tweedie_deviance_score", "single", {"power": 0.0}),
    ("tweedie_deviance_score", "positive", {"power": 1}),
    ("tweedie_deviance_score", "positive", {"power": 1.5}),
    ("tweedie_deviance_score", "positive", {"power": 2}),
    ("tweedie_deviance_score", "positive", {"power": 3}),
    ("tweedie_deviance_score", "positive", {"power": -0.5}),
    ("relative_squared_error", "single", {}),
    ("relative_squared_error", "multi", {"squared": False}),
    ("r2_score", "single", {}),
    ("r2_score", "multi", {"multioutput": "raw_values"}),
    ("r2_score", "multi", {"multioutput": "variance_weighted"}),
    ("r2_score", "single", {"adjusted": 3}),
    ("explained_variance", "single", {}),
    ("explained_variance", "multi", {"multioutput": "raw_values"}),
    ("explained_variance", "multi", {"multioutput": "variance_weighted"}),
    ("critical_success_index", "single", {"threshold": 0.5}),
    ("critical_success_index", "seq", {"threshold": 0.5, "keep_sequence_dim": 0}),
    ("kl_divergence", "rows", {}),
    ("kl_divergence", "rows", {"reduction": "sum"}),
    ("kl_divergence", "rows", {"reduction": "none"}),
    ("kl_divergence", "logrows", {"log_prob": True}),
    ("pearson_corrcoef", "single", {}),
    ("pearson_corrcoef", "multi", {}),
    ("concordance_corrcoef", "single", {}),
    ("concordance_corrcoef", "multi", {}),
    ("cosine_similarity", "rows", {}),
    ("cosine_similarity", "rows", {"reduction": "mean"}),
    ("cosine_similarity", "rows", {"reduction": "none"}),
    ("spearman_corrcoef", "single", {}),
    ("spearman_corrcoef", "multi", {}),
    ("kendall_rank_corrcoef", "single", {"variant": "a"}),
    ("kendall_rank_corrcoef", "single", {"variant": "b"}),
    ("kendall_rank_corrcoef", "single", {"variant": "c"}),
    ("kendall_rank_corrcoef", "multi", {"variant": "b", "t_test": True}),
    ("kendall_rank_corrcoef", "single", {"variant": "a", "t_test": True, "alternative": "less"}),
    ("kendall_rank_corrcoef", "single", {"variant": "c", "t_test": True, "alternative": "greater"}),
]

#: functionals whose value is derived through a difference of large sums
DERIVED = {"r2_score", "relative_squared_error", "explained_variance"}


def _case_id(case):
    name, kind, kw = case
    return "-".join([name, kind] + [f"{k}={v}" for k, v in kw.items()])


@pytest.mark.parametrize("case", FUNCTIONAL_CASES, ids=_case_id)
def test_functional_matches_jax(case):
    name, kind, kw = case
    preds, target = _data(kind, seed=len(name) + len(kw))
    got, want = _both(getattr(JF, name), getattr(TF, name), preds, target, **kw)
    if name == "critical_success_index":
        _bitwise(got, want, name)
    elif name == "kendall_rank_corrcoef" and kw.get("t_test"):
        _close(got[0], want[0], what="tau")
        _close(got[1], want[1], P_RTOL, P_ATOL, "p-value")
    else:
        _close(got, want, DERIVED_RTOL if name in DERIVED else RTOL, what=name)
    # the flat functional namespace re-exports it
    assert getattr(TFA, name) is getattr(TF, name) and hasattr(JFA, name)


def test_cpu_tensors_stay_on_the_cpu_and_numpy_asks_for_the_card():
    preds, target = _data("single", seed=1)
    got = TF.mean_squared_error(torch.from_numpy(preds), torch.from_numpy(target))
    assert got.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TF.mean_squared_error(preds, target)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TR.MeanSquaredError()


def test_log_cosh_softplus_is_jax_softplus_for_large_errors():
    """``logaddexp(x, 0)`` where ``torch.nn.functional.softplus`` would switch
    to the identity above 20: errors of every size, up to 1e30."""
    diff = np.concatenate([np.geomspace(1e-6, 1e30, 60), -np.geomspace(1e-6, 1e30, 60), [0.0, 9.9, 10.1, 25.0, -25.0]])
    preds = diff.astype(np.float32)
    target = np.zeros_like(preds)
    jsum, jn = _jmod("log_cosh")._log_cosh_error_update(jnp.asarray(preds), jnp.asarray(target), 1)
    tsum, tn = _tmod("log_cosh")._log_cosh_error_update(torch.from_numpy(preds), torch.from_numpy(target), 1)
    _bitwise(tn, jn, "count")
    _close(tsum, jsum, what="sum")
    for x in preds[:8]:  # one element each: no summation order involved
        one = np.array([x], np.float32)
        g, _ = _tmod("log_cosh")._log_cosh_error_update(torch.from_numpy(one), torch.zeros(1), 1)
        w, _ = _jmod("log_cosh")._log_cosh_error_update(jnp.asarray(one), jnp.zeros(1, jnp.float32), 1)
        _close(g, w, what=f"log_cosh({x})")


def test_tweedie_domain_errors_match_jax():
    preds, target = _data("positive", seed=4)
    for power, p, t in [(1, -preds, target), (2, preds, -target), (-0.5, -preds, target), (1.5, preds, -target),
                        (3, preds, np.zeros_like(target)), (0.5, preds, target)]:
        want = _raised(J.functional.tweedie_deviance_score, jnp.asarray(p), jnp.asarray(t), power=power)
        got = _raised(T.functional.tweedie_deviance_score, torch.from_numpy(p), torch.from_numpy(t), power=power)
        assert got == want, power


# -------------------------------------------------------------------- modules

MODULE_CASES = [
    ("MeanSquaredError", "single", {}),
    ("MeanSquaredError", "single", {"squared": False}),
    ("MeanSquaredError", "multi", {"num_outputs": D}),
    ("MeanAbsoluteError", "single", {}),
    ("MeanAbsoluteError", "multi", {"num_outputs": D}),
    ("MeanSquaredLogError", "positive", {}),
    ("MeanAbsolutePercentageError", "single", {}),
    ("SymmetricMeanAbsolutePercentageError", "single", {}),
    ("WeightedMeanAbsolutePercentageError", "single", {}),
    ("MinkowskiDistance", "single", {"p": 3}),
    ("MinkowskiDistance", "single", {"p": 1.5}),
    ("LogCoshError", "single", {}),
    ("LogCoshError", "multi", {"num_outputs": D}),
    ("TweedieDevianceScore", "single", {}),
    ("TweedieDevianceScore", "positive", {"power": 1}),
    ("TweedieDevianceScore", "positive", {"power": 1.5}),
    ("TweedieDevianceScore", "positive", {"power": 2}),
    ("TweedieDevianceScore", "positive", {"power": 3}),
    ("RelativeSquaredError", "single", {}),
    ("RelativeSquaredError", "multi", {"num_outputs": D, "squared": False}),
    ("R2Score", "single", {}),
    ("R2Score", "single", {"adjusted": 5}),
    ("R2Score", "multi", {"num_outputs": D, "multioutput": "raw_values"}),
    ("R2Score", "multi", {"num_outputs": D, "multioutput": "variance_weighted"}),
    ("ExplainedVariance", "single", {}),
    ("ExplainedVariance", "multi", {"multioutput": "raw_values"}),
    ("ExplainedVariance", "multi", {"multioutput": "variance_weighted"}),
    ("CriticalSuccessIndex", "single", {"threshold": 0.5}),
    ("CriticalSuccessIndex", "seq", {"threshold": 0.5, "keep_sequence_dim": 0}),
    ("KLDivergence", "rows", {}),
    ("KLDivergence", "rows", {"reduction": "sum"}),
    ("KLDivergence", "rows", {"reduction": "none"}),
    ("KLDivergence", "logrows", {"log_prob": True}),
    ("PearsonCorrCoef", "single", {}),
    ("PearsonCorrCoef", "multi", {"num_outputs": D}),
    ("ConcordanceCorrCoef", "single", {}),
    ("ConcordanceCorrCoef", "multi", {"num_outputs": D}),
    ("CosineSimilarity", "rows", {}),
    ("CosineSimilarity", "rows", {"reduction": "none"}),
    ("SpearmanCorrCoef", "single", {}),
    ("SpearmanCorrCoef", "multi", {"num_outputs": D}),
    ("KendallRankCorrCoef", "single", {}),
    ("KendallRankCorrCoef", "single", {"variant": "a", "t_test": True}),
    ("KendallRankCorrCoef", "single", {"variant": "c", "t_test": True, "alternative": "less"}),
    ("KendallRankCorrCoef", "multi", {"num_outputs": D, "t_test": True, "alternative": "greater"}),
]

#: states held bitwise: counts (int32 or float), and the cat states of inputs
EXACT_STATES = {"total", "num_observations", "hits", "misses", "false_alarms", "hits_list", "misses_list",
                "false_alarms_list", "n_total", "num_obs", "preds", "target"}
DERIVED_MODULES = {"R2Score", "RelativeSquaredError", "ExplainedVariance", "PearsonCorrCoef", "ConcordanceCorrCoef"}


def _module_id(case):
    name, kind, kw = case
    return "-".join([name, kind] + [f"{k}={v}" for k, v in kw.items()])


def _tree(jm):
    return {k: (v if isinstance(v, list) else np.asarray(v)) for k, v in jm.state_tree(include_count=True).items()}


def _value_close(got, want, name):
    if name == "KendallRankCorrCoef" and isinstance(want, tuple):
        _close(got[0], want[0], what="tau")
        _close(got[1], want[1], P_RTOL, P_ATOL, "p-value")
    elif name == "CriticalSuccessIndex":
        _bitwise(got, want, name)
    else:
        _close(got, want, DERIVED_RTOL if name in DERIVED_MODULES else RTOL, what=name)


@pytest.mark.parametrize("case", MODULE_CASES, ids=_module_id)
def test_module_matches_jax(case):
    """Three batches folded into both: state dtypes and shapes equal, counts
    and cat states bitwise, float sums within the budget; the registry
    fingerprint and the value; then each package's state tree into a fresh
    metric of the other, the same value."""
    name, kind, kw = case
    jm, tm = getattr(JR, name)(**kw), getattr(TR, name)(device="cpu", **kw)
    n = 200 if name == "KendallRankCorrCoef" else N  # 600 rows: below JAX's tau-b overflow
    for seed in range(3):
        batch = _data(kind, seed=100 + seed, n=n)
        jm.update(*[jnp.asarray(a) for a in batch])
        tm.update(*[torch.from_numpy(np.array(a)) for a in batch])
    want, got = _tree(jm), state_to_numpy(tm, include_count=True)
    assert sorted(want) == sorted(got)
    for state, w in want.items():
        if state == "_update_count":
            assert int(got[state]) == int(w) == 3
        elif state in EXACT_STATES:
            _bitwise(_flat(got[state]), _flat(w), state)
        else:
            _close(got[state], w, what=state)
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    _value_close(tm.compute(), jm.compute(), name)

    fresh, jfresh = getattr(TR, name)(device="cpu", **kw), getattr(JR, name)(**kw)
    into_port = {k: v if k == "_update_count" else (list(map(np.asarray, v)) if isinstance(v, list) else v) for k, v in want.items()}
    into_jax = {k: v if k == "_update_count" else ([jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v))
                for k, v in got.items()}
    if name == "ExplainedVariance" and kind == "multi":
        # its sums are declared 0-d and a multi-output batch broadcasts them
        # to (D,): neither package restores such a tree, its own included
        with pytest.raises(StateRestoreError):
            state_from_numpy(fresh, into_port, fingerprint=jm.state_spec()["fingerprint"])
        with pytest.raises(JStateRestoreError):
            jfresh.load_state_tree(into_jax)
        return
    state_from_numpy(fresh, into_port, fingerprint=jm.state_spec()["fingerprint"])
    _value_close(fresh.compute(), jm.compute(), name)
    jfresh.load_state_tree(into_jax)
    _value_close(tm.compute(), jfresh.compute(), name)


@pytest.mark.parametrize("name", ["MeanSquaredError", "PearsonCorrCoef", "R2Score", "KLDivergence"])
def test_forward_matches_jax(name):
    """``forward``'s batch value and the accumulated state (the full-state
    path for Pearson, the reduce-state path for the others)."""
    kind = {"KLDivergence": "rows"}.get(name, "single")
    jm, tm = getattr(JR, name)(), getattr(TR, name)(device="cpu")
    for seed in range(3):
        batch = _data(kind, seed=200 + seed)
        want = jm(*[jnp.asarray(a) for a in batch])
        got = tm(*[torch.from_numpy(a) for a in batch])
        _value_close(got, want, name)
    _value_close(tm.compute(), jm.compute(), name)


def test_count_states_are_int32_like_jax():
    """The integer counts are int32 (a torch default would make them int64 and
    change the fingerprint); the float counts stay float32."""
    int32 = {"MeanSquaredError": "total", "MeanAbsoluteError": "total", "MeanSquaredLogError": "total",
             "LogCoshError": "total", "R2Score": "total", "RelativeSquaredError": "total", "KLDivergence": "total",
             "TweedieDevianceScore": "num_observations", "CriticalSuccessIndex": "hits"}
    for name, state in int32.items():
        kw = {"threshold": 0.5} if name == "CriticalSuccessIndex" else {}
        assert getattr(getattr(TR, name)(device="cpu", **kw), state).dtype == torch.int32, name
    for name, state in {"MeanAbsolutePercentageError": "total", "PearsonCorrCoef": "n_total", "ExplainedVariance": "num_obs"}.items():
        assert getattr(getattr(TR, name)(device="cpu"), state).dtype == torch.float32, name


# ----------------------------------------------------------- ranks and ties


def _tied_rows(seed, n=96):
    """Rows with ties, signed zeros and NaNs in both inputs."""
    rng = np.random.default_rng(seed)
    preds = np.round(rng.standard_normal(n) * 2).astype(np.float32)
    target = np.round(rng.standard_normal(n)).astype(np.float32)
    preds[:6] = [0.0, -0.0, 0.0, -0.0, np.nan, np.nan]
    target[3:9] = [np.nan, -0.0, 0.0, np.nan, -0.0, 0.0]
    perm = rng.permutation(n)
    return preds[perm], target[perm]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spearman_ranks_match_jax_on_ties_zeros_and_nan(seed):
    """Tie-averaged ranks equal JAX's bitwise (every NaN its own segment, last;
    -0.0 ties 0.0); the coefficient on tied rows without NaN too."""
    preds, target = _tied_rows(seed)
    for x in (preds, target, np.sort(preds), preds[::-1].copy()):
        _bitwise(_tmod("spearman")._rank_data(torch.from_numpy(x)), _jmod("spearman")._rank_data(jnp.asarray(x)))
    keep = ~(np.isnan(preds) | np.isnan(target))
    got, want = _both(JF.spearman_corrcoef, TF.spearman_corrcoef, preds[keep], target[keep])
    _close(got, want)


@pytest.mark.parametrize("variant", ["a", "b", "c"])
def test_kendall_matches_jax_on_ties_zeros_and_nan(variant):
    """The pair census and tie statistics equal JAX's on rows with ties, signed
    zeros and NaN (a pair with a NaN counts as neither); tau and the p-value."""
    preds, target = _tied_rows(7)
    census = _tmod("kendall")._pair_census(torch.from_numpy(preds), torch.from_numpy(target))
    jcensus = _jmod("kendall")._pair_census(jnp.asarray(preds), jnp.asarray(target))
    for g, w in zip(census, jcensus):
        _bitwise(g, w, "census")
    keep = ~(np.isnan(preds) | np.isnan(target))
    for g, w in zip(_tmod("kendall")._tie_stats(torch.from_numpy(preds[keep])), _jmod("kendall")._tie_stats(jnp.asarray(preds[keep]))):
        _bitwise(g, w, "ties")
    got, want = _both(JF.kendall_rank_corrcoef, TF.kendall_rank_corrcoef, preds[keep], target[keep], variant=variant, t_test=True)
    _close(got[0], want[0], what="tau")
    _close(got[1], want[1], P_RTOL, P_ATOL, "p-value")


@pytest.mark.parametrize("n", [1, 2, 1023, 1024, 1025, 3000])
def test_kendall_census_blocks_match_jax(n):
    """Block edges: fewer rows than a block, exactly one, one more, several."""
    preds, target = _data("single", seed=n, n=n)
    preds = np.round(preds * 4) / 4
    got = _tmod("kendall")._pair_census(torch.from_numpy(preds), torch.from_numpy(target))
    want = _jmod("kendall")._pair_census(jnp.asarray(preds), jnp.asarray(target))
    for g, w in zip(got, want):
        _bitwise(g, w, f"census n={n}")


def test_kendall_float32_census_matches_jax_at_65537_rows():
    """Above 65536 rows the pair count no longer fits int32: the accumulator
    is float32, each block's exact count rounded and added in block order.
    The census equals JAX's bitwise, and tau-a (JAX's tau-b overflows at this
    size) within the budget."""
    preds, target = _data("single", seed=65537, n=65537)
    preds = np.round(preds * 64) / 64  # ties too
    tp, tt = torch.from_numpy(preds), torch.from_numpy(target)
    got = _tmod("kendall")._pair_census(tp, tt)
    want = _jmod("kendall")._pair_census(jnp.asarray(preds), jnp.asarray(target))
    assert got[0].dtype == torch.float32
    for g, w in zip(got, want):
        _bitwise(g, w, "float32 census")
    exact = _tmod("kendall")._census_counts(tp, tt).sum(0)
    assert abs(float(got[0]) - int(exact[0])) <= 2**-20 * int(exact[0])
    _close(TF.kendall_rank_corrcoef(tp, tt, variant="a"),
           J.functional.kendall_rank_corrcoef(jnp.asarray(preds), jnp.asarray(target), variant="a"))


def test_kendall_p_value_matches_scipy_beyond_jax_int32_range():
    """The JAX package's tau-b raises OverflowError from about 620 rows (a
    Python int above int32 meets a float32 array); the port computes tau-b
    and its p-value within 1e-5 and 1e-4 of ``scipy.stats.kendalltau`` on
    5000 rows with ties."""
    scipy_stats = pytest.importorskip("scipy.stats")
    preds, target = _data("single", seed=9, n=5000)
    preds = np.round(preds * 8) / 8
    tau, p = TF.kendall_rank_corrcoef(torch.from_numpy(preds), torch.from_numpy(target), t_test=True)
    ref = scipy_stats.kendalltau(preds, target, variant="b", method="asymptotic")
    assert abs(float(tau) - ref.statistic) < 1e-5 and abs(float(p) - ref.pvalue) < 1e-4
    with pytest.raises(OverflowError):
        J.functional.kendall_rank_corrcoef(jnp.asarray(preds), jnp.asarray(target))


# --------------------------------------------------------------- Pearson shards


def _pearson_shards(pkg, shape):
    """A Pearson metric whose states hold ``shape[:-1]`` stacked shards of
    per-shard statistics (as after sync or sharded folds)."""
    rng = np.random.default_rng(sum(shape))
    shards = int(np.prod(shape[:-1]))
    stats = {k: [] for k in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")}
    for s in range(shards):
        n = 20 + 7 * s
        x = rng.standard_normal((n, shape[-1])).astype(np.float32)
        y = (x + rng.standard_normal((n, shape[-1]))).astype(np.float32)
        m = T.PearsonCorrCoef(num_outputs=shape[-1], device="cpu")
        m.update(torch.from_numpy(x.squeeze(-1) if shape[-1] == 1 else x), torch.from_numpy(y.squeeze(-1) if shape[-1] == 1 else y))
        for k in stats:
            stats[k].append(getattr(m, k).numpy())
    tree = {k: np.stack(v).reshape(shape) for k, v in stats.items()}
    tree["_update_count"] = shards
    if pkg is T:
        metric = T.PearsonCorrCoef(num_outputs=shape[-1], device="cpu")
        metric.load_state_tree(tree)
    else:
        metric = J.PearsonCorrCoef(num_outputs=shape[-1])
        metric.load_state_tree({k: v if k == "_update_count" else jnp.asarray(v) for k, v in tree.items()})
    return metric


@pytest.mark.parametrize("shape", [(2, 1), (3, 2, 1), (2, 2, 2, 1), (4, 3), (2, 3, 3)])
def test_pearson_final_aggregation_over_several_shard_axes(shape):
    """Stacked states with one or several leading shard axes flatten into one
    and merge pairwise in shard order: JAX's ``_merged_states``; Pearson and
    concordance values."""
    tm, jm = _pearson_shards(T, shape), _pearson_shards(J, shape)
    for g, w in zip(tm._merged_states(), jm._merged_states()):
        _close(g, w, DERIVED_RTOL, what="merged")
    _close(tm.compute(), jm.compute(), DERIVED_RTOL)
    tc, jc = T.ConcordanceCorrCoef(num_outputs=shape[-1], device="cpu"), J.ConcordanceCorrCoef(num_outputs=shape[-1])
    tc.load_state_tree(tm.state_tree(include_count=True))
    jc.load_state_tree(jm.state_tree(include_count=True))
    _close(tc.compute(), jc.compute(), DERIVED_RTOL)


def test_pearson_update_captures_as_one_expression():
    """The update reads nothing on the host: the first batch is the merge with
    a zero count, so one fold from zeros equals the two-pass statistics."""
    preds, target = _data("single", seed=5)
    m = T.PearsonCorrCoef(device="cpu")
    m.update(torch.from_numpy(preds), torch.from_numpy(target))
    p64, t64 = preds.astype(np.float64), target.astype(np.float64)
    np.testing.assert_allclose(m.var_x.numpy(), [((p64 - p64.mean()) ** 2).sum()], rtol=1e-5)
    np.testing.assert_allclose(m.corr_xy.numpy(), [((p64 - p64.mean()) * (t64 - t64.mean())).sum()], rtol=1e-5)
    assert m.n_total.dtype == torch.float32 and float(m.n_total) == N


# ---------------------------------------------------------- errors and exports

BAD_ARGUMENTS = [
    ("MeanSquaredError", {"squared": 1}),
    ("MeanSquaredError", {"num_outputs": 0}),
    ("MeanAbsoluteError", {"num_outputs": -1}),
    ("LogCoshError", {"num_outputs": 0}),
    ("MinkowskiDistance", {"p": 0.5}),
    ("TweedieDevianceScore", {"power": 0.5}),
    ("R2Score", {"num_outputs": 0}),
    ("R2Score", {"adjusted": -1}),
    ("R2Score", {"multioutput": "bad"}),
    ("ExplainedVariance", {"multioutput": "bad"}),
    ("CriticalSuccessIndex", {"threshold": "x"}),
    ("CriticalSuccessIndex", {"threshold": 0.5, "keep_sequence_dim": -1}),
    ("KLDivergence", {"log_prob": 1}),
    ("KLDivergence", {"reduction": "max"}),
    ("PearsonCorrCoef", {"num_outputs": 0}),
    ("CosineSimilarity", {"reduction": "max"}),
    ("SpearmanCorrCoef", {"num_outputs": 0}),
    ("SpearmanCorrCoef", {"num_bins": 1}),
    ("KendallRankCorrCoef", {"t_test": 1}),
    ("KendallRankCorrCoef", {"t_test": True, "alternative": None}),
    ("KendallRankCorrCoef", {"variant": "d"}),
    ("KendallRankCorrCoef", {"t_test": True, "alternative": "sideways"}),
]


@pytest.mark.parametrize("case", BAD_ARGUMENTS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_argument_errors_match_jax(case):
    name, kw = case
    assert _raised(getattr(TR, name), device="cpu", **kw) == _raised(getattr(JR, name), **kw)


BAD_INPUTS = [
    ("mean_squared_error", (np.zeros(4, np.float32), np.zeros(5, np.float32)), {}),
    ("log_cosh_error", (np.zeros((4, 2, 2), np.float32), np.zeros((4, 2, 2), np.float32)), {}),
    ("r2_score", (np.zeros((2, 2, 2), np.float32), np.zeros((2, 2, 2), np.float32)), {}),
    ("r2_score", (np.zeros(1, np.float32), np.zeros(1, np.float32)), {}),
    ("r2_score", (np.arange(4, dtype=np.float32), np.arange(4, dtype=np.float32)[::-1].copy()), {"multioutput": "bad"}),
    ("explained_variance", (np.zeros(4, np.float32), np.zeros(4, np.float32)), {"multioutput": "bad"}),
    ("critical_success_index", (np.zeros((2, 3), np.float32), np.zeros((2, 3), np.float32)), {"threshold": 0.5, "keep_sequence_dim": 2}),
    ("kl_divergence", (np.ones(4, np.float32), np.ones(4, np.float32)), {}),
    ("cosine_similarity", (np.ones(4, np.float32), np.ones(4, np.float32)), {}),
    ("cosine_similarity", (np.ones((4, 2), np.float32), np.ones((4, 2), np.float32)), {"reduction": "max"}),
    ("spearman_corrcoef", (np.arange(4, dtype=np.int32), np.arange(4, dtype=np.int32)), {}),
    ("minkowski_distance", (np.ones(4, np.float32), np.ones(4, np.float32)), {"p": 0}),
    ("kendall_rank_corrcoef", (np.ones(4, np.float32), np.ones(4, np.float32)), {"t_test": "yes"}),
]


@pytest.mark.parametrize("case", BAD_INPUTS, ids=lambda c: f"{c[0]}-{sorted(c[2])}")
def test_input_errors_match_jax(case):
    name, arrays, kw = case
    want = _raised(getattr(JF, name), *[jnp.asarray(a) for a in arrays], **kw)
    got = _raised(getattr(TF, name), *[torch.from_numpy(a) for a in arrays], **kw)
    assert got == want


def test_module_shape_errors_match_jax():
    for name, kw, arrays in [
        ("PearsonCorrCoef", {}, _data("multi", 1)),
        ("SpearmanCorrCoef", {"num_outputs": 2}, _data("single", 1)),
        ("KendallRankCorrCoef", {}, _data("multi", 1)),
        ("LogCoshError", {"num_outputs": 4}, _data("multi", 1)),
    ]:
        want = _raised(getattr(JR, name)(**kw).update, *[jnp.asarray(a) for a in arrays])
        got = _raised(getattr(TR, name)(device="cpu", **kw).update, *[torch.from_numpy(a) for a in arrays])
        assert got == want, name


def test_spearman_bounded_mode_is_refused_naming_a9():
    """(Once a refusal; now the parity of the same scope.) Bounded Spearman
    (``num_bins=``) equals JAX's on the same stream: both KLL sketches and
    the float32 joint grid bitwise (a scatter-add of 1.0, exact below 2**24
    per cell), rho within ``rtol=1e-5`` (its sums add in another order);
    ``num_outputs > 1`` raises JAX's error."""
    rng = np.random.default_rng(613)
    jm, tm = JR.SpearmanCorrCoef(num_bins=32), TR.SpearmanCorrCoef(num_bins=32, device="cpu")
    for i in range(3):
        x = rng.standard_normal(900).astype(np.float32)
        y = (0.6 * x + rng.standard_normal(900)).astype(np.float32)
        jm.update(jnp.asarray(x), jnp.asarray(y))
        tm.update(torch.from_numpy(x), torch.from_numpy(y))
    for state in ("preds_sketch", "target_sketch"):
        for got, want in zip(getattr(tm, state), getattr(jm, state)):
            assert np.array_equal(_np(got), _np(want)) and _np(got).dtype == _np(want).dtype, state
    assert np.array_equal(_np(tm.joint), _np(jm.joint)) and tm.joint.dtype == torch.float32
    _close(tm.compute(), jm.compute(), rtol=1e-5, atol=0.0, what="rho")
    assert _raised(JR.SpearmanCorrCoef, num_outputs=3, num_bins=32) == _raised(
        TR.SpearmanCorrCoef, num_outputs=3, num_bins=32, device="cpu"
    )


@pytest.mark.parametrize("kind", ["functional", "module"])
def test_csi_keeps_the_only_dim_as_jax_does(kind):
    """``keep_sequence_dim`` naming the input's only dim reduces nothing, as
    ``jnp.sum(axis=())`` does: per-position counts, and the CSI per position."""
    if kind == "functional":
        preds = np.asarray([0.1, 0.5, 0.9, 0.4], np.float32)
        target = np.asarray([0.6, 0.5, 0.2, 0.1], np.float32)
        want = JF.critical_success_index(jnp.asarray(preds), jnp.asarray(target), 0.3, keep_sequence_dim=0)
        got = TF.critical_success_index(torch.from_numpy(preds), torch.from_numpy(target), 0.3, keep_sequence_dim=0)
        assert np.array_equal(_np(got), np.asarray([0.0, 1.0, 0.0, 0.0], np.float32))
        _close(got, want, rtol=0.0, atol=0.0)
        return
    rng = np.random.default_rng(3)
    jm, tm = JR.CriticalSuccessIndex(0.5, keep_sequence_dim=0), TR.CriticalSuccessIndex(0.5, keep_sequence_dim=0, device="cpu")
    for _ in range(3):
        preds, target = rng.random(50).astype(np.float32), rng.random(50).astype(np.float32)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    for name in ("hits_list", "misses_list", "false_alarms_list"):
        for got, want in zip(getattr(tm, name), getattr(jm, name)):
            assert _np(got).dtype == _np(want).dtype == np.int32 and np.array_equal(_np(got), _np(want)), name
    got, want = tm.compute(), jm.compute()
    assert tuple(got.shape) == (150,)
    _close(got, want, rtol=0.0, atol=0.0)


def test_exports_equal_jax():
    """``regression`` and ``functional.regression`` export exactly JAX's names,
    all defined in the port; the top level and the flat functional namespace
    re-export them, as JAX's do."""
    assert sorted(TR.__all__) == sorted(JR.__all__)
    assert sorted(TF.__all__) == sorted(JF.__all__)
    for name in TR.__all__:
        assert getattr(TR, name).__module__.startswith("torchmetrics_tpu_torch.regression.")
        assert getattr(T, name) is getattr(TR, name) and name in T.__all__ and name in J.__all__
    for name in TF.__all__:
        assert getattr(TF, name).__module__.startswith("torchmetrics_tpu_torch.functional.regression.")
        assert name in TFA.__all__ and name in JFA.__all__


def test_reductions_and_plot_bounds_match_jax():
    """Every class's state reductions and its class attributes."""
    kws = {"MinkowskiDistance": {"p": 2}, "CriticalSuccessIndex": {"threshold": 0.5}}
    for name in TR.__all__:
        kw = kws.get(name, {})
        tm, jm = getattr(TR, name)(device="cpu", **kw), getattr(JR, name)(**kw)
        assert tm._reductions == jm._reductions, name
        for attr in ("is_differentiable", "higher_is_better", "full_state_update", "plot_lower_bound", "plot_upper_bound"):
            assert getattr(tm, attr, None) == getattr(jm, attr, None), (name, attr)


def test_regression_collection_compute_groups_and_values_match_jax():
    """A collection of the sum-state family: the same compute groups as JAX's
    and the values within the budget."""

    def make(pkg):
        kw = {} if pkg is J else {"device": "cpu"}
        return pkg.MetricCollection({
            "mse": pkg.MeanSquaredError(**kw), "rmse": pkg.MeanSquaredError(squared=False, **kw),
            "mae": pkg.MeanAbsoluteError(**kw), "r2": pkg.R2Score(**kw), "rse": pkg.RelativeSquaredError(**kw),
            "pearson": pkg.PearsonCorrCoef(**kw), "ccc": pkg.ConcordanceCorrCoef(**kw),
        })

    jcol, tcol = make(J), make(T)
    for seed in range(3):
        batch = _data("single", seed=300 + seed)
        jcol.update(*[jnp.asarray(a) for a in batch])
        tcol.update(*[torch.from_numpy(a) for a in batch])
    assert sorted(map(sorted, tcol.compute_groups.values())) == sorted(map(sorted, jcol.compute_groups.values()))
    jvals, tvals = jcol.compute(), tcol.compute()
    assert sorted(jvals) == sorted(tvals)
    for key in jvals:
        _close(tvals[key], jvals[key], DERIVED_RTOL, what=key)


def test_fused_plan_equals_eager_and_matches_jax():
    """The sum-state and Welford families through ``suite.fused()`` (the step
    runs eagerly on the CPU): the states equal the eager fold's bitwise, and
    JAX's fused plan's within the budget."""

    def make(pkg):
        kw = {} if pkg is J else {"device": "cpu"}
        return pkg.MetricCollection({
            "mse": pkg.MeanSquaredError(**kw), "mae": pkg.MeanAbsoluteError(**kw), "msle": pkg.MeanSquaredLogError(**kw),
            "mape": pkg.MeanAbsolutePercentageError(**kw), "tweedie": pkg.TweedieDevianceScore(power=1.5, **kw),
            "logcosh": pkg.LogCoshError(**kw), "r2": pkg.R2Score(**kw), "ev": pkg.ExplainedVariance(**kw),
            "pearson": pkg.PearsonCorrCoef(**kw), "csi": pkg.CriticalSuccessIndex(0.5, **kw),
        })

    batches = [_data("positive", seed=400 + s) for s in range(5)]
    eager, fused, jfused = make(T), make(T), make(J)
    for b in batches[:2]:
        fused.update(*[torch.from_numpy(a) for a in b])
        jfused.update(*[jnp.asarray(a) for a in b])
    fused.reset()
    jfused.reset()
    plan, jplan = fused.fused(), jfused.fused()
    for b in batches:
        eager.update(*[torch.from_numpy(a) for a in b])
        plan.update(*[torch.from_numpy(a) for a in b])
        jplan.update(*[jnp.asarray(a) for a in b])
    plan.fold_back()
    jplan.fold_back()
    for key in eager.keys(keep_base=True):
        a, b = state_to_numpy(dict.__getitem__(eager, key)), state_to_numpy(dict.__getitem__(fused, key))
        jt = _tree(dict.__getitem__(jfused, key))
        for name in a:
            _bitwise(b[name], a[name], f"{key}.{name}")
            if name in EXACT_STATES:
                _bitwise(b[name], jt[name], f"{key}.{name} vs JAX")
            else:
                _close(b[name], jt[name], what=f"{key}.{name} vs JAX")
    jvals, tvals = jfused.compute(), fused.compute()
    for key in jvals:
        _close(tvals[key], jvals[key], DERIVED_RTOL, what=key)


def test_fusion_report_matches_jax():
    from torchmetrics_tpu.parallel import fusion_report as j_fusion_report
    from torchmetrics_tpu_torch.parallel import fusion_report

    def members(pkg):
        kw = {} if pkg is J else {"device": "cpu"}
        return pkg.MetricCollection({
            "mse": pkg.MeanSquaredError(**kw), "pearson": pkg.PearsonCorrCoef(**kw),
            "spearman": pkg.SpearmanCorrCoef(**kw), "kendall": pkg.KendallRankCorrCoef(**kw),
            "cos": pkg.CosineSimilarity(**kw), "kl": pkg.KLDivergence(reduction=None, **kw),
        })

    assert fusion_report(members(T)) == j_fusion_report(members(J))


def test_nan_propagates_like_jax():
    """A NaN in a batch reaches the float sums as in JAX (no strategy here)."""
    preds, target = _data("single", seed=6)
    preds[3] = np.nan
    for name in ("mean_squared_error", "mean_absolute_error", "pearson_corrcoef"):
        got, want = _both(getattr(JF, name), getattr(TF, name), preds, target)
        assert math.isnan(float(got)) and math.isnan(float(np.asarray(want)))
