# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Parity of the port's binned curve state (kernel K1's module) with JAX's.

``torchmetrics_tpu_torch``'s ``_binned_curve_state`` takes the
``(T, ..., 2, 2)`` int32 state from
:func:`~torchmetrics_tpu_torch.ops.binned_curve_state`; on the CPU tensors
used here that is the plain PyTorch version. It is held BITWISE against
both formulations of the JAX package's ``_binned_curve_state`` (bucketize,
which the CPU backend picks, and the jitted contraction), on probability
inputs: values on every grid point, outside [0, 1], NaN, +-inf, masked
entries, uniform and irregular grids, labels mode and binary mode.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# by module path: the JAX package's ``functional.classification`` also exports
# a function named ``precision_recall_curve``
jprc = importlib.import_module("torchmetrics_tpu.functional.classification.precision_recall_curve")
tprc = importlib.import_module("torchmetrics_tpu_torch.functional.classification.precision_recall_curve")
from torchmetrics_tpu_torch.ops import binned_curve_state, binned_curve_state_plain

_CONTRACTION = jax.jit(jprc._binned_curve_state)  # traced thresholds: the contraction path


def _grids():
    uniform = np.array(jnp.linspace(0.0, 1.0, 37))
    irregular = np.sort(np.random.RandomState(7).rand(29)).astype(np.float32)
    with_dupes = np.array([0.0, 0.1, 0.1, 0.5, 0.5, 0.5, 0.9, 1.0], np.float32)
    return {"uniform37": uniform, "irregular29": irregular, "duplicates8": with_dupes}


def _probs(rng, shape, grid):
    p = rng.random(shape).astype(np.float32)
    flat = p.reshape(-1)
    k = min(len(grid), flat.size)
    flat[:k] = grid[:k]  # exactly on grid points
    flat[k : k + 4] = [-0.25, 1.25, 0.0, 1.0]  # outside / on the range ends
    flat[k + 4 : k + 6] = np.nan  # NaN: below every threshold
    flat[k + 6 : k + 8] = [np.inf, -np.inf]  # +-inf: above / below every threshold
    return p


@pytest.mark.parametrize("grid", sorted(_grids()))
@pytest.mark.parametrize("inner", [None, 4])
def test_binary_mode_bitwise(grid, inner):
    thr = _grids()[grid]
    rng = np.random.default_rng(11)
    shape = (513,) if inner is None else (513, inner)
    p = _probs(rng, shape, thr)
    t = rng.integers(0, 2, shape).astype(np.int32)
    v = rng.random(shape) > 0.1
    got = tprc._binned_curve_state(torch.from_numpy(p), torch.from_numpy(np.where(v, t, -1)), torch.from_numpy(thr))
    assert got.dtype == torch.int32
    for jfn in (jprc._binned_curve_state, _CONTRACTION):
        want = np.asarray(jfn(jnp.asarray(p), jnp.asarray(t), jnp.asarray(v), jnp.asarray(thr)))
        assert want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("grid", sorted(_grids()))
def test_labels_mode_bitwise(grid):
    """Multiclass: class labels instead of a one-hot target, -1 = ignored."""
    thr = _grids()[grid]
    rng = np.random.default_rng(12)
    n, c = 400, 6
    p = _probs(rng, (n, c), thr)
    labels = rng.integers(0, c, n).astype(np.int32)
    labels[rng.random(n) < 0.1] = -1
    got = tprc._binned_curve_state(torch.from_numpy(p), torch.from_numpy(labels), torch.from_numpy(thr), labels=True)
    valid = np.broadcast_to((labels >= 0)[:, None], (n, c))
    onehot = np.asarray(jax.nn.one_hot(np.clip(labels, 0, c - 1), c, dtype=jnp.int32))
    for jfn in (jprc._binned_curve_state, _CONTRACTION):
        want = np.asarray(jfn(jnp.asarray(p), jnp.asarray(onehot), jnp.asarray(valid), jnp.asarray(thr)))
        np.testing.assert_array_equal(got.numpy(), want)


def test_labels_mode_clips_out_of_range_labels():
    """A label >= C counts as class C-1, as JAX's one-hot of the clipped label does."""
    rng = np.random.default_rng(13)
    n, c = 64, 4
    p = rng.random((n, c)).astype(np.float32)
    labels = rng.integers(0, c + 3, n).astype(np.int32)
    thr = np.array(jnp.linspace(0.0, 1.0, 9))
    got = tprc._binned_curve_state(torch.from_numpy(p), torch.from_numpy(labels), torch.from_numpy(thr), labels=True)
    onehot = np.asarray(jax.nn.one_hot(np.clip(labels, 0, c - 1), c, dtype=jnp.int32))
    want = np.asarray(jprc._binned_curve_state(jnp.asarray(p), jnp.asarray(onehot), jnp.ones((n, c), bool), jnp.asarray(thr)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_unsorted_thresholds_keep_caller_order():
    """The kernel needs ascending thresholds; the state comes back in the caller's order."""
    rng = np.random.default_rng(14)
    thr = rng.permutation(np.asarray(jnp.linspace(0.0, 1.0, 17)))
    p = rng.random((200, 3)).astype(np.float32)
    t = rng.integers(0, 2, (200, 3)).astype(np.int32)
    got = tprc._binned_curve_state(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(thr))
    want = np.asarray(_CONTRACTION(jnp.asarray(p), jnp.asarray(t), jnp.ones((200, 3), bool), jnp.asarray(thr)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num", [2, 8, 32, 37, 128, 1000, 4097])
def test_linspace_grid_ascends(num):
    """The functional paths give K1 an integer ``thresholds``' grid unsorted; it must ascend."""
    grid = tprc._adjust_threshold_arg(num)
    assert tprc._thresholds_ascend(grid)
    assert bool(torch.all(grid[1:] >= grid[:-1]))


@pytest.mark.parametrize(
    "thr,ascend",
    [
        ([], True),
        ([0.5], True),
        ([0.0, 0.1, 0.1, 1.0], True),
        ([0.0, 0.5, float("nan")], True),
        ([float("nan"), 0.5], False),
        ([0.2, 0.1], False),
    ],
)
def test_thresholds_ascend(thr, ascend):
    assert tprc._thresholds_ascend(torch.tensor(thr, dtype=torch.float32)) is ascend


def test_ascending_grid_is_not_sorted_again(monkeypatch):
    """With ``ascending`` the state needs no sort and equals the sorted path's, bitwise."""
    rng = np.random.default_rng(17)
    thr = torch.from_numpy(np.array(jnp.linspace(0.0, 1.0, 21)))
    p = torch.from_numpy(rng.random((300, 4)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 4, 300).astype(np.int32))
    want = tprc._binned_curve_state(p, t, thr, labels=True)

    def no_sort(*args, **kwargs):
        raise AssertionError("the thresholds were sorted although they ascend")

    monkeypatch.setattr(torch, "sort", no_sort)
    got = tprc._binned_curve_state(p, t, thr, labels=True, ascending=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("thresholds", [[0.9, 0.1, 0.5, 0.3, 0.7], 9], ids=["unsorted_list", "int_grid"])
def test_module_fixes_grid_order_once(thresholds):
    """The module asks once, at init, whether its grid ascends; its state stays
    bitwise the JAX module's, in the caller's threshold order."""
    import torchmetrics_tpu as J
    import torchmetrics_tpu_torch as T

    rng = np.random.default_rng(18)
    n, c = 200, 4
    jm = J.classification.MulticlassPrecisionRecallCurve(num_classes=c, thresholds=thresholds)
    tm = T.MulticlassPrecisionRecallCurve(num_classes=c, thresholds=thresholds, device="cpu")
    assert tm._thresholds_ascend is isinstance(thresholds, int)
    assert (tm._thresholds_affine is not None) is isinstance(thresholds, int)
    for _ in range(2):
        p = rng.random((n, c)).astype(np.float32)
        p /= p.sum(1, keepdims=True)
        t = rng.integers(0, c, n).astype(np.int32)
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_array_equal(tm.confmat.numpy(), np.asarray(jm.confmat))


def test_hist_counts_every_valid_entry_once():
    rng = np.random.default_rng(15)
    n, k, len_t = 300, 5, 11
    p = torch.from_numpy(rng.random((n, k)).astype(np.float32))
    t = torch.from_numpy(rng.integers(-1, 2, (n, k)).astype(np.int64))
    thr = torch.linspace(0, 1, len_t)
    state = binned_curve_state(p, thr, t, labels=False)
    assert state.shape == (len_t, k, 2, 2) and state.dtype == torch.int32
    # at every threshold each valid entry is either below or at/above it
    per_threshold = state.sum((1, 2, 3))
    assert per_threshold.tolist() == [int((t >= 0).sum())] * len_t
    np.testing.assert_array_equal(state.numpy(), binned_curve_state_plain(p, thr, t, False).numpy())


def test_hist_cpu_path_never_counts_a_launch():
    before = binned_curve_state.launches
    p = torch.rand(10, 2)
    binned_curve_state(p, torch.linspace(0, 1, 5), torch.zeros(10, dtype=torch.int32), labels=True, affine=(0.0, 4.0))
    assert binned_curve_state.launches == before


def test_hist_empty_batch_is_zero_and_counts_no_launch():
    before = binned_curve_state.launches
    state = binned_curve_state(torch.zeros(0, 3), torch.linspace(0, 1, 5), torch.zeros(0, dtype=torch.int32), labels=True)
    assert state.shape == (5, 3, 2, 2) and state.dtype == torch.int32 and int(state.abs().sum()) == 0
    assert binned_curve_state.launches == before


@pytest.mark.parametrize(
    "p,thr,t,labels",
    [
        (torch.rand(4, 2, dtype=torch.float64), torch.linspace(0, 1, 3), torch.zeros(4, dtype=torch.int32), True),
        (torch.rand(4, 2), torch.linspace(0, 1, 3).double(), torch.zeros(4, dtype=torch.int32), True),
        (torch.rand(4, 2), torch.linspace(0, 1, 3), torch.zeros(4, 2, dtype=torch.int32), True),
        (torch.rand(4, 2), torch.linspace(0, 1, 3), torch.zeros(4, dtype=torch.int32), False),
        (torch.rand(4, 2), torch.linspace(0, 1, 3), torch.zeros(4, 2), False),
    ],
)
def test_hist_rejects_what_the_kernel_does_not_take(p, thr, t, labels):
    with pytest.raises(ValueError):
        binned_curve_state(p, thr, t, labels)


def _jax_grid(kind, len_t):
    if kind == "uniform":
        return np.array(jnp.linspace(0.0, 1.0, len_t))
    return np.sort(np.random.RandomState(len_t).rand(len_t)).astype(np.float32)


@pytest.mark.parametrize("k", [5, 8])
@pytest.mark.parametrize("labels", [True, False], ids=["labels", "binary"])
@pytest.mark.parametrize("len_t", [1, 2, 3, 128])
@pytest.mark.parametrize("grid", ["uniform", "irregular"])
def test_plain_state_matches_jax(grid, len_t, labels, k):
    """K1's plain version (histogram, prefix, stack) against JAX's
    ``_binned_curve_state``: NaN, +-inf, values on the grid, masked targets,
    K not a multiple of 4, both target modes; bitwise."""
    thr = _jax_grid(grid, len_t)
    rng = np.random.default_rng(31 + len_t)
    n = 257
    p = _probs(rng, (n, k), thr)
    if labels:
        target = rng.integers(-1, k + 2, n).astype(np.int32)
        target_bin = np.asarray(jax.nn.one_hot(np.clip(target, 0, k - 1), k, dtype=jnp.int32))
        valid = np.broadcast_to((target >= 0)[:, None], (n, k))
    else:
        target = rng.integers(-1, 3, (n, k)).astype(np.int32)
        target_bin, valid = target, target >= 0
    got = binned_curve_state_plain(torch.from_numpy(p), torch.from_numpy(thr), torch.from_numpy(target), labels)
    want = np.asarray(jprc._binned_curve_state(jnp.asarray(p), jnp.asarray(target_bin), jnp.asarray(valid), jnp.asarray(thr)))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("labels", [True, False], ids=["labels", "binary"])
def test_int64_target_is_cut_to_int32(labels):
    """An int64 label is read as ``static_cast<int>`` reads it, as ``astype(jnp.int32)`` cuts it."""
    rng = np.random.default_rng(32)
    n, k = 64, 4
    p = torch.from_numpy(rng.random((n, k)).astype(np.float32))
    small = rng.integers(-1, k if labels else 2, n if labels else (n, k))
    wide = small + rng.choice([-(2**32), 2**32, 2**33], small.shape)  # the same low 32 bits
    thr = torch.from_numpy(np.array(jnp.linspace(0.0, 1.0, 7)))
    got = binned_curve_state_plain(p, thr, torch.from_numpy(wide.astype(np.int64)), labels)
    want = binned_curve_state_plain(p, thr, torch.from_numpy(wide.astype(np.int32)), labels)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), binned_curve_state_plain(p, thr, torch.from_numpy(small), labels).numpy())


_MARGIN_GRIDS = {
    **{f"linspace{n}": np.asarray(jnp.linspace(0.0, 1.0, n), np.float64) for n in (1, 2, 3, 4, 5, 7, 16, 32, 100, 128, 129, 1000, 4097)},
    "linspace_shifted": np.asarray(jnp.linspace(-2.0, 3.0, 41), np.float64),
    "irregular": np.sort(np.random.RandomState(3).rand(50)),
    "near_uniform_jitter": np.linspace(0.0, 1.0, 64) + np.r_[0.0, 1e-3, np.zeros(62)],
    "duplicates": np.array([0.0, 0.1, 0.1, 0.5, 0.9, 1.0]),
    "nan": np.r_[np.linspace(0.0, 1.0, 8), np.nan],
    "inf": np.r_[np.linspace(0.0, 1.0, 8), np.inf],
    "constant": np.zeros(5),
}


@pytest.mark.parametrize("name", sorted(_MARGIN_GRIDS))
def test_uniform_bin_margin_ok_matches_jax(name):
    """The port's copy of ``_uniform_bin_margin_ok`` decides as JAX's does."""
    thr = _MARGIN_GRIDS[name]
    assert tprc._uniform_bin_margin_ok(thr) is jprc._uniform_bin_margin_ok(thr)


@pytest.mark.parametrize("num", [2, 3, 8, 32, 128, 1000])
def test_uniform_grid_of_an_int_grid(num):
    """An integer ``thresholds`` always gets the affine bin index, with JAX's ``lo`` and ``scale``."""
    lo, scale = tprc._uniform_grid(num)
    grid = np.asarray(jnp.linspace(0.0, 1.0, num), np.float64)
    assert lo == grid[0] and scale == (num - 1) / (grid[-1] - grid[0])
    assert tprc._uniform_grid(torch.tensor([0.3, 0.1, 0.2])) is None  # not sorted
    assert tprc._uniform_grid(_MARGIN_GRIDS["irregular"]) is None


@pytest.mark.parametrize("average", [None, "micro"])
def test_multiclass_update_through_format(average):
    """Format + update, the functional path the module metric runs: int32 and bitwise."""
    rng = np.random.default_rng(16)
    n, c = 256, 5
    p = rng.random((n, c)).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    t = rng.integers(0, c, n).astype(np.int32)
    t[:9] = 3  # the ignore_index below
    jp, jt, jthr = jprc._multiclass_precision_recall_curve_format(jnp.asarray(p), jnp.asarray(t), c, 33, 3, average)
    want = np.asarray(jprc._multiclass_precision_recall_curve_update(jp, jt, c, jthr, average))
    tp_, tt, tthr = tprc._multiclass_precision_recall_curve_format(torch.from_numpy(p), torch.from_numpy(t), c, 33, 3, average)
    got = tprc._multiclass_precision_recall_curve_update(tp_, tt, c, tthr, average)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tthr.numpy(), np.asarray(jthr))


def test_exact_mode_is_refused_with_roadmap_item():
    """The exact mode (``thresholds=None``), once refused, is ported: it builds
    the unique-threshold curve and raises nothing (parity in test_torch_exact_curve.py)."""
    p = torch.tensor([0.1, 0.4, 0.4, 0.8])
    t = torch.tensor([0, 1, 0, 1])
    precision, recall, thr = tprc.binary_precision_recall_curve(p, t, thresholds=None)
    assert thr.tolist() == pytest.approx([0.1, 0.4, 0.8])
    assert precision.tolist() == pytest.approx([0.5, 2 / 3, 1.0, 1.0]) and recall.tolist() == [1.0, 1.0, 0.5, 0.0]
