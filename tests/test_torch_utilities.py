# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Parity of the port's main-path utilities with the JAX package's.

The same numpy arrays go through the JAX function and its counterpart in
``torchmetrics_tpu_torch``. Integer results are held bitwise; float results
within the tolerance each test states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.utilities import compute as jcompute
from torchmetrics_tpu.utilities import data as jdata
from torchmetrics_tpu_torch.utilities import compute as tcompute
from torchmetrics_tpu_torch.utilities import data as tdata


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.int32)


# ------------------------------------------------------------------ linspace


@pytest.mark.parametrize("num", [2, 8, 32, 37, 128, 1000])
def test_linspace_like_jax_unit_grid_bitwise(num):
    """The grid an integer ``thresholds`` builds is ``jnp.linspace(0, 1, T)`` bit for bit."""
    want = np.asarray(jnp.linspace(0, 1, num))
    got = tcompute._linspace_like_jax(0.0, 1.0, num).numpy()
    assert got.dtype == np.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("num", [32, 128, 1000])
def test_torch_linspace_is_not_jax_linspace(num):
    """The trap the port avoids: ``torch.linspace`` differs from ``jnp.linspace`` in float32."""
    want = np.asarray(jnp.linspace(0, 1, num))
    assert (_bits(torch.linspace(0, 1, num).numpy()) != _bits(want)).any()


@pytest.mark.parametrize(
    "lo,hi,num", [(0.2, 0.9, 37), (0.1, 0.7, 128), (-5.5, 2.25, 300), (0.3, 0.31, 50), (-1, 3, 1000), (-0.5, 0.5, 64)]
)
def test_linspace_like_jax_general_range(lo, hi, num):
    """Other ranges replay XLA's fused form, held within 2 float32 ulps of the
    range's magnitude: the port is exact only on [0, 1], and XLA's CPU code
    contracts into an FMA where the host has one."""
    want = np.asarray(jnp.linspace(lo, hi, num))
    got = tcompute._linspace_like_jax(lo, hi, num).numpy()
    ulp = np.spacing(np.float32(max(abs(lo), abs(hi))))
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp)
    assert got[-1] == want[-1] and got[0] == want[0]


@pytest.mark.parametrize("num", [0, 1])
def test_linspace_like_jax_degenerate(num):
    np.testing.assert_array_equal(
        tcompute._linspace_like_jax(0.25, 1.0, num).numpy(), np.asarray(jnp.linspace(0.25, 1.0, num))
    )


# ------------------------------------------------------------------ bincount


@pytest.mark.parametrize(
    "values,length",
    [
        ([-3, 0, 2, 5, 9], 6),  # negative -> bin 0, >= length dropped
        ([0, 0, 1, 1, 1, 7], 8),
        ([10, 11, 12], 4),  # everything dropped
        ([-1, -1, -100], 3),  # everything in bin 0
        ([], 5),
    ],
)
def test_bincount_has_jnp_semantics(values, length):
    x = np.asarray(values, np.int32)
    want = np.asarray(jnp.bincount(jnp.asarray(x), length=length))
    got = tdata._bincount(torch.from_numpy(x), minlength=length)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_bincount_documented_example():
    got = tdata._bincount(torch.tensor([-3, 0, 2, 5, 9]), minlength=6)
    assert got.tolist() == [2, 0, 1, 0, 0, 1]


def test_bincount_random_parity():
    rng = np.random.default_rng(3)
    x = rng.integers(-5, 70, 1024).astype(np.int32)
    want = np.asarray(jdata._bincount(jnp.asarray(x), minlength=64))
    np.testing.assert_array_equal(tdata._bincount(torch.from_numpy(x), 64).numpy(), want)


# -------------------------------------------------------------- safe divide


@pytest.mark.parametrize("zero_division", [0.0, 1.0])
def test_safe_divide_parity(zero_division):
    rng = np.random.default_rng(4)
    num = rng.integers(0, 10, 64).astype(np.int32)
    den = rng.integers(0, 4, 64).astype(np.int32)
    want = np.asarray(jcompute._safe_divide(jnp.asarray(num), jnp.asarray(den), zero_division))
    got = tcompute._safe_divide(torch.from_numpy(num), torch.from_numpy(den), zero_division)
    assert got.dtype == torch.float32
    # one float32 division per element on both sides: equal bits
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("average,top_k", [("macro", 1), ("weighted", 1), ("macro", 2), (None, 1)])
def test_adjust_weights_safe_divide_parity(average, top_k):
    rng = np.random.default_rng(5)
    tp, fp, fn = (rng.integers(0, 5, 8).astype(np.int32) for _ in range(3))
    tp[2] = fp[2] = fn[2] = 0  # an absent class
    score = np.array(jcompute._safe_divide(jnp.asarray(tp), jnp.asarray(tp + fn)))
    score[5] = np.nan
    want = np.asarray(
        jcompute._adjust_weights_safe_divide(
            jnp.asarray(score), average, False, jnp.asarray(tp), jnp.asarray(fp), jnp.asarray(fn), top_k
        )
    )
    got = tcompute._adjust_weights_safe_divide(
        torch.from_numpy(score), average, False, torch.from_numpy(tp), torch.from_numpy(fp), torch.from_numpy(fn), top_k
    )
    # a sum of 8 float32 terms, possibly in another order: rtol 1e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7, equal_nan=True)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("num", [1, 5, 8, 31, 32, 33, 40, 63, 64])
def test_sum_last_in_xla_order_is_jnp_sum(num, jit):
    """The fixed-order float sum equals ``jnp.sum(-1)`` on the CPU bit for bit
    (XLA's order), so a card and the CPU sum a macro average alike (ROADMAP C6)."""
    rng = np.random.default_rng(num)
    x = (rng.random((4000, num)) / num).astype(np.float32)
    x[:5] *= np.float32(1e-6)  # rows that mix magnitudes
    jsum = jax.jit(lambda a: a.sum(-1)) if jit else (lambda a: jnp.sum(a, -1))
    want = np.asarray(jsum(jnp.asarray(x)))
    got = tcompute._sum_last_in_xla_order(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("num", [1, 5, 19, 33, 64])
def test_mean_last_in_xla_order_is_jnp_mean(num):
    """``jnp.mean(-1)`` is XLA's sum times the float32 reciprocal of the count,
    bit for bit (segmentation's class means, retrieval's curve means)."""
    rng = np.random.default_rng(num + 100)
    x = rng.random((2000, num)).astype(np.float32)
    want = np.asarray(jnp.mean(jnp.asarray(x), axis=-1))
    got = tcompute._mean_last_in_xla_order(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_safe_matmul_parity(dtype):
    rng = np.random.default_rng(7)
    x, y = rng.standard_normal((6, 16)).astype(dtype), rng.standard_normal((4, 16)).astype(dtype)
    want = np.asarray(jcompute._safe_matmul(jnp.asarray(x), jnp.asarray(y)))
    got = tcompute._safe_matmul(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), rtol=1e-3 if dtype == np.float16 else 1e-6, atol=1e-5)


@pytest.mark.parametrize("shapes", [((1, 4, 1), (1, 4, 1)), ((3, 1, 5), (3, 1, 5)), ((1, 1), (1, 1)), ((0,), (0,)), ((2, 3), (0,))])
def test_input_squeeze_and_empty_check_parity(shapes):
    from torchmetrics_tpu.utilities import checks as jchecks
    from torchmetrics_tpu_torch.utilities import checks as tchecks

    p, t = (np.arange(int(np.prod(s)), dtype=np.float32).reshape(s) for s in shapes)
    assert tchecks._check_for_empty_tensors(torch.from_numpy(p), torch.from_numpy(t)) == jchecks._check_for_empty_tensors(
        jnp.asarray(p), jnp.asarray(t))
    if p.size and p.shape == t.shape:
        want = jchecks._input_squeeze(jnp.asarray(p), jnp.asarray(t))
        got = tchecks._input_squeeze(torch.from_numpy(p), torch.from_numpy(t))
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("num_classes", [8, 64])
def test_macro_average_bitwise_parity(num_classes):
    """Macro averages of random counts equal JAX's bit for bit, the float sum
    in XLA's order (the card takes the same order)."""
    rng = np.random.default_rng(num_classes)
    tp, fp, fn = (rng.integers(0, 5000, (64, num_classes)).astype(np.int32) for _ in range(3))
    score = np.array(jcompute._safe_divide(jnp.asarray(tp), jnp.asarray(tp + fn)))
    want = np.asarray(jcompute._adjust_weights_safe_divide(jnp.asarray(score), "macro", False, *map(jnp.asarray, (tp, fp, fn))))
    got = tcompute._adjust_weights_safe_divide(torch.from_numpy(score), "macro", False, *map(torch.from_numpy, (tp, fp, fn)))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_auc_compute_without_check_parity():
    rng = np.random.default_rng(6)
    x = np.sort(rng.random((3, 33)).astype(np.float32), axis=1)
    y = rng.random((3, 33)).astype(np.float32)
    want = np.asarray(jcompute._auc_compute_without_check(jnp.asarray(x), jnp.asarray(y), 1.0, axis=1))
    got = tcompute._auc_compute_without_check(torch.from_numpy(x), torch.from_numpy(y), 1.0, axis=1).numpy()
    # a float32 sum of 32 trapezoids, possibly in another order: rtol 1e-6
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------- logits


def test_normalize_logits_keeps_probabilities():
    rng = np.random.default_rng(7)
    p = rng.random((16, 5)).astype(np.float32)
    for norm in ("sigmoid", "softmax"):
        got = tcompute.normalize_logits_if_needed(torch.from_numpy(p), norm).numpy()
        want = np.asarray(jcompute.normalize_logits_if_needed(jnp.asarray(p), norm))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, p)


@pytest.mark.parametrize("norm", ["sigmoid", "softmax"])
def test_normalize_logits_applies_to_whole_tensor(norm):
    """One value outside [0, 1] normalizes the whole tensor, as in JAX."""
    rng = np.random.default_rng(8)
    x = rng.random((16, 5)).astype(np.float32)
    x[3, 2] = 1.5
    got = tcompute.normalize_logits_if_needed(torch.from_numpy(x), norm).numpy()
    want = np.asarray(jcompute.normalize_logits_if_needed(jnp.asarray(x), norm))
    # sigmoid/softmax differ between torch and XLA by a few ulps: rtol 1e-6
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert not np.array_equal(got, x)


def test_normalize_logits_does_not_sync_the_host(monkeypatch):
    """The in-range choice is a ``torch.where`` select, never a host read."""
    x = torch.randn(8, 4)

    def _no_item(*_a, **_k):
        raise AssertionError("normalize_logits_if_needed read a value back to the host")

    monkeypatch.setattr(torch.Tensor, "item", _no_item)
    monkeypatch.setattr(torch.Tensor, "__bool__", _no_item)
    out = tcompute.normalize_logits_if_needed(x, "softmax")
    monkeypatch.undo()
    torch.testing.assert_close(out.sum(1), torch.ones(8))


# -------------------------------------------------------------------- topk


def test_select_topk_first_max_ties():
    x = np.array([[0.2, 0.5, 0.5, 0.1], [0.3, 0.3, 0.3, 0.3], [0.9, 0.0, 0.9, 0.9]], np.float32)
    for k in (1, 2, 3):
        want = np.asarray(jdata.select_topk(jnp.asarray(x), topk=k, dim=1))
        got = tdata.select_topk(torch.from_numpy(x), topk=k, dim=1)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_dim_zero_and_flatten_dict():
    a, b = torch.tensor([1, 2], dtype=torch.int32), torch.tensor([3], dtype=torch.int32)
    assert tdata.dim_zero_cat([a, b]).tolist() == [1, 2, 3]
    assert tdata.dim_zero_sum(torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)).dtype == torch.int32
    assert tdata.dim_zero_max(torch.tensor([[1, 5], [3, 4]])).tolist() == [3, 5]
    assert tdata.dim_zero_min(torch.tensor([[1, 5], [3, 4]])).tolist() == [1, 4]
    assert tdata.dim_zero_mean(torch.tensor([[1.0, 5.0], [3.0, 4.0]])).tolist() == [2.0, 4.5]
    nested = {"a": 1, "b": {"c": 2, "d": 3}}
    assert tdata._flatten_dict(nested) == jdata._flatten_dict(nested)
    with pytest.raises(ValueError):
        tdata.dim_zero_cat([])
    assert jax.numpy is jnp  # both packages are loaded here; the port itself never imports jax


# ------------------------------------------------------- input placement


def _small_multiclass(seed=0, n=32, c=4):
    rng = np.random.default_rng(seed)
    p = rng.random((n, c)).astype(np.float32)
    return (p / p.sum(1, keepdims=True)).astype(np.float32), rng.integers(0, c, n).astype(np.int32)


def test_numpy_inputs_to_a_functional_go_to_the_card():
    """A numpy (or list) input to a port functional goes to the card, as a module
    metric's inputs do, and raises without one; it never drops to the CPU."""
    from torchmetrics_tpu_torch.functional.classification import multiclass_auroc

    p, t = _small_multiclass()
    if torch.cuda.is_available():
        assert multiclass_auroc(p, t, num_classes=4, thresholds=8).device.type == "cuda"
        assert tdata._to_tensor([1, 2]).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device is available. Pass CPU tensors"):
        multiclass_auroc(p, t, num_classes=4, thresholds=8)
    with pytest.raises(RuntimeError, match="a list input was asked to run on cuda"):
        tdata._to_tensor([1, 2])


def test_cpu_tensors_to_a_functional_stay_on_the_cpu():
    """A torch tensor runs where it lies; list ``thresholds`` go beside ``preds``."""
    from torchmetrics_tpu.functional.classification import multiclass_auroc as j_auroc
    from torchmetrics_tpu_torch.functional.classification import multiclass_auroc

    p, t = _small_multiclass()
    for thresholds in (8, [0.1, 0.4, 0.6, 0.9], np.asarray([0.2, 0.5, 0.8], np.float32)):
        got = multiclass_auroc(torch.from_numpy(p), torch.from_numpy(t), num_classes=4, thresholds=thresholds)
        want = np.asarray(j_auroc(jnp.asarray(p), jnp.asarray(t), num_classes=4, thresholds=thresholds))
        assert got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    target = tdata._to_tensor(t, torch.device("cpu"))  # an explicit device is honoured
    assert target.device.type == "cpu" and target.dtype == torch.int32
