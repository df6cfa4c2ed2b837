# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's module metrics against the JAX package's, and its Metric base.

Binary and multiclass Accuracy, F1 and binned AUROC are fed the same numpy
batches in both packages (three updates each, on ``device="cpu"``). States
must be bitwise equal and int32; values computed from probabilities agree
within ``rtol=1e-6, atol=1e-7``, values from logits within the budget the
test states. Also pinned: the ``forward`` dual return, ``reset``, the
transactional update, ``state_spec`` fingerprints equal to JAX's, and state
carried JAX -> port and port -> JAX giving the same ``compute()``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as J
import torchmetrics_tpu_torch as T
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.exceptions import StateRestoreError

C = 6
N = 256
RTOL, ATOL = 1e-6, 1e-7


def _pairs():
    """(name, JAX factory, port factory, input kind) for each module metric of the slice."""
    return {
        "binary_accuracy": (lambda: J.BinaryAccuracy(), lambda: T.BinaryAccuracy(device="cpu"), "binary"),
        "binary_f1": (lambda: J.BinaryF1Score(ignore_index=-1), lambda: T.BinaryF1Score(ignore_index=-1, device="cpu"), "binary"),
        "binary_auroc": (
            lambda: J.BinaryAUROC(thresholds=33),
            lambda: T.BinaryAUROC(thresholds=33, device="cpu"),
            "binary",
        ),
        "binary_auroc_maxfpr": (
            lambda: J.BinaryAUROC(thresholds=[0.0, 0.2, 0.4, 0.5, 0.6, 0.8, 1.0], max_fpr=0.5),
            lambda: T.BinaryAUROC(thresholds=[0.0, 0.2, 0.4, 0.5, 0.6, 0.8, 1.0], max_fpr=0.5, device="cpu"),
            "binary",
        ),
        "multiclass_accuracy_micro": (
            lambda: J.MulticlassAccuracy(num_classes=C, average="micro"),
            lambda: T.MulticlassAccuracy(num_classes=C, average="micro", device="cpu"),
            "multiclass",
        ),
        "multiclass_accuracy_macro": (
            lambda: J.MulticlassAccuracy(num_classes=C, average="macro", ignore_index=2),
            lambda: T.MulticlassAccuracy(num_classes=C, average="macro", ignore_index=2, device="cpu"),
            "multiclass",
        ),
        "multiclass_f1_macro": (
            lambda: J.MulticlassF1Score(num_classes=C, average="macro"),
            lambda: T.MulticlassF1Score(num_classes=C, average="macro", device="cpu"),
            "multiclass",
        ),
        "multiclass_f1_weighted": (
            lambda: J.MulticlassF1Score(num_classes=C, average="weighted"),
            lambda: T.MulticlassF1Score(num_classes=C, average="weighted", device="cpu"),
            "multiclass",
        ),
        "multiclass_auroc_macro": (
            lambda: J.MulticlassAUROC(num_classes=C, average="macro", thresholds=37),
            lambda: T.MulticlassAUROC(num_classes=C, average="macro", thresholds=37, device="cpu"),
            "multiclass",
        ),
        "multiclass_auroc_weighted_ignore": (
            lambda: J.MulticlassAUROC(num_classes=C, average="weighted", thresholds=17, ignore_index=0),
            lambda: T.MulticlassAUROC(num_classes=C, average="weighted", thresholds=17, ignore_index=0, device="cpu"),
            "multiclass",
        ),
        "multiclass_auroc_none": (
            lambda: J.MulticlassAUROC(num_classes=C, average=None, thresholds=np.linspace(0, 1, 11).astype(np.float32)),
            lambda: T.MulticlassAUROC(num_classes=C, average=None, thresholds=np.linspace(0, 1, 11).astype(np.float32), device="cpu"),
            "multiclass",
        ),
    }


def _batches(kind, seed, logits=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        if kind == "binary":
            p = (rng.standard_normal(N) * 2).astype(np.float32) if logits else rng.random(N).astype(np.float32)
            t = rng.integers(0, 2, N).astype(np.int32)
        else:
            p = rng.standard_normal((N, C)).astype(np.float32)
            if not logits:
                p = np.exp(p) / np.exp(p).sum(1, keepdims=True)
                p = p.astype(np.float32)
            t = rng.integers(0, C, N).astype(np.int32)
        out.append((p, t))
    return out


def _jax_states(metric):
    return {k: np.asarray(v) for k, v in metric.state_tree().items()}


def _assert_states_equal(jm, tm):
    js, ts = _jax_states(jm), state_to_numpy(tm)
    assert sorted(js) == sorted(ts)
    for name in js:
        assert ts[name].dtype == js[name].dtype, (name, ts[name].dtype, js[name].dtype)
        np.testing.assert_array_equal(ts[name], js[name], err_msg=name)


def _assert_values_close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(_pairs()))
def test_module_metric_parity_on_probabilities(name):
    jf, tf, kind = _pairs()[name]
    jm, tm = jf(), tf()
    for p, t in _batches(kind, seed=sorted(_pairs()).index(name)):
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    _assert_states_equal(jm, tm)
    _assert_values_close(tm.compute(), jm.compute())


@pytest.mark.parametrize("name", ["multiclass_accuracy_macro", "multiclass_f1_macro", "multiclass_auroc_macro", "binary_auroc"])
def test_module_metric_parity_on_logits(name):
    """From logits the port's softmax/sigmoid differs from XLA's by ulps, and
    an ulp can move a probability across a threshold: one entry then shifts
    one bin in one class's curve, which moves that class's AUC by at most
    1/(T-1) of 1/min(P, N) of the class. The budget, 2e-3, covers a few such
    flips at N=3x256 (none happens at these seeds; the argmax-based counts
    are exact either way)."""
    jf, tf, kind = _pairs()[name]
    jm, tm = jf(), tf()
    for p, t in _batches(kind, seed=7, logits=True):
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    _assert_values_close(tm.compute(), jm.compute(), rtol=0, atol=2e-3)


@pytest.mark.parametrize("name", ["binary_auroc", "multiclass_f1_macro", "multiclass_auroc_macro", "multiclass_accuracy_micro"])
def test_forward_dual_return(name):
    """``forward`` returns the batch value and accumulates globally, as in JAX."""
    jf, tf, kind = _pairs()[name]
    jm, tm = jf(), tf()
    for p, t in _batches(kind, seed=3):
        jb = jm(jnp.asarray(p), jnp.asarray(t))
        tb = tm(torch.from_numpy(p), torch.from_numpy(t))
        _assert_values_close(tb, jb)
    assert tm._update_count == jm._update_count == 3
    _assert_states_equal(jm, tm)
    _assert_values_close(tm.compute(), jm.compute())


def test_forward_full_state_update_path():
    """A metric with ``full_state_update=True`` takes the double-update path."""

    class FullAccuracy(T.MulticlassAccuracy):
        full_state_update = True

    tm, ref = FullAccuracy(num_classes=C, device="cpu"), T.MulticlassAccuracy(num_classes=C, device="cpu")
    batches = _batches("multiclass", seed=4)
    for p, t in batches:
        single = T.MulticlassAccuracy(num_classes=C, device="cpu")
        single.update(torch.from_numpy(p), torch.from_numpy(t))
        torch.testing.assert_close(tm(torch.from_numpy(p), torch.from_numpy(t)), single.compute())
        ref.update(torch.from_numpy(p), torch.from_numpy(t))
    assert tm._update_count == 3
    torch.testing.assert_close(tm.compute(), ref.compute())


def test_reset_restores_defaults():
    tm = T.MulticlassAUROC(num_classes=C, thresholds=9, device="cpu")
    p, t = _batches("multiclass", seed=5)[0]
    tm.update(torch.from_numpy(p), torch.from_numpy(t))
    assert int(tm.confmat.sum()) > 0
    tm.reset()
    assert tm._update_count == 0 and int(tm.confmat.sum()) == 0 and tm.confmat.dtype == torch.int32
    tm.update(torch.from_numpy(p), torch.from_numpy(t))
    jm = J.MulticlassAUROC(num_classes=C, thresholds=9)
    jm.update(jnp.asarray(p), jnp.asarray(t))
    _assert_states_equal(jm, tm)


def test_compute_cache_and_clone():
    tm = T.MulticlassF1Score(num_classes=C, device="cpu")
    p, t = _batches("multiclass", seed=6)[0]
    tm.update(torch.from_numpy(p), torch.from_numpy(t))
    first = tm.compute()
    assert tm.compute() is first  # cached until the next update
    twin = tm.clone()
    twin.update(torch.from_numpy(p), torch.from_numpy(t))
    assert tm._update_count == 1 and twin._update_count == 2
    assert int(twin.tp.sum()) == 2 * int(tm.tp.sum())


class _TwoStates(Metric):
    """A sum state and a cat state, with an update that can fail half way."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("seen", [], dist_reduce_fx="cat")

    def update(self, x, fail=False):
        self.total = self.total + x.sum(dtype=torch.int32)
        self.seen.append(x)
        if fail:
            raise RuntimeError("update failed half way")

    def compute(self):
        return self.total


def test_update_rolls_back_on_exception():
    m = _TwoStates(device="cpu")
    m.update(torch.tensor([1, 2], dtype=torch.int32))
    with pytest.raises(RuntimeError, match="half way"):
        m.update(torch.tensor([5, 5], dtype=torch.int32), fail=True)
    assert m._update_count == 1
    assert int(m.total) == 3 and len(m.seen) == 1
    m.update(torch.tensor([4], dtype=torch.int32))
    assert int(m.compute()) == 7 and m._update_count == 2


def test_module_update_with_bad_target_leaves_state_untouched():
    tm = T.MulticlassAUROC(num_classes=C, thresholds=9, device="cpu")
    p, t = _batches("multiclass", seed=8)[0]
    tm.update(torch.from_numpy(p), torch.from_numpy(t))
    before = tm.confmat
    bad = t.copy()
    bad[0] = C + 4
    with pytest.raises(RuntimeError):
        tm.update(torch.from_numpy(p), torch.from_numpy(bad))
    assert tm._update_count == 1 and tm.confmat is before


def test_add_state_refuses_merge_and_bad_reductions():
    """``"merge"`` without a sketch default and a sketch under another
    reduction raise JAX's two ``ValueError``s, message for message; a bad
    reduction name raises JAX's list of the valid ones."""
    import torchmetrics_tpu as JT
    from torchmetrics_tpu import sketch as jsk
    from torchmetrics_tpu_torch import sketch as tsk

    m = _TwoStates(device="cpu")
    jm = JT.MeanMetric()
    for name, t_default, j_default, red in [
        ("sketch", torch.zeros(3), jnp.zeros(3), "merge"),
        ("sketch2", tsk.kll_init(32, 4, device="cpu"), jsk.kll_init(32, 4), "sum"),
        ("bad", torch.zeros(3), jnp.zeros(3), "median"),
    ]:
        with pytest.raises(ValueError) as want:
            jm.add_state(name, j_default, dist_reduce_fx=red)
        with pytest.raises(ValueError) as got:
            m.add_state(name, t_default, dist_reduce_fx=red)
        # the same text but the packages' names for a tensor and for the state
        want_text = str(want.value).replace("ArrayImpl", "Tensor").replace("pytree", "state")
        assert str(got.value).replace("torchmetrics_tpu_torch", "torchmetrics_tpu") == want_text, name
    for red in ("sum", "mean", "cat", "min", "max", None, lambda x: x.sum(0)):
        m.add_state(f"s_{id(red)}", torch.zeros(2), dist_reduce_fx=red)
    m.add_state("q", tsk.kll_init(32, 4, device="cpu"), dist_reduce_fx="merge")
    assert m._reductions["q"] == "merge" and m.q.items.shape == (4, 32)


def test_reduce_states_per_reduction():
    """The reduce-state ``forward`` merges each reduction as JAX does."""

    class AllReductions(Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("s", torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("m", torch.tensor(0.0), dist_reduce_fx="mean")
            self.add_state("lo", torch.tensor(float("inf")), dist_reduce_fx="min")
            self.add_state("hi", torch.tensor(float("-inf")), dist_reduce_fx="max")
            self.add_state("c", [], dist_reduce_fx="cat")

        def update(self, x):
            self.s = self.s + x.sum()
            self.m = x.mean()
            self.lo = torch.minimum(self.lo, x.min())
            self.hi = torch.maximum(self.hi, x.max())
            self.c.append(x)

        def compute(self):
            return self.s

    m = AllReductions(device="cpu")
    xs = [torch.tensor([1.0, 3.0]), torch.tensor([-2.0, 8.0]), torch.tensor([0.5])]
    for x in xs:
        m(x)
    assert float(m.s) == 10.5 and float(m.lo) == -2.0 and float(m.hi) == 8.0
    assert float(m.m) == pytest.approx((2.0 + 3.0 + 0.5) / 3)
    assert len(m.c) == 3


# ------------------------------------------------------------ specs and carry


@pytest.mark.parametrize("name", sorted(_pairs()))
def test_state_spec_fingerprint_equals_jax(name):
    jf, tf, _ = _pairs()[name]
    jspec, tspec = jf().state_spec(), tf().state_spec()
    assert tspec["fingerprint"] == jspec["fingerprint"]
    assert {k: tuple(v) for k, v in tspec["states"].items()} == {k: tuple(v) for k, v in jspec["states"].items()}


def test_fingerprint_tracks_configuration():
    a = T.MulticlassAUROC(num_classes=C, thresholds=9, device="cpu").state_spec()["fingerprint"]
    b = T.MulticlassAUROC(num_classes=C, thresholds=10, device="cpu").state_spec()["fingerprint"]
    c = T.MulticlassF1Score(num_classes=C, device="cpu").state_spec()["fingerprint"]
    assert len({a, b, c}) == 3


@pytest.mark.parametrize("name", sorted(_pairs()))
def test_state_carried_jax_to_port(name):
    jf, tf, kind = _pairs()[name]
    jm = jf()
    for p, t in _batches(kind, seed=9):
        jm.update(jnp.asarray(p), jnp.asarray(t))
    tree = {k: np.array(v) for k, v in jm.state_tree(include_count=True).items()}
    tm = tf()
    state_from_numpy(tm, tree, fingerprint=jm.state_spec()["fingerprint"])
    assert tm._update_count == 3
    # the port copies: writing into the caller's arrays leaves the metric alone
    for k, v in tree.items():
        if isinstance(v, np.ndarray):
            v[...] = 0
    _assert_values_close(tm.compute(), jm.compute())


@pytest.mark.parametrize("name", sorted(_pairs()))
def test_state_carried_port_to_jax(name):
    jf, tf, kind = _pairs()[name]
    tm = tf()
    for p, t in _batches(kind, seed=10):
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    tree = state_to_numpy(tm, include_count=True)
    jm = jf()
    jm.load_state_tree({k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in tree.items()})
    assert jm._update_count == 3
    _assert_values_close(tm.compute(), jm.compute())


def test_state_from_numpy_rejects_fingerprint_mismatch():
    jm = J.MulticlassAUROC(num_classes=C, thresholds=9)
    tm = T.MulticlassAUROC(num_classes=C, thresholds=10, device="cpu")
    tree = {k: np.asarray(v) for k, v in jm.state_tree().items()}
    with pytest.raises(StateRestoreError, match="fingerprint"):
        state_from_numpy(tm, tree, fingerprint=jm.state_spec()["fingerprint"])
    with pytest.raises(StateRestoreError, match="shape"):
        state_from_numpy(tm, tree)


def test_load_state_tree_refuses_int64_counts():
    """The int-width trap: an int64 tree is refused by a strict restore."""
    tm = T.MulticlassF1Score(num_classes=C, device="cpu")
    tree = {k: np.zeros(C, np.int64) for k in ("tp", "fp", "tn", "fn")}
    with pytest.raises(StateRestoreError, match="dtype"):
        tm.load_state_tree(tree)
    tm.load_state_tree({k: np.zeros(C, np.int16) for k in ("tp", "fp", "tn", "fn")}, strict=False)
    assert tm.tp.dtype == torch.int32


def test_state_dict_round_trip_copies():
    tm = T.MulticlassAUROC(num_classes=C, thresholds=9, device="cpu")
    tm.persistent(True)
    p, t = _batches("multiclass", seed=11)[0]
    tm.update(torch.from_numpy(p), torch.from_numpy(t))
    sd = tm.state_dict()
    other = T.MulticlassAUROC(num_classes=C, thresholds=9, device="cpu")
    other.load_state_dict(sd)
    sd["confmat"][...] = 0
    assert torch.equal(other.confmat, tm.confmat)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert T.MulticlassAccuracy(num_classes=3).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.MulticlassAccuracy(num_classes=3)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.MulticlassAUROC(num_classes=3, thresholds=5, device="cuda:0")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.MulticlassAccuracy(num_classes=3, device="cpu").to("cuda")


def test_task_wrappers_dispatch():
    assert isinstance(T.Accuracy(task="multiclass", num_classes=3, device="cpu"), T.MulticlassAccuracy)
    assert isinstance(T.F1Score(task="binary", device="cpu"), T.BinaryF1Score)
    assert isinstance(T.AUROC(task="multiclass", num_classes=3, thresholds=5, device="cpu"), T.MulticlassAUROC)
    assert isinstance(T.Accuracy(task="multilabel", num_labels=3, device="cpu"), T.MultilabelAccuracy)
    assert isinstance(T.AUROC(task="multilabel", num_labels=3, device="cpu"), T.MultilabelAUROC)
    exact = T.MulticlassAUROC(num_classes=3, device="cpu")  # thresholds=None: the exact mode
    assert exact.thresholds is None and exact.preds == [] and exact.target == []


# ------------------------------------------------------------- functional API


def _functional_cases():
    """(name, kwargs, input kind): the port's functional entry points with their JAX namesakes."""
    return [
        ("binary_accuracy", {}, "binary"),
        ("binary_f1_score", {"ignore_index": -1}, "binary"),
        ("binary_fbeta_score", {"beta": 2.0}, "binary"),
        ("binary_auroc", {"thresholds": 21}, "binary"),
        ("binary_auroc", {"thresholds": 21, "max_fpr": 0.3}, "binary"),
        ("binary_roc", {"thresholds": [0.0, 0.25, 0.5, 0.75, 1.0]}, "binary"),
        ("binary_precision_recall_curve", {"thresholds": 11}, "binary"),
        ("multiclass_accuracy", {"num_classes": C, "average": "macro"}, "multiclass"),
        ("multiclass_accuracy", {"num_classes": C, "average": "micro", "ignore_index": 1}, "multiclass"),
        ("multiclass_f1_score", {"num_classes": C, "average": "weighted"}, "multiclass"),
        ("multiclass_fbeta_score", {"beta": 0.5, "num_classes": C, "average": None}, "multiclass"),
        ("multiclass_auroc", {"num_classes": C, "thresholds": 19}, "multiclass"),
        ("multiclass_auroc", {"num_classes": C, "thresholds": 19, "average": "weighted", "ignore_index": 0}, "multiclass"),
        ("multiclass_roc", {"num_classes": C, "thresholds": 9}, "multiclass"),
        ("multiclass_precision_recall_curve", {"num_classes": C, "thresholds": 9}, "multiclass"),
        ("multiclass_precision_recall_curve", {"num_classes": C, "thresholds": 9, "average": "micro"}, "multiclass"),
        ("multiclass_stat_scores", {"num_classes": C, "average": "macro"}, "multiclass"),
        ("binary_stat_scores", {}, "binary"),
    ]


@pytest.mark.parametrize("case", range(len(_functional_cases())), ids=lambda i: _functional_cases()[i][0] + f"-{i}")
def test_functional_parity_on_probabilities(case):
    import torchmetrics_tpu.functional.classification as JF
    import torchmetrics_tpu_torch.functional.classification as TF

    name, kwargs, kind = _functional_cases()[case]
    p, t = _batches(kind, seed=100 + case)[0]
    want = getattr(JF, name)(jnp.asarray(p), jnp.asarray(t), **kwargs)
    got = getattr(TF, name)(torch.from_numpy(p), torch.from_numpy(t), **kwargs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == np.int32:
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            _assert_values_close(g, w)
