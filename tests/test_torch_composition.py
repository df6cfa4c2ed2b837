# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Metric arithmetic of the port (``CompositionalMetric`` and the 40
operators of ``Metric``) against the JAX package's, on the CPU.

The same seeded numpy batches go through a JAX metric and its port twin;
every operator, forward and reflected, and the four unary ones and
``getitem`` compose them with each other or with a scalar, and the composed
values must agree: the same dtype (JAX's scalar promotion: a Python ``int``
or ``float`` is weak, numpy's 64-bit scalars are 32-bit), integer and boolean
values bitwise, float values within rtol 1e-6 (``torch.remainder`` and
``torch.pow`` may differ from XLA's by an ulp). Integer powers that overflow
int32 are not compared: XLA's and torch's wrapped results differ.

The traps pinned here: ``__eq__`` returns a (truthy) ``CompositionalMetric``,
so ``metric in [other]`` is True for a different metric, and the port keeps
metrics hashable; ``__getitem__`` makes a metric look like a sequence to a
tensor, a number or a numpy scalar on the left of an operator (each such
test runs under its own alarm); a scalar operand lives on the metric
operand's device; operands on two devices raise.
"""
import operator
import signal
from contextlib import contextmanager

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as T
from torchmetrics_tpu_torch.metric import CompositionalMetric

C, N = 4, 64
RTOL = 1e-6
SECONDS = 30  # each reflected-operator probe; a sequence walk over a metric would never end


@contextmanager
def _alarm(seconds=SECONDS):
    def fail(*_):
        raise TimeoutError(f"an operator did not return within {seconds} s (a metric iterated as a sequence?)")

    old = signal.signal(signal.SIGALRM, fail)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _batches():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(2):
        x = rng.standard_normal((N, C)).astype(np.float32)
        probs = (np.exp(x) / np.exp(x).sum(1, keepdims=True)).astype(np.float32)
        out.append((probs, rng.integers(0, C, N).astype(np.int32)))
    return out


def _make(pkg, kind):
    """A metric of ``pkg`` whose value is of ``kind``: a float scalar, a
    float vector, or an int32 vector (stat scores)."""
    kw = {} if pkg is J else {"device": "cpu"}
    cls = pkg.classification
    return {
        "float": lambda: cls.MulticlassAccuracy(num_classes=C, average="micro", **kw),
        "float2": lambda: cls.MulticlassF1Score(num_classes=C, average="macro", **kw),
        "vector": lambda: cls.MulticlassF1Score(num_classes=C, average=None, **kw),
        "vector2": lambda: cls.MulticlassRecall(num_classes=C, average=None, **kw),
        "int": lambda: cls.MulticlassStatScores(num_classes=C, average="micro", **kw),
        "int2": lambda: cls.MulticlassStatScores(num_classes=C, average="micro", ignore_index=0, **kw),
    }[kind]()


def _fed(pkg, kind):
    metric = _make(pkg, kind)
    for probs, labels in _batches():
        if pkg is J:
            metric.update(jnp.asarray(probs), jnp.asarray(labels))
        else:
            metric.update(torch.from_numpy(probs), torch.from_numpy(labels))
    return metric


def _as_numpy(value):
    return value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def _assert_same(got, want, what):
    got, want = _as_numpy(got), np.asarray(want)
    assert got.dtype == want.dtype, f"{what}: dtype {got.dtype} vs JAX {want.dtype}"
    assert got.shape == want.shape, f"{what}: shape {got.shape} vs JAX {want.shape}"
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


# ------------------------------------------------------- binary operators

SCALARS = {
    "int": 3,
    "float": 2.5,
    "bool": True,
    "np_float64": np.float64(2.5),
    "np_int64": np.int64(3),
    "np_float32": np.float32(0.5),
}

# (name, the operator, the metric kinds it is defined on)
BINARY = [
    ("add", operator.add, ("float", "int")),
    ("sub", operator.sub, ("float", "int")),
    ("mul", operator.mul, ("float", "int")),
    ("truediv", operator.truediv, ("float", "int")),
    ("floordiv", operator.floordiv, ("float", "int")),
    ("mod", operator.mod, ("float", "int")),
    ("pow", operator.pow, ("float", "int")),
    ("and", operator.and_, ("int",)),
    ("or", operator.or_, ("int",)),
    ("xor", operator.xor, ("int",)),
    ("eq", operator.eq, ("float", "int")),
    ("ne", operator.ne, ("float", "int")),
    ("lt", operator.lt, ("float", "int")),
    ("le", operator.le, ("float", "int")),
    ("gt", operator.gt, ("float", "int")),
    ("ge", operator.ge, ("float", "int")),
]
BITWISE = ("and", "or", "xor")
FLOAT_SCALARS = ("float", "np_float64", "np_float32")
REFLECTED = ["radd", "rsub", "rmul", "rtruediv", "rfloordiv", "rmod", "rpow", "rand", "ror", "rxor"]


def _cases():
    for name, _, kinds in BINARY:
        for kind in kinds:
            for other in ("metric", *SCALARS):
                if kind == "float" and other == "bool" and name in ("sub", "floordiv", "mod", "pow"):
                    continue
                if (name, kind, other) == ("pow", "int", "metric"):
                    continue  # counts to the power of counts overflow int32, where XLA and torch wrap differently
                if name in BITWISE and other in FLOAT_SCALARS:
                    continue  # both packages raise: test_bitwise_operators_on_floats_raise
                yield name, kind, other


@pytest.mark.parametrize("name,kind,other", list(_cases()))
def test_binary_operator_matches_jax(name, kind, other):
    """``metric <op> other``: the composed value equals JAX's."""
    op = dict((n, o) for n, o, _ in BINARY)[name]
    second = {"float": "float2", "int": "int2"}[kind]
    values = {}
    for pkg in (J, T):
        a = _fed(pkg, kind)
        b = _fed(pkg, second) if other == "metric" else SCALARS[other]
        composed = op(a, b)
        assert type(composed).__name__ == "CompositionalMetric"
        values[pkg] = composed.compute()
    _assert_same(values[T], values[J], f"{kind} {name} {other}")


def _reflected_cases():
    for name in REFLECTED:
        for other in ("int", "float", "np_float32", "np_int64"):
            if name in ("rand", "ror", "rxor") and other in FLOAT_SCALARS:
                continue  # both packages raise: test_bitwise_operators_on_floats_raise
            yield name, other


@pytest.mark.parametrize("name,other", list(_reflected_cases()))
def test_reflected_operator_matches_jax(name, other):
    """``metric.__r<op>__(scalar)`` (the scalar on the left) equals JAX's."""
    kind = "int" if name in ("rand", "ror", "rxor") else "float"
    values = {}
    for pkg in (J, T):
        composed = getattr(_fed(pkg, kind), f"__{name}__")(SCALARS[other])
        values[pkg] = composed.compute()
    _assert_same(values[T], values[J], f"{kind} {name} {other}")


@pytest.mark.parametrize("name", ["and", "or", "xor", "rand", "ror", "rxor"])
def test_bitwise_operators_on_floats_raise(name):
    """A float operand of ``&``, ``|`` or ``^`` raises at compute in both packages."""
    for pkg in (J, T):
        composed = getattr(_fed(pkg, "int"), f"__{name}__")(2.5)
        with pytest.raises((TypeError, RuntimeError)):
            composed.compute()
        composed = getattr(_fed(pkg, "float"), f"__{name}__")(_fed(pkg, "int"))
        with pytest.raises((TypeError, RuntimeError)):
            composed.compute()


@pytest.mark.parametrize("name", ["matmul", "rmatmul"])
def test_matmul_matches_jax(name):
    """Vector values: ``a @ b`` and ``a.__rmatmul__(b)`` (``b @ a``)."""
    values = {}
    for pkg in (J, T):
        a, b = _fed(pkg, "vector"), _fed(pkg, "vector2")
        values[pkg] = getattr(a, f"__{name}__")(b).compute()
    _assert_same(values[T], values[J], name)


@pytest.mark.parametrize("name", ["abs", "neg", "pos", "invert", "getitem"])
@pytest.mark.parametrize("kind", ["vector", "int"])
def test_unary_operator_matches_jax(name, kind):
    """``abs``, ``-``, ``+`` (abs, as JAX defines it), ``~`` (logical not)
    and ``metric[1]``; ``-`` is ``-abs``, as JAX defines it."""
    ops = {"abs": abs, "neg": operator.neg, "pos": operator.pos, "invert": operator.invert, "getitem": lambda m: m[1]}
    values = {}
    for pkg in (J, T):
        values[pkg] = ops[name](_fed(pkg, kind)).compute()
    _assert_same(values[T], values[J], f"{kind} {name}")


def test_forward_and_update_run_both_operands():
    """``forward`` returns the op over the operands' batch values and
    accumulates both; ``reset`` resets both; a scalar operand stays."""
    values, totals = {}, {}
    for pkg in (J, T):
        a, b = _make(pkg, "float"), _make(pkg, "float2")
        composed = (a + b) / 2
        batch = []
        for probs, labels in _batches():
            args = (jnp.asarray(probs), jnp.asarray(labels)) if pkg is J else (torch.from_numpy(probs), torch.from_numpy(labels))
            batch.append(composed(*args))
        values[pkg] = batch
        totals[pkg] = composed.compute()
        composed.reset()
        assert a._update_count == 0 and b._update_count == 0
    for got, want in zip(values[T], values[J]):
        _assert_same(got, want, "forward")
    _assert_same(totals[T], totals[J], "compute after forward")


def test_forward_none_rules_match_jax():
    """A ``None`` batch value of a metric operand makes ``forward`` return ``None``."""

    def none_forward(pkg):
        class NoneForward(pkg.classification.MulticlassAccuracy):
            def forward(self, *args, **kwargs):
                self.update(*args, **kwargs)
                return None

        return NoneForward

    probs, labels = _batches()[0]
    for pkg, args, kw in ((J, (jnp.asarray(probs), jnp.asarray(labels)), {}),
                          (T, (torch.from_numpy(probs), torch.from_numpy(labels)), {"device": "cpu"})):
        quiet = none_forward(pkg)(num_classes=C, **kw)
        assert (quiet + 1)(*args) is None
        assert (2 * quiet)(*args) is None
        assert (_make(pkg, "float") - quiet)(*args) is None


def test_repr_and_persistent_match_jax():
    for pkg in (J, T):
        composed = _make(pkg, "float") * 2
        composed.persistent(True)
        assert composed.metric_a._persistent == {k: True for k in composed.metric_a._defaults}
    assert repr(_make(T, "float") - _make(T, "float2")) == repr(_make(J, "float") - _make(J, "float2")).replace("subtract", "sub")


# ----------------------------------------------------------------- traps


def test_eq_returns_a_compositional_metric_and_metrics_stay_hashable():
    """``__eq__`` composes, so a class defining it must define ``__hash__``:
    the port hashes the class name and the states' bytes, as JAX does (equal
    states give equal hashes across the packages); ``in`` and ``==`` on
    metrics are True for a different metric, which is why the port compares
    metrics by identity."""
    tm, jm = _fed(T, "int"), _fed(J, "int")
    other = _fed(T, "int2")
    assert isinstance(tm == other, CompositionalMetric) and isinstance(tm != other, CompositionalMetric)
    assert hash(tm) == hash(jm)  # same class name, bitwise equal states
    assert hash(tm) != hash(other)
    assert tm in [other]  # the trap: identity fails, then == returns a truthy metric
    assert not any(m is tm for m in [other])
    composed = tm + other
    assert hash(composed) == object.__hash__(composed)
    assert {tm: 1, other: 2}[other] == 2  # dict lookup hashes first, then compares


@pytest.mark.parametrize("left", ["tensor", "int", "float", "np_float32"])
@pytest.mark.parametrize("op", ["add", "mul", "sub"])
def test_left_operands_reach_the_reflected_operators(left, op):
    """A tensor, a Python number and a numpy scalar on the left of ``+``,
    ``*`` and ``-`` end in the metric's reflected operator, as JAX's
    arrays, numbers and numpy scalars do, with the same value."""
    lefts = {"tensor": (torch.tensor(2.0), jnp.asarray(2.0)), "int": (2, 2), "float": (2.5, 2.5),
             "np_float32": (np.float32(0.5), np.float32(0.5))}
    fn = {"add": operator.add, "mul": operator.mul, "sub": operator.sub}[op]
    tl, jl = lefts[left]
    with _alarm():
        got = fn(tl, _fed(T, "float"))
        want = fn(jl, _fed(J, "float"))
    assert type(got).__name__ == type(want).__name__ == "CompositionalMetric", (type(got), type(want))
    _assert_same(got.compute(), want.compute(), f"{left} {op} metric")


def test_a_metric_iterates_as_jax_does():
    """``__getitem__`` without ``__len__``: ``iter(metric)`` succeeds in both
    packages and yields composed metrics; only a bounded number is taken."""
    with _alarm():
        for pkg in (J, T):
            items = iter(_make(pkg, "vector"))
            first = next(items)
            assert type(first).__name__ == "CompositionalMetric"


@pytest.mark.parametrize("scalar", ["int", "float", "np_float64", "np_int64", "bool"])
@pytest.mark.parametrize("order", ["metric_first", "scalar_first"])
@pytest.mark.parametrize("kind", ["float", "int"])
def test_scalar_operands_take_jax_dtypes(scalar, order, kind):
    """``jnp.asarray(2)`` is a weak int32 where ``torch.as_tensor(2)`` is
    int64: the result dtype equals JAX's in both operand orders, and the
    scalar lives on the metric operand's device."""
    value = SCALARS[scalar]
    results = {}
    for pkg in (J, T):
        metric = _fed(pkg, kind)
        composed = metric + value if order == "metric_first" else value + metric
        results[pkg] = composed.compute()
        if pkg is T:
            held = composed.metric_b if order == "metric_first" else composed.metric_a
            assert isinstance(held, torch.Tensor) and held.device == metric.device
    _assert_same(results[T], results[J], f"{kind} {order} {scalar}")


def test_operands_on_two_devices_raise():
    cpu = _make(T, "float")
    meta = T.classification.MulticlassF1Score(num_classes=C, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        cpu + meta
    assert (cpu + 1).device == cpu.device and (meta * 2).device == meta.device
