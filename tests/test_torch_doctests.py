# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Doctest runner over the whole port (counterpart of ``tests/unittests/test_doctests.py``).

Walks every ``torchmetrics_tpu_torch`` module, collects the ``>>>`` examples
of its module, class and function docstrings (the tables of
``_examples.py``/``_examples_generated.py`` attached at import, the factory
classes' own) and runs them on the CPU. Then it holds the port's surface to
the JAX package's: at least as many examples, an example on every public
metric class and as many such classes, and the two example tables read as
data, key by key: the same expected output, letter for letter, and the
same source but for the port's module name and ``device='cpu'``
(``_TORCH_ARITHMETIC`` lists the custom-metric examples whose arithmetic is
written in torch, and why).
"""
import doctest
import importlib
import inspect
import pkgutil
import re

import pytest

import torchmetrics_tpu
import torchmetrics_tpu_torch

#: the native extensions' package (it compiles C++ at first use), as JAX's runner skips its own
_SKIP_PREFIXES = ("torchmetrics_tpu_torch.native",)

#: the subpackages whose ``__all__`` name the public metric classes (JAX's runner's list)
_SUBS = ("classification", "clustering", "nominal", "detection", "segmentation", "image",
         "audio", "text", "retrieval", "regression", "wrappers", "aggregation", "multimodal", "")

#: examples whose source is JAX's but for more than the module and the device: a custom metric's own
#: arithmetic, written with torch where JAX's uses ``jnp``; the port's retrieval base evaluates a
#: ``(Q, L)`` grid in ``_metric_rows`` where JAX's vmaps a one-row ``_metric_row``
_TORCH_ARITHMETIC = {
    "metric.Metric": "the state default and the update in torch",
    "retrieval.base.RetrievalMetric": "the row kernel over the whole grid in torch (_metric_rows)",
    "wrappers.transformations.MetricInputTransformer": "the clamp in torch",
}


def _modules(package, skip=()):
    names = {package.__name__}
    for info in pkgutil.walk_packages(package.__path__, prefix=f"{package.__name__}."):
        if not info.name.startswith(skip):
            names.add(info.name)
    return sorted(names)


_MODULES = _modules(torchmetrics_tpu_torch, _SKIP_PREFIXES)


def _docstring_examples(module_name):
    module = importlib.import_module(module_name)
    return [t for t in doctest.DocTestFinder(exclude_empty=True).find(module, module_name) if t.examples]


@pytest.mark.parametrize("module_name", _MODULES)
def test_module_doctests(module_name):
    runner = doctest.DocTestRunner(optionflags=doctest.NORMALIZE_WHITESPACE | doctest.ELLIPSIS)
    failures = sum(runner.run(test).failed for test in _docstring_examples(module_name))
    assert failures == 0, f"{failures} doctest failure(s) in {module_name}"


def _count(package, skip):
    total = 0
    for name in _modules(package, skip):
        try:
            total += len(_docstring_examples(name))
        except Exception:  # a JAX module gated on an optional dependency, as JAX's runner skips it
            continue
    return total


def test_example_count_at_least_jax_s():
    jax_count = _count(torchmetrics_tpu, ("torchmetrics_tpu.native",))
    port_count = _count(torchmetrics_tpu_torch, _SKIP_PREFIXES)
    assert jax_count >= 220
    assert port_count >= jax_count, f"the port has {port_count} docstring examples, the JAX package {jax_count}"


def _public_classes(package):
    base = importlib.import_module(f"{package}.metric").Metric
    seen, have = set(), 0
    for sub in _SUBS:
        module = importlib.import_module(f"{package}.{sub}" if sub else package)
        for name in getattr(module, "__all__", []):
            obj = getattr(module, name, None)
            if inspect.isclass(obj) and issubclass(obj, base) and name not in seen:
                seen.add(name)
                have += bool(obj.__doc__ and ">>>" in obj.__doc__)
    return seen, have


def test_every_public_class_carries_an_example_as_in_jax():
    seen, have = _public_classes("torchmetrics_tpu_torch")
    jseen, _ = _public_classes("torchmetrics_tpu")
    assert have == len(seen), f"only {have}/{len(seen)} public classes carry a docstring example"
    assert seen == jseen, (sorted(jseen - seen), sorted(seen - jseen))
    assert len(seen) >= 224


def _tables(package):
    manual = importlib.import_module(f"{package}._examples")._EXAMPLES
    generated = importlib.import_module(f"{package}._examples_generated")
    return manual, generated._GENERATED, generated._PROVENANCE


def test_provenance_covers_the_generated_table_as_in_jax():
    _, generated, provenance = _tables("torchmetrics_tpu_torch")
    _, jgenerated, jprovenance = _tables("torchmetrics_tpu")
    assert set(provenance) == set(generated)
    assert provenance == jprovenance


def _parsed(text):
    return doctest.DocTestParser().get_examples(text)


def _as_jax(source):
    """A port example's source as JAX's would read: the package's name back, ``device='cpu'`` out."""
    source = source.replace("torchmetrics_tpu_torch", "torchmetrics_tpu")
    return re.sub(r"(, )?device='cpu'", "", source)


@pytest.mark.parametrize("table", ["manual", "generated"])
def test_tables_equal_jax_s_output_for_output(table):
    """Every key of both packages' tables: the same examples, the same expected output letter for letter,
    the same directives (the +SKIP of the pretrained towers), the same source but for the module name and
    ``device='cpu'``; every constructor of a leaf metric is given ``device='cpu'``."""
    index = {"manual": 0, "generated": 1}[table]
    port, jax_ = _tables("torchmetrics_tpu_torch")[index], _tables("torchmetrics_tpu")[index]
    assert list(port) == list(jax_)
    for key in jax_:
        got, want = _parsed(port[key]), _parsed(jax_[key])
        assert len(got) == len(want), key
        assert [e.want for e in got] == [e.want for e in want], key  # no key's output differs from JAX's
        assert [e.options for e in got] == [e.options for e in want], key
        assert "jnp" not in port[key] and "import jax" not in port[key], key
        if key not in _TORCH_ARITHMETIC:
            assert [_as_jax(e.source) for e in got] == [e.source for e in want], key
        if "metric = " in port[key] and "Wrapper" not in key and "Transformer" not in key:
            assert "device='cpu'" in port[key], key
