# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's batched edit distance (``torchmetrics_tpu_torch/native``, its
own copy of ``edit_distance.cpp`` built with ``-fopenmp`` into its own
``_build/``) against the JAX package's ``_batch_edit_distance``: int64
distances bitwise on seeded token corpora, with empty and degenerate pairs
and substitution costs 1 and 2; the source byte-equal to JAX's; a failed
build raising with the compiler's output, with no fallback."""
from __future__ import annotations

import numpy as np
import pytest

from torchmetrics_tpu.functional.text.helper import _batch_edit_distance as jax_batch
from torchmetrics_tpu.functional.text.helper import _edit_distance as jax_python_dp
from torchmetrics_tpu_torch import native
from torchmetrics_tpu_torch.functional.text import helper
from torchmetrics_tpu_torch.functional.text.helper import _batch_edit_distance

_WORDS = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran", "xyz", "q", "Ünïcode", "東京", ""]


def _corpus(seed, n_pairs, max_len):
    rng = np.random.default_rng(seed)
    preds = [[str(w) for w in rng.choice(_WORDS, int(rng.integers(0, max_len + 1)))] for _ in range(n_pairs)]
    tgts = [[str(w) for w in rng.choice(_WORDS, int(rng.integers(0, max_len + 1)))] for _ in range(n_pairs)]
    return preds, tgts


@pytest.mark.parametrize("substitution_cost", [1, 2])
@pytest.mark.parametrize("n_pairs,max_len", [(1, 5), (63, 12), (65, 40), (400, 30)])
def test_batch_equals_jax(substitution_cost, n_pairs, max_len):
    """Below and above the 64 pairs where OpenMP takes over; JAX's per-pair Python DP agrees too."""
    preds, tgts = _corpus(n_pairs + max_len, n_pairs, max_len)
    got = _batch_edit_distance(preds, tgts, substitution_cost)
    want = jax_batch(preds, tgts, substitution_cost)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:50], [jax_python_dp(p, t, substitution_cost) for p, t in zip(preds[:50], tgts[:50])])


@pytest.mark.parametrize("substitution_cost", [1, 2])
def test_empty_and_degenerate_pairs_equal_jax(substitution_cost):
    preds = [[], ["a"], [], ["a", "b", "c"], ["a", "b"], ["x"] * 50, list("abcdef"), [1, 2, 3], [("t",), ("u",)]]
    tgts = [["x", "y"], [], [], ["a", "b", "c"], ["b", "a"], ["y"] * 3, list("fedcba"), [3, 2, 1], [("t",)]]
    got = _batch_edit_distance(preds, tgts, substitution_cost)
    np.testing.assert_array_equal(got, jax_batch(preds, tgts, substitution_cost))
    assert got[:4].tolist() == [2, 1, 0, 0]
    assert _batch_edit_distance([], [], substitution_cost).shape == (0,)


def test_mismatched_lengths_raise_as_jax():
    with pytest.raises(ValueError) as got:
        _batch_edit_distance([["a"]], [], 1)
    with pytest.raises(ValueError) as want:
        jax_batch([["a"]], [], 1)
    assert str(got.value) == str(want.value)


def test_source_is_jax_s_and_builds_into_the_port():
    lib_path = native._library_path("edit_distance")
    native.get_edit_library()
    assert lib_path.exists() and lib_path.parent == native._BUILD_DIR
    jax_src = native._HERE.parent.parent / "torchmetrics_tpu" / "native" / "edit_distance.cpp"
    assert (native._HERE / "edit_distance.cpp").read_bytes() == jax_src.read_bytes()  # copied as it is
    assert native._flags("edit_distance")[-1] == "-fopenmp" and "-fopenmp" not in native._flags("rle_codec")


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    """A broken source fails the build with g++'s output; the text metrics
    then raise too (no numpy route, no switch to turn the extension off)."""
    (tmp_path / "edit_distance.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(native, "_HERE", tmp_path)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="building the native extension 'edit_distance' failed") as err:
        helper._batch_edit_distance([["a"]], [["b"]])
    assert "-fopenmp" in str(err.value) and "error" in str(err.value)
    assert not list((tmp_path / "_build").glob("*"))
    from torchmetrics_tpu_torch.functional.text import word_error_rate

    with pytest.raises(RuntimeError, match="edit_distance"):
        word_error_rate(["a b"], ["a c"])
    assert not hasattr(helper, "_edit_distance")
    assert not hasattr(native, "_DISABLE_ENV")
