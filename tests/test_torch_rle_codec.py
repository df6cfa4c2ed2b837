# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's RLE codec (``torchmetrics_tpu_torch/native``, its own copy of
``rle_codec.cpp`` built into its own ``_build/``) and its ``mask_utils``
against the JAX package's ``mask_utils`` and against the numpy plain routes.

Everything here is bitwise: run lengths are integers, areas are integer
counts in float64, and the IoU matrix is the same C++ float64 arithmetic on
both sides (the dense numpy route divides the same integers, so it agrees
to the last bit too, checked with ``assert_array_equal``). A build that
fails raises with the compiler's output: there is no numpy fallback.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from torchmetrics_tpu.functional.detection import mask_utils as JM
from torchmetrics_tpu_torch import native
from torchmetrics_tpu_torch.functional.detection import mask_utils as TM


def _masks(seed, n, shape, densities=(0.0, 0.05, 0.3, 0.7, 1.0)):
    rng = np.random.default_rng(seed)
    out = [(rng.random(shape) < densities[i % len(densities)]).astype(np.uint8) for i in range(n)]
    blob = np.zeros(shape, np.uint8)
    blob[shape[0] // 4: shape[0] // 2, shape[1] // 3: shape[1] - 1] = 1  # long runs across columns
    return out + [blob]


def _same_rle(got, want):
    assert got["size"] == want["size"]
    assert got["counts"].dtype == want["counts"].dtype == np.uint32
    np.testing.assert_array_equal(got["counts"], want["counts"])


def test_the_library_builds_from_the_port_source_into_the_port():
    lib_path = native._library_path("rle_codec")
    native.get_rle_library()
    assert lib_path.exists() and lib_path.parent == native._BUILD_DIR
    assert native._BUILD_DIR.parent.name == "native" and native._BUILD_DIR.parent.parent.name == "torchmetrics_tpu_torch"
    jax_src = native._HERE.parent.parent / "torchmetrics_tpu" / "native" / "rle_codec.cpp"
    assert (native._HERE / "rle_codec.cpp").read_bytes() == jax_src.read_bytes()  # copied as it is


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(native, "_HERE", tmp_path)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="building the native extension 'broken' failed") as err:
        native._build_library("broken")
    assert "error" in str(err.value)
    assert not list((tmp_path / "_build").glob("*"))  # no half-written library is left


@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (37, 53), (480, 64)])
def test_encode_decode_area_equal_jax_and_numpy(shape):
    for m in _masks(1, 5, shape):
        rle = TM.encode(m)
        _same_rle(rle, JM.encode(m))
        np.testing.assert_array_equal(rle["counts"], TM._encode_numpy(np.asarray(m).flatten(order="F")))
        np.testing.assert_array_equal(TM.decode(rle), m)
        np.testing.assert_array_equal(TM.decode(rle), JM.decode(rle))
        np.testing.assert_array_equal(TM._decode_numpy(rle), m)
        assert TM.area(rle) == JM.area(rle) == float(m.sum())
    rles = [TM.encode(m) for m in _masks(2, 4, shape)]
    np.testing.assert_array_equal(TM.area(rles), TM._area_numpy(rles))
    np.testing.assert_array_equal(TM.area(rles), JM.area(rles))


def test_encode_takes_tensors():
    m = _masks(3, 3, (20, 30))[1]
    _same_rle(TM.encode(torch.from_numpy(m)), JM.encode(m))


@pytest.mark.parametrize("crowd", [None, [0, 1, 0]])
def test_iou_matrix_equal_jax_and_the_dense_numpy_route(crowd):
    dts = [TM.encode(m) for m in _masks(4, 4, (40, 60), densities=(0.2, 0.5, 0.8))]
    gts = [TM.encode(m) for m in _masks(5, 2, (40, 60), densities=(0.3, 0.6))]
    got = TM.iou(dts, gts, iscrowd=crowd)
    assert got.dtype == np.float64 and got.shape == (5, 3)
    np.testing.assert_array_equal(got, JM.iou(dts, gts, iscrowd=crowd))
    np.testing.assert_array_equal(got, TM._iou_numpy(dts, gts, iscrowd=crowd))
    assert TM.iou([], []).shape == (0, 0) and TM.iou(dts[:1], []).shape == (1, 0)
    with pytest.raises(ValueError, match="one entry per gt"):
        TM.iou(dts, gts, iscrowd=[1])


def test_polygons_bboxes_and_merge_equal_jax():
    h, w = 40, 50
    polys = [
        [[10, 5, 30, 5, 30, 25, 10, 25]],
        [[0, 0, 40, 0, 0, 30]],
        [[2, 2, 8, 2, 8, 8, 2, 8], [20, 20, 28, 20, 28, 30, 20, 30]],
        [[5.5, 3.2, 44.1, 9.9, 30.3, 38.7, 1.0, 20.0], [25, 25, 35, 25, 35, 35]],
        [[1, 1, 2, 2]],  # degenerate: an empty mask
    ]
    for poly in polys:
        got, want = TM.from_polygons(poly, h, w), JM.from_polygons(poly, h, w)
        _same_rle(got, want)
        np.testing.assert_array_equal(TM.to_bbox(got), JM.to_bbox(want))
    rles = [TM.from_polygons(p, h, w) for p in polys]
    _same_rle(TM.merge_union(rles), JM.merge_union(rles))
    np.testing.assert_array_equal(TM.decode(TM.merge_union(rles)), np.any([TM.decode(r) for r in rles], 0).astype(np.uint8))
    np.testing.assert_array_equal(TM.to_bbox(rles), JM.to_bbox(rles))
    with pytest.raises(ValueError, match="positive integer"):
        TM.from_polygons(polys[0], 0, w)


def test_string_form_round_trips_and_equals_jax():
    for m in _masks(6, 5, (33, 47)):
        counts = TM.encode(m)["counts"]
        s = TM.rle_to_string(counts)
        assert s == JM.rle_to_string(counts)
        np.testing.assert_array_equal(TM.rle_from_string(s), counts)
        np.testing.assert_array_equal(TM.rle_from_string(s.encode()), JM.rle_from_string(s))
