# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The faults the port's metriclint found on captured paths, each pinned.

- An update that made a tensor from host data on its own device
  (``torch.tensor(x, device=...)``: a pageable copy, which a CUDA graph
  cannot capture): the exact matches' sample count, ``_safe_divide``'s zero
  (MeanIoU's update), VIF's epsilon, MS-SSIM's betas and the IoU family's
  threshold fill. Each now fills on the device; on the CPU the test makes
  every such upload raise while the update runs.
- LPIPS read the images' range on the host inside ``update``: the check now
  runs only where ``_is_concrete`` holds, as JAX's skips it on tracers.
- ``_mean_valid(s, dims=())`` reduced every dim (``sum(dim=())``) where
  ``jnp.sum(axis=())`` reduces none.

The values stay JAX's (``tests/test_torch_families.py``,
``test_torch_segmentation.py``, ``test_torch_image.py``,
``test_torch_detection.py``); ``chip_smoke.py``'s ``lint`` phase captures
each repaired update on the card and holds it bitwise to its eager fold.
"""
import contextlib

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch.functional.detection.iou import _iou_family_update
from torchmetrics_tpu_torch.functional.detection.map import _mean_valid
from torchmetrics_tpu_torch.image.lpip import _validate_lpips_inputs
from torchmetrics_tpu_torch.utilities.data import _device_values

CPU = "cpu"


@contextlib.contextmanager
def _no_uploads():
    """Make every tensor built from host data with an explicit device raise."""
    originals = {name: getattr(torch, name) for name in ("tensor", "as_tensor", "asarray")}

    def guard(name):
        def ctor(data, *args, **kwargs):
            if "device" in kwargs and not isinstance(data, torch.Tensor):
                raise AssertionError(f"torch.{name}(<host data>, device=...) inside a captured update")
            return originals[name](data, *args, **kwargs)

        return ctor

    for name in originals:
        setattr(torch, name, guard(name))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(torch, name, fn)


def _rng(seed):
    return np.random.default_rng(seed)


_CASES = {
    "MulticlassExactMatch": (lambda: tm.classification.MulticlassExactMatch(num_classes=3, device=CPU),
                             lambda r: (r.integers(0, 3, (8, 5)), r.integers(0, 3, (8, 5)))),
    "MultilabelExactMatch": (lambda: tm.classification.MultilabelExactMatch(num_labels=4, device=CPU),
                             lambda r: (r.random((8, 4), dtype=np.float32), r.integers(0, 2, (8, 4)))),
    "MeanIoU": (lambda: tm.segmentation.MeanIoU(num_classes=3, device=CPU),
                lambda r: (r.integers(0, 3, (2, 8, 8)), r.integers(0, 3, (2, 8, 8)))),
    "VisualInformationFidelity": (lambda: tm.image.VisualInformationFidelity(device=CPU),
                                  lambda r: (r.random((1, 1, 41, 41), dtype=np.float32), r.random((1, 1, 41, 41), dtype=np.float32))),
    "MultiScaleStructuralSimilarityIndexMeasure": (
        lambda: tm.image.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device=CPU),
        lambda r: (r.random((1, 1, 180, 180), dtype=np.float32), r.random((1, 1, 180, 180), dtype=np.float32))),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_repaired_update_uploads_nothing(name):
    make, batch = _CASES[name]
    metric = make()
    preds, target = (torch.from_numpy(np.ascontiguousarray(x)) for x in batch(_rng(0)))
    with _no_uploads():
        metric.update(preds, target)
    assert metric._update_count == 1


def test_iou_threshold_fills_on_the_device():
    from torchmetrics_tpu_torch.functional.detection.helpers import box_iou as _box_iou

    preds = torch.tensor([[0.0, 0.0, 10.0, 10.0], [5.0, 5.0, 15.0, 15.0]])
    target = torch.tensor([[0.0, 0.0, 10.0, 10.0]])
    want = _iou_family_update(_box_iou, preds, target, None)
    want = torch.where(want < 0.5, torch.full_like(want, -1.0), want)
    with _no_uploads():
        got = _iou_family_update(_box_iou, preds, target, 0.5, -1.0)
    assert torch.equal(got, want) and got.dtype == want.dtype and bool((got == -1.0).any())


def test_lpips_range_check_runs_only_where_values_can_be_read():
    bad = torch.full((2, 3, 8, 8), 3.0)
    with pytest.raises(ValueError, match="normalized tensors"):
        _validate_lpips_inputs(bad, bad, normalize=False)

    def checked(x):
        _validate_lpips_inputs(x[None], x[None], normalize=False)
        return x.sum()

    torch.func.vmap(checked)(bad)  # the capture's stand-in on the CPU: no host read, no raise


def test_mean_valid_over_no_dims_reduces_nothing():
    s = torch.tensor([[0.5, -1.0], [0.25, 0.75]])
    got = _mean_valid(s, ())
    assert torch.equal(got, torch.tensor([[0.5, -1.0], [0.25, 0.75]]))
    assert torch.equal(_mean_valid(s), torch.tensor(1.5 / 3))
    assert torch.equal(_mean_valid(s, (1,)), torch.tensor([0.5, 0.5]))


def test_device_values_round_as_torch_tensor():
    values = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        assert torch.equal(_device_values(values, dtype, CPU), torch.tensor(values, dtype=dtype))
