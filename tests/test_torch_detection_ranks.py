# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Detection states across two gloo ranks: ``MeanAveragePrecision`` with
the mixed ``("bbox", "segm")`` tuple, whose RLE mask lists take the object
gather while its tensor lists take the base gather, both merged by element
index, so each mask stays beside its boxes, scores and labels; and
``PanopticQuality``'s ``"sum"`` states.

This file run as a script is the worker (``python tests/test_torch_detection_ranks.py
<rank> <world> <addr> detection <out_dir>``; no JAX): rank ``r`` updates
images ``r, r + 2, ...`` of a seeded stream, so the merged order is the
stream's own; each rank checks the merged lists against the stream and
saves its synced results (``.npz``). The parent holds them against one
metric of each package fed the whole stream: the port's bitwise, JAX's
tables bitwise and its summaries within 1e-6.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_sync import run_workers

N_IMAGES = 6
THINGS, STUFFS = {0, 1}, {6}


def _rects(rng, n, size=64):
    xy = rng.integers(0, size - 12, (n, 2))
    return np.concatenate([xy, xy + rng.integers(4, 12, (n, 2))], 1).astype(np.float64)


def _masks(rects, size=64):
    out = np.zeros((len(rects), size, size), np.uint8)
    for i, (x1, y1, x2, y2) in enumerate(rects.astype(int)):
        out[i, y1:y2, x1:x2] = 1
    return out


def _stream():
    """N_IMAGES images of boxes and rectangle masks (detections jittered from the ground truths), numpy."""
    rng = np.random.default_rng(19)
    preds, target = [], []
    for _ in range(N_IMAGES):
        n_g, n_d = int(rng.integers(1, 5)), int(rng.integers(1, 7))
        gt = _rects(rng, n_g)
        det = _rects(rng, n_d)
        k = min(n_g, n_d)
        det[:k] = np.clip(gt[:k] + rng.integers(-2, 3, (k, 4)), 0, 63)
        det[:, 2:] = np.maximum(det[:, 2:], det[:, :2] + 1)
        preds.append({"boxes": det, "masks": _masks(det), "scores": rng.random(n_d), "labels": rng.integers(0, 2, n_d)})
        target.append({"boxes": gt, "masks": _masks(gt), "labels": rng.integers(0, 2, n_g),
                       "iscrowd": (rng.random(n_g) < 0.2).astype(np.int64)})
    return preds, target


def _panoptic():
    rng = np.random.default_rng(20)
    target = np.stack([rng.choice([0, 1, 6], (4, 8, 8)), rng.integers(0, 3, (4, 8, 8))], -1)
    preds = target.copy()
    preds[..., 0] = np.where(rng.random((4, 8, 8)) < 0.3, rng.choice([0, 1, 6], (4, 8, 8)), preds[..., 0])
    return preds, target


# -------------------------------------------------------------------- worker


def _scenario_detection(rank: int, world: int, out_dir: Path) -> None:
    import torch.distributed as dist

    import torchmetrics_tpu_torch as T
    from torchmetrics_tpu_torch.functional.detection import mask_utils

    preds, target = _stream()
    mine = list(range(rank, N_IMAGES, world))
    metric = T.MeanAveragePrecision(iou_type=("bbox", "segm"), extended_summary=True, device="cpu")
    metric.update([preds[i] for i in mine], [target[i] for i in mine])
    saved = {f"map.{k}": v.numpy() for k, v in metric.compute().items()}  # compute() syncs both ranks
    metric.sync()
    assert len(metric.detection_box) == len(metric.detection_mask) == N_IMAGES
    for i in range(N_IMAGES):  # the merged order is the stream's, each mask beside its boxes
        assert np.array_equal(metric.detection_box[i].numpy(), preds[i]["boxes"].astype(np.float32))
        assert np.array_equal(metric.groundtruth_labels[i].numpy(), target[i]["labels"].astype(np.int32))
        for rle, m in zip(metric.detection_mask[i], preds[i]["masks"]):
            assert np.array_equal(rle["counts"], mask_utils.encode(m)["counts"])
        for rle, m in zip(metric.groundtruth_mask[i], target[i]["masks"]):
            assert np.array_equal(rle["counts"], mask_utils.encode(m)["counts"])
    metric.unsync()
    assert len(metric.detection_mask) == len(mine), "unsync did not restore the local masks"

    pq_preds, pq_target = _panoptic()
    pq = T.PanopticQuality(things=THINGS, stuffs=STUFFS, return_sq_and_rq=True, device="cpu")
    pq.update(torch.from_numpy(pq_preds[rank::world]), torch.from_numpy(pq_target[rank::world]))
    saved["pq"] = pq.compute().numpy()
    np.savez(out_dir / f"detection_rank{rank}.npz", **saved)
    dist.barrier()
    print(f"rank {rank}: all detection rank checks passed", flush=True)


def _worker_main(argv) -> None:
    import torch.distributed as dist

    rank, world, addr, out_dir = int(argv[1]), int(argv[2]), argv[3], Path(argv[5])
    dist.init_process_group("gloo", init_method=addr, world_size=world, rank=rank)
    try:
        _scenario_detection(rank, world, out_dir)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- the tests


@pytest.fixture(scope="module")
def worker_states(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("detection_ranks")
    results = run_workers(Path(__file__), "detection", out_dir, timeout=180)
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank}: all detection rank checks passed" in out, out
    return [dict(np.load(out_dir / f"detection_rank{rank}.npz")) for rank in range(2)]


def test_two_rank_mixed_map_equals_one_process(worker_states):
    """Both ranks' synced mixed-mode mAP equals one metric fed the whole
    stream: the port's bitwise; JAX's tables bitwise, summaries within 1e-6."""
    import torchmetrics_tpu as J
    import torchmetrics_tpu_torch as T

    preds, target = _stream()
    one = T.MeanAveragePrecision(iou_type=("bbox", "segm"), extended_summary=True, device="cpu")
    one.update(preds, target)
    want = {k: v.numpy() for k, v in one.compute().items()}
    jm = J.MeanAveragePrecision(iou_type=("bbox", "segm"), extended_summary=True)
    jm.update(preds, target)
    jwant = {k: np.asarray(v) for k, v in jm.compute().items()}
    for saved in worker_states:
        assert sorted(k[4:] for k in saved if k.startswith("map.")) == sorted(want) == sorted(jwant)
        for key, w in want.items():
            got = saved[f"map.{key}"]
            assert got.dtype == w.dtype and got.shape == w.shape, key
            np.testing.assert_array_equal(*(np.ascontiguousarray(np.atleast_1d(x)).view(np.uint8) for x in (got, w)), err_msg=key)
            if key.split("_", 1)[-1] in ("precision", "recall", "scores") or key == "classes":
                np.testing.assert_array_equal(got, jwant[key], err_msg=key)
            else:
                np.testing.assert_allclose(got, jwant[key], atol=1e-6, rtol=0, err_msg=key)


def test_two_rank_panoptic_quality_sums(worker_states):
    """PanopticQuality's summed states over two ranks equal one process's, bitwise."""
    import torchmetrics_tpu_torch as T

    pq_preds, pq_target = _panoptic()
    one = T.PanopticQuality(things=THINGS, stuffs=STUFFS, return_sq_and_rq=True, device="cpu")
    for rank in range(2):
        one.update(torch.from_numpy(pq_preds[rank::2]), torch.from_numpy(pq_target[rank::2]))
    want = one.compute().numpy()
    for saved in worker_states:
        np.testing.assert_array_equal(saved["pq"].view(np.uint8), want.view(np.uint8))


if __name__ == "__main__":
    _worker_main(sys.argv)
