# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's sharded sliced plan (``SlicedPlan(mesh=...)``) across two gloo
ranks, against the port's local plan and the JAX package's mesh plan: the
counterpart of ``tests/unittests/bases/test_sliced.py::test_sliced_sharded_parity_full_suite``.

This file run as a script is the worker (``python tests/test_torch_sliced_ranks.py
<rank> <world> <addr> sliced <out_dir>``; no JAX): each rank passes its half
of every batch (keys and rows) to the mesh plan, builds the local plan over
the whole batches itself, checks that the two carries are bitwise equal
(table, int, cat and sketch leaves, the KLL sketch's serial fold included),
and saves its carry (``.npz``). The parent holds the saved carries against
JAX's ``SlicedPlan(mesh=...)`` over the whole batches on a 2-device virtual
mesh, bitwise.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_sync import run_workers

C, BATCH, NUM_CELLS, COHORTS, NB = 5, 48, 32, 7, 3


def _batches():
    rng = np.random.default_rng(21)
    out = []
    for _ in range(NB):
        x = rng.standard_normal((BATCH, C))
        e = np.exp(x - x.max(-1, keepdims=True))
        out.append((rng.integers(0, COHORTS, BATCH).astype(np.int32), (e / e.sum(-1, keepdims=True)).astype(np.float32),
                    rng.integers(0, C, BATCH).astype(np.int32)))
    return out


def _suite(pkg, with_kll=False):
    """Accuracy (K2s route), an add-style histogram sketch, exact AUROC (cat
    states) and, with ``with_kll``, a KLL sketch (the serial merge fold)."""
    torch_side = pkg.__name__ == "torchmetrics_tpu_torch"
    sk = pkg.sketch
    extra = {"device": "cpu"} if torch_side else {}

    def top(preds):
        return preds.max(-1).values if torch_side else preds.max(-1)

    class _ScoreHistogram(pkg.Metric):
        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("hist", sk.hist_init(bins=8, lo=0.0, hi=1.0, **extra), dist_reduce_fx="merge")

        def update(self, preds, target):
            self.hist = sk.hist_update(self.hist, top(preds))

        def compute(self):
            return self.hist.counts

    class _ScoreQuantile(pkg.Metric):
        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("sketch", sk.kll_init(capacity=16, levels=4, **extra), dist_reduce_fx="merge")

        def update(self, preds, target):
            self.sketch = sk.kll_update(self.sketch, top(preds))

        def compute(self):
            return self.sketch.count

    cls = pkg if torch_side else pkg.classification
    kw = dict(validate_args=False, distributed_available_fn=lambda: False, **extra)
    members = {
        "acc": cls.MulticlassAccuracy(num_classes=C, **kw),
        "auroc_exact": cls.MulticlassAUROC(num_classes=C, thresholds=None, **kw),
        "hist": _ScoreHistogram(distributed_available_fn=lambda: False, **extra),
    }
    if with_kll:
        members["kll"] = _ScoreQuantile(distributed_available_fn=lambda: False, **extra)
    return pkg.MetricCollection(members, compute_groups=False)


def _flatten(tree, prefix="", out=None):
    out = {} if out is None else out
    for key, value in tree.items():
        if isinstance(value, dict):
            _flatten(value, f"{prefix}{key}.", out)
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


# -------------------------------------------------------------------- worker


def _scenario_sliced(rank: int, world: int, out_dir: Path) -> None:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    import torchmetrics_tpu_torch as T
    from torchmetrics_tpu_torch.parallel import SlicedPlan

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    batches = _batches()
    half = BATCH // world
    example = tuple(torch.from_numpy(a) for a in batches[0][1:])
    kw = dict(num_cells=NUM_CELLS, cat_capacity=BATCH * NB + 8, example_batch=example)
    p_mesh = SlicedPlan(_suite(T, with_kll=True), mesh=mesh, **kw)
    p_local = SlicedPlan(_suite(T, with_kll=True), **kw)
    for keys, preds, target in batches:
        mine = slice(rank * half, (rank + 1) * half)
        p_mesh.update(torch.from_numpy(keys[mine]), torch.from_numpy(preds[mine]), torch.from_numpy(target[mine]))
        p_local.update(torch.from_numpy(keys), torch.from_numpy(preds), torch.from_numpy(target))
    got, want = _flatten(p_mesh.save_checkpoint()), _flatten(p_local.save_checkpoint())
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), f"rank {rank}: {key} differs from the local plan"
    # an exported cell of the mesh plan computes without a second sync
    cohort = int(batches[0][0][0])
    values = p_mesh.export_cell(cohort).compute()
    assert torch.equal(values["acc"], p_local.export_cell(cohort).compute()["acc"])
    np.savez(out_dir / f"sliced_rank{rank}.npz", **got)
    print(f"rank {rank}: sliced-sharded equals sliced-local bitwise")


def _worker_main(argv) -> None:
    import torch.distributed as dist

    rank, world, addr, out_dir = int(argv[1]), int(argv[2]), argv[3], Path(argv[5])
    dist.init_process_group("gloo", init_method=addr, world_size=world, rank=rank)
    try:
        _scenario_sliced(rank, world, out_dir)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- the tests


@pytest.fixture(scope="module")
def worker_states(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("sliced_ranks")
    results = run_workers(Path(__file__), "sliced", out_dir, timeout=180)
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} failed:\n{out}"
    return results, [dict(np.load(out_dir / f"sliced_rank{rank}.npz")) for rank in range(2)]


def test_sliced_sharded_equals_local_on_two_ranks(worker_states):
    """Each rank's mesh plan (its half of every batch) == the local plan over
    the whole batches, bitwise, on both ranks; the two ranks' carries agree."""
    results, states = worker_states
    for rank, (_, out) in enumerate(results):
        assert f"rank {rank}: sliced-sharded equals sliced-local bitwise" in out, out
    assert set(states[0]) == set(states[1])
    for key in states[0]:
        assert np.array_equal(states[0][key], states[1][key]), key


def test_sliced_sharded_equals_jax_mesh_plan(worker_states):
    """The two ranks' carries == JAX's ``SlicedPlan(mesh=...)`` over the same
    global batches on a 2-device mesh: the table and every leaf of the
    members JAX's plan holds, bitwise."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import torchmetrics_tpu as J
    from torchmetrics_tpu.parallel import SlicedPlan as JPlan

    _, states = worker_states
    batches = _batches()
    example = tuple(jnp.asarray(a) for a in batches[0][1:])
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    jp = JPlan(_suite(J), mesh=mesh, num_cells=NUM_CELLS, cat_capacity=BATCH * NB + 8, example_batch=example)
    for b in batches:
        jp.update(*(jnp.asarray(a) for a in b))
    want = _flatten(jp.save_checkpoint())
    for saved in states:
        for key, value in want.items():
            if key == "fingerprint":  # the port's suite holds one member more (the KLL sketch)
                continue
            assert key in saved, key
            assert saved[key].dtype == value.dtype and np.array_equal(saved[key], value), key


if __name__ == "__main__":
    _worker_main(sys.argv)
