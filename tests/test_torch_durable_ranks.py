# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Durable kill-and-resume across two gloo ranks, against the JAX package.

This file run as a script is the worker (``python
tests/test_torch_durable_ranks.py <rank> 2 <addr> durable <out_dir>``; it
imports no JAX). Both ranks hold one seeded stream of 4 batches and take
half the rows of each. Two regimes, each killed after batch 3 (the last
snapshot at batch 2) and resumed in a freshly built headline suite:

- replica: plain updates of the local rows, one store directory per rank
  (``write_rank=None``); ``compute()`` syncs, and every write of a rank lands
  in its own directory;
- sharded fused: ``fused=True`` with ``fused_options={"mesh": ...}`` and one
  store that rank 0 alone writes (``write_rank=0``; rank 1 writes no file).
  The restored members are re-marked mesh-replicated before the plan is
  built (a bare restore of the same snapshot is refused by the mesh plan,
  checked too), and ``compute()`` does not sync again.

The parent holds the results against JAX's ``sharded_update`` over a
2-device mesh of the whole batches: in the sharded regime each rank's int32
states bitwise; in the replica regime the two ranks' local int32 states
summed bitwise; the synced values within rtol 1e-6, atol 1e-7.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_sync import run_workers

C, N, NB, THR = 5, 48, 4, 16
HALF = N // 2
KILL_AFTER = 2  # the fault skips two hits: the run dies after batch 3, the last snapshot is at 2


def _batches():
    rng = np.random.default_rng(17)
    out = []
    for _ in range(NB):
        x = rng.standard_normal((N, C)).astype(np.float32)
        probs = (np.exp(x) / np.exp(x).sum(1, keepdims=True)).astype(np.float32)
        out.append((probs, rng.integers(0, C, N).astype(np.int32)))
    return out


def _suite(pkg, **kw):
    cls = pkg.classification
    return pkg.MetricCollection(
        {
            "acc": cls.MulticlassAccuracy(num_classes=C, average="micro", **kw),
            "f1": cls.MulticlassF1Score(num_classes=C, average="macro", **kw),
            "auroc": cls.MulticlassAUROC(num_classes=C, thresholds=THR, **kw),
        }
    )


# -------------------------------------------------------------------- worker


def _drive(T, rank, out_dir, regime, mesh, local, saved):
    import torch.distributed as dist

    from torchmetrics_tpu_torch.robustness import CheckpointStore, StreamingEvaluator, faults
    from torchmetrics_tpu_torch.robustness import store_format as fmt
    from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

    if regime == "replica":
        directory, options = out_dir / f"replica_rank{rank}", {"write_rank": None}
        kw = {}
    else:
        directory, options = out_dir / "sharded", {"write_rank": 0}
        kw = {"fused": True, "fused_options": {"mesh": mesh}}

    written = []
    atomic_write = fmt.atomic_write

    def recording_write(path, data):
        written.append(str(path))
        atomic_write(path, data)

    syncs = []
    sync_dist = T.Metric._sync_dist

    def counting_sync(self, *args, **kwargs):
        syncs.append(type(self).__name__)
        return sync_dist(self, *args, **kwargs)

    fmt.atomic_write, T.Metric._sync_dist = recording_write, counting_sync
    try:
        ev = StreamingEvaluator(_suite(T, device="cpu"), store=CheckpointStore(str(directory), keep_last=2, **options),
                                snapshot_every_n=2, **kw)
        with faults.inject(faults.Fault("preempt", "runner.preempt", after=KILL_AFTER, count=1)):
            try:
                ev.run(local)
            except faults.SimulatedPreemption:
                pass
            else:
                raise AssertionError(f"{regime}: the run was not killed")
        dist.barrier()  # rank 0's snapshot is on disk before any rank reads the store
        store = CheckpointStore(str(directory), keep_last=2, **options)
        assert store.last_step() == 2, (regime, store.steps())

        if regime == "sharded":
            # a bare restore of a mesh snapshot gives rank-local states, which the mesh plan refuses
            bare = _suite(T, device="cpu")
            StreamingEvaluator(bare, store=store).serve_open()
            try:
                bare.fused(mesh=mesh)
            except TorchMetricsUserError as err:
                assert "Call reset() first" in str(err), err
            else:
                raise AssertionError("a mesh plan accepted a bare (rank-local) restore")

        syncs.clear()
        resumed = StreamingEvaluator(_suite(T, device="cpu"), store=store, snapshot_every_n=2, **kw)
        value = resumed.resume(local)
        assert resumed.cursor == NB
    finally:
        fmt.atomic_write, T.Metric._sync_dist = atomic_write, sync_dist

    if regime == "replica":
        assert syncs, "the replica regime's compute() did not sync"
        assert written and all(Path(p).parent == directory for p in written), written
    else:
        assert not syncs, f"the sharded regime synced again: {syncs}"
        for _, m in resumed.metric.items(keep_base=True, copy_state=False):
            assert m._mesh_replicated and not m._is_synced
        assert bool(written) == (rank == 0), f"rank {rank} wrote {written}"
    for key, m in resumed.metric.items(keep_base=True, copy_state=False):
        for name, state in m.state_tree().items():
            saved[f"{regime}.{key}.{name}"] = state.numpy()
    for key, v in value.items():
        saved[f"{regime}.value.{key}"] = v.numpy()
    print(f"rank {rank}: {regime} kill and resume passed", flush=True)


def _scenario_durable(rank: int, world: int, out_dir: Path) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import torchmetrics_tpu_torch as T

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    shard = slice(rank * HALF, (rank + 1) * HALF)
    local = [tuple(torch.from_numpy(x[shard]) for x in b) for b in _batches()]
    saved: dict = {}
    for regime in ("replica", "sharded"):
        _drive(T, rank, out_dir, regime, mesh, local, saved)
    np.savez(out_dir / f"durable_rank{rank}.npz", **saved)
    dist.barrier()
    print(f"rank {rank}: all durable checks passed", flush=True)


def _worker_main(argv) -> None:
    import torch.distributed as dist

    rank, world, addr, out_dir = int(argv[1]), int(argv[2]), argv[3], Path(argv[5])
    dist.init_process_group("gloo", init_method=addr, world_size=world, rank=rank)
    try:
        _scenario_durable(rank, world, out_dir)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- the tests


@pytest.fixture(scope="module")
def worker_states(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("durable")
    results = run_workers(Path(__file__), "durable", out_dir, timeout=150)
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank}: all durable checks passed" in out, out
    return [dict(np.load(out_dir / f"durable_rank{rank}.npz")) for rank in range(2)]


@pytest.fixture(scope="module")
def jax_suite():
    """JAX's suite after ``sharded_update`` of the whole batches over a 2-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import torchmetrics_tpu as J
    from torchmetrics_tpu.parallel import sharded_update

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    suite = _suite(J)
    for b in _batches():
        for _, m in suite.items(keep_base=True, copy_state=False):
            sharded_update(m, mesh, *(jnp.asarray(x) for x in b))
    return suite


def _jax_states(suite):
    return {f"{key}.{name}": np.asarray(v) for key, m in suite.items(keep_base=True, copy_state=False)
            for name, v in m.state_tree().items()}


def _assert_bitwise(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _assert_values(saved, regime, want):
    for key, value in want.items():
        np.testing.assert_allclose(saved[f"{regime}.value.{key}"], np.asarray(value), rtol=1e-6, atol=1e-7, err_msg=f"{regime} {key}")


def test_sharded_fused_resume_matches_jax_two_devices(worker_states, jax_suite):
    want = _jax_states(jax_suite)
    for rank, saved in enumerate(worker_states):
        for name, value in want.items():
            _assert_bitwise(saved[f"sharded.{name}"], value, f"rank {rank} sharded {name}")
        _assert_values(saved, "sharded", jax_suite.compute())


def test_replica_resume_matches_jax_two_devices(worker_states, jax_suite):
    want = _jax_states(jax_suite)
    for name, value in want.items():
        summed = worker_states[0][f"replica.{name}"] + worker_states[1][f"replica.{name}"]
        _assert_bitwise(summed.astype(value.dtype), value, f"replica {name}")
    for saved in worker_states:
        _assert_values(saved, "replica", jax_suite.compute())


if __name__ == "__main__":
    _worker_main(sys.argv)
