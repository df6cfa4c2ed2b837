# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's sketch ("merge") states across two gloo ranks, against the
JAX package's: the counterparts of ``test_multiprocess_sync.py``'s sketch
and drift merge-sync tests, the sharded update and the sharded fused plan
of sketch members (JAX's ``test_fused_sharded_sketch_parity``), and a
reservoir whose ``uint32`` key crosses the gather.

This file run as a script is the worker (``python tests/test_torch_sketch_ranks.py
<rank> <world> <addr> sketch <out_dir>``; no JAX): each rank drives its
shard, checks what it can alone (a synced sketch equals the merge of both
ranks' sketches, which each rank can rebuild from the shared seed) and saves
its states (``.npz``). The parent holds the sharded states against JAX's
``sharded_update`` and ``fused(mesh=...)`` over the whole batches on a
2-device virtual mesh, sketch leaves bitwise.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_sync import run_workers

QS = np.asarray([0.1, 0.5, 0.9], np.float32)
C, N, NB = 5, 64, 4


def _score_batches():
    rng = np.random.default_rng(3)
    return [(rng.standard_normal((N, C)).astype(np.float32), rng.integers(0, C, N).astype(np.int32)) for _ in range(NB)]


def _spearman_batches():
    rng = np.random.default_rng(13)
    out = []
    for _ in range(2):
        x = rng.standard_normal(2_000).astype(np.float32)
        out.append((x, (0.6 * x + 0.6 * rng.standard_normal(2_000)).astype(np.float32)))
    return out


def _quantile_batches():
    rng = np.random.default_rng(16)
    return [rng.normal(size=4_000).astype(np.float32) for _ in range(4)]


def _score_quantile_class(T, kll_init, kll_update, kll_quantile):
    """A metric with one KLL state over the top score of each row (JAX's
    ``_ScoreQuantile`` of ``test_fused.py`` takes the top softmax probability;
    the row max is the same on both packages bit for bit, so the sketches
    compare bitwise)."""

    class ScoreQuantile(T.Metric):
        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("sketch", kll_init(capacity=256, levels=8, **({} if T.__name__ == "torchmetrics_tpu" else {"device": "cpu"})),
                           dist_reduce_fx="merge")

        def update(self, preds, target):
            self.sketch = kll_update(self.sketch, preds.max(-1).values if isinstance(preds, torch.Tensor) else preds.max(-1))

        def compute(self):
            return kll_quantile(self.sketch, QS[1:2])[0]

    return ScoreQuantile


# -------------------------------------------------------------------- worker


def _save_sketch(saved: dict, prefix: str, state) -> None:
    for field, leaf in zip(state._fields, state):
        saved[f"{prefix}.{field}"] = leaf.numpy()


def _same_state(got, want, what: str) -> None:
    for field, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), f"{what}.{field}: {a} vs {b}"


def _scenario_sketch(rank: int, world: int, out_dir: Path) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import torchmetrics_tpu_torch as T
    from torchmetrics_tpu_torch import sketch as sk
    from torchmetrics_tpu_torch.drift import Cardinality, DriftScore, drift_scores
    from torchmetrics_tpu_torch.parallel import ShardedMetric, sharded_update
    from torchmetrics_tpu_torch.robustness import SyncConfig, faults
    from torchmetrics_tpu_torch.utilities.exceptions import SyncError

    saved: dict = {}
    rng = np.random.RandomState(42)  # identical on both ranks
    n_total = 40_000
    data = rng.randn(n_total).astype(np.float32)
    bounds = [0, 27_000, n_total]  # uneven split
    lo, hi = bounds[rank], bounds[rank + 1]

    # A) compute() syncs by pairwise merge in rank order, equal to the merge
    # of both ranks' sketches; inside the rank-error bound
    metric = T.Quantile(q=QS, capacity=256, levels=14, device="cpu")
    metric.update(torch.from_numpy(data[lo:hi]))
    parts = [sk.kll_update(sk.kll_init(256, 14, device="cpu"), torch.from_numpy(data[a:b])) for a, b in zip(bounds, bounds[1:])]
    metric.sync()
    _same_state(metric.sketch, sk.kll_merge(parts[0], parts[1]), "synced quantile")
    assert int(metric.sketch.count) == n_total
    bound = float(sk.kll_error_bound(metric.sketch))
    for q, est in zip(QS, sk.kll_quantile(metric.sketch, torch.from_numpy(QS)).numpy()):
        assert abs(float((data <= est).sum()) - q * n_total) <= bound + 1
    _save_sketch(saved, "quantile_sync", metric.sketch)
    metric.unsync()
    assert int(metric.sketch.count) == hi - lo, "unsync did not restore the local sketch"

    # B) below capacity the merged sketch is the sorted union
    exact = T.Quantile(q=0.5, capacity=4096, levels=14, device="cpu")
    exact.update(torch.from_numpy(data[lo:hi][:1500]))
    both = np.concatenate([data[0:1500], data[27_000:28_500]])
    assert float(exact.compute()) == float(np.sort(both)[int(np.ceil(0.5 * both.size)) - 1])

    # C) a corrupt payload from rank 1: SyncError naming rank 1 on both ranks, clean rollback
    bad = T.Quantile(q=0.5, capacity=256, sync_config=SyncConfig(retries=0), device="cpu")
    bad.update(torch.from_numpy(data[lo:hi]))
    before = int(bad.sketch.count)
    with faults.inject(faults.Fault("corrupt", "sync.sketch_state", arg=1, count=1)):
        try:
            bad.sync()
            raise AssertionError("corrupt sketch gather did not raise")
        except SyncError as err:
            assert "rank 1" in str(err) and "sketch" in str(err), err
    assert not bad._is_synced and int(bad.sketch.count) == before
    bad._computed = None
    assert abs(float(bad.compute()) - float(np.quantile(data, 0.5))) <= 0.05
    print(f"rank {rank}: all sketch merge-sync checks passed", flush=True)

    # D) drift: the union distinct count, and the pooled live window
    n_distinct = 50_000
    tags = rng.permutation(n_distinct).astype(np.int32)
    card_bounds = [(0, 33_000), (25_000, n_distinct)]
    card = Cardinality(precision=12, device="cpu")
    card.update(torch.from_numpy(tags[slice(*card_bounds[rank])]))
    card.sync()
    hll_parts = [sk.hll_update(sk.hll_init(12, device="cpu"), torch.from_numpy(tags[slice(*b)])) for b in card_bounds]
    _same_state(card.sketch, sk.hll_merge(*hll_parts), "synced HLL")
    assert abs(float(sk.hll_cardinality(card.sketch)) - n_distinct) / n_distinct <= 3 * card.error_bound()
    card.unsync()
    ref_sample = rng.normal(0.5, 0.1, 16_384).astype(np.float32)
    live_total = rng.normal(0.62, 0.1, 9_000).astype(np.float32)
    lbounds = [0, 6_000, 9_000]
    ds = DriftScore(reference=torch.from_numpy(ref_sample), bins=32, lo=0.0, hi=1.0, patience=1, device="cpu")
    ds.update(torch.from_numpy(live_total[lbounds[rank]:lbounds[rank + 1]]))
    ds.sync()
    reference = sk.hist_update(sk.hist_init(32, 0.0, 1.0, device="cpu"), torch.from_numpy(ref_sample))
    pooled = sk.hist_update(sk.hist_init(32, 0.0, 1.0, device="cpu"), torch.from_numpy(live_total))
    _same_state(ds.live, pooled, "pooled live window")
    # the synced window's scores (compute() would sync again)
    for name, got, want in zip(("psi", "kl", "ks"), drift_scores(ds.reference, ds.live), drift_scores(reference, pooled)):
        assert torch.equal(got, want), f"synced {name}: {got} vs {want}"
        saved[f"drift.{name}"] = got.numpy()
    ds.unsync()
    assert int(ds.live.count) == lbounds[rank + 1] - lbounds[rank]
    print(f"rank {rank}: all drift merge-sync checks passed", flush=True)

    # E) a reservoir per rank (its own rank folded into the key): the synced
    # state is the merge of both, its uint32 key carried across the gather
    class Sample(T.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("res", sk.reservoir_init(64, seed=7, rank=rank, device="cpu"), dist_reduce_fx="merge")

        def update(self, x):
            self.res = sk.reservoir_update(self.res, x)

        def compute(self):
            return self.res.values

    sample = Sample(device="cpu")
    sample.update(torch.from_numpy(data[lo:hi]))
    res_parts = [sk.reservoir_update(sk.reservoir_init(64, seed=7, rank=r, device="cpu"), torch.from_numpy(data[a:b]))
                 for r, (a, b) in enumerate(zip(bounds, bounds[1:]))]
    sample.sync()
    _same_state(sample.res, sk.reservoir_merge(*res_parts), "synced reservoir")
    assert sample.res.key.dtype == torch.uint32
    _save_sketch(saved, "reservoir_sync", sample.res)
    sample.unsync()

    # F) the sharded update of sketch states over a 2-rank mesh: each rank
    # holds half the rows of every batch
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    shard_q = ShardedMetric(T.Quantile(q=QS, capacity=128, levels=14, device="cpu"), mesh)
    for batch in _quantile_batches():
        half = batch.size // 2
        shard_q.update(torch.from_numpy(batch[rank * half:(rank + 1) * half]))
    _save_sketch(saved, "sharded_quantile", shard_q._metric.sketch)
    spear = T.SpearmanCorrCoef(num_bins=32, device="cpu")
    for x, y in _spearman_batches():
        half = x.size // 2
        sharded_update(spear, mesh, torch.from_numpy(x[rank * half:(rank + 1) * half]), torch.from_numpy(y[rank * half:(rank + 1) * half]))
    _save_sketch(saved, "sharded_spearman_preds", spear.preds_sketch)
    saved["sharded_spearman_joint"] = spear.joint.numpy()
    saved["sharded_spearman_value"] = spear.compute().numpy()

    # G) the sharded fused plan with a sketch member == sharded_update, bitwise
    score_quantile = _score_quantile_class(T, sk.kll_init, sk.kll_update, sk.kll_quantile)
    ref = score_quantile(device="cpu")
    fus = score_quantile(device="cpu")
    plan = T.MetricCollection({"sq": fus}).fused(mesh=mesh)
    for preds, target in _score_batches():
        local = (torch.from_numpy(preds[rank * (N // 2):(rank + 1) * (N // 2)]), torch.from_numpy(target[rank * (N // 2):(rank + 1) * (N // 2)]))
        sharded_update(ref, mesh, *local)
        plan.update(*local)
    plan.fold_back()
    _same_state(fus.sketch, ref.sketch, "fused sharded sketch")
    assert torch.equal(fus.compute(), ref.compute())
    _save_sketch(saved, "fused_sketch", fus.sketch)

    np.savez(out_dir / f"sketch_rank{rank}.npz", **saved)
    dist.barrier()
    print(f"rank {rank}: all sketch rank checks passed", flush=True)


def _worker_main(argv) -> None:
    import torch.distributed as dist

    rank, world, addr, out_dir = int(argv[1]), int(argv[2]), argv[3], Path(argv[5])
    dist.init_process_group("gloo", init_method=addr, world_size=world, rank=rank)
    try:
        _scenario_sketch(rank, world, out_dir)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- the tests


@pytest.fixture(scope="module")
def worker_states(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("sketch_ranks")
    results = run_workers(Path(__file__), "sketch", out_dir, timeout=180)
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} failed:\n{out}"
    return results, [dict(np.load(out_dir / f"sketch_rank{rank}.npz")) for rank in range(2)]


def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:2]), ("data",))


def _assert_leaves(saved: dict, prefix: str, state) -> None:
    for field, leaf in zip(state._fields, state):
        got, want = np.atleast_1d(saved[f"{prefix}.{field}"]), np.atleast_1d(np.asarray(leaf))
        assert got.dtype == want.dtype and got.shape == want.shape, (prefix, field, got.dtype, want.dtype)
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=f"{prefix}.{field}")


def test_two_process_sketch_merge_sync(worker_states):
    """A real two-rank merge sync of a ``Quantile``: equal to the merge of both
    ranks' sketches, in the bound, exact below capacity; a corrupt payload
    raises naming rank 1 on both ranks and rolls back. Both ranks end with
    the JAX package's merge of the two shards' sketches."""
    from torchmetrics_tpu import sketch as jsk

    results, states = worker_states
    for rank, (_, out) in enumerate(results):
        assert f"rank {rank}: all sketch merge-sync checks passed" in out, out
    data = np.random.RandomState(42).randn(40_000).astype(np.float32)
    want = jsk.kll_merge(*[jsk.kll_update(jsk.kll_init(256, 14), data[a:b]) for a, b in ((0, 27_000), (27_000, 40_000))])
    for saved in states:
        _assert_leaves(saved, "quantile_sync", want)


def test_two_process_drift_merge_sync(worker_states):
    """``Cardinality`` syncs to the union distinct count and ``DriftScore``
    pools the live windows: the synced scores equal the JAX package's scores
    of the concatenated stream (PSI/KL within rtol 1e-5, KS within atol 1e-7)."""
    import jax.numpy as jnp

    from torchmetrics_tpu import drift as jdr
    from torchmetrics_tpu import sketch as jsk

    results, states = worker_states
    for rank, (_, out) in enumerate(results):
        assert f"rank {rank}: all drift merge-sync checks passed" in out, out
    rng = np.random.RandomState(42)
    rng.randn(40_000)
    rng.permutation(50_000)
    ref_sample = rng.normal(0.5, 0.1, 16_384).astype(np.float32)
    live_total = rng.normal(0.62, 0.1, 9_000).astype(np.float32)
    want = jdr.drift_scores(jsk.hist_update(jsk.hist_init(32, 0.0, 1.0), jnp.asarray(ref_sample)),
                            jsk.hist_update(jsk.hist_init(32, 0.0, 1.0), jnp.asarray(live_total)))
    for saved in states:
        np.testing.assert_allclose(saved["drift.psi"], np.asarray(want.psi), rtol=1e-5)
        np.testing.assert_allclose(saved["drift.kl"], np.asarray(want.kl), rtol=1e-5)
        np.testing.assert_allclose(saved["drift.ks"], np.asarray(want.ks), rtol=2.0**-23, atol=1e-7)


def test_reservoir_key_crosses_the_gather(worker_states):
    """A reservoir synced across the ranks (its ``uint32`` key sent as int32
    bits) equals the JAX package's merge of both ranks' reservoirs."""
    from torchmetrics_tpu import sketch as jsk

    _, states = worker_states
    data = np.random.RandomState(42).randn(40_000).astype(np.float32)
    parts = [jsk.reservoir_update(jsk.reservoir_init(64, seed=7, rank=r), data[a:b]) for r, (a, b) in enumerate(((0, 27_000), (27_000, 40_000)))]
    for saved in states:
        _assert_leaves(saved, "reservoir_sync", jsk.reservoir_merge(*parts))


def test_sharded_sketch_states_match_jax(worker_states):
    """``ShardedMetric(Quantile)`` and bounded Spearman under ``sharded_update``
    over two ranks == JAX's ``sharded_update`` over the whole batches on a
    2-device mesh: sketch leaves and the joint grid bitwise, rho within 1e-5."""
    import jax.numpy as jnp

    import torchmetrics_tpu as J
    from torchmetrics_tpu.parallel import ShardedMetric, sharded_update

    _, states = worker_states
    jq = ShardedMetric(J.Quantile(q=QS, capacity=128, levels=14), _jax_mesh())
    for batch in _quantile_batches():
        jq.update(jnp.asarray(batch))
    spear = J.SpearmanCorrCoef(num_bins=32)
    for x, y in _spearman_batches():
        sharded_update(spear, _jax_mesh(), jnp.asarray(x), jnp.asarray(y))
    for saved in states:
        _assert_leaves(saved, "sharded_quantile", jq.sketch)
        _assert_leaves(saved, "sharded_spearman_preds", spear.preds_sketch)
        np.testing.assert_array_equal(saved["sharded_spearman_joint"], np.asarray(spear.joint))
        np.testing.assert_allclose(saved["sharded_spearman_value"], np.asarray(spear.compute()), rtol=1e-5)


def test_fused_sharded_sketch_parity(worker_states):
    """A sketch member of ``fused(mesh=...)`` on two ranks == ``sharded_update``
    (checked on each rank, bitwise, the first event loaded rather than
    merged) == JAX's ``FusedCollectionPlan(mesh=...)`` over the whole batches."""
    import jax.numpy as jnp

    import torchmetrics_tpu as J
    from torchmetrics_tpu.parallel import FusedCollectionPlan
    from torchmetrics_tpu.sketch import kll_init, kll_quantile, kll_update

    _, states = worker_states
    fus = _score_quantile_class(J, kll_init, kll_update, kll_quantile)(distributed_available_fn=lambda: False)
    plan = FusedCollectionPlan(fus, mesh=_jax_mesh())
    for preds, target in _score_batches():
        plan.update(jnp.asarray(preds), jnp.asarray(target))
    plan.fold_back()
    for saved in states:
        _assert_leaves(saved, "fused_sketch", fus.sketch)


if __name__ == "__main__":
    _worker_main(sys.argv)
