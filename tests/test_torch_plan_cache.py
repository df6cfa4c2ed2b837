# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's compiled-step cache (``_SHARDED_FN_CACHE``, ``plan_cache_lookup``,
``plan_cache_store``) against the JAX package's, on the CPU.

Each of JAX's six cache tests runs here as one sequence written once for both
packages: ``sharded_update``'s child swap, its eviction and its telemetry
flip, the sharded and the local fused plan rebuilt over one collection, the
sliced plan rebuilt over one metric. The port's ``obs.snapshot()`` cache
counters must equal JAX's after every step, and the states JAX's tests read
must be bitwise JAX's. The sequences that need a mesh run on a 2-rank gloo
``DeviceMesh`` (this file run as a script is the worker: ``python
tests/test_torch_plan_cache.py <rank> 2 <addr> cache <out_dir>``; it imports
no JAX), each rank passing its half of every batch, against a 2-device JAX
mesh over the whole batches.

The port's own cases: a rebuilt plan adopts the cached entry (its carry,
graphs and pool); a live plan whose entry moved to a new plan keeps its
results (old and new plans interleaved, carries bitwise equal to plans built
with the cache cleared); a carry of another layout is a miss; eviction leaves
one live entry per (kind, target, mesh, axis) and sweeps dead targets only at
a store, never from a finalizer. On the card the same is checked in
``tests/test_torch_kernels_cuda.py``.
"""
from __future__ import annotations

import gc
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as T
from tests.test_torch_sync import run_workers

C, N, CELLS = 5, 32, 8


def _batches(n=3, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((N, C)).astype(np.float32)
        probs = (np.exp(x) / np.exp(x).sum(1, keepdims=True)).astype(np.float32)
        out.append((probs, rng.integers(0, C, N).astype(np.int32)))
    return out


def _keys(seed=3):
    return np.random.default_rng(seed).integers(0, 5, N).astype(np.int32)


class _SumPairs(T.Metric):
    """The port's twin of JAX's test metric ``_SumPairs`` (test_parallel.py)."""

    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("count", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("maximum", torch.tensor(-float("inf")), dist_reduce_fx="max")

    def update(self, values):
        self.total = self.total + values.sum()
        self.count = self.count + values.numel()
        self.maximum = torch.maximum(self.maximum, values.max())

    def compute(self):
        return {"mean": self.total / self.count, "max": self.maximum}


class _ChildWrapper(T.Metric):
    """The port's twin of JAX's ``_ChildWrapper``: update goes to a swappable child."""

    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.child = _SumPairs()

    def update(self, values):
        self.child.update(values)

    def compute(self):
        return self.child.compute()


def _jax_classes():
    import jax.numpy as jnp

    from torchmetrics_tpu import Metric

    class SumPairs(Metric):
        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", jnp.zeros(()), dist_reduce_fx="sum")
            self.add_state("count", jnp.zeros(()), dist_reduce_fx="sum")
            self.add_state("maximum", jnp.asarray(-jnp.inf), dist_reduce_fx="max")

        def update(self, values):
            self.total = self.total + jnp.sum(values)
            self.count = self.count + values.size
            self.maximum = jnp.maximum(self.maximum, jnp.max(values))

        def compute(self):
            return {"mean": self.total / self.count, "max": self.maximum}

    class ChildWrapper(Metric):
        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.child = SumPairs()

        def update(self, values):
            self.child.update(values)

        def compute(self):
            return self.child.compute()

    return SumPairs, ChildWrapper


class _Side:
    """What a sequence needs of one package: its obs, cache, mesh, metric
    classes, and how a numpy batch enters (JAX: the whole batch; a port rank:
    its half)."""

    def __init__(self, jax_side: bool, mesh=None, rank=0, world=1):
        self.jax = jax_side
        self.mesh, self.rank, self.world = mesh, rank, world
        if jax_side:
            import jax.numpy as jnp

            import torchmetrics_tpu as J
            from torchmetrics_tpu import obs
            from torchmetrics_tpu.obs import device
            from torchmetrics_tpu.parallel import sharded_update
            from torchmetrics_tpu.parallel.sharded import _SHARDED_FN_CACHE
            from torchmetrics_tpu.robustness import StreamingEvaluator

            self.pkg, self.cls, self.kw = J, J.classification, {}
            self.SumPairs, self.ChildWrapper = _jax_classes()
            self.array = jnp.asarray
        else:
            from torchmetrics_tpu_torch import obs
            from torchmetrics_tpu_torch.obs import device
            from torchmetrics_tpu_torch.parallel import sharded_update
            from torchmetrics_tpu_torch.parallel.sharded import _SHARDED_FN_CACHE
            from torchmetrics_tpu_torch.robustness import StreamingEvaluator

            self.pkg, self.cls, self.kw = T, T, {"device": "cpu"}
            self.SumPairs, self.ChildWrapper = _SumPairs, _ChildWrapper
            self.array = torch.from_numpy
        self.obs, self.device, self.sharded_update = obs, device, sharded_update
        self.cache, self.Evaluator = _SHARDED_FN_CACHE, StreamingEvaluator

    def shard(self, values: np.ndarray) -> np.ndarray:
        if self.jax or self.mesh is None:
            return values
        n = values.shape[0] // self.world
        return values[self.rank * n : (self.rank + 1) * n]

    def batch(self, *arrays: np.ndarray):
        return tuple(self.array(np.ascontiguousarray(self.shard(a))) for a in arrays)

    def counters(self) -> dict:
        return {k: v for k, v in self.obs.snapshot()["counters"].items() if ".cache." in k}

    def entry(self, plan):
        """What a rebuilt plan shares with the plan it replaced: JAX's compiled
        step, the port's capture entry."""
        return plan._step if self.jax else plan._entry

    def states(self, metric) -> dict:
        return {k: np.asarray(v).tolist() for k, v in metric.state_tree().items()}


# ------------------------------------------------------------- the sequences


def _seq_child_swap(s: _Side) -> dict:
    """JAX's ``test_sharded_update_child_swap_invalidates_cached_step``."""
    s.cache.clear()
    metric = s.ChildWrapper()
    with s.obs.tracing():
        s.sharded_update(metric, s.mesh, *s.batch(np.arange(16.0, dtype=np.float32)))
        old_child = metric.child
        metric.child = s.SumPairs()
        s.sharded_update(metric, s.mesh, *s.batch(np.arange(16.0, 32.0, dtype=np.float32)))
        counters = s.counters()
    return {
        "counters": counters,
        "new": [float(metric.child.total), float(metric.child.count)],
        "old": [float(old_child.total), float(old_child.count)],
    }


def _seq_eviction(s: _Side) -> dict:
    """JAX's ``test_sharded_cache_eviction_leaves_one_live_entry``, with the
    ``cold`` flag of every ``sharded.update_step`` span and the evict instants."""
    s.cache.clear()
    metric = s.ChildWrapper()
    triple = (id(metric), id(s.mesh), "data")
    steps = []

    def step(start: float) -> None:
        s.sharded_update(metric, s.mesh, *s.batch(np.arange(start, start + 16.0, dtype=np.float32)))
        steps.append({"live": len([k for k in s.cache if k[:3] == triple]), "counters": s.counters()})

    with s.obs.tracing():
        step(0.0)
        for start in (16.0, 32.0):
            metric.child = s.SumPairs()
            step(start)
        step(48.0)
        events = s.obs.get_trace()
    cold = [e["args"]["cold"] for e in events if e["name"] == "sharded.update_step"]
    evicts = [e["args"]["evicted"] for e in events if e["type"] == "instant" and e["name"] == "sharded.cache.evict"]
    return {"steps": steps, "cold": cold, "evict_instants": evicts, "state": s.states(metric.child)}


def _seq_telemetry_flip(s: _Side) -> dict:
    """JAX's ``test_telemetry_flag_flip_invalidates_sharded_cache``."""
    s.cache.clear()
    metric = s.pkg.SumMetric(**s.kw) if not s.jax else s.pkg.SumMetric(distributed_available_fn=lambda: False)
    batch = s.batch(np.arange(2.0, dtype=np.float32))
    out = {}
    with s.obs.tracing():
        try:
            s.sharded_update(metric, s.mesh, *batch)
            s.sharded_update(metric, s.mesh, *batch)
            out["before"] = s.counters()
            s.device.enable()
            s.sharded_update(metric, s.mesh, *batch)  # config changed: miss and rebuild
            out["after"] = s.counters()
        finally:
            s.device.disable()
    out["telemetry"] = metric._device_telemetry is not None
    out["entries"] = len([k for k in s.cache if k[0] == id(metric)])
    out["state"] = s.states(metric)
    return out


def _seq_fused_rebuilt(s: _Side) -> dict:
    """JAX's ``test_fused_sharded_step_rides_cache`` (with a mesh) and
    ``test_fused_local_step_rides_cache`` (without)."""
    s.cache.clear()
    b0, b1 = _batches(2, seed=15)
    col = s.pkg.MetricCollection({"acc": s.cls.MulticlassAccuracy(num_classes=C, **s.kw)})
    options = {"mesh": s.mesh} if s.mesh is not None else {}
    with s.obs.tracing():
        plan1 = col.fused(**options)
        plan1.update(*s.batch(*b0))
        plan1.fold_back()
        first = s.entry(plan1)
        plan2 = col.fused(**options)
        counters = s.counters()
        adopted = s.entry(plan2) is first
        kept_apart = s.entry(plan1) is not first  # the port hands the live plan1 a carry of its own
    plan2.update(*s.batch(*b1))
    plan2.fold_back()
    member = dict.__getitem__(col, "acc")
    return {"counters": counters, "adopted": adopted, "kept_apart": kept_apart, "count": member._update_count,
            "state": s.states(member)}


def _seq_sliced_rebuilt(s: _Side) -> dict:
    """JAX's ``test_sliced_step_rides_cache``, and both plans' results after."""
    s.cache.clear()
    b0, b1 = _batches(2, seed=10)
    keys = s.array(_keys())
    metric = s.cls.MulticlassAccuracy(num_classes=C, **s.kw)
    with s.obs.tracing():
        plan1 = metric.sliced(num_cells=CELLS)
        plan1.update(keys, *s.batch(*b0))
        first = s.entry(plan1)
        plan2 = metric.sliced(num_cells=CELLS)
        counters = s.counters()
        adopted = s.entry(plan2) is first
    plan2.update(keys, *s.batch(*b1))
    results = lambda plan: {str(k): float(v) for k, v in sorted(plan.results().items())}  # noqa: E731
    return {"counters": counters, "adopted": adopted, "plan1": results(plan1), "plan2": results(plan2)}


def _seq_fused_eviction(s: _Side) -> dict:
    """Plans of one collection whose fingerprints differ (``donate``) supersede
    each other's entries; a collected target's entry goes at the next store."""
    s.cache.clear()
    b0 = _batches(1, seed=21)[0]
    col = s.pkg.MetricCollection({"acc": s.cls.MulticlassAccuracy(num_classes=C, **s.kw)})
    live = lambda c: len([k for k in s.cache if k[:4] == ("fused", id(c), None, "data")])  # noqa: E731
    steps = []
    with s.obs.tracing():
        for donate in (True, False, True, True):
            plan = col.fused(donate=donate)
            plan.update(*s.batch(*b0))
            steps.append({"live": live(col), "counters": s.counters()})
        other = s.pkg.MetricCollection({"acc": s.cls.MulticlassAccuracy(num_classes=C, **s.kw)})
        other_plan = other.fused()
        del other, other_plan
        gc.collect()
        size_after_gc = len(s.cache)  # no finalizer sweeps: the dead entry stays until a store
        col.fused(donate=False)
        steps.append({"live": live(col), "counters": s.counters()})
    return {"steps": steps, "size_after_gc": size_after_gc, "size": len(s.cache)}


def _seq_runner_drives(s: _Side) -> dict:
    """Two ``StreamingEvaluator`` drives over one collection: the second drive's
    plan is served from the cache."""
    s.cache.clear()
    batches = [s.batch(*b) for b in _batches(3, seed=5)]
    col = s.pkg.MetricCollection({
        "acc": s.cls.MulticlassAccuracy(num_classes=C, average="micro", **s.kw),
        "auroc": s.cls.MulticlassAUROC(num_classes=C, thresholds=16, **s.kw),
    })
    with s.obs.tracing():
        first = s.Evaluator(col, fused=True).run(batches)
        second = s.Evaluator(col, fused=True).run(batches)
        counters = s.counters()
    values = lambda v: {k: np.asarray(x).tolist() for k, x in sorted(v.items())}  # noqa: E731
    return {"counters": counters, "first": values(first), "second": values(second)}


# -------------------------------------------------------------------- worker


def _scenario_cache(rank: int, world: int, out_dir: Path) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    side = _Side(False, mesh=mesh, rank=rank, world=world)
    out = {
        "child_swap": _seq_child_swap(side),
        "eviction": _seq_eviction(side),
        "telemetry_flip": _seq_telemetry_flip(side),
        "fused_mesh": _seq_fused_rebuilt(side),
    }
    (out_dir / f"cache_rank{rank}.json").write_text(json.dumps(out))
    print(f"rank {rank}: cache sequences ran", flush=True)


def _worker_main(argv) -> None:
    import torch.distributed as dist

    rank, world, addr, out_dir = int(argv[1]), int(argv[2]), argv[3], Path(argv[5])
    dist.init_process_group("gloo", init_method=addr, world_size=world, rank=rank)
    try:
        _scenario_cache(rank, world, out_dir)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- the tests


@pytest.fixture(autouse=True)
def _clean_obs():
    from torchmetrics_tpu import obs as jobs
    from torchmetrics_tpu_torch import obs as tobs

    for pkg in (jobs, tobs):
        pkg.disable()
        pkg.clear()
    yield
    for pkg in (jobs, tobs):
        pkg.disable()
        pkg.clear()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's record of the mesh sequences (the 2-rank worker, run once)."""
    out_dir = tmp_path_factory.mktemp("plan_cache")
    results = run_workers(Path(__file__), "cache", out_dir, timeout=120)
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank}: cache sequences ran" in out, out
    return [json.loads((out_dir / f"cache_rank{rank}.json").read_text()) for rank in range(2)]


def _jax_mesh_side() -> _Side:
    import jax
    from jax.sharding import Mesh

    return _Side(True, mesh=Mesh(np.array(jax.devices()[:2]), ("data",)))


MESH_SEQUENCES = {
    "child_swap": _seq_child_swap,
    "eviction": _seq_eviction,
    "telemetry_flip": _seq_telemetry_flip,
    "fused_mesh": _seq_fused_rebuilt,
}


@pytest.mark.parametrize("name", sorted(MESH_SEQUENCES))
def test_mesh_sequence_matches_jax(ranks, name):
    """JAX's four cache tests that need a mesh: every rank's counters, flags and
    states equal JAX's record of the same sequence over the whole batches."""
    want = MESH_SEQUENCES[name](_jax_mesh_side())
    want.pop("kept_apart", None)
    for rank, record in enumerate(ranks):
        got = dict(record[name])
        if name == "fused_mesh":
            assert got.pop("kept_apart") is True, f"rank {rank}: the live plan kept the adopted entry"
        assert got == want, f"rank {rank}, {name}: port {got} vs JAX {want}"


def test_mesh_sequences_say_what_jax_tests_assert(ranks):
    """The assertions of JAX's tests, on the port's records: the new child
    folded, the old one untouched; one live entry after every flip, 3 misses, 2
    evictions, then a hit; a telemetry flip is a miss that evicts; a rebuilt
    sharded plan adopts the entry and counts 2 updates."""
    for record in ranks:
        swap = record["child_swap"]
        assert swap["new"] == [float(np.arange(16.0, 32.0).sum()), 16.0] and swap["old"] == [float(np.arange(16.0).sum()), 16.0]
        ev = record["eviction"]
        assert [s["live"] for s in ev["steps"]] == [1, 1, 1, 1]
        assert ev["steps"][2]["counters"] == {"sharded.cache.miss": 3, "sharded.cache.evict": 2}
        assert ev["steps"][3]["counters"]["sharded.cache.hit"] == 1
        assert ev["cold"] == [True, True, True, False] and ev["evict_instants"] == [1, 1]
        flip = record["telemetry_flip"]
        assert flip["before"] == {"sharded.cache.miss": 1, "sharded.cache.hit": 1}
        assert flip["after"]["sharded.cache.miss"] == 2 and flip["telemetry"] and flip["entries"] == 1
        fused = record["fused_mesh"]
        assert fused["counters"]["fused.cache.hit"] == 1 and fused["adopted"] and fused["count"] == 2


LOCAL_SEQUENCES = {
    "fused_local": _seq_fused_rebuilt,
    "sliced": _seq_sliced_rebuilt,
    "fused_eviction": _seq_fused_eviction,
    "runner_drives": _seq_runner_drives,
}


@pytest.mark.parametrize("name", sorted(LOCAL_SEQUENCES))
def test_local_sequence_matches_jax(name):
    """JAX's ``test_fused_local_step_rides_cache`` and ``test_sliced_step_rides_cache``,
    an eviction sequence and two runner drives, in one process: counters, the
    adoption and the states or results equal JAX's."""
    want = LOCAL_SEQUENCES[name](_Side(True))
    got = LOCAL_SEQUENCES[name](_Side(False))
    if name == "fused_local":
        assert got.pop("kept_apart") is True
        want.pop("kept_apart")
    assert got == want, f"{name}: port {got} vs JAX {want}"
    if name in ("fused_local", "sliced"):
        assert got["counters"] == {f"{name.split('_')[0]}.cache.miss": 1, f"{name.split('_')[0]}.cache.hit": 1}
        assert got["adopted"]
    if name == "fused_eviction":
        assert [s["live"] for s in got["steps"]] == [1] * 5
        assert got["size_after_gc"] == 2 and got["size"] == 1
    if name == "runner_drives":
        assert got["counters"]["fused.cache.hit"] == 1 and got["first"] == got["second"]


def _carry_bits(tree) -> list:
    from torch.utils._pytree import tree_flatten

    return [(tuple(t.shape), t.dtype, t.numpy().tobytes()) for t in tree_flatten(tree)[0]]


def _clear_cache() -> None:
    from torchmetrics_tpu_torch.parallel.sharded import _SHARDED_FN_CACHE

    _SHARDED_FN_CACHE.clear()


def _handover_plans(kind: str, clear: bool):
    """Plan A driven 2 batches, then plan B built over the same target (with
    ``clear``, the cache emptied first: no adoption), then A and B in turns."""
    from torchmetrics_tpu_torch import obs

    members = {
        "acc": T.MulticlassAccuracy(num_classes=C, average="micro", device="cpu"),
        "auroc": T.MulticlassAUROC(num_classes=C, thresholds=16, device="cpu"),
    }
    target = T.MetricCollection(members)
    batches = [tuple(torch.from_numpy(x) for x in b) for b in _batches(6, seed=31)]
    keys = torch.from_numpy(_keys(7))
    build = (lambda: target.fused()) if kind == "fused" else (lambda: target.sliced(num_cells=CELLS))
    drive = (lambda p, b: p.update(*b)) if kind == "fused" else (lambda p, b: p.update(keys, *b))
    _clear_cache()
    with obs.tracing():
        plan_a = build()
        drive(plan_a, batches[0])
        drive(plan_a, batches[1])
        if clear:
            _clear_cache()
        entry_a = plan_a._entry
        plan_b = build()
        counters = {k: v for k, v in obs.snapshot()["counters"].items() if ".cache." in k}
    for batch_a, batch_b in zip(batches[2:4], batches[4:6]):
        drive(plan_a, batch_a)
        drive(plan_b, batch_b)
    return plan_a, plan_b, entry_a, counters


@pytest.mark.parametrize("kind", ["fused", "sliced"])
def test_handover_keeps_both_plans_independent(kind):
    """A plan rebuilt over the target of a live plan adopts the live plan's
    entry; the live plan gets its carry back in fresh buffers. Interleaved
    updates of the two leave carries bitwise equal to two plans built with
    the cache cleared."""
    plan_a, plan_b, entry_a, counters = _handover_plans(kind, clear=False)
    assert counters == {f"{kind}.cache.miss": 1, f"{kind}.cache.hit": 1}
    assert plan_b._entry is entry_a and plan_a._entry is not entry_a
    assert plan_a._captured == {} and plan_a._sharded == {} and plan_a._pool is None
    ref_a, ref_b, ref_entry_a, ref_counters = _handover_plans(kind, clear=True)
    assert ref_counters == {f"{kind}.cache.miss": 2} and ref_b._entry is not ref_entry_a
    assert _carry_bits(plan_a.state) == _carry_bits(ref_a.state)
    assert _carry_bits(plan_b.state) == _carry_bits(ref_b.state)
    assert plan_a.updates_applied == 4 and plan_b.updates_applied == 2


def test_carry_of_another_layout_is_a_miss():
    """The same fingerprint over a carry of other dtypes (``set_dtype``) is a
    miss: the plan stores a fresh entry and never hands a graph a carry it
    was not captured on; its states equal an unfused float64 update."""
    from torchmetrics_tpu_torch import obs
    from torchmetrics_tpu_torch.parallel.sharded import _SHARDED_FN_CACHE

    _clear_cache()
    values = [torch.from_numpy(np.random.default_rng(s).standard_normal(16).astype(np.float32)) for s in (1, 2)]
    col = T.MetricCollection({"mean": T.MeanMetric(device="cpu")})
    with obs.tracing():
        plan1 = col.fused()
        plan1.update(values[0])
        plan1.fold_back()
        col.set_dtype(torch.float64)
        plan2 = col.fused()
        counters = {k: v for k, v in obs.snapshot()["counters"].items() if ".cache." in k}
    assert counters == {"fused.cache.miss": 2}
    assert plan2._entry is not plan1._entry and plan2._carry["members"]["mean"]["mean_value"].dtype == torch.float64
    assert [e[2] for e in _SHARDED_FN_CACHE.values()] == [plan2._entry]
    plan2.update(values[1])
    plan2.fold_back()
    eager = T.MeanMetric(device="cpu")
    eager.update(values[0])
    eager.set_dtype(torch.float64)
    eager.update(values[1])
    for name, value in eager.state_tree().items():
        got = dict.__getitem__(col, "mean").state_tree()[name]
        assert got.dtype == value.dtype and torch.equal(got, value), name


def test_no_sweep_from_a_finalizer():
    """Dropping a plan, or its target, changes nothing in the cache until the
    next store: nothing is swept from a finalizer or a weak-reference callback."""
    from torchmetrics_tpu_torch.parallel.sharded import _SHARDED_FN_CACHE

    _clear_cache()
    col = T.MetricCollection({"acc": T.MulticlassAccuracy(num_classes=C, device="cpu")})
    plan = col.fused()
    entry = plan._entry
    del plan
    gc.collect()
    assert [e[2] for e in _SHARDED_FN_CACHE.values()] == [entry]
    del col
    gc.collect()
    (key, (target_ref, _, held)), = _SHARDED_FN_CACHE.items()
    assert held is entry and target_ref() is None
    T.MetricCollection({"acc": T.MulticlassAccuracy(num_classes=C, device="cpu")}).fused()
    assert key not in _SHARDED_FN_CACHE and len(_SHARDED_FN_CACHE) == 1


if __name__ == "__main__":
    _worker_main(sys.argv)
