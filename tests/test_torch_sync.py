# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Distributed sync of the port (``Metric.sync``/``compute``, the gathers,
``SyncConfig`` and the fault drills) against the JAX package's.

Two kinds of test:

- REAL 2-process ``torch.distributed`` groups (gloo, localhost CPU): this
  file run as a script is the worker (``python tests/test_torch_sync.py
  <rank> <world> <addr> <scenario> <out_dir>``); it imports no JAX. The
  ``full`` and ``faults`` scenarios are the gloo twins of
  ``tests/unittests/_helpers/mp_sync_worker.py``'s; the ``regression``
  scenario syncs Pearson's stacked ``None`` states (uneven batch counts),
  ``MaxMetric``/``MinMetric`` and ``CatMetric``; the ``wrappers`` scenario
  syncs wrapped metrics (``MinMaxMetric``, ``ClasswiseWrapper``, an
  arithmetic composition, ``MultioutputWrapper``, ``BootStrapper``'s copies)
  through their children's compute(). Each rank folds its
  share of one seeded stream and saves its synced states (``.npz``); the
  parent test holds them against the JAX package's single-process fold of
  the whole stream, one update per rank's share in rank order. Integer
  states are bitwise equal; float states too, at world size 2 (the synced
  sum of two parts is the fold's ``part0 + part1``; one update per rank
  keeps every float op elementwise). Values computed from the synced states
  are held bitwise against the port's own single-process fold and within
  the budgets of ``tests/test_torch_classification.py`` against JAX's.
- single-process unit tests with a fake ``dist_sync_fn`` and
  ``distributed_available_fn``, the way the JAX package's ``test_metric.py``
  tests sync without processes.

Each 2-process test bounds its workers with ``communicate(timeout=...)`` and
kills them on expiry; ports come from binding port 0.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

N_TOTAL, SPLIT = 48, 37  # the JAX worker's uneven split: 37 rows on rank 0, 11 on rank 1
C = 5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(script: Path, scenario: str, out_dir: Path, timeout: float, extra_env: dict = None) -> list:
    """Run ``script`` as 2 ranks of one gloo group; kill both if either
    outlives ``timeout``. Returns ``[(returncode, output)]`` by rank."""
    addr = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{ROOT}{os.pathsep}" + env.get("PYTHONPATH", "")
    env.pop("TM_TPU_FAULTS", None)
    env.update(extra_env or {})
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(rank), "2", addr, scenario, str(out_dir)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=str(ROOT),
        )
        for rank in range(2)
    ]
    deadline = time.monotonic() + timeout
    results = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            results.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"2-process {scenario!r} workers outlived {timeout} s (a hung collective?)")
    return results


def _stream():
    """The seeded stream both ranks hold: binary probabilities and labels,
    multiclass probabilities and labels, and a float vector per rank."""
    rng = np.random.RandomState(42)
    preds = rng.rand(N_TOTAL).astype(np.float32)
    target = rng.randint(0, 2, N_TOTAL).astype(np.int64)
    logits = rng.randn(N_TOTAL, C).astype(np.float32)
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    labels = rng.randint(0, C, N_TOTAL).astype(np.int64)
    vec = rng.randn(2, 6).astype(np.float32)
    return preds, target, probs, labels, vec


# -------------------------------------------------------------------- worker


def _moments_cls():
    """A port metric with float states of every elementwise reduction."""
    import torchmetrics_tpu_torch as T

    class Moments(T.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", torch.zeros(4), dist_reduce_fx="sum")
            self.add_state("avg", torch.zeros(4), dist_reduce_fx="mean")
            self.add_state("peak", torch.full((4,), -float("inf")), dist_reduce_fx="max")
            self.add_state("low", torch.full((4,), float("inf")), dist_reduce_fx="min")

        def update(self, x):
            x = torch.as_tensor(x)
            self.total = self.total + x[:4] * 0.37
            self.avg = x[2:6] * 1.5
            self.peak = torch.maximum(self.peak, x[:4])
            self.low = torch.minimum(self.low, x[1:5])

        def compute(self):
            return self.total

    return Moments


def _suite(T, **kw):
    """The headline suite, with a stat-scores family (precision shares F1's
    compute group) and a confusion matrix."""
    return T.MetricCollection(
        {
            "acc": T.MulticlassAccuracy(num_classes=C, average="micro", device="cpu", **kw),
            "f1": T.MulticlassF1Score(num_classes=C, average="macro", device="cpu", **kw),
            "auroc": T.MulticlassAUROC(num_classes=C, thresholds=16, device="cpu", **kw),
            "prec": T.MulticlassPrecision(num_classes=C, average="macro", device="cpu", **kw),
            "cm": T.MulticlassConfusionMatrix(num_classes=C, device="cpu", **kw),
        }
    )


def _np_tree(metric) -> dict:
    out = {}
    for k, v in metric.state_tree().items():
        out[k] = torch.cat([torch.atleast_1d(t) for t in v]).numpy() if isinstance(v, list) else v.numpy()
    return out


def _local(rank: int):
    return slice(0, SPLIT) if rank == 0 else slice(SPLIT, N_TOTAL)


def _scenario_full(rank: int, world: int, out_dir: Path) -> None:
    import torch.distributed as dist

    import torchmetrics_tpu_torch as T
    from torchmetrics_tpu_torch.utilities.distributed import _gather_objects_via_bytes, gather_all_objects, gather_all_tensors

    preds, target, probs, labels, vec = _stream()
    mine = _local(rank)
    t = torch.from_numpy
    saved = {}

    def off():
        return {"distributed_available_fn": lambda: False}

    # 1) sum states: compute() syncs; the synced states are saved for the parent
    acc = T.BinaryAccuracy(device="cpu")
    acc.update(t(preds[mine]), t(target[mine]))
    ref = T.BinaryAccuracy(device="cpu", **off())
    ref.update(t(preds), t(target))
    assert torch.equal(acc.compute(), ref.compute()), "BinaryAccuracy sync"
    assert acc._update_count == 1 and not acc._is_synced, "compute() left the metric synced"
    acc.sync()
    saved.update({f"acc.{k}": v for k, v in _np_tree(acc).items()})
    acc.unsync()

    # 2) the headline suite: every member syncs in compute(), compute groups as in JAX
    suite = _suite(T)
    suite.update(t(probs[mine]), t(labels[mine]))
    values = suite.compute()
    ref_suite = _suite(T, **off())
    ref_suite.update(t(probs[: SPLIT]), t(labels[: SPLIT]))
    ref_suite.update(t(probs[SPLIT:]), t(labels[SPLIT:]))
    ref_values = ref_suite.compute()
    for k in ref_values:
        assert torch.equal(values[k], ref_values[k]), f"suite value {k}: {values[k]} vs {ref_values[k]}"
    for key in ("acc", "f1", "auroc", "prec", "cm"):
        member = suite[key]
        member.sync()
        saved.update({f"suite.{key}.{k}": v for k, v in _np_tree(member).items()})
        member.unsync()

    # 3) cat states, uneven shards: exact average precision
    ap = T.BinaryAveragePrecision(device="cpu")
    ap.update(t(preds[mine]), t(target[mine]))
    ref_ap = T.BinaryAveragePrecision(device="cpu", **off())
    ref_ap.update(t(preds), t(target))
    assert torch.equal(ap.compute(), ref_ap.compute()), "cat-state sync"
    ap.sync()
    saved.update({f"ap.{k}": v for k, v in _np_tree(ap).items()})
    assert saved["ap.preds"].shape == (N_TOTAL,), saved["ap.preds"].shape
    ap.unsync()
    assert sum(x.shape[0] for x in ap.preds) == mine.stop - mine.start, "unsync did not restore the local rows"

    # 4) empty ranks: rank 1 folds an empty batch, or nothing at all (its
    # list state is empty and contributes a (0,) float32 tensor)
    for what in ("empty update", "no update"):
        ap2 = T.BinaryAveragePrecision(device="cpu")
        cut = 20 if rank == 0 else 0
        if rank == 0 or what == "empty update":
            ap2.update(t(preds[:cut]), t(target[:cut]))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # compute before update on rank 1
            got = ap2.compute()
        ref2 = T.BinaryAveragePrecision(device="cpu", **off())
        ref2.update(t(preds[:20]), t(target[:20]))
        assert torch.equal(got, ref2.compute()), f"{what}: {got} vs {ref2.compute()}"
        ap2.sync()
        want_target = torch.cat(ref2.target)
        assert ap2.target.dtype == want_target.dtype and torch.equal(ap2.target, want_target), (what, ap2.target)
        saved.update({f"empty.{what}.{k}": v for k, v in _np_tree(ap2).items()})
        ap2.unsync()

    # 5) float states of every elementwise reduction, one update per rank
    Moments = _moments_cls()
    mom = Moments(device="cpu")
    mom.update(t(vec[rank]))
    mom.sync()
    saved.update({f"moments.{k}": v for k, v in _np_tree(mom).items()})
    mom.unsync()

    # 6) uneven-shape gathers: pad/trim, and ndim > 8 (the shape buffer is sized from the gathered ndim)
    local = torch.arange(3 + 4 * rank, dtype=torch.float32).reshape(1, -1) + 10 * rank
    gathered = gather_all_tensors(local)
    assert [tuple(g.shape) for g in gathered] == [(1, 3), (1, 7)], [g.shape for g in gathered]
    assert torch.equal(gathered[1], torch.arange(7, dtype=torch.float32).reshape(1, -1) + 10)
    deep = torch.full((1,) * 9 + (2 + rank,), float(rank))
    gathered = gather_all_tensors(deep)
    assert [tuple(g.shape) for g in gathered] == [(1,) * 9 + (2,), (1,) * 9 + (3,)], [g.shape for g in gathered]
    assert torch.equal(gathered[1], torch.ones((1,) * 9 + (3,)))

    # 7) object gather: RLE-style payloads of rank-dependent sizes
    rle = {"size": [7 + rank, 9], "counts": bytes(range(5 + 3 * rank))}
    objs = gather_all_objects([rle, rank])
    assert len(objs) == world and objs[rank][1] == rank, objs
    assert objs[1][0]["size"] == [8, 9] and len(objs[1][0]["counts"]) == 8, objs
    objs2 = _gather_objects_via_bytes(("payload", rank, b"x" * (1 + 100 * rank)))
    assert objs2[1][2] == b"x" * 101, objs2

    # 8) sync_context: synced inside, the local state restored after
    ctx = T.BinaryAccuracy(device="cpu")
    ctx.update(t(preds[mine]), t(target[mine]))
    local_tp = ctx.tp.clone()
    with ctx.sync_context():
        assert ctx._is_synced and torch.equal(ctx.tp, ref.tp), "sync_context did not sync"
    assert not ctx._is_synced and torch.equal(ctx.tp, local_tp), "sync_context did not restore"

    # 9) dist_sync_on_step: forward's batch value covers every rank's batch,
    # the accumulated state stays local
    step = T.BinaryAccuracy(device="cpu", dist_sync_on_step=True)
    halves = [slice(0, 24), slice(24, 48)]
    batch_val = step(t(preds[halves[rank]]), t(target[halves[rank]]))
    both = T.BinaryAccuracy(device="cpu", **off())
    both.update(t(preds), t(target))
    assert torch.equal(batch_val, both.compute()), f"dist_sync_on_step: {batch_val} vs {both.compute()}"
    alone = T.BinaryAccuracy(device="cpu", **off())
    alone.update(t(preds[halves[rank]]), t(target[halves[rank]]))
    assert torch.equal(step.tp, alone.tp) and not step._is_synced, "dist_sync_on_step changed the local state"
    assert torch.equal(step.compute(), both.compute()), "compute() after a synced forward"

    np.savez(out_dir / f"full_rank{rank}.npz", **saved)
    dist.barrier()
    print(f"rank {rank}: all multi-process sync checks passed", flush=True)


def _regression_stream():
    """Seeded regression rows both ranks hold: preds and target (N_TOTAL, 2)
    float32 and a value vector for the aggregators."""
    rng = np.random.RandomState(7)
    preds = rng.randn(N_TOTAL, 2).astype(np.float32)
    target = (preds * np.array([1.0, -0.5], np.float32) + rng.randn(N_TOTAL, 2)).astype(np.float32)
    values = (rng.randn(N_TOTAL) * 3).astype(np.float32)
    return preds, target, values


def _regression_chunks(rank: int) -> list:
    """This rank's row indices in batches: rank 0 folds three, rank 1 one."""
    mine = _local(rank)
    return np.array_split(np.arange(mine.start, mine.stop), 3 if rank == 0 else 1)


def _scenario_regression(rank: int, world: int, out_dir: Path) -> None:
    import torch.distributed as dist

    import torchmetrics_tpu_torch as T

    preds, target, values = _regression_stream()
    t = torch.from_numpy
    saved = {}
    off = {"distributed_available_fn": lambda: False}

    # 1) Pearson's None states: compute() gathers them stacked (ranks, outputs)
    # and merges the shards; uneven batch counts on the two ranks
    for tag, kw, cols in (("pearson", {}, 0), ("pearson2", {"num_outputs": 2}, slice(None))):
        metric = T.PearsonCorrCoef(device="cpu", **kw)
        ref = T.PearsonCorrCoef(device="cpu", **kw, **off)
        for idx in _regression_chunks(rank):
            metric.update(t(preds[idx][:, cols]), t(target[idx][:, cols]))
        for r in range(world):
            for idx in _regression_chunks(r):
                ref.update(t(preds[idx][:, cols]), t(target[idx][:, cols]))
        got, want = metric.compute(), ref.compute()
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-6), f"{tag} sync: {got} vs the one-process fold {want}"
        metric.sync()
        assert metric.mean_x.shape == (world, metric.num_outputs), metric.mean_x.shape
        saved.update({f"{tag}.{k}": v for k, v in _np_tree(metric).items()})
        saved[f"{tag}.value"] = got.numpy()
        metric.unsync()
        assert metric.mean_x.shape == (metric.num_outputs,), "unsync did not restore the local statistics"

    # 2) "max"/"min" states and the "cat" state of uneven rows
    for name in ("MaxMetric", "MinMetric", "CatMetric"):
        metric, ref = getattr(T, name)(device="cpu"), getattr(T, name)(device="cpu", **off)
        for idx in _regression_chunks(rank):
            metric.update(t(values[idx]))
        ref.update(t(values))
        got = metric.compute()
        assert torch.equal(got, ref.compute()), f"{name} sync: {got} vs {ref.compute()}"
        metric.sync()
        saved.update({f"{name}.{k}": v for k, v in _np_tree(metric).items()})
        metric.unsync()

    np.savez(out_dir / f"regression_rank{rank}.npz", **saved)
    dist.barrier()
    print(f"rank {rank}: all regression sync checks passed", flush=True)


def _scenario_wrappers(rank: int, world: int, out_dir: Path) -> None:
    """Wrappers in the replica regime: each rank folds its share, the
    wrapped metrics sync at compute(); values equal the port's one-process fold."""
    import torch.distributed as dist

    import torchmetrics_tpu_torch as T

    preds, target, probs, labels, vec = _stream()
    reg_preds, reg_target, _ = _regression_stream()
    mine = _local(rank)
    t = torch.from_numpy
    saved = {}
    off = {"distributed_available_fn": lambda: False}
    mc = (t(probs[mine]), t(labels[mine].astype(np.int32)))
    mc_all = (t(probs), t(labels.astype(np.int32)))

    def acc(**kw):
        return T.MulticlassAccuracy(num_classes=C, average="micro", device="cpu", **kw)

    def f1(**kw):
        return T.MulticlassF1Score(num_classes=C, average=None, device="cpu", **kw)

    pairs = {
        "minmax": (T.MinMaxMetric(acc()), T.MinMaxMetric(acc(**off))),
        "classwise": (T.ClasswiseWrapper(f1()), T.ClasswiseWrapper(f1(**off))),
        "composed": ((acc() + T.MulticlassF1Score(num_classes=C, device="cpu")) / 2,
                     (acc(**off) + T.MulticlassF1Score(num_classes=C, device="cpu", **off)) / 2),
    }
    for tag, (metric, ref) in pairs.items():
        metric.update(*mc)
        ref.update(*mc_all)
        got, want = metric.compute(), ref.compute()
        for k, w in (want.items() if isinstance(want, dict) else [("value", want)]):
            g = got[k] if isinstance(got, dict) else got
            assert torch.equal(g, w), f"{tag} sync {k}: {g} vs the one-process fold {w}"
            saved[f"{tag}.value.{k}"] = g.numpy()
    child = pairs["minmax"][0]._base_metric
    child.sync()
    saved.update({f"minmax.child.{k}": v for k, v in _np_tree(child).items()})
    child.unsync()

    multi = T.MultioutputWrapper(T.MeanSquaredError(device="cpu"), num_outputs=2)
    multi.update(t(reg_preds[mine]), t(reg_target[mine]))
    ref = T.MultioutputWrapper(T.MeanSquaredError(device="cpu", **off), num_outputs=2)
    ref.update(t(reg_preds), t(reg_target))
    got = multi.compute()
    assert torch.allclose(got, ref.compute(), rtol=1e-6), f"multioutput sync {got} vs {ref.compute()}"
    saved["multioutput.value"] = got.numpy()

    # BootStrapper: each rank resamples its own share with its own seed; copy i syncs to the sum over the ranks
    boot = T.BootStrapper(acc(), num_bootstraps=3, seed=5 + rank, raw=True)
    boot.update(*mc)
    saved["bootstrap.raw"] = boot.compute()["raw"].numpy()
    for i, copy in enumerate(boot.metrics):
        copy.sync()
        saved.update({f"bootstrap.{i}.{k}": v for k, v in _np_tree(copy).items()})
        copy.unsync()

    np.savez(out_dir / f"wrappers_rank{rank}.npz", **saved)
    dist.barrier()
    print(f"rank {rank}: all wrapper sync checks passed", flush=True)


def _scenario_faults(rank: int, world: int, out_dir: Path) -> None:
    import torchmetrics_tpu_torch as T
    from torchmetrics_tpu_torch.robustness import SyncConfig, faults
    from torchmetrics_tpu_torch.utilities.distributed import _gather_objects_via_bytes
    from torchmetrics_tpu_torch.utilities.exceptions import SyncError, SyncWarning

    preds, target, _, _, _ = _stream()
    mine = _local(rank)
    t = torch.from_numpy
    full = T.BinaryAccuracy(device="cpu", distributed_available_fn=lambda: False)
    full.update(t(preds), t(target))
    want = full.compute()

    # A) corrupt payload on rank 1 from TM_TPU_FAULTS: SyncError naming rank 1 on both ranks, then healed
    assert faults.active(), "the parent exports TM_TPU_FAULTS for the faults scenario"
    try:
        _gather_objects_via_bytes(("rle-ish payload", rank))
        raise AssertionError("corrupt object gather did not raise")
    except SyncError as err:
        assert "rank 1" in str(err) and "corrupt" in str(err).lower(), f"bad SyncError message: {err}"
    objs = _gather_objects_via_bytes(("rle-ish payload", rank))
    assert [o[1] for o in objs] == [0, 1], objs
    faults.clear()

    # B) truncated payload on rank 0
    with faults.inject(faults.Fault("truncate", "gather_bytes.payload", rank=0, arg=64)):
        try:
            _gather_objects_via_bytes(("x" * 512, rank))
            raise AssertionError("truncated object gather did not raise")
        except SyncError as err:
            assert "rank 0" in str(err) and "truncated" in str(err), f"bad SyncError message: {err}"

    # C) a transient failure before any collective passes after retry and backoff
    acc = T.BinaryAccuracy(device="cpu", sync_config=SyncConfig(retries=3, backoff_base_s=0.05, backoff_max_s=0.2))
    acc.update(t(preds[mine]), t(target[mine]))
    with faults.inject(faults.Fault("fail", "sync.attempt", count=2)):
        assert torch.equal(acc.compute(), want), "retry/backoff sync"

    # D) on_error="local": one SyncWarning on rank 0 only, the local value, then a healed sync
    acc2 = T.BinaryAccuracy(device="cpu", sync_config=SyncConfig(retries=0, on_error="local"))
    acc2.update(t(preds[mine]), t(target[mine]))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with faults.inject(faults.Fault("fail", "sync.attempt")):
            got_local = acc2.compute()
    alone = T.BinaryAccuracy(device="cpu", distributed_available_fn=lambda: False)
    alone.update(t(preds[mine]), t(target[mine]))
    assert torch.equal(got_local, alone.compute()), "local fallback"
    n_warn = sum(issubclass(w.category, SyncWarning) for w in caught)
    assert n_warn == (1 if rank == 0 else 0), f"rank {rank}: {n_warn} SyncWarnings"
    acc2._computed = None
    assert torch.equal(acc2.compute(), want), "post-fallback sync"

    # E) a mid-sync failure (one state already overwritten) rolls back
    acc3 = T.BinaryAccuracy(device="cpu")
    acc3.update(t(preds[mine]), t(target[mine]))
    before = {k: v.clone() for k, v in acc3.state_tree().items()}
    with faults.inject(faults.Fault("fail", "sync.state_apply", after=1, count=1)):
        try:
            acc3.sync()
            raise AssertionError("mid-sync fault did not raise")
        except SyncError:
            pass
    for key, val in before.items():
        assert torch.equal(getattr(acc3, key), val), f"half-synced state {key!r}"
    assert not acc3._is_synced and acc3._cache is None
    acc3.sync()
    acc3.unsync()
    assert torch.equal(acc3.compute(), want), "post-rollback sync"

    # F) timeout_s: a straggling gather raises from the waiting thread; the
    # abandoned attempts finish together, and the group stays usable
    acc4 = T.BinaryAccuracy(device="cpu", sync_config=SyncConfig(timeout_s=0.3))
    acc4.update(t(preds[mine]), t(target[mine]))
    with faults.inject(faults.Fault("delay", "sync.state_gather", count=1, arg=1.5)):
        try:
            acc4.sync()
            raise AssertionError("a straggling sync did not time out")
        except SyncError as err:
            assert "timed out after 0.3s" in str(err), f"bad SyncError message: {err}"
        for thread in threading.enumerate():
            if thread.name.startswith("tm-tpu-sync-"):
                thread.join(30)
                assert not thread.is_alive(), "the abandoned sync attempt never finished"
    fresh = T.BinaryAccuracy(device="cpu")
    fresh.update(t(preds[mine]), t(target[mine]))
    assert torch.equal(fresh.compute(), want), "sync after a timeout"

    (out_dir / f"faults_rank{rank}.ok").write_text("ok")
    print(f"rank {rank}: all injected-fault checks passed", flush=True)


def _worker_main(argv) -> None:
    import torch.distributed as dist

    rank, world, addr, scenario, out_dir = int(argv[1]), int(argv[2]), argv[3], argv[4], Path(argv[5])
    dist.init_process_group("gloo", init_method=addr, world_size=world, rank=rank)
    try:
        {"full": _scenario_full, "faults": _scenario_faults, "regression": _scenario_regression, "wrappers": _scenario_wrappers}[
            scenario
        ](rank, world, out_dir)
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------- the 2-process tests


def _bytes(x: np.ndarray) -> np.ndarray:
    """The raw bytes of an array (bitwise comparisons, 0-d included)."""
    return np.ascontiguousarray(np.atleast_1d(x)).view(np.uint8)


def _jax_fold(jcls, *parts, **kw):
    """The JAX package's single-process fold: one update per rank's share, in rank order."""
    metric = jcls(distributed_available_fn=lambda: False, **kw)
    for part in parts:
        metric.update(*part)
    return metric


def _assert_tree_bitwise(saved, prefix, jmetric):
    for key, value in jmetric.state_tree().items():
        want = np.concatenate([np.atleast_1d(np.asarray(v)) for v in value]) if isinstance(value, list) else np.asarray(value)
        got = saved[f"{prefix}.{key}"]
        assert got.dtype == want.dtype, f"{prefix}.{key}: {got.dtype} vs JAX {want.dtype}"
        np.testing.assert_array_equal(_bytes(got), _bytes(want), err_msg=f"{prefix}.{key}")


def test_two_process_replica_sync(tmp_path):
    import jax.numpy as jnp

    import torchmetrics_tpu as J

    results = run_workers(Path(__file__), "full", tmp_path, timeout=120)
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank}: all multi-process sync checks passed" in out, out
    preds, target, probs, labels, vec = _stream()
    shares = [slice(0, SPLIT), slice(SPLIT, N_TOTAL)]
    bin_parts = [(jnp.asarray(preds[s]), jnp.asarray(target[s].astype(np.int32))) for s in shares]
    mc_parts = [(jnp.asarray(probs[s]), jnp.asarray(labels[s].astype(np.int32))) for s in shares]
    JC = J.classification
    expected = {
        "acc": _jax_fold(JC.BinaryAccuracy, *bin_parts),
        "suite.acc": _jax_fold(JC.MulticlassAccuracy, *mc_parts, num_classes=C, average="micro"),
        "suite.f1": _jax_fold(JC.MulticlassF1Score, *mc_parts, num_classes=C, average="macro"),
        "suite.auroc": _jax_fold(JC.MulticlassAUROC, *mc_parts, num_classes=C, thresholds=16),
        "suite.prec": _jax_fold(JC.MulticlassPrecision, *mc_parts, num_classes=C, average="macro"),
        "suite.cm": _jax_fold(JC.MulticlassConfusionMatrix, *mc_parts, num_classes=C),
    }
    for rank in range(2):
        saved = dict(np.load(tmp_path / f"full_rank{rank}.npz"))
        for prefix, jmetric in expected.items():
            _assert_tree_bitwise(saved, prefix, jmetric)
        # cat states
        jap = _jax_fold(JC.BinaryAveragePrecision, *bin_parts)
        jpreds = np.concatenate([np.asarray(p) for p in jap.preds])
        jtarget = np.concatenate([np.asarray(p) for p in jap.target])
        np.testing.assert_array_equal(saved["ap.preds"].view(np.int32), jpreds.view(np.int32))
        assert saved["ap.target"].dtype == jtarget.dtype
        np.testing.assert_array_equal(saved["ap.target"], jtarget)
        for what in ("empty update", "no update"):
            np.testing.assert_array_equal(saved[f"empty.{what}.preds"].view(np.int32), preds[:20].view(np.int32))
            np.testing.assert_array_equal(saved[f"empty.{what}.target"], target[:20])
        jmom = _jax_moments()
        for part in vec:
            jmom.update(jnp.asarray(part))
        for key in ("total", "peak", "low"):
            np.testing.assert_array_equal(
                saved[f"moments.{key}"].view(np.int32), np.asarray(getattr(jmom, key)).view(np.int32), err_msg=key
            )
        # "mean" syncs as the mean of the two ranks' states: (a + b) / 2, bitwise
        want_avg = ((vec[0, 2:6] * np.float32(1.5)) + (vec[1, 2:6] * np.float32(1.5))) / np.float32(2)
        np.testing.assert_array_equal(saved["moments.avg"].view(np.int32), want_avg.astype(np.float32).view(np.int32))


def test_two_process_regression_sync(tmp_path):
    """Pearson's ``None`` states arrive stacked from both ranks (3 batches
    against 1) and equal JAX's per-rank statistics (counts bitwise, sums
    within rtol 1e-6); the merged value is JAX's compute of the same stacked
    states within 1e-5. Max, min and the concatenated values equal JAX's
    fold of the whole stream bitwise."""
    import jax.numpy as jnp

    import torchmetrics_tpu as J

    results = run_workers(Path(__file__), "regression", tmp_path, timeout=120)
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank}: all regression sync checks passed" in out, out
    preds, target, values = _regression_stream()
    for tag, kw, cols in (("pearson", {}, 0), ("pearson2", {"num_outputs": 2}, slice(None))):
        per_rank = []
        for r in range(2):
            jm = J.PearsonCorrCoef(**kw)
            for idx in _regression_chunks(r):
                jm.update(jnp.asarray(preds[idx][:, cols]), jnp.asarray(target[idx][:, cols]))
            per_rank.append(jm.state_tree())
        stacked = {k: jnp.stack([tree[k] for tree in per_rank]) for k in per_rank[0]}
        jsynced = J.PearsonCorrCoef(**kw)
        jsynced.load_state_tree({**stacked, "_update_count": 2})
        want_value = np.asarray(jsynced.compute())
        for rank in range(2):
            saved = dict(np.load(tmp_path / f"regression_rank{rank}.npz"))
            for key, want in stacked.items():
                got, want = saved[f"{tag}.{key}"], np.asarray(want)
                assert got.dtype == want.dtype and got.shape == want.shape, (tag, key, got.shape, want.shape)
                if key == "n_total":
                    np.testing.assert_array_equal(_bytes(got), _bytes(want), err_msg=f"{tag}.{key}")
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=f"{tag}.{key}")
            np.testing.assert_allclose(saved[f"{tag}.value"], want_value, rtol=1e-5, err_msg=f"{tag} value")
    for name, state in (("MaxMetric", "max_value"), ("MinMetric", "min_value"), ("CatMetric", "value")):
        jm = getattr(J, name)()
        jm.update(jnp.asarray(values))
        want = np.asarray(jm.compute())
        for rank in range(2):
            saved = dict(np.load(tmp_path / f"regression_rank{rank}.npz"))
            got = saved[f"{name}.{state}"]
            assert got.dtype == want.dtype and got.shape == want.shape, (name, got.shape, want.shape)
            np.testing.assert_array_equal(_bytes(got), _bytes(want), err_msg=name)


def test_two_process_wrapper_sync(tmp_path):
    """Wrappers sync through their children at compute(): the values of
    ``MinMaxMetric``, ``ClasswiseWrapper``, an arithmetic composition and
    ``MultioutputWrapper`` and the synced child states equal the JAX
    package's fold of the whole stream (states bitwise, values within the
    budget of ``tests/test_torch_wrappers.py``); each ``BootStrapper`` copy
    syncs to the sum of the two ranks' copies, each drawn by JAX's sampler
    with the rank's seed."""
    import jax.numpy as jnp

    import torchmetrics_tpu as J

    results = run_workers(Path(__file__), "wrappers", tmp_path, timeout=120)
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank}: all wrapper sync checks passed" in out, out
    _, _, probs, labels, _ = _stream()
    reg_preds, reg_target, _ = _regression_stream()
    shares = [slice(0, SPLIT), slice(SPLIT, N_TOTAL)]
    parts = [(jnp.asarray(probs[s]), jnp.asarray(labels[s].astype(np.int32))) for s in shares]
    JC = J.classification
    off = {"distributed_available_fn": lambda: False}
    minmax = J.MinMaxMetric(_jax_fold(JC.MulticlassAccuracy, *parts, num_classes=C, average="micro"))
    classwise = J.ClasswiseWrapper(_jax_fold(JC.MulticlassF1Score, *parts, num_classes=C, average=None))
    composed = (_jax_fold(JC.MulticlassAccuracy, *parts, num_classes=C, average="micro")
                + _jax_fold(JC.MulticlassF1Score, *parts, num_classes=C)) / 2
    multi = J.MultioutputWrapper(J.MeanSquaredError(**off), num_outputs=2)
    multi.update(jnp.asarray(reg_preds), jnp.asarray(reg_target))
    boots = []
    for r, part in enumerate(parts):
        boot = J.BootStrapper(JC.MulticlassAccuracy(num_classes=C, average="micro", **off), num_bootstraps=3, seed=5 + r)
        boot.update(*part)
        boots.append(boot)
    for rank in range(2):
        saved = dict(np.load(tmp_path / f"wrappers_rank{rank}.npz"))
        _assert_tree_bitwise(saved, "minmax.child", minmax._base_metric)
        for tag, metric in (("minmax", minmax), ("classwise", classwise), ("composed", composed)):
            value = metric.compute()
            for k, want in (value.items() if isinstance(value, dict) else [("value", value)]):
                np.testing.assert_allclose(saved[f"{tag}.value.{k}"], np.asarray(want), rtol=1e-6, err_msg=f"{tag} {k}")
        np.testing.assert_allclose(saved["multioutput.value"], np.asarray(multi.compute()), rtol=1e-6)
        for i in range(3):
            for key in boots[0].metrics[i]._defaults:
                want = np.asarray(getattr(boots[0].metrics[i], key)) + np.asarray(getattr(boots[1].metrics[i], key))
                got = saved[f"bootstrap.{i}.{key}"]
                assert got.dtype == want.dtype, (i, key)
                np.testing.assert_array_equal(_bytes(got), _bytes(want), err_msg=f"bootstrap copy {i} {key}")


def _jax_moments():
    import jax.numpy as jnp

    import torchmetrics_tpu as J

    class Moments(J.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", jnp.zeros(4, jnp.float32), dist_reduce_fx="sum")
            self.add_state("avg", jnp.zeros(4, jnp.float32), dist_reduce_fx="mean")
            self.add_state("peak", jnp.full((4,), -jnp.inf, jnp.float32), dist_reduce_fx="max")
            self.add_state("low", jnp.full((4,), jnp.inf, jnp.float32), dist_reduce_fx="min")

        def update(self, x):
            self.total = self.total + x[:4] * 0.37
            self.avg = x[2:6] * 1.5
            self.peak = jnp.maximum(self.peak, x[:4])
            self.low = jnp.minimum(self.low, x[1:5])

        def compute(self):
            return self.total

    return Moments(distributed_available_fn=lambda: False)


def test_two_process_fault_drills(tmp_path):
    results = run_workers(
        Path(__file__), "faults", tmp_path, timeout=120, extra_env={"TM_TPU_FAULTS": "corrupt:gather_bytes.payload:rank=1:count=1"}
    )
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank}: all injected-fault checks passed" in out, out
        assert (tmp_path / f"faults_rank{rank}.ok").exists()


# ------------------------------------------------------ single-process tests


def _twins():
    import torchmetrics_tpu as J
    import torchmetrics_tpu_torch as T

    return J.classification.BinaryAccuracy, T.BinaryAccuracy


@pytest.mark.parametrize(
    "kwarg,value",
    [
        ("compute_on_cpu", 1),
        ("dist_sync_on_step", "yes"),
        ("dist_sync_fn", 3),
        ("sync_on_compute", None),
        ("compute_with_cache", 0),
        ("sync_config", {"retries": 1}),
        ("no_such_kwarg", True),
    ],
)
def test_kwarg_validation_matches_jax(kwarg, value):
    jcls, tcls = _twins()
    with pytest.raises(ValueError) as jerr:
        jcls(**{kwarg: value})
    with pytest.raises(ValueError) as terr:
        tcls(device="cpu", **{kwarg: value})
    assert str(terr.value) == str(jerr.value)


def test_sync_kwargs_are_accepted():
    import torchmetrics_tpu_torch as T
    from torchmetrics_tpu_torch.robustness import SyncConfig

    cfg = SyncConfig(retries=2)
    m = T.BinaryAccuracy(
        device="cpu", compute_on_cpu=True, dist_sync_on_step=True, process_group=None, dist_sync_fn=lambda x, group=None: [x],
        distributed_available_fn=lambda: False, sync_on_compute=False, sync_config=cfg,
    )
    assert m.sync_config is cfg and m.dist_sync_on_step and m.compute_on_cpu and not m.sync_on_compute


def _fake_world(n=2):
    """A ``dist_sync_fn`` that pretends ``n`` ranks hold this rank's tensor."""
    return lambda x, group=None: [x.clone() for _ in range(n)]


def _fold_both(kind):
    """One metric of ``kind`` per package, folded on the same batch."""
    import jax.numpy as jnp

    import torchmetrics_tpu as J
    import torchmetrics_tpu_torch as T

    preds, target, _, _, vec = _stream()
    if kind == "moments":
        jm, tm = _jax_moments(), _moments_cls()(device="cpu")
        jm.update(jnp.asarray(vec[0]))
        tm.update(torch.from_numpy(vec[0]))
        return jm, tm
    jcls = {"accuracy": J.classification.BinaryAccuracy, "ap": J.classification.BinaryAveragePrecision}[kind]
    tcls = {"accuracy": T.BinaryAccuracy, "ap": T.BinaryAveragePrecision}[kind]
    jm, tm = jcls(), tcls(device="cpu")
    jm.update(jnp.asarray(preds), jnp.asarray(target.astype(np.int32)))
    tm.update(torch.from_numpy(preds), torch.from_numpy(target.astype(np.int32)))
    return jm, tm


@pytest.mark.parametrize("kind", ["accuracy", "ap", "moments"])
def test_fake_two_rank_sync_matches_jax_bitwise(kind):
    """``sync`` with a fake 2-rank gather applies the same reductions as
    JAX's: int, float and cat states bitwise; ``unsync`` restores."""
    jm, tm = _fold_both(kind)
    before = {k: (list(v) if isinstance(v, list) else v.clone()) for k, v in tm.state_tree().items()}
    jm.sync(dist_sync_fn=_fake_world(), distributed_available=lambda: True)
    tm.sync(dist_sync_fn=_fake_world(), distributed_available=lambda: True)
    assert tm._is_synced
    for key, jv in jm.state_tree().items():
        tv = tm.state_tree()[key]
        want = np.concatenate([np.asarray(v) for v in jv]) if isinstance(jv, list) else np.asarray(jv)
        got = torch.cat(list(tv)).numpy() if isinstance(tv, list) else tv.numpy()
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(_bytes(got), _bytes(want), err_msg=key)
    tm.unsync()
    for key, value in before.items():
        now = getattr(tm, key)
        if isinstance(value, list):
            assert len(now) == len(value) and all(a is b for a, b in zip(now, value)), key
        else:
            assert torch.equal(now, value), key


def test_double_sync_and_double_unsync_raise():
    from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

    _, tm = _fold_both("accuracy")
    tm.sync(dist_sync_fn=_fake_world(), distributed_available=lambda: True)
    with pytest.raises(TorchMetricsUserError, match="already been synced"):
        tm.sync(dist_sync_fn=_fake_world(), distributed_available=lambda: True)
    with pytest.raises(TorchMetricsUserError, match="shouldn't be synced when performing ``forward``"):
        tm(torch.rand(4), torch.ones(4, dtype=torch.int32))
    tm.unsync()
    with pytest.raises(TorchMetricsUserError, match="already been un-synced"):
        tm.unsync()


def test_sync_is_a_no_op_without_a_group():
    _, tm = _fold_both("accuracy")
    tp = tm.tp
    tm.sync()  # no initialised process group: nothing to gather
    assert not tm._is_synced and tm.tp is tp


def test_compute_syncs_through_dist_sync_fn_and_restores():
    import torchmetrics_tpu_torch as T

    calls = []

    def fake(x, group=None):
        calls.append(x.shape)
        return [x, x]

    preds, target, *_ = _stream()
    m = T.BinaryAccuracy(device="cpu", dist_sync_fn=fake, distributed_available_fn=lambda: True)
    m.update(torch.from_numpy(preds), torch.from_numpy(target))
    tp = m.tp.clone()
    value = m.compute()
    local = T.BinaryAccuracy(device="cpu", distributed_available_fn=lambda: False)
    local.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert torch.equal(value, local.compute())  # doubled counts, same ratio
    assert len(calls) == len(m._defaults) and torch.equal(m.tp, tp) and not m._is_synced


def test_failed_sync_rolls_back_and_raises():
    from torchmetrics_tpu_torch.robustness import SyncConfig
    from torchmetrics_tpu_torch.utilities.exceptions import SyncError

    _, tm = _fold_both("accuracy")
    before = dict(tm.state_tree())
    seen = []

    def flaky(x, group=None):
        seen.append(1)
        if len(seen) == 3:
            raise RuntimeError("transport reset")
        return [x, x]

    with pytest.raises(SyncError, match="failed after 1 attempt"):
        tm.sync(dist_sync_fn=flaky, distributed_available=lambda: True)
    assert not tm._is_synced and tm._cache is None
    assert all(getattr(tm, k) is v for k, v in before.items())
    seen.clear()
    tm.sync(dist_sync_fn=flaky, distributed_available=lambda: True, sync_config=SyncConfig(retries=1, backoff_base_s=0.0))
    assert tm._is_synced and torch.equal(tm.tp, 2 * before["tp"])


def test_sync_timeout_raises_from_the_waiting_thread():
    from torchmetrics_tpu_torch.robustness import SyncConfig
    from torchmetrics_tpu_torch.utilities.exceptions import SyncError

    _, tm = _fold_both("accuracy")
    release = threading.Event()

    def straggler(x, group=None):
        release.wait(10)
        return [x, x]

    with pytest.raises(SyncError, match="timed out after 0.2s"):
        tm.sync(dist_sync_fn=straggler, distributed_available=lambda: True, sync_config=SyncConfig(timeout_s=0.2))
    release.set()
    assert not tm._is_synced


def test_on_error_local_warns_once_and_keeps_local_state():
    from torchmetrics_tpu_torch.robustness import SyncConfig
    from torchmetrics_tpu_torch.utilities.exceptions import SyncWarning

    _, tm = _fold_both("accuracy")
    tp = tm.tp

    def broken(x, group=None):
        raise RuntimeError("no route to host")

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tm.sync(dist_sync_fn=broken, distributed_available=lambda: True,
                sync_config=SyncConfig(retries=2, backoff_base_s=0.0, on_error="local"))
    assert sum(issubclass(w.category, SyncWarning) for w in caught) == 1
    assert not tm._is_synced and tm.tp is tp


@pytest.mark.parametrize(
    "kwargs",
    [
        {"on_error": "ignore"},
        {"retries": -1},
        {"timeout_s": 0},
        {"backoff_base_s": -1},
        {"backoff_factor": 0.5},
        {"backoff_max_s": -0.1},
    ],
)
def test_sync_config_checks_match_jax(kwargs):
    from torchmetrics_tpu.robustness import SyncConfig as JSyncConfig
    from torchmetrics_tpu_torch.robustness import SyncConfig

    with pytest.raises(ValueError) as jerr:
        JSyncConfig(**kwargs)
    with pytest.raises(ValueError) as terr:
        SyncConfig(**kwargs)
    assert str(terr.value) == str(jerr.value)


def test_sync_config_backoff_matches_jax():
    from torchmetrics_tpu.robustness import SyncConfig as JSyncConfig
    from torchmetrics_tpu_torch.robustness import SyncConfig

    kw = {"retries": 6, "backoff_base_s": 0.25, "backoff_factor": 3.0, "backoff_max_s": 5.0}
    assert SyncConfig(**kw).attempts == JSyncConfig(**kw).attempts == 7
    assert [SyncConfig(**kw).backoff(a) for a in range(7)] == [JSyncConfig(**kw).backoff(a) for a in range(7)]


@pytest.mark.parametrize(
    "spec",
    [
        "corrupt:gather_bytes.payload:rank=1;fail:sync.attempt:count=2",
        "delay:sync.state_gather:after=1:count=3:arg=0.25",
        "truncate:gather_bytes.payload:arg=64",
        "fail:feed.stage",
        "preempt:update.preempt:after=4",
        "",
    ],
)
def test_fault_grammar_matches_jax(spec):
    from torchmetrics_tpu.robustness import faults as jfaults
    from torchmetrics_tpu_torch.robustness import faults

    try:
        parsed = faults.install_from_env(spec)
        jparsed = jfaults.install_from_env(spec)
        assert [(f.kind, f.point, f.rank, f.after, f.count, f.arg) for f in parsed] == [
            (f.kind, f.point, f.rank, f.after, f.count, f.arg) for f in jparsed
        ]
    finally:
        faults.clear()
        jfaults.clear()
    assert faults.KNOWN_POINTS == jfaults.KNOWN_POINTS


@pytest.mark.parametrize(
    "spec", ["fail", "fail:sync.atempt", "fail:sync.attempt:rnk=1", "explode:sync.attempt", "fail:sync.attempt:count=-1"]
)
def test_fault_grammar_errors_match_jax(spec):
    from torchmetrics_tpu.robustness import faults as jfaults
    from torchmetrics_tpu_torch.robustness import faults

    with pytest.raises(ValueError) as jerr:
        jfaults.install_from_env(spec)
    with pytest.raises(ValueError) as terr:
        faults.install_from_env(spec)
    assert str(terr.value) == str(jerr.value)
    assert not faults.active()
    jfaults.clear()


def test_fault_windows_are_deterministic():
    from torchmetrics_tpu_torch.robustness import faults

    fault = faults.Fault("fail", "private.point", after=1, count=2)
    fired = []
    with faults.inject(fault):
        for _ in range(5):
            try:
                faults.fire("private.point")
                fired.append(False)
            except faults.FaultInjected:
                fired.append(True)
    assert fired == [False, True, True, False, False] and not faults.active()


def test_feed_stage_fault_reaches_the_consumer():
    from torchmetrics_tpu_torch.parallel import DeviceFeed
    from torchmetrics_tpu_torch.robustness import faults

    batches = [(np.ones(3, np.float32), np.zeros(3, np.int32)) for _ in range(4)]
    got = []
    with faults.inject(faults.Fault("fail", "feed.stage", after=2, count=1)):
        with pytest.raises(faults.FaultInjected, match="feed.stage"):
            for batch in DeviceFeed(batches, device="cpu"):
                got.append(batch)
    assert len(got) == 2


def test_update_preempt_fires_after_a_completed_update():
    import torchmetrics_tpu_torch as T
    from torchmetrics_tpu_torch.robustness import faults

    preds, target, *_ = _stream()
    m = T.BinaryAccuracy(device="cpu")
    with faults.inject(faults.Fault("preempt", "update.preempt", after=1, count=1)):
        m.update(torch.from_numpy(preds), torch.from_numpy(target))
        with pytest.raises(faults.SimulatedPreemption):
            m.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert m._update_count == 2  # the update completed before the preemption


def test_compute_on_cpu_keeps_list_states_on_the_host():
    import torchmetrics_tpu_torch as T

    preds, target, *_ = _stream()
    m = T.BinaryAveragePrecision(device="cpu", compute_on_cpu=True)
    m.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert all(t.device.type == "cpu" for t in m.preds + m.target)
    ref = T.BinaryAveragePrecision(device="cpu")
    ref.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert torch.equal(m.compute(), ref.compute())


def test_rank_zero_warn_reads_the_rank_at_each_call(monkeypatch):
    """A group initialised after import is honoured: the rank is not cached."""
    import torch.distributed as dist

    from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

    with pytest.warns(UserWarning, match="first"):
        rank_zero_warn("first")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rank_zero_warn("second")
    assert not caught
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    with pytest.warns(UserWarning, match="third"):
        rank_zero_warn("third")


if __name__ == "__main__":
    _worker_main(sys.argv)
