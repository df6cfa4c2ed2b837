# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's sharded plane (``sharded_update``, ``ShardedMetric``,
``suite.fused(mesh=...)``, ``mesh_reduce_tree``, ``cat_buffer_all_gather``)
on a 2-rank gloo ``DeviceMesh``, against the JAX package's on a 2-device
virtual CPU mesh.

This file run as a script is the worker (``python tests/test_torch_sharded.py
<rank> <world> <addr> sharded <out_dir>``; no JAX): each rank gets half the
rows of every batch, drives the port's sharded paths, checks what it can on
its own (values bitwise equal to the port's single-process fold, each
reduction kind of ``mesh_reduce_tree`` against its definition, the
rank-ordered gather of CatBuffers; rank-local and sharded updates refused
in either order until ``reset()``; two sharded folds of Pearson, whose
``None`` states stack per fold, and MSE; four sharded events of
``MinMaxMetric``, ``ClasswiseWrapper``, ``MultioutputWrapper`` and
``Running``, and the refusals of ``BootStrapper`` and
``MultioutputWrapper(remove_nans=True)``) and saves its states (``.npz``). The
parent holds them against JAX's ``sharded_update`` and ``fused(mesh=...)``
over the whole batches: integer states, CatBuffers and the exact group's cat
states bitwise; the suite's values within the budgets of
``tests/test_torch_fused.py`` (rtol 1e-6, atol 1e-7 from probabilities).
At world size 1 (a one-rank group in this process) the mix is accepted and
gives JAX's states.
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


def _batches():
    rng = np.random.default_rng(11)
    out = []
    for _ in range(NB):
        x = rng.standard_normal((N, C)).astype(np.float32)
        probs = (np.exp(x) / np.exp(x).sum(1, keepdims=True)).astype(np.float32)
        out.append((probs, rng.integers(0, C, N).astype(np.int32)))
    return out


def _members(pkg, exact=False, **kw):
    """The headline suite, or the exact group (cat states), of ``pkg``."""
    cls = pkg.classification if not hasattr(pkg, "BinaryAccuracy") else pkg
    if exact:
        return {
            "auroc": cls.MulticlassAUROC(num_classes=C, **kw),
            "ap": cls.MulticlassAveragePrecision(num_classes=C, **kw),
        }
    return {
        "acc": cls.MulticlassAccuracy(num_classes=C, average="micro", **kw),
        "f1": cls.MulticlassF1Score(num_classes=C, average="macro", **kw),
        "auroc": cls.MulticlassAUROC(num_classes=C, thresholds=THR, **kw),
    }


def _flat(value) -> np.ndarray:
    if isinstance(value, (list, tuple)):
        return np.concatenate([np.atleast_1d(np.asarray(v)) for v in value])
    return np.asarray(value)


def _save_members(saved: dict, prefix: str, members: dict) -> None:
    for key, metric in members.items():
        for name, value in metric.state_tree().items():
            saved[f"{prefix}.{key}.{name}"] = _flat([v.numpy() for v in value] if isinstance(value, list) else value.numpy())


# -------------------------------------------------------------------- worker


def _check_mesh_reduce_tree(rank: int, mesh) -> None:
    from torchmetrics_tpu_torch.parallel import mesh_reduce_tree

    def part(r):
        g = torch.Generator().manual_seed(100 + r)
        return {
            "s": torch.randint(0, 9, (3,), generator=g, dtype=torch.int32),
            "m": torch.rand(3, generator=g),
            "mx": torch.rand(2, 2, generator=g),
            "mn": torch.rand(2, generator=g),
            "c": torch.rand(2 + r, generator=g),
            "n": torch.rand(2, generator=g),
            "f": torch.rand(3, generator=g),
            "lc": [torch.rand(2, generator=g), torch.rand(1, generator=g)],
            "ln": [torch.rand(3, generator=g)],
        }

    reductions = {"s": "sum", "m": "mean", "mx": "max", "mn": "min", "c": "cat", "n": None,
                  "f": lambda x: x.sum(0) * 2, "lc": "cat", "ln": None}
    mine, parts = part(rank), [part(0), part(1)]
    before = {k: [t.clone() for t in v] if isinstance(v, list) else v.clone() for k, v in mine.items()}
    got = mesh_reduce_tree(reductions, mine, "data", mesh=mesh)
    want = {
        "s": parts[0]["s"] + parts[1]["s"],
        "m": (parts[0]["m"] + parts[1]["m"]) / 2,
        "mx": torch.maximum(parts[0]["mx"], parts[1]["mx"]),
        "mn": torch.minimum(parts[0]["mn"], parts[1]["mn"]),
        "c": torch.cat([parts[0]["c"], parts[1]["c"]]),
        "n": torch.stack([parts[0]["n"], parts[1]["n"]]),
        "f": torch.stack([parts[0]["f"], parts[1]["f"]]).sum(0) * 2,
        "lc": [torch.cat([parts[0]["lc"][i], parts[1]["lc"][i]]) for i in range(2)],
        "ln": [torch.cat([parts[0]["ln"][0], parts[1]["ln"][0]])],
    }
    assert list(got) == list(want), list(got)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, list):
            assert len(g) == len(w) and all(torch.equal(a, b) for a, b in zip(g, w)), key
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), (key, g, w)
    for key, value in before.items():  # the input tree is not written
        now = mine[key]
        assert all(torch.equal(a, b) for a, b in zip(now, value)) if isinstance(value, list) else torch.equal(now, value), key


def _check_cat_buffer_all_gather(rank: int, mesh, saved: dict) -> None:
    from torchmetrics_tpu_torch.parallel import cat_buffer_all_gather, cat_buffer_append, cat_buffer_init

    rows = torch.arange(14, dtype=torch.float32).reshape(7, 2) + 100 * rank
    buf = cat_buffer_append(cat_buffer_init(5, (2,)), rows[: 2 if rank == 0 else 7])  # rank 1 overflows
    out = cat_buffer_all_gather(buf, "data", mesh=mesh)
    assert out.data.shape == (10, 2) and int(out.count) == 7 and bool(out.overflowed), out
    want = torch.zeros(10, 2)
    want[:2] = torch.arange(4, dtype=torch.float32).reshape(2, 2)
    want[2:7] = torch.arange(10, dtype=torch.float32).reshape(5, 2) + 100
    assert torch.equal(out.data, want), out.data
    saved.update({"gather.data": out.data.numpy(), "gather.count": out.count.numpy(), "gather.overflowed": out.overflowed.numpy()})


def _refused(call, *args) -> str:
    """The message of the TorchMetricsUserError that ``call(*args)`` must raise."""
    from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

    try:
        call(*args)
    except TorchMetricsUserError as err:
        assert "reset()" in str(err), f"the refusal does not say how to clear the state: {err}"
        return str(err)
    raise AssertionError(f"{getattr(call, '__name__', call)} mixed rank-local and sharded updates without an error")


def _check_mixing_is_refused(T, mesh, local) -> None:
    """A plain update()/forward() after a sharded fold, a sharded fold after
    plain updates, and a plan seeded from the other regime's state all raise,
    leave the state as it was, and pass after reset()."""
    from torchmetrics_tpu_torch.parallel import sharded_update

    def acc():
        return T.MulticlassAccuracy(num_classes=C, average="micro", device="cpu")

    m = acc()
    sharded_update(m, mesh, *local[0])
    before = {k: v.clone() for k, v in m.state_tree().items()}
    _refused(m.update, *local[1])
    _refused(m.forward, *local[1])
    assert m._update_count == 1 and m._mesh_replicated, "a refused update moved the count or the flag"
    assert all(torch.equal(v, before[k]) for k, v in m.state_tree().items()), "a refused update changed the state"
    m.reset()
    m.update(*local[1])  # after reset() a plain update is accepted
    _refused(sharded_update, m, mesh, *local[0])  # the collective ran on both ranks; both refuse after it
    assert m._update_count == 1 and not m._mesh_replicated, "a refused sharded fold moved the count or the flag"
    m.reset()
    sharded_update(m, mesh, *local[0])
    assert m._update_count == 1 and m._mesh_replicated

    suite = T.MetricCollection({"acc": acc(), "f1": T.MulticlassF1Score(num_classes=C, device="cpu")})
    suite.update(*local[0])
    _refused(lambda: suite.fused(mesh=mesh))  # a mesh plan seeded from rank-local states
    suite.reset()
    plan = suite.fused(mesh=mesh)
    plan.update(*local[0])
    plan.fold_back()
    _refused(suite.update, *local[1])
    _refused(lambda: suite.fused())  # a local plan seeded from mesh-replicated states
    suite.reset()
    suite.fused().update(*local[1])
    print(f"rank {torch.distributed.get_rank()}: mixing refused in both orders, accepted after reset()", flush=True)


def _regression_batches():
    rng = np.random.default_rng(13)
    out = []
    for _ in range(2):
        preds = rng.standard_normal((N, 2)).astype(np.float32)
        out.append((preds, (preds + rng.standard_normal((N, 2))).astype(np.float32)))
    return out


def _regression_members(pkg, **kw):
    return {"pearson": pkg.PearsonCorrCoef(num_outputs=2, **kw), "mse": pkg.MeanSquaredError(num_outputs=2, **kw)}


def _check_regression_folds(T, mesh, rank: int, saved: dict) -> None:
    """Two ``sharded_update`` folds of each rank's half: Pearson's states grow
    to (folds, ranks, outputs) and merge over both shard axes at compute."""
    from torchmetrics_tpu_torch.parallel import sharded_update

    members = _regression_members(T, device="cpu")
    ref = _regression_members(T, device="cpu", distributed_available_fn=lambda: False)
    shard = slice(rank * HALF, (rank + 1) * HALF)
    for preds, target in _regression_batches():
        for key, m in members.items():
            sharded_update(m, mesh, torch.from_numpy(preds[shard]), torch.from_numpy(target[shard]))
            ref[key].update(torch.from_numpy(preds), torch.from_numpy(target))
    assert members["pearson"].mean_x.shape == (2, 2, 2), members["pearson"].mean_x.shape
    for key, m in members.items():
        got, want = m.compute(), ref[key].compute()
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-6), f"sharded {key}: {got} vs the one-process fold {want}"
        saved[f"regression.{key}.value"] = got.numpy()
    _save_members(saved, "regression", members)


def _perplexity_batches():
    """Two (N, T, V) logit batches and their targets, some ignored (JAX's sweep's ``_perplexity_data``, wider)."""
    rng = np.random.default_rng(19)
    out = []
    for _ in range(2):
        target = rng.integers(0, 11, (N, 12))
        target[rng.random((N, 12)) < 0.1] = -100
        out.append(((3 * rng.standard_normal((N, 12, 11))).astype(np.float32), target))
    return out


def _check_perplexity(T, mesh, rank: int, saved: dict) -> None:
    """Perplexity rides ``sharded_update`` (JAX's sweep has it): each rank's half of each batch, states summed
    over the mesh, against the one-process fold."""
    from torchmetrics_tpu_torch.parallel import sharded_update

    m = T.Perplexity(ignore_index=-100, device="cpu")
    ref = T.Perplexity(ignore_index=-100, device="cpu", distributed_available_fn=lambda: False)
    shard = slice(rank * HALF, (rank + 1) * HALF)
    for logits, target in _perplexity_batches():
        sharded_update(m, mesh, torch.from_numpy(logits[shard]), torch.from_numpy(target[shard]))
        ref.update(torch.from_numpy(logits), torch.from_numpy(target))
    assert torch.equal(m.count, ref.count), (m.count, ref.count)
    assert torch.allclose(m.compute(), ref.compute(), rtol=1e-6), f"sharded Perplexity {m.compute()} vs {ref.compute()}"
    _save_members(saved, "perplexity", {"ppl": m})


def _wrapper_reg_batches():
    rng = np.random.default_rng(17)
    out = []
    for _ in range(NB):
        preds = rng.standard_normal((N, 2)).astype(np.float32)
        out.append((preds, (preds + rng.standard_normal((N, 2))).astype(np.float32)))
    return out


def _wrappers(pkg, **kw):
    """The wrapper metrics the sharded plane takes, each with its stream's key:
    ``cls`` (the headline batches) or ``reg`` (``_wrapper_reg_batches``)."""
    cls = pkg.classification if hasattr(pkg, "classification") else pkg
    return {
        "minmax": (pkg.MinMaxMetric(cls.MulticlassAUROC(num_classes=C, thresholds=THR, **kw)), "cls"),
        "classwise": (pkg.ClasswiseWrapper(cls.MulticlassF1Score(num_classes=C, average=None, **kw)), "cls"),
        "multioutput": (pkg.MultioutputWrapper(pkg.MeanSquaredError(**kw), num_outputs=2, remove_nans=False), "reg"),
        "running": (pkg.Running(pkg.MeanSquaredError(**kw), window=3), "reg1"),
    }


def _reg_event(batch, key):
    """A wrapper's inputs from a regression batch: both columns, or the first (``reg1``)."""
    return batch if key == "reg" else tuple(x[:, 0] for x in batch)


def _check_wrappers(T, mesh, rank: int, saved: dict) -> None:
    """Four sharded events of each wrapper (each rank holds half the rows of
    every batch), computed after every event; the deep state trees and the
    values are saved for the parent's comparison with JAX. ``BootStrapper``
    and ``MultioutputWrapper(remove_nans=True)`` are refused with JAX's reasons."""
    from torchmetrics_tpu_torch.parallel import ShardedMetric, sharded_update
    from torchmetrics_tpu_torch.parallel.sharded import deep_state_tree

    shard = slice(rank * HALF, (rank + 1) * HALF)
    streams = {"cls": _batches(), "reg": _wrapper_reg_batches()}
    for tag, (metric, key) in _wrappers(T, device="cpu").items():
        stream = streams["cls" if key == "cls" else "reg"]
        for i, batch in enumerate(stream):
            local = tuple(torch.from_numpy(x[shard]) for x in (batch if key == "cls" else _reg_event(batch, key)))
            sharded_update(metric, mesh, *local)
            value = metric.compute()
            for k, v in (value.items() if isinstance(value, dict) else [("value", value)]):
                saved[f"wrap.{tag}.{i}.{k}"] = v.numpy()
        for name, value in deep_state_tree(metric).items():
            saved[f"wrap.{tag}.state.{name}"] = value.numpy()
        assert metric._mesh_replicated, tag

    # a plain update after a sharded fold is refused, children included
    minmax = _wrappers(T, device="cpu")["minmax"][0]
    first = tuple(torch.from_numpy(x[shard]) for x in _batches()[0])
    sharded_update(minmax, mesh, *first)
    _refused(minmax.update, *first)
    reg_first = tuple(torch.from_numpy(x[shard, 0]) for x in _wrapper_reg_batches()[0])
    running = _wrappers(T, device="cpu")["running"][0]
    running.update(*reg_first)
    _refused(sharded_update, running, mesh, *reg_first)  # a window holding plain updates takes no sharded event
    running.reset()
    sharded_update(running, mesh, *reg_first)
    _refused(running.update, *reg_first)  # nor a window holding sharded events a plain update

    # ShardedMetric.forward of a wrapper: the batch value over both ranks' shards; the children keep the totals
    fwd = ShardedMetric(T.MinMaxMetric(T.MulticlassAccuracy(num_classes=C, average="micro", device="cpu")), mesh)
    one = T.MulticlassAccuracy(num_classes=C, average="micro", device="cpu", distributed_available_fn=lambda: False)
    total = T.MulticlassAccuracy(num_classes=C, average="micro", device="cpu", distributed_available_fn=lambda: False)
    for b in _batches()[:3]:
        one.reset()
        one.update(*(torch.from_numpy(x) for x in b))
        total.update(*(torch.from_numpy(x) for x in b))
        got = fwd(*(torch.from_numpy(x[shard]) for x in b))
        assert torch.equal(got["raw"], one.compute()), ("ShardedMetric.forward of MinMaxMetric", got, one.compute())
    assert torch.equal(fwd._metric._base_metric.tp, total.tp), "forward's detour lost the child's totals"

    for refused in (T.BootStrapper(T.MulticlassAccuracy(num_classes=C, device="cpu"), num_bootstraps=2),
                    T.MultioutputWrapper(T.MeanSquaredError(device="cpu"), num_outputs=2)):
        try:
            sharded_update(refused, mesh, *first)
        except ValueError as err:
            assert str(err).endswith(refused._sharded_update_unsupported), err
            saved[f"refusal.{type(refused).__name__}"] = np.array(str(err))
        else:
            raise AssertionError(f"{type(refused).__name__} was not refused")
    print(f"rank {rank}: sharded wrapper checks passed", flush=True)


def _scenario_sharded(rank: int, world: int, out_dir: Path) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import torchmetrics_tpu_torch as T
    from torchmetrics_tpu_torch.parallel import ShardedMetric, sharded_update

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    batches = [tuple(torch.from_numpy(x) for x in b) for b in _batches()]
    shard = slice(rank * HALF, (rank + 1) * HALF)
    local = [tuple(x[shard] for x in b) for b in batches]
    saved: dict = {}

    def single(exact=False):
        """The port's single-process fold of the whole batches."""
        members = _members(T, exact=exact, device="cpu", distributed_available_fn=lambda: False)
        for b in batches:
            for m in members.values():
                m.update(*b)
        return members

    # 1) ShardedMetric / sharded_update: every rank's metric holds the whole batch's totals
    ref = single()
    sharded = {k: ShardedMetric(m, mesh) for k, m in _members(T, device="cpu").items()}
    for b in local:
        for m in sharded.values():
            m.update(*b)
    for key, m in sharded.items():
        assert torch.equal(m.compute(), ref[key].compute()), f"sharded {key}: {m.compute()} vs {ref[key].compute()}"
        assert m._mesh_replicated and not m._is_synced
    _save_members(saved, "sharded", {k: m._metric for k, m in sharded.items()})

    # forward: the batch value over every rank's shard
    fwd = ShardedMetric(T.MulticlassAccuracy(num_classes=C, average="micro", device="cpu"), mesh)
    one = T.MulticlassAccuracy(num_classes=C, average="micro", device="cpu", distributed_available_fn=lambda: False)
    for b, lb in zip(batches[:2], local[:2]):
        one.reset()
        one.update(*b)
        assert torch.equal(fwd(*lb), one.compute()), "ShardedMetric.forward batch value"

    ref_exact = single(exact=True)
    exact = _members(T, exact=True, device="cpu")
    for b in local:
        for m in exact.values():
            sharded_update(m, mesh, *b)
    for key, m in exact.items():
        assert torch.equal(m.compute(), ref_exact[key].compute()), f"sharded exact {key}"
    _save_members(saved, "sharded_exact", exact)

    # 2) the sharded fused plan: update and run_scan
    for mode in ("update", "scan"):
        suite = T.MetricCollection(_members(T, device="cpu"))
        suite.update(*local[0])
        suite.update(*local[1])
        suite.reset()
        plan = suite.fused(mesh=mesh)
        if mode == "update":
            for b in local:
                plan.update(*b)
        else:
            plan.run_scan(local)
        assert plan.updates_applied == NB
        plan.fold_back()
        values = suite.compute()
        for key in ref:
            assert torch.equal(values[key], ref[key].compute()), f"fused {mode} {key}: {values[key]}"
        _save_members(saved, f"fused_{mode}", {k: suite[k] for k in ref})
        saved.update({f"fused_{mode}.value.{k}": v.numpy() for k, v in values.items()})

    cap = N * NB + 8
    group = T.MetricCollection(_members(T, exact=True, device="cpu"), compute_groups=False)
    plan = group.fused(mesh=mesh, cat_capacity=cap, example_batch=local[0])
    for b in local:
        plan.update(*b)
    carry = plan.state["members"]
    for key in ("auroc", "ap"):
        for name in ("preds", "target"):
            buf = carry[key][name]
            saved.update({f"fused_exact.{key}.{name}.{part}": t.numpy() for part, t in zip(buf._fields, buf)})
    plan.fold_back()
    for key, value in group.compute().items():
        assert torch.equal(value, ref_exact[key].compute()), f"fused exact {key}"

    # 3) the building blocks
    _check_mesh_reduce_tree(rank, mesh)
    _check_cat_buffer_all_gather(rank, mesh, saved)

    # 4) rank-local and sharded updates do not mix while sync would run
    _check_mixing_is_refused(T, mesh, local)

    # 5) two sharded folds of Pearson (None states: stacked per fold) and MSE
    _check_regression_folds(T, mesh, rank, saved)

    # 6) wrapper metrics: the deep walk, one window slot per event for Running
    _check_wrappers(T, mesh, rank, saved)

    # 7) Perplexity, the text metric whose update is device work
    _check_perplexity(T, mesh, rank, saved)

    np.savez(out_dir / f"sharded_rank{rank}.npz", **saved)
    dist.barrier()
    print(f"rank {rank}: all sharded checks passed", flush=True)


def _worker_main(argv) -> None:
    import torch.distributed as dist

    rank, world, addr, out_dir = int(argv[1]), int(argv[2]), argv[3], Path(argv[5])
    dist.init_process_group("gloo", init_method=addr, world_size=world, rank=rank)
    try:
        _scenario_sharded(rank, world, out_dir)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- the tests


def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:2]), ("data",))


def _assert_bitwise(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8), err_msg=what)


def _assert_members(saved: dict, prefix: str, members: dict) -> None:
    for key, metric in members.items():
        for name, value in metric.state_tree().items():
            _assert_bitwise(saved[f"{prefix}.{key}.{name}"], _flat(value), f"{prefix}.{key}.{name}")


@pytest.fixture(scope="module")
def worker_states(tmp_path_factory):
    """Run the 2-rank worker once for this file's tests; each rank's saved states."""
    out_dir = tmp_path_factory.mktemp("sharded")
    results = run_workers(Path(__file__), "sharded", out_dir, timeout=120)
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank}: all sharded checks passed" in out, out
        assert f"rank {rank}: mixing refused in both orders" in out, out
        assert f"rank {rank}: sharded wrapper checks passed" in out, out
    return [dict(np.load(out_dir / f"sharded_rank{rank}.npz")) for rank in range(2)]


@pytest.fixture(scope="module")
def jax_batches():
    import jax.numpy as jnp

    return [tuple(jnp.asarray(x) for x in b) for b in _batches()]


def _jax_sharded(batches, exact=False):
    import torchmetrics_tpu as J
    from torchmetrics_tpu.parallel import sharded_update

    mesh = _jax_mesh()
    members = _members(J, exact=exact)
    for b in batches:
        for m in members.values():
            sharded_update(m, mesh, *b)
    return members


@pytest.mark.parametrize("exact", [False, True], ids=["suite", "exact_group"])
def test_sharded_update_matches_jax(worker_states, jax_batches, exact):
    """Both ranks' states after ``ShardedMetric``/``sharded_update`` over
    their halves == JAX's ``sharded_update`` over the whole batches."""
    members = _jax_sharded(jax_batches, exact=exact)
    for saved in worker_states:
        _assert_members(saved, "sharded_exact" if exact else "sharded", members)


@pytest.mark.parametrize("mode", ["update", "scan"])
def test_fused_mesh_matches_jax(worker_states, jax_batches, mode):
    """``suite.fused(mesh=...)`` on both ranks == JAX's ``fused(mesh=...)``:
    states bitwise, values within the probability budget."""
    import torchmetrics_tpu as J

    fused = J.MetricCollection(_members(J))
    fused.update(*jax_batches[0])
    fused.update(*jax_batches[1])
    fused.reset()
    plan = fused.fused(mesh=_jax_mesh())
    for b in jax_batches:
        plan.update(*b)
    plan.fold_back()
    values = {k: np.asarray(v) for k, v in fused.compute().items()}
    for saved in worker_states:
        _assert_members(saved, f"fused_{mode}", {k: fused[k] for k in values})
        for key, want in values.items():
            np.testing.assert_allclose(saved[f"fused_{mode}.value.{key}"], want, rtol=1e-6, atol=1e-7, err_msg=key)


def test_fused_mesh_catbuffers_match_jax(worker_states, jax_batches):
    """The exact group's CatBuffer carries (data, count, overflowed) == JAX's, bitwise."""
    import torchmetrics_tpu as J

    group = J.MetricCollection(_members(J, exact=True), compute_groups=False)
    plan = group.fused(mesh=_jax_mesh(), cat_capacity=N * NB + 8, example_batch=jax_batches[0])
    for b in jax_batches:
        plan.update(*b)
    for saved in worker_states:
        for key in ("auroc", "ap"):
            for name in ("preds", "target"):
                jbuf = plan.state["members"][key][name]
                for part, want in zip(jbuf._fields, jbuf):
                    _assert_bitwise(saved[f"fused_exact.{key}.{name}.{part}"], np.asarray(want), f"{key}.{name}.{part}")


def test_sharded_perplexity_matches_jax(worker_states):
    """Perplexity through ``sharded_update`` on both ranks == JAX's ``sharded_update`` over the whole batches:
    the float32 token count bitwise, the summed -log p within ``rtol=1e-6`` (each rank adds its half first)."""
    import jax.numpy as jnp

    import torchmetrics_tpu as J
    from torchmetrics_tpu.parallel import sharded_update

    jm = J.Perplexity(ignore_index=-100)
    for logits, target in _perplexity_batches():
        sharded_update(jm, _jax_mesh(), jnp.asarray(logits), jnp.asarray(target))
    want = jm.state_tree()
    for saved in worker_states:
        _assert_bitwise(saved["perplexity.ppl.count"], np.asarray(want["count"]), "count")
        got = saved["perplexity.ppl.total_log_probs"]
        assert got.dtype == np.asarray(want["total_log_probs"]).dtype
        np.testing.assert_allclose(got, np.asarray(want["total_log_probs"]), rtol=1e-6)


def test_sharded_regression_folds_match_jax(worker_states):
    """Two folds of Pearson and MSE on both ranks == JAX's ``sharded_update``
    over the whole batches on a 2-device mesh: counts bitwise, float states
    (the per-device partial sums) within rtol 1e-6, the values within 1e-5."""
    import jax.numpy as jnp

    import torchmetrics_tpu as J
    from torchmetrics_tpu.parallel import sharded_update

    members = _regression_members(J)
    for preds, target in _regression_batches():
        for m in members.values():
            sharded_update(m, _jax_mesh(), jnp.asarray(preds), jnp.asarray(target))
    for saved in worker_states:
        for key, metric in members.items():
            for name, value in metric.state_tree().items():
                got, want = saved[f"regression.{key}.{name}"], _flat(value)
                if name in ("n_total", "total"):
                    _assert_bitwise(got, want, f"{key}.{name}")
                else:
                    assert got.shape == want.shape and got.dtype == want.dtype, (key, name, got.shape, want.shape)
                    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=f"{key}.{name}")
            np.testing.assert_allclose(saved[f"regression.{key}.value"], np.asarray(metric.compute()), rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("tag", ["minmax", "classwise", "multioutput", "running"])
def test_sharded_wrappers_match_jax(worker_states, tag):
    """Four ``sharded_update`` events of a wrapper on both ranks == JAX's
    ``sharded_update`` over the whole batches on a 2-device mesh: the deep
    state tree (the wrapper's and its children's states; ``Running``'s
    window, one slot rotated per event) with int32 states bitwise and float
    states within rtol 1e-6, and the value after every event within rtol 1e-6."""
    import jax.numpy as jnp

    import torchmetrics_tpu as J
    from torchmetrics_tpu.parallel import sharded_update
    from torchmetrics_tpu.parallel.sharded import deep_state_tree

    metric, key = _wrappers(J)[tag]
    stream = _batches() if key == "cls" else [_reg_event(b, key) for b in _wrapper_reg_batches()]
    values = []
    for batch in stream:
        sharded_update(metric, _jax_mesh(), *(jnp.asarray(x) for x in batch))
        value = metric.compute()
        values.append(dict(value) if isinstance(value, dict) else {"value": value})
    tree = deep_state_tree(metric)
    for saved in worker_states:
        state_keys = sorted(k.split(".state.", 1)[1] for k in saved if k.startswith(f"wrap.{tag}.state."))
        assert state_keys == sorted(tree), (state_keys, sorted(tree))
        for name, value in tree.items():
            got, want = saved[f"wrap.{tag}.state.{name}"], np.asarray(value)
            if np.issubdtype(want.dtype, np.integer):
                _assert_bitwise(got, want, f"{tag}.{name}")
            else:
                assert got.dtype == want.dtype and got.shape == want.shape, (tag, name)
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=f"{tag}.{name}")
        for i, want_values in enumerate(values):
            for k, want in want_values.items():
                np.testing.assert_allclose(saved[f"wrap.{tag}.{i}.{k}"], np.asarray(want), rtol=1e-6, atol=1e-7, err_msg=f"{tag} {i} {k}")


def test_sharded_wrapper_refusals_match_jax(worker_states):
    """``BootStrapper`` and ``MultioutputWrapper(remove_nans=True)`` are refused with JAX's messages."""
    import torchmetrics_tpu as J
    from torchmetrics_tpu.parallel import sharded_update

    for refused in (J.BootStrapper(J.MulticlassAccuracy(num_classes=C), num_bootstraps=2) if hasattr(J, "MulticlassAccuracy")
                    else J.BootStrapper(J.classification.MulticlassAccuracy(num_classes=C), num_bootstraps=2),
                    J.MultioutputWrapper(J.MeanSquaredError(), num_outputs=2)):
        with pytest.raises(ValueError) as err:
            sharded_update(refused, _jax_mesh(), *(np.asarray(x) for x in _batches()[0]))
        for saved in worker_states:
            assert str(saved[f"refusal.{type(refused).__name__}"]) == str(err.value)


def test_cat_buffer_all_gather_matches_jax(worker_states):
    for saved in worker_states:
        _assert_gather_matches_jax(saved)


def _assert_gather_matches_jax(saved: dict) -> None:
    """JAX's ``cat_buffer_all_gather`` over the two devices' buffers of the worker's check."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from torchmetrics_tpu.parallel.cat_buffer import CatBuffer, cat_buffer_all_gather, cat_buffer_append, cat_buffer_init
    from torchmetrics_tpu.parallel.sharded import shard_map

    bufs = []
    for rank in range(2):
        rows = np.arange(14, dtype=np.float32).reshape(7, 2) + 100 * rank
        bufs.append(cat_buffer_append(cat_buffer_init(5, (2,)), jnp.asarray(rows[: 2 if rank == 0 else 7])))
    data = jnp.concatenate([b.data for b in bufs])
    count = jnp.stack([b.count for b in bufs])
    over = jnp.stack([b.overflowed for b in bufs])

    def per_device(d, c, o):
        return cat_buffer_all_gather(CatBuffer(d, c[0], o[0]), "data")

    out = shard_map(per_device, mesh=_jax_mesh(), in_specs=(P("data"), P("data"), P("data")), out_specs=P())(data, count, over)
    _assert_bitwise(saved["gather.data"], np.asarray(out.data), "gather.data")
    _assert_bitwise(saved["gather.count"], np.asarray(out.count), "gather.count")
    _assert_bitwise(saved["gather.overflowed"], np.asarray(out.overflowed), "gather.overflowed")


@pytest.fixture
def single_rank_mesh():
    """A one-rank gloo group (an in-process store, no port) and its DeviceMesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("order", ["sharded_then_plain", "plain_then_sharded"])
def test_single_rank_mix_matches_jax(single_rank_mesh, jax_batches, order):
    """At world size 1 sync never runs, so mixing plain and sharded updates is
    accepted, as JAX's one-process mesh accepts it, with JAX's states bitwise."""
    import torchmetrics_tpu as J
    from torchmetrics_tpu.parallel import sharded_update as jax_sharded_update

    import torchmetrics_tpu_torch as T
    from torchmetrics_tpu_torch.parallel import sharded_update

    port, ref = _members(T, device="cpu"), _members(J)
    for i, (jb, b) in enumerate(zip(jax_batches, _batches())):
        b = tuple(torch.from_numpy(x) for x in b)
        sharded = (i % 2 == 0) == (order == "sharded_then_plain")
        for key in port:
            if sharded:
                sharded_update(port[key], single_rank_mesh, *b)
                jax_sharded_update(ref[key], _jax_mesh(), *jb)
            else:
                port[key].update(*b)
                ref[key].update(*jb)
    _assert_members({f"mix.{k}.{n}": _flat(v.numpy()) for k, m in port.items() for n, v in m.state_tree().items()}, "mix", ref)
    for key in port:
        np.testing.assert_allclose(port[key].compute().numpy(), np.asarray(ref[key].compute()), rtol=1e-6, atol=1e-7, err_msg=key)


if __name__ == "__main__":
    _worker_main(sys.argv)
