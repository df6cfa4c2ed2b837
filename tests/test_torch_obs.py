# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's observability plane (``torchmetrics_tpu_torch/obs``) against
the JAX package's, on the CPU.

The host modules are the JAX package's, kept close to word for word, so the
formats are held across the packages: a JSON-lines trace of either package
reads in the other's ``read_jsonl``, in ``tools/metricscope.py summary`` (a
subprocess on the CPU) and in either ``merge_traces``; the Chrome trace and
the OpenMetrics text of equal recordings are equal; the same program run in
both packages records the same span, counter and gauge names (the
counterpart of JAX's ``test_traced_smoke_suite``). The disabled path records
nothing. JAX's ``test_runner_obs_counters`` and
``test_snapshot_bytes_gauge_and_counters`` have their counterparts here, and
the live publisher is scraped over HTTP on localhost (port 0, joined in
teardown). JAX's timing ratchets are not ported: the overhead is measured on
the card (``chip_smoke.py``'s obs phase).
"""
import json
import os
import re
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as T
from torchmetrics_tpu import obs as jobs
from torchmetrics_tpu.robustness import CheckpointStore as JStore
from torchmetrics_tpu.robustness import StreamingEvaluator as JEvaluator
from torchmetrics_tpu_torch import obs as tobs
from torchmetrics_tpu_torch.obs import live as tlive
from torchmetrics_tpu_torch.robustness import CheckpointStore, StreamingEvaluator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _clean_obs():
    for pkg in (jobs, tobs):
        pkg.live.disable()
        pkg.disable()
        pkg.clear()
    yield
    for pkg in (jobs, tobs):
        pkg.live.disable()
        pkg.disable()
        pkg.clear()
        for name in pkg.live.probes():
            pkg.live.unregister_probe(name)


def _batches(n=4, size=32, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 5, size).astype(np.int32), rng.integers(0, 5, size).astype(np.int32)) for _ in range(n)]


def _program(pkg, tmp_path):
    """One program, written once for both packages: the base runtime, a
    collection with compute groups, a checkpoint round-trip, a window ring
    and a durable run killed and resumed through the store."""
    is_jax = pkg is J
    kw = {} if is_jax else CPU
    arr = (lambda x: np.asarray(x, dtype=np.float32)) if is_jax else (lambda x: torch.tensor(x, dtype=torch.float32))
    lab = (lambda x: x) if is_jax else torch.from_numpy
    mean = pkg.MeanMetric(**kw)
    mean.update(arr([1.0, 2.0]))
    mean(arr([3.0]))
    mean.compute()
    mean.reset()
    coll = pkg.MetricCollection({"m1": pkg.MeanMetric(**kw), "m2": pkg.MeanMetric(**kw), "s": pkg.SumMetric(**kw)})
    for step in range(3):
        coll.update(arr(np.arange(1.0 + step, 4.0 + step)))
    coll.compute()
    total = pkg.SumMetric(**kw)
    total.update(arr([1.0, 2.0]))
    total.load_checkpoint(total.save_checkpoint())
    batches = [tuple(lab(a) for a in b) for b in _batches()]
    acc = pkg.classification.MulticlassAccuracy(num_classes=5, **kw)
    ring = pkg.parallel.WindowRing(acc, every_n=2, slots=2)
    store_cls, ev_cls = (JStore, JEvaluator) if is_jax else (CheckpointStore, StreamingEvaluator)
    ev_cls(acc, store=store_cls(str(tmp_path / "ring")), snapshot_every_n=2, window_ring=ring).run(batches)
    store = store_cls(str(tmp_path / "store"))
    ev = ev_cls(pkg.classification.MulticlassAccuracy(num_classes=5, **kw), store=store, snapshot_every_n=2)
    ev.run(batches[:2])
    ev_cls(pkg.classification.MulticlassAccuracy(num_classes=5, **kw), store=store, snapshot_every_n=2).resume(batches)


def _record(pkg, tmp_path):
    obs = jobs if pkg is J else tobs
    with obs.tracing():
        _program(pkg, tmp_path)
        events = obs.get_trace()
        snap = obs.snapshot()
    return events, snap


def test_same_program_records_the_same_names(tmp_path):
    """The counterpart of JAX's ``test_traced_smoke_suite``: the same program
    in both packages records equal sets of span, instant, counter and gauge
    names, and the spans carry the metric class tags the summary groups by."""
    (jev, jsnap), (tev, tsnap) = _record(J, tmp_path / "j"), _record(T, tmp_path / "t")
    names = lambda evs, kind: {e["name"] for e in evs if e["type"] == kind}  # noqa: E731
    assert names(tev, "span") == names(jev, "span")
    assert names(tev, "instant") == names(jev, "instant")
    assert set(tsnap["counters"]) == set(jsnap["counters"])
    assert set(tsnap["gauges"]) == set(jsnap["gauges"])
    expected = {
        "metric.update", "metric.forward", "metric.compute", "metric.sync", "metric.reset",
        "collection.group_update", "collection.compute", "checkpoint.save", "checkpoint.load",
        "runner.run", "runner.resume", "robustness.store.save", "robustness.store.load",
    }
    assert expected <= names(tev, "span")
    for key in ("collection.update.dedup_skipped", "checkpoint.save", "runner.snapshot", "runner.resume"):
        assert tsnap["counters"][key] == jsnap["counters"][key], key
    assert tsnap["counters"]["window.MulticlassAccuracy.rotations"] == 2
    tags = {e["args"]["metric"] for e in tev if e["name"] == "metric.update"}
    assert tags == {e["args"]["metric"] for e in jev if e["name"] == "metric.update"}


def test_disabled_path_records_nothing(tmp_path):
    _program(T, tmp_path)
    assert tobs.get_trace() == [] and tobs.snapshot() == {"counters": {}, "gauges": {}}
    assert tobs.xla_records() == [] and tobs.attribution.registry_rows() == {}


def test_counters_and_trace_ring():
    tobs.counter_inc("a")
    tobs.counter_inc("a", 2)
    tobs.set_gauge("g", 1.5)
    assert tobs.counter_get("a") == 3 and tobs.snapshot() == {"counters": {"a": 3}, "gauges": {"g": 1.5}}
    with tobs.tracing():
        with tobs.span("outer", metric="M"):
            with tobs.span("inner"):
                pass
        tobs.instant("point", why="x")
    events = tobs.get_trace()
    assert [(e["name"], e["depth"], e["type"]) for e in events] == [("inner", 1, "span"), ("outer", 0, "span"), ("point", 0, "instant")]
    assert events[1]["args"] == {"metric": "M"} and events[1]["dur"] >= events[0]["dur"] >= 0
    tobs.configure(2)
    with tobs.tracing(clear_first=False):
        tobs.instant("overflow")
    assert len(tobs.get_trace()) == 2 and tobs.dropped_events() == 2
    tobs.configure(65536)


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_jsonl_and_chrome_read_across(tmp_path, direction):
    """A trace written by one package reads in the other's ``read_jsonl``
    (events, counters, gauges, meta), and both packages' Chrome conversions
    and summaries of it are equal."""
    src, dst = (tobs, jobs) if direction == "torch_to_jax" else (jobs, tobs)
    pkg = T if src is tobs else J
    with src.tracing():
        _program(pkg, tmp_path)
        path = str(tmp_path / "trace.jsonl")
        src.write_jsonl(path, rank=3)
    events, counters, gauges, meta = dst.read_jsonl(path)
    assert (events, counters, gauges) == src.read_jsonl(path)[:3]
    assert meta["rank"] == 3 and meta["dropped"] == 0
    assert json.dumps(dst.to_chrome_trace(events, {"counters": counters, "gauges": gauges})) == json.dumps(
        src.to_chrome_trace(events, {"counters": counters, "gauges": gauges})
    )
    assert dst.summarize(events, counters, gauges) == src.summarize(events, counters, gauges)
    assert dst.aggregate(events) == src.aggregate(events)


def test_metricscope_summary_reads_a_port_trace(tmp_path):
    """``tools/metricscope.py`` (which loads the JAX package's obs modules by
    path, without jax) summarizes a port trace, in a subprocess on the CPU."""
    with tobs.tracing():
        _program(T, tmp_path)
        path = str(tmp_path / "port.trace.jsonl")
        tobs.write_jsonl(path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "metricscope.py"), "summary", path],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "MulticlassAccuracy" in out.stdout and "update" in out.stdout and "runner.snapshot" in out.stdout


def test_merge_joins_a_jax_and_a_port_trace(tmp_path):
    paths = []
    for rank, (pkg, obs) in enumerate(((J, jobs), (T, tobs))):
        with obs.tracing():
            _program(pkg, tmp_path / str(rank))
            paths.append(str(tmp_path / f"rank{rank}.jsonl"))
            obs.write_jsonl(paths[-1], rank=rank)
    merged = tobs.merge_traces(paths)
    assert merged == jobs.merge_traces(paths)
    assert sorted(merged["otherData"]["ranks"]) == ["0", "1"] and "unaligned" not in merged["otherData"]
    lanes = {e["pid"] for e in merged["traceEvents"] if e["ph"] == "X"}
    assert lanes == {0, 1}


def test_openmetrics_text_equal_for_equal_counters():
    snap = {"counters": {"runner.progress.batches": 4, "metric.sync.attempt": 2},
            "gauges": {"runner.cursor": 4, "metric.MulticlassAccuracy.state_bytes": 16, "window.X.age_s": 0.5}}
    labels = {"rank": "0"}
    text = tobs.openmetrics.render(snap["counters"], snap["gauges"], labels=labels)
    assert text == jobs.openmetrics.render(snap["counters"], snap["gauges"], labels=labels)
    assert text.endswith("# EOF\n") and "tm_tpu_runner_progress_batches_total" in text


def _parse_openmetrics(text):
    samples = {}
    for line in text.split("\n"):
        if line and not line.startswith("#"):
            m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)", line)
            assert m, line
            samples[m.group(1)] = float(m.group(3))
    return samples


def _alarm(signum, frame):
    raise TimeoutError("the live publisher test outlived its 60 s limit")


def test_live_publisher_serves_a_port_run(tmp_path):
    """A durable run of the port publishes over HTTP (localhost, port 0): the
    OpenMetrics text parses and carries the runner's progress and throughput.
    The test has a time limit of its own (``signal.alarm``)."""
    previous = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(60)
    try:
        _live_run(tmp_path)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def _live_run(tmp_path):
    batches = [tuple(torch.from_numpy(a) for a in b) for b in _batches(n=6)]
    store = CheckpointStore(str(tmp_path / "s"))
    with tlive.publishing(http=":0", cadence_s=5.0, rank=1) as pub:
        host, port = pub.http_address()
        ev = StreamingEvaluator(T.classification.MulticlassAccuracy(num_classes=5, **CPU), store=store, snapshot_every_n=2)
        ev.run(batches)
        body = urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=5).read().decode()
        health = json.loads(urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=5).read().decode())
    assert tlive.publisher() is None  # stopped: its thread and server are joined
    samples = _parse_openmetrics(body)
    assert samples["tm_tpu_runner_progress_batches_total"] == 6
    assert samples["tm_tpu_runner_cursor"] == 6
    assert samples["tm_tpu_runner_throughput_samples_per_s"] > 0
    assert samples["tm_tpu_runner_snapshot_bytes_last"] > 0
    assert samples["tm_tpu_robustness_store_save_total"] >= 3
    assert health["state"] == "ok" and health["cursor"] == 6


def test_runner_obs_counters(tmp_path):
    """The counterpart of JAX's ``test_runner_obs_counters``."""
    batches = [tuple(torch.from_numpy(a) for a in b) for b in _batches()]
    store = CheckpointStore(str(tmp_path / "s"))
    with tobs.tracing():
        ev = StreamingEvaluator(T.classification.MulticlassAccuracy(num_classes=5, **CPU), store=store, snapshot_every_n=2)
        ev.run(batches[:2])  # killed after batch 2: its snapshots stay
        resumed = StreamingEvaluator(T.classification.MulticlassAccuracy(num_classes=5, **CPU), store=store, snapshot_every_n=2)
        resumed.resume(batches)
        snap = tobs.snapshot()
        spans = [e["name"] for e in tobs.get_trace() if e.get("type") == "span"]
    assert snap["counters"]["runner.resume"] == 1
    assert snap["counters"]["runner.snapshot"] >= 2
    assert snap["counters"]["robustness.store.save"] >= 2
    assert "runner.resume" in spans and "robustness.store.save" in spans


def test_snapshot_bytes_gauge_and_counters(tmp_path):
    """The counterpart of JAX's ``test_snapshot_bytes_gauge_and_counters``."""
    store = CheckpointStore(str(tmp_path / "s"))
    with tobs.tracing():
        store.save({"blob": np.zeros(128, np.float32)}, step=1)
        store.latest()
        snap = tobs.snapshot()
    assert snap["counters"]["robustness.store.save"] == 1
    assert snap["counters"]["robustness.store.load"] == 1
    assert snap["gauges"]["robustness.store.snapshot_bytes"] > 128 * 4


def test_attribution_rows_equal_jax(tmp_path):
    """Cost attribution: the registry rows and the per-class state-bytes
    gauges of the same collection equal JAX's (torch tensors expose
    ``nbytes`` as jax arrays do). The deduplicated process total differs by
    design: a port compute-group member holds a copy of its leader's states
    (``load_state_tree`` never aliases), where JAX's members share the
    leader's immutable arrays, so the port's total counts both copies."""
    rows = {}
    for pkg, obs in ((J, jobs), (T, tobs)):
        kw = {} if pkg is J else CPU
        lab = (lambda x: x) if pkg is J else torch.from_numpy
        coll = pkg.MetricCollection({
            "acc": pkg.classification.MulticlassAccuracy(num_classes=5, **kw),
            "f1": pkg.classification.MulticlassF1Score(num_classes=5, average="macro", **kw),
        })
        with obs.tracing():
            for b in _batches(n=2):
                coll.update(*(lab(a) for a in b))
            coll.compute()
            rows[pkg] = (obs.attribution.registry_rows(), {k: v for k, v in obs.snapshot()["gauges"].items() if "state_bytes" in k})
    jtotal, ttotal = rows[J][1].pop("metric.state_bytes_total"), rows[T][1].pop("metric.state_bytes_total")
    assert rows[T] == rows[J]
    assert jtotal == 80 and ttotal == 2 * 80  # one group of two members: shared in JAX, copied in the port


def test_sliced_gauges_and_attribution_row():
    """JAX's ``test_sliced_gauges_and_attribution_row``: publish_gauges files
    the plan's state bytes under its class, and results() publishes."""
    keys = torch.tensor([0, 1, 2, 0, 1, 2], dtype=torch.int32)
    preds, target = torch.rand(6, 4, generator=torch.Generator().manual_seed(0)), torch.tensor([0, 1, 2, 3, 0, 1])
    plan = T.classification.MulticlassAccuracy(num_classes=4, **CPU).sliced(num_cells=8)
    plan.update(keys, preds, target)
    with tobs.tracing():
        plan.results()
        gauges = tobs.snapshot()["gauges"]
        rows = tobs.attribution.registry_rows()
    assert gauges["slice.table.occupancy"] == 3 / 8 and gauges["slice.table.cells"] == 8
    assert gauges["metric.SlicedPlan.state_bytes"] == sum(plan.state_byte_sizes().values())
    assert rows["SlicedPlan"]["updates"] == 1


def test_fused_build_span_and_capture_records_off_the_card():
    """On the CPU the fused step runs eagerly: the build span is recorded
    and no capture record is (records come from the card's captures)."""
    coll = T.MetricCollection({"acc": T.classification.MulticlassAccuracy(num_classes=5, **CPU)})
    with tobs.tracing():
        plan = coll.fused()
        plan.update(*(torch.from_numpy(a) for a in _batches(n=1)[0]))
        plan.fold_back()
        spans = {e["name"] for e in tobs.get_trace()}
    assert "fused.build" in spans and tobs.xla_records() == []
    assert tobs.attribution.registry_rows()["MetricCollection"]["instances"] == ["acc"]
