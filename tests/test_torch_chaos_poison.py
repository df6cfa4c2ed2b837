# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's chaos harness in ``--mode poison`` (the StateGuard drill), on
port daemons on the CPU (counterpart of JAX's
``test_poison_soak_upholds_guard_invariants``); the helpers and the
poisoned-path rule are in ``tests/test_torch_chaos_short.py``."""
from __future__ import annotations

from tests.test_torch_chaos_short import chaos_report, run_chaos


def test_poison_soak_upholds_guard_invariants(tmp_path):
    """The mask stream matches a reference fed the valid ROWS, the reject
    stream a reference fed the valid BATCHES, and the propagate+probe MSE
    stream rolls back from its in-memory known-good ring, quarantines both
    NaN frames with their guard verdicts and walks /healthz 200 -> 503 ->
    200. The harness asserts every invariant; this test that the leg ran and
    accounted for every injected frame."""
    report = chaos_report(run_chaos(tmp_path, "--mode", "poison", "--seed", "11"))
    (leg,) = report["legs"]
    assert leg["leg"] == "poison"
    assert leg["quarantined"] == [2, 4]
    assert leg["rollbacks"] == 2
    assert leg["masked_rows"] == 4
    assert leg["rejected_batches"] == 2
    assert leg["health_walk"] == ["ok", "degraded", "ok"]
    assert all(isinstance(v, float) for v in leg["results"].values())
    assert len(leg["ready_s"]) == 2  # the chaos daemon and the reference
