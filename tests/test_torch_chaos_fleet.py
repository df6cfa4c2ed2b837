# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's chaos harness in ``--mode fleet`` (the federation drill, which
the JAX package's tests do not run): three port leaves and a corrupt stub
leaf under a port aggregator on the CPU; a leaf and then the aggregator are
SIGKILLed mid-fold and restarted. The harness asserts the fleet aggregate
equals one uninterrupted daemon fed every leaf's batches, bitwise. The
helpers are in ``tests/test_torch_chaos_short.py``."""
from __future__ import annotations

from tests.test_torch_chaos_short import chaos_report, run_chaos


def test_fleet_drill_folds_bitwise_through_kills_and_a_corrupt_leaf(tmp_path):
    report = chaos_report(run_chaos(tmp_path, "--mode", "fleet", "--seed", "11"))
    (leg,) = report["legs"]
    assert leg["leg"] == "fleet"
    assert leg["victim"] == "leaf1"
    assert leg["quarantined"] == ["corrupt"]
    assert leg["coverage"] == 0.75
    assert isinstance(leg["aggregate"], float)
    # three leaves, the aggregator, the victim's restart, the aggregator's, the reference
    assert len(leg["ready_s"]) == 7
