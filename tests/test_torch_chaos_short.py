# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's chaos-soak harness end to end (counterpart of
``tests/unittests/serve/test_metricchaos.py``): ``python
torchmetrics_tpu_torch/serve/chaos.py --device cpu`` drives real port
daemons (``python -m torchmetrics_tpu_torch.serve serve``) through worker
crashes, a poison batch, snapshot ENOSPC, a daemon SIGKILL and a
circuit-breaker park and revive, and asserts the self-healing invariants
itself. This file holds the short soak, the randomized long soak (``slow``,
as in JAX) and the helpers the poison and fleet files share.

Every harness run here has poisoned ``jax``, ``torch``, ``torchmetrics_tpu``
and ``torchmetrics_tpu_torch`` modules first on its ``PYTHONPATH``: the
harness runs as the file's path and imports the stdlib alone, and the
daemons it starts get a clean path. pytest-timeout is not installed, so
each run carries its own ``subprocess.run`` deadline; the harness kills its
daemons when it dies.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

_REPO_ROOT = Path(__file__).parent.parent
_CHAOS = str(_REPO_ROOT / "torchmetrics_tpu_torch" / "serve" / "chaos.py")
_POISONED = ("jax", "torch", "torchmetrics_tpu", "torchmetrics_tpu_torch")


def poisoned_env(tmp_path):
    """An environment whose ``PYTHONPATH`` makes importing any of
    :data:`_POISONED` fatal."""
    poison = tmp_path / "poison"
    poison.mkdir(exist_ok=True)
    for mod in _POISONED:
        (poison / f"{mod}.py").write_text(f"raise ImportError('the chaos harness must not import {mod}')\n")
    return dict(os.environ, PYTHONPATH=str(poison))


def run_chaos(tmp_path, *args, timeout=420):
    """One harness run on the CPU, poisoned as above."""
    return subprocess.run(
        [sys.executable, _CHAOS, "--workdir", str(tmp_path / "chaos"), "--device", "cpu", *args],
        capture_output=True, text=True, timeout=timeout, env=poisoned_env(tmp_path), cwd=str(tmp_path),
    )


def chaos_report(result):
    assert result.returncode == 0, f"stdout={result.stdout}\nstderr={result.stderr}"
    report = json.loads(result.stdout.strip().splitlines()[-1])
    assert report["ok"], report
    assert report["device"] == "cpu"
    for leg in report["legs"]:
        assert leg["seconds"] > 0 and leg["ready_s"] and all(s > 0 for s in leg["ready_s"]), leg
    return report


@pytest.mark.parametrize("mod", _POISONED)
def test_the_poisoned_path_refuses_each_module(tmp_path, mod):
    """The poison bites: a plain interpreter on that path cannot import it."""
    out = subprocess.run([sys.executable, "-c", f"import {mod}"], capture_output=True, text=True,
                         timeout=120, env=poisoned_env(tmp_path), cwd=str(tmp_path))
    assert out.returncode != 0 and "must not import" in out.stderr


def test_short_soak_upholds_invariants(tmp_path):
    """Seeded short soak: transient crash + poison batch + persistent ENOSPC
    + SIGKILL on one leg, restart-budget exhaustion + revive on the other;
    the harness asserts every invariant (no drops, bitwise parity minus the
    quarantined seq, a durable dead letter, the health transitions), this
    test that it ran both legs and agreed, as JAX's test does."""
    report = chaos_report(run_chaos(tmp_path, "--mode", "short", "--seed", "11"))
    legs = {leg["leg"]: leg for leg in report["legs"]}
    assert set(legs) == {"main", "circuit"}
    assert legs["main"]["quarantined"] == [6]
    assert legs["main"]["degraded_observed"] is True
    assert legs["circuit"]["restarts"] >= 2
    assert isinstance(legs["main"]["results"], float)
    assert isinstance(legs["circuit"]["results"], float)
    # main: the chaos daemon, its restart after SIGKILL, the reference; circuit: two
    assert [len(legs["main"]["ready_s"]), len(legs["circuit"]["ready_s"])] == [3, 2]


def test_a_daemon_that_cannot_serve_on_the_asked_device_fails_the_leg(tmp_path):
    """``--device cuda`` without a card: the daemon exits before its ready
    line, and the harness reports the failed invariant instead of running
    the leg on the host."""
    if _cuda_available():
        pytest.skip("a card is present: the daemon would serve on it")
    out = subprocess.run(
        [sys.executable, _CHAOS, "--workdir", str(tmp_path / "chaos"), "--mode", "poison", "--device", "cuda"],
        capture_output=True, text=True, timeout=300, env=poisoned_env(tmp_path), cwd=str(tmp_path),
    )
    assert out.returncode == 1, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["ok"] is False and "no ready line" in report["invariant"]
    assert "no CUDA device is available" in report["invariant"]


def _cuda_available() -> bool:
    import torch

    return torch.cuda.is_available()


@pytest.mark.slow
def test_long_soak_randomized_rounds(tmp_path):
    """Randomized (but seeded, hence reproducible) multi-round soak: each
    round draws crash timing, poison position, ENOSPC window and kill point
    from the master seed and must uphold the same invariants."""
    report = chaos_report(run_chaos(tmp_path, "--mode", "long", "--seed", "7", "--rounds", "2", timeout=1100))
    assert sum(1 for leg in report["legs"] if leg["leg"] == "main") == 2
