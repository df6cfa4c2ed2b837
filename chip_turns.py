# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Compare two checkouts of the port on one card, in turns.

    python3 chip_turns.py OTHER_ROOT . . OTHER_ROOT

runs, for each root in the order given, that root's own ``chip_smoke.py``
phases of the hand kernels' main paths (``sketch``: K3 eager and the fused
sketch pass; ``sliced``: K1s, K2s and K4 under the sliced suite; ``guard``:
K2s and K1s at one cell under the StateGuard's mask), each in a process of its
own with that root's package and kernels, and prints one ``[turns]`` line
per run and the median of each number per root. Needs one NVIDIA GPU; it
exits 2 without one. A root is any directory holding ``chip_smoke.py`` and
``torchmetrics_tpu_torch`` (an older commit unpacked with ``git archive``).
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys


def _one(root: str) -> dict:
    """The phases of ``root``'s chip_smoke.py, in this process."""
    sys.path.insert(0, root)
    import chip_smoke as cs
    from torchmetrics_tpu_torch.ops import KERNELS

    device, smi = cs.phase_device()
    cs.phase_build()
    batches = cs._main_path_batches(device)
    sketch = cs.phase_sketch(device, {"cm_track": KERNELS["cm_track"]}, smi)
    sliced = cs.phase_sliced(device, batches, smi)
    guard = cs.phase_guard(device, batches, smi)
    return {
        "card": smi,
        "sketch fused pass wall ms": sketch["fused_wall_us"] / 1e3,
        "sketch fused pass busy ms": sketch["fused_busy_us"] / 1e3,
        "sliced suite pass ms": sliced["suite_pass_ms"],
        "sliced suite busy ms": sliced["suite_busy_us"] / 1e3,
        **{f"guard {policy} fused pass ms": t["fused"] for policy, t in guard["pass_ms"].items()},
        **{f"{row['name']} device ms": row["ms"] for row in (sketch["k3_row"], *sliced["rows"], *guard["rows"])},
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_turns: torch.cuda.is_available() is false; the turns need an NVIDIA GPU", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print("[turns] " + json.dumps({"root": sys.argv[2], **_one(sys.argv[2])}), flush=True)
        return 0
    roots = [os.path.abspath(r) for r in sys.argv[1:]]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], cwd=root, capture_output=True,
                              text=True, timeout=600)
        lines = [line for line in proc.stdout.splitlines() if line.startswith("[turns] ")]
        if proc.returncode != 0 or not lines:
            print(f"chip_turns: {root} failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}", file=sys.stderr)
            return proc.returncode or 1
        print(lines[-1], flush=True)
        runs.append(json.loads(lines[-1][len("[turns] "):]))
    for root in dict.fromkeys(roots):
        mine = [r for r in runs if r["root"] == root]
        keys = [k for k in mine[0] if isinstance(mine[0][k], float)]
        print(f"[turns] median of {len(mine)} runs of {root} ({mine[0]['card']}): "
              + "; ".join(f"{k} {statistics.median(r[k] for r in mine if k in r):.5f}" for k in keys))
    return 0


if __name__ == "__main__":
    sys.exit(main())
