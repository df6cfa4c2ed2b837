# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Compare two checkouts of the port on one card, in turns.

    python3 chip_turns.py [--phases kernels,image,audio,detection] OTHER_ROOT . . OTHER_ROOT

runs, for each root in the order given, that root's own ``chip_smoke.py``
phases of the hand kernels' main paths, each in a process of its own with
that root's package and kernels, and prints one ``[turns]`` line per run
and the median of each number per root. The phases (all by default):
``kernels``: ``sketch`` (K3 eager and the fused sketch pass), ``sliced``
(K1s, K2s and K4 under the sliced suite) and ``guard`` (K2s and K1s at one
cell under the StateGuard's mask), then K2s and K4 through their wrappers
at those phases' shapes split into their device operations (K4 also from
empty tables: the suite's and the fan-out's first batches and a spill
batch); ``image``: K7 alone at SSIM's 11 x 11 Gaussian on the image phase's
8 x 3 x 1,356 x 2,040 batches (the root's ``time_window_moments``), then
the steady updates (the median of batches 2-4) of SSIM, MS-SSIM, VIF and
SCC over the image phase's 4 batches; ``audio``: K5's two banks alone on
the audio phase's 8 clips of 160,000 samples (the root's
``time_biquad_cascade``: the gammatone cascade and the modulation bank,
device and stream ms), then the steady SRMR update (``norm=False``, the
median of updates 2-5 of those clips); ``detection``: K6 alone on the
bbox compute's own arguments at COCO val2017's shape (the detection
phase's stream of 5,000 images through ``MeanAveragePrecision``; device
and stream ms), then that compute's wall time (the median of 3). K5 is
compared with its parent as ``python3 chip_turns.py --phases audio PARENT
. . PARENT``, K6 as ``python3 chip_turns.py --phases detection PARENT . .
PARENT``. Needs one
NVIDIA GPU; it exits 2 without one. A root is any directory holding ``chip_smoke.py`` and
``torchmetrics_tpu_torch`` (an older commit unpacked with ``git archive``).
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def _split(cs, fn, arg_sets, reps):
    """Device ms of one call of ``fn`` and its device operations (us a call), from ``root``'s profiler helper."""
    ms, found = cs._device_ms(fn, arg_sets, reps)
    return ms, {cs._short_kernel_name(k): round(t / reps, 3) for k, (t, n) in found.items()}


def _kernel_split(cs, device) -> dict:
    """K2s and K4 through their public wrappers at the shapes of the sliced and
    guard phases, each call split into its device operations: K2s at one cell
    (1.5% of 65,536 x 64 rows dropped), into 256 cells and 8,192 x 8 into 1,024;
    K4 in steady state (65,536 keys, every cohort resident) and from empty
    tables at the suite's first batch (65,536 keys over 200 cohorts into 256
    cells), the fan-out's (8,192 over 1,024 into 1,024) and a spill batch
    (8,192 over 2,048 into 1,024), a fresh table a call."""
    import torch

    from torchmetrics_tpu_torch.ops import slice_assign, stat_counts_segmented

    gen = torch.Generator(device=device)
    gen.manual_seed(cs.SEED + 30)
    n, c = cs.BATCH, cs.NUM_CLASSES
    logits = [torch.randn((n, c), generator=gen, device=device) for _ in range(4)]
    labels = [torch.randint(0, c, (n,), generator=gen, device=device, dtype=torch.int32) for _ in range(4)]
    one = [torch.where(torch.rand(n, generator=gen, device=device) < 0.015, -1, 0).to(torch.int32) for _ in range(4)]
    many = [torch.randint(0, 200, (n,), generator=gen, device=device, dtype=torch.int32) for _ in range(4)]
    fan = [(torch.randn((8192, 8), generator=gen, device=device), torch.randint(0, 8, (8192,), generator=gen, device=device, dtype=torch.int32),
            torch.randint(0, 1024, (8192,), generator=gen, device=device, dtype=torch.int32)) for _ in range(4)]
    out = {}
    for label, sets in (("K2s 1 cell", [(x, y, z, 1, c) for x, y, z in zip(logits, labels, one)]),
                        ("K2s 256 cells", [(x, y, z, 256, c) for x, y, z in zip(logits, labels, many)]),
                        ("K2s fan-out", [(x, y, z, 1024, 8) for x, y, z in fan])):
        out[f"{label} ms"], out[f"{label} ops"] = _split(cs, stat_counts_segmented, sets, cs.PROFILE_REPS)

    def table(cells):
        return (torch.zeros((cells, 1), dtype=torch.int32, device=device), torch.zeros(cells, dtype=torch.bool, device=device),
                torch.zeros((), dtype=torch.int32, device=device))

    steady = table(256)
    keys = [torch.randint(0, 200, (n, 1), generator=gen, device=device, dtype=torch.int32) for _ in range(4)]
    slice_assign(*steady, keys[0])
    out["K4 steady ms"], out["K4 steady ops"] = _split(cs, slice_assign, [(*steady, k) for k in keys], cs.PROFILE_REPS)
    for label, cells, rows, cohorts in (("suite first", 256, n, 200), ("fan-out first", 1024, 8192, 1024), ("spill", 1024, 8192, 2048)):
        kmat = torch.randint(0, cohorts, (rows, 1), generator=gen, device=device, dtype=torch.int32)
        fresh = iter([table(cells) for _ in range(7 * cs.PROFILE_TRACES)])
        out[f"K4 {label} ms"], out[f"K4 {label} ops"] = _split(cs, lambda: slice_assign(*next(fresh), kmat), [()], 6)
    return out


def _image(cs, device, smi) -> dict:
    """K7 alone at the image phase's 11 x 11 shape, then the steady SSIM, MS-SSIM, VIF and SCC updates."""
    import torch

    import torchmetrics_tpu_torch as tm

    k7 = cs.time_window_moments(device)
    out = {"K7 11x11 device ms": k7["ms"], "K7 11x11 stream ms": k7["stream_ms"]["kernel"]}
    I_ = tm.image
    metrics = {
        "SSIM": I_.StructuralSimilarityIndexMeasure(device=device),
        "MS-SSIM": I_.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device=device),
        "VIF": I_.VisualInformationFidelity(device=device),
        "SCC": I_.SpatialCorrelationCoefficient(device=device),
    }
    batches = cs._img_batches(device)
    for name, metric in metrics.items():
        walls = []
        for p, t in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metric.update(p, t)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[f"{name} steady update ms"] = statistics.median(walls[1:])
        metric.reset()
    return out


AUDIO_UPDATES = 5


def _audio(cs, device, smi) -> dict:
    """K5's two banks alone at the audio phase's shape, then the steady SRMR update (norm False) on its clips."""
    import torch

    import torchmetrics_tpu_torch as tm

    out = {}
    for row, bank in zip(cs.time_biquad_cascade(device), ("gammatone", "modulation")):
        out[f"K5 {bank} device ms"] = row["ms"]
        out[f"K5 {bank} stream ms"] = row["stream_ms"]["kernel"]
    clips = cs._quality_clips(device)[0]
    metric = tm.SpeechReverberationModulationEnergyRatio(fs=cs.QUALITY_FS, norm=False, device=device)
    walls = []
    for _ in range(AUDIO_UPDATES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metric.update(clips)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["SRMR steady update ms"] = statistics.median(walls[1:])
    return out


def _kernels(cs, device, smi) -> dict:
    """The sketch, sliced and guard phases, then K2s and K4 split into their device operations."""
    from torchmetrics_tpu_torch.ops import KERNELS

    batches = cs._main_path_batches(device)
    sketch = cs.phase_sketch(device, {"cm_track": KERNELS["cm_track"]}, smi)
    sliced = cs.phase_sliced(device, batches, smi)
    guard = cs.phase_guard(device, batches, smi)
    kernels = _kernel_split(cs, device)
    return {
        "sketch fused pass wall ms": sketch["fused_wall_us"] / 1e3,
        "sketch fused pass busy ms": sketch["fused_busy_us"] / 1e3,
        "sliced suite pass ms": sliced["suite_pass_ms"],
        "sliced suite busy ms": sliced["suite_busy_us"] / 1e3,
        **{f"guard {policy} fused pass ms": t["fused"] for policy, t in guard["pass_ms"].items()},
        **{f"{row['name']} device ms": row["ms"] for row in (sketch["k3_row"], *sliced["rows"], *guard["rows"])},
        **kernels,
    }


DET_COMPUTES = 3
K6_REPS = 50


def _bbox_inputs(cs, device):
    """The root's fed bbox metric and K6's arguments from its compute (the root's ``k6_bbox_inputs``; a root
    from before that helper builds them from its stream the same way)."""
    if hasattr(cs, "k6_bbox_inputs"):
        return cs.k6_bbox_inputs(device)
    import torchmetrics_tpu_torch as tm

    preds, target, _ = cs._det_stream(device)
    metric = tm.MeanAveragePrecision(device=device, class_metrics=True, extended_summary=True)
    for i in range(0, len(preds), cs.DET_BATCH):
        metric.update(preds[i:i + cs.DET_BATCH], target[i:i + cs.DET_BATCH])
    keep = {}
    cs._timed_map_compute(metric, keep)
    return metric, keep["args"]


def _detection(cs, device, smi) -> dict:
    """K6 alone on the bbox compute's own arguments (device and stream ms), then the mAP compute's wall
    time (the median of DET_COMPUTES computes of the same state, after a first one)."""
    import torch

    from torchmetrics_tpu_torch.ops import coco_match

    metric, args = _bbox_inputs(cs, device)
    stream_ms = cs._events_ms(lambda: coco_match(*args), K6_REPS)
    out = {"K6 device ms": cs._device_ms_or_events(coco_match, args, stream_ms)[0], "K6 stream ms": stream_ms}
    del args
    walls = []
    for _ in range(DET_COMPUTES):
        metric._computed = None  # compute again, not from the cache
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metric.compute()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["mAP compute wall ms"] = statistics.median(walls)
    return out


PHASES = {"kernels": _kernels, "image": _image, "audio": _audio, "detection": _detection}


def _one(root: str, phases: list) -> dict:
    """The named phases of ``root``'s chip_smoke.py, in this process."""
    sys.path.insert(0, root)
    import chip_smoke as cs

    device, smi = cs.phase_device()
    cs.phase_build()
    out = {"card": smi}
    for phase in phases:
        out.update(PHASES[phase](cs, device, smi))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_turns: torch.cuda.is_available() is false; the turns need an NVIDIA GPU", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    phases = list(PHASES)
    if len(args) >= 2 and args[0] == "--phases":
        phases, args = args[1].split(","), args[2:]
        if not phases or any(p not in PHASES for p in phases):
            print(f"chip_turns: --phases takes a comma-separated subset of {sorted(PHASES)}", file=sys.stderr)
            return 2
    if len(args) == 2 and args[0] == "--one":
        print("[turns] " + json.dumps({"root": args[1], **_one(args[1], phases)}), flush=True)
        return 0
    roots = [os.path.abspath(r) for r in args]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--phases", ",".join(phases), "--one", root],
                              cwd=root, capture_output=True, text=True, timeout=600)
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
