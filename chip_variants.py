# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Split a hand kernel's time on one card by textual variants of its source.

The machinery of ``chip_k5_variants.py`` and ``chip_k6_variants.py``: each
gives a :class:`Spec` (the source, its variants, a caller for a built
library, the inputs, a timer, a bitwise test, an optional probe) and calls
:func:`main`, which builds the source as it is and each variant with the
port's ``nvcc`` flags into ``smoke_checkout/<tag>_variants/`` (git-ignored),
checks that the variants that keep the arithmetic give the base's bits,
and times each variant in turns with the base (base, variant, variant,
base) on every input. ``--sass`` writes the SASS of the base library to
``base.sass`` there; ``--only NAME,...`` runs the named variants alone
(``--only none``: the probe alone). Needs one NVIDIA GPU; exits 2 without
one.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

ROOT = Path(__file__).resolve().parent


@dataclass
class Spec:
    tag: str  # the kernel's short name: the output lines' prefix and the build directory's
    source: Path
    variants: dict  # name -> {"exact": keeps the arithmetic, "edits": [(old, new), ...]}
    caller: Callable  # ctypes library -> a function of one input's arguments
    inputs: Callable  # (chip_smoke module, device) -> {label: arguments}
    timer: Callable  # (chip_smoke module, function, arguments) -> ms of one call
    same: Callable  # (got, want) -> the same bits
    sync: Callable  # (what) -> None once the card's queue has drained
    probe: Optional[Callable] = None  # (build, clock_hz) -> a dict with a "text" line
    include_source_dir: bool = False  # -I the source's directory (a source that includes a header beside it)

    @property
    def out(self) -> Path:
        return ROOT / "smoke_checkout" / f"{self.tag}_variants"


def nvcc_flags():
    sys.path.insert(0, str(ROOT))
    from torchmetrics_tpu_torch.ops import _build

    return _build._nvcc(), _build._NVCC_FLAGS


def build(spec: Spec, name: str, text: str) -> tuple:
    """``text`` built as ``lib<name>.so``: the library, its path, the registers of each function and the
    ptxas lines that report a spill."""
    nvcc, flags = nvcc_flags()
    spec.out.mkdir(parents=True, exist_ok=True)
    src, lib = spec.out / f"{name}.cu", spec.out / f"lib{name}.so"
    src.write_text(text)
    include = ["-I", str(spec.source.parent)] if spec.include_source_dir else []
    proc = subprocess.run([nvcc, *flags, *include, "-o", str(lib), str(src)], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}\n{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    regs = sorted({int(line.split("Used")[1].split()[0]) for line in log if "registers" in line})
    spills = [line.strip() for line in log if "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill")]
    return ctypes.CDLL(str(lib)), lib, regs, spills


def variant_text(base: str, edits) -> str:
    text = base
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant edit does not apply: {old!r}")
        text = text.replace(old, new)
    return text


def main(spec: Spec) -> int:
    import torch

    prefix = f"[{spec.tag} variants]"
    if not torch.cuda.is_available():
        print(f"chip_{spec.tag}_variants: torch.cuda.is_available() is false; the variants need an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    clock = smi.split(",")[-1].split()[0] if smi else ""
    clock_hz = float(clock) * 1e6 if clock.replace(".", "", 1).isdigit() else 1.98e9
    print(f"{prefix} {smi}", flush=True)
    base_text = spec.source.read_text()
    base_lib, base_path, base_regs, base_spills = build(spec, "base", base_text)
    argv = sys.argv[1:]
    if "--sass" in argv:
        dump = subprocess.run([str(Path(nvcc_flags()[0]).parent / "cuobjdump"), "-sass", str(base_path)],
                              capture_output=True, text=True, timeout=120)
        (spec.out / "base.sass").write_text(dump.stdout + dump.stderr)
    base = spec.caller(base_lib)
    inputs = spec.inputs(cs, torch.device("cuda:0"))
    want = {label: base(*args) for label, args in inputs.items()}
    spec.sync("the source as it is")
    results = {"card": smi, "base_registers": base_regs, "base_spills": base_spills}
    only = argv[argv.index("--only") + 1].split(",") if "--only" in argv[:-1] else list(spec.variants)
    for name in (n for n in only if n != "none"):
        edit = spec.variants[name]
        lib, _, regs, spills = build(spec, name, variant_text(base_text, edit["edits"]))
        var = spec.caller(lib)
        row = {"registers": regs, "spills": spills}
        try:
            for label, args in inputs.items():
                got = var(*args)
                spec.sync(f"variant {name} on {label}")
                if edit["exact"] and not spec.same(got, want[label]):
                    raise RuntimeError(f"variant {name} changed the result on {label}")
                del got
                times = [spec.timer(cs, f, args) for f in (base, var, var, base)]
                row[label] = {"base_ms": statistics.mean(times[0::3]), "variant_ms": statistics.mean(times[1:3]), "turns": times}
        except RuntimeError as err:  # a variant that does not launch, or changes the bits, is reported, not timed
            results[name] = {"registers": regs, "error": str(err)}
            print(f"{prefix} {name}: {err}", flush=True)
            continue
        results[name] = row
        print(f"{prefix} {name} (registers {regs}, {len(spills)} with spills): " + "; ".join(
            f"{label} {row[label]['variant_ms']:.5f} ms against the base's {row[label]['base_ms']:.5f}" for label in inputs), flush=True)
    if spec.probe is not None:
        results["probe"] = spec.probe(lambda name, text: build(spec, name, text), clock_hz)
        print(f"{prefix} {results['probe']['text']}", flush=True)
    print(f"{prefix} " + json.dumps(results), flush=True)
    return 0
