# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Split K5's time on one card by variants of its source, and probe the chain.

    python3 chip_k5_variants.py [--sass] [--only NAME,...]

builds ``torchmetrics_tpu_torch/csrc/biquad.cu`` as it is and in variants,
each a textual edit of that source (``VARIANTS``), with the port's ``nvcc``
flags into ``smoke_checkout/k5_variants/`` (git-ignored), and times each on
SRMR's two banks at the audio phase's shape (8 clips x 160,000 samples at
16 kHz: the gammatone's 4 stages over 184 rows, the modulation bank's 1
stage over 1,472; ``chip_smoke._k5_banks``) by CUDA events, in turns with
the source as it is (base, variant, variant, base). Variants that keep the
arithmetic (tile, ring) must give the base's bits; the others skip a part
(the barriers, the loader's copies, the storer's stores, the step) and are
timed only. Then a probe kernel runs one stage's step on registers alone
(the numerator products hoisted, as a constant input makes them) and
reports its cycles a step by ``clock64``: the chain as the card runs it.
``--sass`` writes the SASS of the base library to
``smoke_checkout/k5_variants/base.sass``; ``--only`` runs the named
variants alone (``--only none``: the probe alone). The build, the edits and
the turns are ``chip_variants.py``'s. Needs one NVIDIA GPU; exits 2 without
one.
"""
from __future__ import annotations

import ctypes
import os
import sys
import time
from pathlib import Path

import chip_variants

ROOT = Path(__file__).resolve().parent
REPS = 10
HANG_S = 30.0  # a variant's first call at the main shape takes a few ms; one that runs this long is deadlocked

_NO_WAIT = [("  } while (!done);\n}", "  } while (false);\n}"),
            ("      : \"memory\");\n  return done;\n}\n\n// The phase parity", "      : \"memory\");\n  return 1;\n}\n\n// The phase parity")]
VARIANTS = {
    "tile32": {"exact": True, "edits": [("constexpr int kTile = 64;", "constexpr int kTile = 32;")]},
    "ring2": {"exact": True, "edits": [("constexpr int kRing = 4;", "constexpr int kRing = 2;")]},
    # the chain tied to the block's start: z1's bits OR 0 through the polls' answer, so ptxas cannot step
    # ahead of the block's one branch
    "pin": {"exact": True, "edits": [
        ("__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {",
         "__device__ __forceinline__ uint32_t bar_wait(uint32_t bar, uint32_t parity) {"),
        ("  } while (!done);\n}", "  } while (!done);\n  return done;\n}"),
        ("  if (!w.polled) {\n    bar_wait(w.in.full + slot * 8, parity(k));\n    bar_wait(w.out.empty + slot * 8, parity(k) ^ 1);\n",
         "  uint32_t ready = w.polled;\n  if (!ready) {\n    ready = bar_wait(w.in.full + slot * 8, parity(k)) & bar_wait(w.out.empty + slot * 8, parity(k) ^ 1);\n"),
        ("  if (!First) {\n    const uint32_t prev_slot",
         "  w.z1 = __uint_as_float(__float_as_uint(w.z1) | (ready ^ 1u));\n  if (!First) {\n    const uint32_t prev_slot")]},
    # no early polls: each block waits for its own slots (the polls' latency on the chain)
    "no_early_poll": {"exact": True, "edits": [("  if (!w.polled) {\n", "  if (true) {\n")]},
    # every barrier poll returns after one try: the warps run unsynchronised (the values are wrong)
    "no_wait": {"exact": False, "edits": _NO_WAIT},
    # the loader issues no copy (its barrier arrivals stay)
    "no_copy": {"exact": False, "edits": [("          copy4(dst + j * 4, in_row ? src + j : x, in_row);\n", "")]},
    # the storer writes nothing to y (its waits and arrivals stay)
    "no_store": {"exact": False, "edits": [
        ("          if (r < live) *reinterpret_cast<float4*>(dst)", "          if (r < 0) *reinterpret_cast<float4*>(dst)"),
        ("            if (t0 + j + lane < T) dst[j]", "            if (false) dst[j]")]},
    # a stage passes its input through: the pipeline and the bytes without the chain
    "no_step": {"exact": False, "edits": [("  const float y = __fadd_rn(__fmul_rn(c.b0, v), z1);", "  const float y = v;\n  return y;")]},
}

PROBE = r"""
#include <cuda_runtime.h>
__global__ void chain_probe(const float* c, float* out, long long* cycles, long long steps) {
  const float b0v = c[0] * c[5], b1v = c[1] * c[5], b2v = c[2] * c[5], a1 = c[3], a2 = c[4];
  float z1 = 0.0f, z2 = 0.0f, acc = 0.0f;
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll 16
  for (long long t = 0; t < steps; ++t) {
    const float y = __fadd_rn(b0v, z1);
    z1 = __fadd_rn(__fsub_rn(b1v, __fmul_rn(a1, y)), z2);
    z2 = __fsub_rn(b2v, __fmul_rn(a2, y));
    acc = y;
  }
  const long long t1 = clock64();
  out[threadIdx.x] = acc + z1 + z2;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}
extern "C" int chain_probe_launch(const float* c, float* out, long long* cycles, long long steps, void* stream) {
  chain_probe<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(c, out, cycles, steps);
  return static_cast<int>(cudaGetLastError());
}
"""


def _caller(lib):
    import torch

    from torchmetrics_tpu_torch.ops.biquad import _ARGTYPES, normalized_coefficients

    fn = lib.biquad_cascade
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int

    def call(x, num, den):
        group, stages = int(num.shape[0]), int(num.shape[1])
        rows, length = x.shape[0] * group, x.shape[1]
        y = torch.empty((rows, length), dtype=torch.float32, device=x.device)
        coefs = normalized_coefficients(num, den).to(x.device)
        status = fn(x.data_ptr(), y.data_ptr(), coefs.data_ptr(), rows, length, group, stages, torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"launch failed: cudaError {status}")
        return y

    return call


def _bounded_sync(what: str, limit_s: float = HANG_S) -> None:
    """Wait for the card's queue, at most ``limit_s`` seconds: a variant whose barriers deadlock must not
    hold the card until the command's own limit. Exits the process (code 3) if the queue does not drain."""
    import torch

    done = torch.cuda.Event()
    done.record()
    start = time.monotonic()
    while not done.query():
        if time.monotonic() - start > limit_s:
            print(f"[k5 variants] {what} did not finish in {limit_s:.0f} s (a deadlock); stopping", flush=True)
            os._exit(3)
        time.sleep(0.001)


def _events_ms(fn, reps=REPS):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _probe(build, clock_hz) -> dict:
    import torch

    lib, _, regs, _ = build("chain_probe", PROBE)
    fn = lib.chain_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    c = torch.tensor([0.3, -0.2, 0.1, -1.9, 0.95, 0.5], device="cuda")
    out = torch.empty(32, device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    steps = 160_000
    run = lambda: fn(c.data_ptr(), out.data_ptr(), cycles.data_ptr(), steps, torch.cuda.current_stream().cuda_stream)  # noqa: E731
    ms = _events_ms(run)
    per_step = int(cycles.item()) / steps
    return {"cycles_per_step": per_step, "ms_at_160000": ms, "ms_at_clock": per_step * steps / clock_hz * 1e3, "registers": regs,
            "text": f"chain probe: {per_step:.3f} cycles a step (clock64), {ms:.5f} ms for 160,000 steps (CUDA events;"
                    f" {per_step * steps / clock_hz * 1e3:.5f} at {clock_hz / 1e6:.0f} MHz)"}


def _same(got, want) -> bool:
    import torch

    return torch.equal(got.view(torch.int32), want.view(torch.int32))


def _inputs(cs, device):
    """SRMR's two banks at the audio phase's shape: {bank: (x, num, den)}."""
    return {bank: args for bank, _, args in cs._k5_banks(cs._quality_clips(device)[0])}


SPEC = chip_variants.Spec(
    tag="k5", source=ROOT / "torchmetrics_tpu_torch" / "csrc" / "biquad.cu", variants=VARIANTS, caller=_caller,
    inputs=_inputs, timer=lambda cs, fn, args: _events_ms(lambda: fn(*args)),
    same=_same, sync=_bounded_sync, probe=_probe)


if __name__ == "__main__":
    sys.exit(chip_variants.main(SPEC))
