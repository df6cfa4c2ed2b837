# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Split K6's time on one card by variants of its source, and probe the chain.

    python3 chip_k6_variants.py [--sass] [--only NAME,...]

builds ``torchmetrics_tpu_torch/csrc/coco_match.cu`` as it is and in
variants (``VARIANTS``), each a textual edit of that source, with the
port's ``nvcc`` flags into ``smoke_checkout/k6_variants/`` (git-ignored),
and times the kernel of each by torch.profiler (device time of the kernel
alone, over 20 launches) in turns with the source as it is (base,
variant, variant, base) on two inputs: the bbox compute's own arguments at
COCO val2017's shape (``chip_smoke.k6_bbox_inputs``: a (5,000, 104, 64)
IoU, A = 4, T = 10) and its densest image alone (one block's walk).
Variants that keep the arithmetic must give the base's bits; the others
skip a part (the candidates' IoU loads, the output stores, the candidate
walk, the prologue's ok masks) and are timed only. Then a probe kernel
runs one thread's step on registers alone (G = 64, two mask words; the ok
masks, IoUs, ignore and crowd masks made in registers; a bar of 0.5, so
that a step with a candidate matches) at 0 to 4 candidates a step and
reports its cycles a step by ``clock64``: the chain as the card runs it,
which ``chip_smoke.K6_STEP_CYCLES`` holds. ``--sass`` writes the SASS of
the base library to ``smoke_checkout/k6_variants/base.sass``; ``--only``
runs the named variants alone (``--only none``: the probe alone). The
build, the edits and the turns are ``chip_variants.py``'s. Needs one
NVIDIA GPU; exits 2 without one.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import chip_variants

ROOT = Path(__file__).resolve().parent
REPS = 20

VARIANTS = {
    # no register cap: ptxas chooses the registers, and fewer blocks of 256 threads fit an SM
    "no_cap": {"exact": True, "edits": [("__launch_bounds__(kBlock, kBlocksPerSm)", "__launch_bounds__(kBlock)")]},
    "block128": {"exact": True, "edits": [("constexpr int kBlock = 256;", "constexpr int kBlock = 128;")]},
    # nothing staged: every candidate's IoU read in the walk; or four staged a (detection, mask word)
    "no_stage": {"exact": True, "edits": [("constexpr int kStage = 2;", "constexpr int kStage = 0;")]},
    "stage4": {"exact": True, "edits": [("constexpr int kStage = 2;", "constexpr int kStage = 4;")]},
    # every detection stepped, those without a candidate too
    "no_skip": {"exact": True, "edits": [("    if (any || filler) {\n", "    if (true) {\n")]},
    # each candidate's IoU made from its index: the walk without its loads (the values are wrong)
    "no_load": {"exact": False, "edits": [("x = c < kStage ? staged[(d * nw + w) * kStage + c] : __ldg(row + g);",
                                           "x = __int_as_float(0x3f000000 | (g << 12));")]},
    # the output bits stay in their buffer: no row is written
    "no_store": {"exact": False, "edits": [("  if (rows_left <= 0) return;", "  return;")]},
    # no candidate walked: the word operations and the threshold compare alone
    "no_walk": {"exact": False, "edits": [("for (uint32_t u = k; u; u &= u - 1, ++c) {", "for (uint32_t u = 0; u; u &= u - 1, ++c) {")]},
    # the prologue's ok masks left at zero (its crowd and ig ballots stay): the steps without candidates
    "no_ok": {"exact": False, "edits": [("    for (int j = 0; j < dn; ++j) {", "    for (int j = 0; j < 0; ++j) {")]},
}

# The kernel's step at W = 2 (the register instantiation of G = 33-64), with what it reads from shared memory
# and the IoU made in registers: the ok mask a 64-bit pattern (in[0], in[1]) rotated by d, the IoU of ground
# truth g in [0.5, 1) rising with g, ig in[2..3], crowd in[4..5], the bar in[7]. A walk is 32 steps (the
# pattern's 32 rotations, so a candidate is unmatched when it comes), then the matched set starts again.
PROBE = r"""
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

__device__ __forceinline__ bool prefer(float bv, int bi, float av, int ai) {
  const bool bn = isnan(bv), an = isnan(av);
  if (bn != an) return bn;
  if (bn) return bi > ai;
  return bv > av || (bv == av && bi > ai);
}

__global__ void k6_chain_probe(const uint32_t* in, uint32_t* out, long long* cycles, int walks) {
  constexpr int W = 2, nw = 2;
  const uint32_t p0 = in[0], p1 = in[1], salt = in[6];
  const uint32_t ig_r[W] = {in[2], in[3]}, cr_r[W] = {in[4], in[5]};
  const float bar = __uint_as_float(in[7]);
  const bool filler = bar <= -1.0f;
  const uint32_t top = 0xffffffffu;
  uint32_t acc = 0;
  __syncwarp();
  const long long t0 = clock64();
  for (int walk = 0; walk < walks; ++walk) {
    uint32_t mt_r[W] = {0, 0}, out_m = 0, out_i = 0;
    for (int d = 0; d < 32; ++d) {
      const uint32_t okd[W] = {__funnelshift_l(p1, p0, d), __funnelshift_l(p0, p1, d)};
      uint32_t any = okd[0] | okd[1];
      bool matched = false, ignored = false;
      if (any || filler) {
        float v1 = -INFINITY, v2 = -INFINITY;
        int i1 = -1, i2 = -1, f1 = -1, f2 = -1;
#pragma unroll
        for (int w = 0; w < nw; ++w) {
          const uint32_t ig = ig_r[w], cr = cr_r[w], mt = mt_r[w];
          const uint32_t k = okd[w];
          const uint32_t c1 = k & ~ig & ~mt, c2 = k & ig & (cr | ~mt);
          if (filler) {
            const uint32_t valid = w == nw - 1 ? top : 0xffffffffu;
            const uint32_t z1 = ~c1 & valid, z2 = ~c2 & valid;
            if (z1) f1 = w * 32 + 31 - __clz(z1);
            if (z2) f2 = w * 32 + 31 - __clz(z2);
          }
          for (uint32_t u = k; u; u &= u - 1) {
            const int b = __ffs(u) - 1, g = w * 32 + b;
            const float x = __uint_as_float(0x3f000000u | (static_cast<uint32_t>(g) << 17) | salt);
            const bool xn = isnan(x);
            const bool t1 = ((c1 >> b) & 1u) && (xn || (!isnan(v1) && x >= v1));
            const bool t2 = ((c2 >> b) & 1u) && (xn || (!isnan(v2) && x >= v2));
            v1 = t1 ? x : v1;
            i1 = t1 ? g : i1;
            v2 = t2 ? x : v2;
            i2 = t2 ? g : i2;
          }
        }
        if (f1 >= 0 && prefer(-1.0f, f1, v1, i1)) {
          v1 = -1.0f;
          i1 = f1;
        }
        if (f2 >= 0 && prefer(-1.0f, f2, v2, i2)) {
          v2 = -1.0f;
          i2 = f2;
        }
        const bool ok1 = v1 >= bar, ok2 = v2 >= bar;
        matched = ok1 || ok2;
        if (matched) {
          const int m = ok1 ? i1 : i2, mw = m >> 5;
          const uint32_t bit = 1u << (m & 31);
#pragma unroll
          for (int w = 0; w < W; ++w) {
            if (w == mw) {
              mt_r[w] |= bit;
              ignored = ig_r[w] & bit;
            }
          }
        }
      }
      out_m |= static_cast<uint32_t>(matched) << d;
      out_i |= static_cast<uint32_t>(ignored) << d;
    }
    acc ^= mt_r[0] ^ mt_r[1] ^ out_m ^ (out_i << 1);
  }
  const long long t1 = clock64();
  out[threadIdx.x] = acc;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

extern "C" int k6_chain_probe_launch(const uint32_t* in, uint32_t* out, long long* cycles, int walks, void* stream) {
  k6_chain_probe<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(in, out, cycles, walks);
  return static_cast<int>(cudaGetLastError());
}
"""
PROBE_BITS = (5, 37, 20, 52)  # the pattern's candidates, in the order they are added: two a word at most
PROBE_WALKS = 6500  # 208,000 steps a launch


def _caller(lib):
    import torch

    from torchmetrics_tpu_torch.ops.coco_match import _ARGTYPES, _PLAN_ARGTYPES, match_bar

    fn = lib.coco_match
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    words_fn = lib.coco_match_scratch_words
    words_fn.argtypes, words_fn.restype = _PLAN_ARGTYPES + [ctypes.POINTER(ctypes.c_longlong)], ctypes.c_int

    def call(iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd, gt_ig, thrs):
        n, d, g = iou.shape
        a, t = gt_ig.shape[1], thrs.numel()
        words = ctypes.c_longlong(0)
        words_fn(n, d, g, a, t, ctypes.byref(words))
        scratch = torch.empty(words.value, dtype=torch.int32, device=iou.device)
        out = [torch.empty((n, a, t, d), dtype=torch.bool, device=iou.device) for _ in range(2)]
        bar = match_bar(thrs)
        status = fn(iou.data_ptr(), det_labels.data_ptr(), det_valid.data_ptr(), gt_labels.data_ptr(), gt_valid.data_ptr(),
                    gt_crowd.data_ptr(), gt_ig.data_ptr(), bar.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                    scratch.data_ptr() if words.value else None, n, d, g, a, t, torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"launch failed: cudaError {status}")
        return out

    return call


def _kernel_ms(cs, fn, args):
    """Device ms of one launch of the kernel alone (torch.profiler, over REPS calls; no memset, no casts)."""
    _, found = cs._device_ms(fn, [args], REPS)
    return cs._kernel_only_us(found, "coco_match") / 1e3


def _inputs(cs, device):
    """The bbox compute's own K6 arguments at COCO val2017's shape, and its densest image alone."""
    args = cs.k6_bbox_inputs(device)[1]
    pair_ok = args[2][:, :, None] & args[4][:, None, :] & (args[1][:, :, None] == args[3][:, None, :])
    densest = int(pair_ok.sum((1, 2)).argmax())
    return {"full": args, "densest": tuple(x[densest:densest + 1] for x in args[:7]) + (args[7],)}


def _same(got, want) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(got, want))


def _sync(what: str) -> None:
    import torch

    torch.cuda.synchronize()


def _probe(build, clock_hz) -> dict:
    """Cycles a step of the probe's walk at 0-4 candidates a step (one warp alone, by clock64)."""
    import numpy as np
    import torch

    lib, _, regs, spills = build("chain_probe", PROBE)
    fn = lib.k6_chain_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(32, dtype=torch.int32, device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    per_step = []
    for c in range(len(PROBE_BITS) + 1):
        pattern = sum(1 << b for b in PROBE_BITS[:c])
        words = np.array([pattern & 0xFFFFFFFF, pattern >> 32, 0x00010001, 0x00100010, 0x00000001, 0x00100000, 0x1234,
                          np.float32(0.5).view(np.uint32)], dtype=np.uint32)
        inp = torch.from_numpy(words.view(np.int32)).cuda()
        for _ in range(2):  # the first launch loads the module
            status = fn(inp.data_ptr(), out.data_ptr(), cycles.data_ptr(), PROBE_WALKS, torch.cuda.current_stream().cuda_stream)
            if status != 0:
                raise RuntimeError(f"chain probe: launch failed: cudaError {status}")
            torch.cuda.synchronize()
        per_step.append(int(cycles.item()) / (PROBE_WALKS * 32))
    text = (f"chain probe: {', '.join(f'{x:.3f}' for x in per_step)} cycles a step at 0-{len(PROBE_BITS)} candidates"
            f" (clock64, one warp alone, G = 64, a bar of 0.5); a 104-step walk at 1 candidate a step:"
            f" {104 * per_step[1] / clock_hz * 1e6:.3f} us at {clock_hz / 1e6:.0f} MHz")
    return {"cycles_per_step": per_step, "registers": regs, "spills": spills, "text": text}


SPEC = chip_variants.Spec(
    tag="k6", source=ROOT / "torchmetrics_tpu_torch" / "csrc" / "coco_match.cu", variants=VARIANTS, caller=_caller,
    inputs=_inputs, timer=_kernel_ms, same=_same, sync=_sync, probe=_probe, include_source_dir=True)


if __name__ == "__main__":
    sys.exit(chip_variants.main(SPEC))
