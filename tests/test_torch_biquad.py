# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K5 (``ops.biquad_cascade``, SRMR's IIR filter banks) on the CPU: its
plain route against JAX's ``_biquad`` and ``_erb_filterbank`` at T = 8,000.

What the comparison found: XLA's CPU backend contracts the step's
``b * x + (...)`` into fused multiply-adds. A numpy emulation of the step
with those three FMAs (``fma(b0, x, z1)``, ``fma(b1, x, -(a1 * y)) + z2``,
``fma(b2, x, -(a2 * y))``) equals ``lax.scan`` bit for bit, and a numpy
float32 loop with every product and sum rounded on its own, in the step's
order, equals the plain route bit for bit; so does K5 on the card
(``tests/test_torch_kernels_cuda.py::test_biquad_matches_plain``), where
nvcc's contraction is switched off by the rounding intrinsics. The two
roundings drift apart over T, most where the poles lie near the unit
circle. Budgets, relative to each row's largest magnitude, measured by
these tests' inputs at T = 8,000 (seeded noise scaled to a peak of 1) and
held at about twice the larger reading:

- the gammatone cascade (4 stages, 23 channels, the gain division):
  measured 1.1e-5 (fs 8 kHz) and 1.9e-5 (16 kHz); budget ``4e-5``;
- the 8-band modulation bank on the envelope (a 4 Hz band at 16 kHz has
  its poles within 0.002 of 1): measured 8.2e-4 and 2.6e-3; budget ``6e-3``;
- one gammatone stage: measured 4.0e-6 and 1.2e-5; budget ``3e-5``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.functional.audio import srmr as js
from torchmetrics_tpu_torch.functional.audio import srmr as ts
from torchmetrics_tpu_torch.ops import biquad_cascade, biquad_cascade_plain
from torchmetrics_tpu_torch.ops.biquad import normalized_coefficients

T = 8000
BUDGET = {"gammatone": 4e-5, "modulation": 6e-3, "one_stage": 3e-5}
F32 = np.float32


def _wave(seed, rows=2, length=T):
    rng = np.random.RandomState(seed)
    wave = rng.randn(rows, length).astype(F32)
    return wave / np.abs(wave).max()


def _banks(fs, bank):
    """``(x (rows, T), b (group, 3), a (group, 3))`` float32 inputs of one ``_biquad`` call."""
    coefs = js._make_erb_filters(fs, 23, 125)
    if bank == "one_stage":
        return _wave(fs), np.asarray(coefs[:, [0, 1, 5]], F32), np.asarray(coefs[:, 6:9], F32)
    # the modulation bank runs on the gammatone envelope
    env = np.asarray(js._hilbert_envelope(js._erb_filterbank(jnp.asarray(_wave(fs + 1)), coefs)))
    _, mf_b, mf_a, _, _ = js._modulation_filterbank_and_cutoffs(4, 128, 8, float(fs), 2)
    return env.reshape(-1, T).astype(F32), np.asarray(mf_b, F32), np.asarray(mf_a, F32)


def _jax_biquad(x, b, a):
    """JAX's ``_biquad`` over rows ``x`` broadcast to every coefficient set: ``(rows * group, T)``."""
    xb = jnp.broadcast_to(jnp.asarray(x)[:, None, :], (x.shape[0], b.shape[0], x.shape[1]))
    return np.asarray(js._biquad(xb, jnp.asarray(b), jnp.asarray(a))).reshape(-1, x.shape[1])


def _numpy_step_loop(x, b, a, contracted):
    """The step in numpy over rows ``x`` broadcast to every set, float32 each
    op (``contracted=False``) or with XLA's three FMAs, emulated by float64
    products and sums rounded once (``contracted=True``)."""
    bn, an = (b / a[:, 0:1]).astype(F32), (a / a[:, 0:1]).astype(F32)
    rows = x.shape[0] * b.shape[0]
    b0, b1, b2 = (np.tile(bn[:, k], x.shape[0]) for k in range(3))
    a1, a2 = np.tile(an[:, 1], x.shape[0]), np.tile(an[:, 2], x.shape[0])
    v = np.repeat(x, b.shape[0], axis=0)
    z1, z2 = np.zeros(rows, F32), np.zeros(rows, F32)
    out = np.empty_like(v)
    d = np.float64
    for t in range(v.shape[1]):
        xt = v[:, t]
        if contracted:
            y = (d(b0) * d(xt) + d(z1)).astype(F32)
            z1 = ((d(b1) * d(xt) - d(a1 * y)).astype(F32) + z2).astype(F32)
            z2 = (d(b2) * d(xt) - d(a2 * y)).astype(F32)
        else:
            y = b0 * xt + z1
            z1 = (b1 * xt - a1 * y) + z2
            z2 = b2 * xt - a2 * y
        out[:, t] = y
    return out


def _rel_err(got, want):
    scale = np.abs(want).max(axis=-1, keepdims=True)
    return float((np.abs(got.astype(np.float64) - want) / scale).max())


@pytest.mark.parametrize("bank", ["one_stage", "modulation"])
def test_lax_scan_is_the_contracted_step_and_plain_the_uncontracted_one(bank):
    """What separates the two: XLA's FMAs. Both emulations are bitwise."""
    x, b, a = _banks(16000, bank)
    want = _jax_biquad(x, b, a)
    np.testing.assert_array_equal(_numpy_step_loop(x, b, a, contracted=True).view(np.uint32), want.view(np.uint32))
    got = biquad_cascade_plain(torch.from_numpy(x), torch.from_numpy(b)[:, None], torch.from_numpy(a)[:, None]).numpy()
    np.testing.assert_array_equal(_numpy_step_loop(x, b, a, contracted=False).view(np.uint32), got.view(np.uint32))
    assert (got != want).any()  # the contraction shows


@pytest.mark.parametrize("fs", [8000, 16000])
@pytest.mark.parametrize("bank", ["one_stage", "modulation"])
def test_plain_route_against_jax_biquad_within_budget(bank, fs):
    x, b, a = _banks(fs, bank)
    got = biquad_cascade(torch.from_numpy(x), torch.from_numpy(b)[:, None], torch.from_numpy(a)[:, None])
    assert got.dtype == torch.float32 and tuple(got.shape) == (x.shape[0] * b.shape[0], T)
    assert _rel_err(got.numpy(), _jax_biquad(x, b, a)) <= BUDGET[bank]


@pytest.mark.parametrize("fs", [8000, 16000])
def test_erb_filterbank_against_jax_within_budget(fs):
    """The 4-stage cascade in one call (K5's route: stages fused per sample) and the gain division."""
    wave = _wave(fs + 2)
    coefs = js._make_erb_filters(fs, 23, 125)
    want = np.asarray(js._erb_filterbank(jnp.asarray(wave), coefs))
    got = ts._erb_filterbank(torch.from_numpy(wave), coefs).numpy()
    assert got.shape == want.shape == (2, 23, T) and got.dtype == want.dtype
    assert _rel_err(got.reshape(-1, T), want.reshape(-1, T)) <= BUDGET["gammatone"]


def test_fused_stages_equal_stages_one_after_another():
    """S stages in one cascade equal S one-stage passes bitwise (the kernel fuses them per sample)."""
    wave = _wave(3, length=2000)
    coefs = js._make_erb_filters(8000, 23, 125)
    num, den, _ = ts._gammatone_banks(coefs)
    rows = biquad_cascade_plain(torch.from_numpy(wave), num, den).reshape(2, 23, -1)
    for ch in (0, 11, 22):
        v = torch.from_numpy(wave)
        for s in range(4):
            v = biquad_cascade_plain(v, num[ch : ch + 1, s : s + 1], den[ch : ch + 1, s : s + 1])
        assert torch.equal(v, rows[:, ch]), ch


def test_plain_steps_walked_in_chunks_equal_one_walk():
    """``biquad_cascade_plain``'s ``steps``: a walk that carries ``z1``, ``z2``
    over chunks of time (as ``chip_smoke.py`` replays them from CUDA graphs)
    gives the bits of one walk over the whole row."""
    from torchmetrics_tpu_torch.ops.biquad import stage_steps

    def chunked(bx0, bx1, bx2, a1, a2, z1, z2, out, width=300):
        for t0 in range(0, bx0.shape[1], width):
            cols = slice(t0, t0 + width)
            z1, z2 = stage_steps(bx0[:, cols], bx1[:, cols], bx2[:, cols], a1, a2, z1, z2, out[:, cols])
        return z1, z2

    wave = torch.from_numpy(_wave(5, length=1000))
    num, den, _ = ts._gammatone_banks(js._make_erb_filters(16000, 23, 125))
    assert torch.equal(biquad_cascade_plain(wave, num, den, steps=chunked), biquad_cascade_plain(wave, num, den))


def test_normalized_coefficients_are_jax_float32_division():
    coefs = js._make_erb_filters(16000, 23, 125)
    num, den, _ = ts._gammatone_banks(coefs)
    got = normalized_coefficients(num, den).numpy()
    b, a = jnp.asarray(num.numpy()), jnp.asarray(den.numpy())
    want = np.concatenate([np.asarray(b / a[..., 0:1]), np.asarray(a / a[..., 0:1])[..., 1:3]], axis=-1)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_cpu_tensors_take_the_plain_route_and_count_no_launch():
    before = biquad_cascade.launches
    x, b, a = _banks(8000, "one_stage")
    out = biquad_cascade(torch.from_numpy(x[:, :500]), torch.from_numpy(b)[:, None], torch.from_numpy(a)[:, None])
    plain = biquad_cascade_plain(torch.from_numpy(x[:, :500]), torch.from_numpy(b)[:, None], torch.from_numpy(a)[:, None])
    assert torch.equal(out, plain) and biquad_cascade.launches == before


def test_constants_match_the_kernel_source():
    """``ops/biquad.py``'s tile and ring (the card tests' lengths around a turn of the rings) are the kernel's."""
    import re
    from pathlib import Path

    from torchmetrics_tpu_torch.ops import biquad

    src = (Path(biquad.__file__).resolve().parent.parent / "csrc" / "biquad.cu").read_text()
    assert int(re.search(r"constexpr int kTile = (\d+);", src).group(1)) == biquad.TILE
    assert int(re.search(r"constexpr int kRing = (\d+);", src).group(1)) == biquad.RING
    assert biquad.RING & (biquad.RING - 1) == 0  # the kernel takes a slot as k & (kRing - 1)
    stages = tuple(int(v) for v in re.findall(r"case (\d+): return static_cast<int>\(launch<", src))
    assert stages == biquad._STAGES  # the wrapper's stage counts are the kernel's instantiations


@pytest.mark.parametrize("case", ["1d_input", "float64_input", "two_stages", "five_stages", "den_shape"])
def test_bad_arguments_raise(case):
    x = torch.zeros(2, 16)
    num = den = torch.ones(3, 1, 3)
    if case == "1d_input":
        x = torch.zeros(16)
    elif case == "float64_input":
        x = x.double()
    elif case == "two_stages":  # the kernel is built for SRMR's 1 and 4 stages only
        num = den = torch.ones(3, 2, 3)
    elif case == "five_stages":
        num = den = torch.ones(3, 5, 3)
    else:
        den = torch.ones(3, 2, 3)
    with pytest.raises(ValueError, match="biquad_cascade"):
        biquad_cascade(x, num, den)
