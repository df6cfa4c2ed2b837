# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K7's plain route (``window_moments_plain``, what CPU tensors take) against
the JAX package's depthwise convolution over the five-way stacked input
``(x, y, x*x, y*y, x*y)`` (``functional/image/ssim.py``'s filter) under
JAX's own 2-D table, on seeded numpy inputs: Gaussian and uniform windows,
odd non-square windows, VIF's 17 x 17 VALID window, several batch and
channel counts; each factor function against JAX's 2-D table; the refusal of
a window whose staged tile cannot fit; the gradient of the autograd route.

Budget: XLA's CPU convolution adds the 2-D taps in its own order; the plain
route sums along rows, then down columns (the kernel's order), under the
window's two factors. Each moment differs by the rounding of two float32
sums of up to 17 terms against one of up to 289, and the factors' outer
product from JAX's table by a few float32 roundings: ``rtol=2e-6`` and
``atol=2e-7`` (measured at most 2.4e-7 absolute on values in [-0.5, 1.5]).
On CPU tensors the wrapper is the plain route, bit for bit.
"""
from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.functional.image.helpers import _gaussian_kernel_2d as j_gaussian_kernel_2d
from torchmetrics_tpu.functional.image.helpers import conv2d as j_conv2d
from torchmetrics_tpu.functional.image.metrics import _vif_filter as j_vif_filter
from torchmetrics_tpu_torch.functional.image.helpers import _gaussian_factors, _uniform_factors
from torchmetrics_tpu_torch.functional.image.metrics import _vif_factor
from torchmetrics_tpu_torch.ops import window_moments, window_moments_plain
from torchmetrics_tpu_torch.ops.window_moments import COL_RUN, SMEM_MAX, SMEM_PAIR, TILE_HEIGHTS, TILE_W, staged_bytes, tile_height

RTOL, ATOL = 2e-6, 2e-7
CSRC = Path(__file__).resolve().parent.parent / "torchmetrics_tpu_torch" / "csrc" / "window_moments.cu"


def _windows(kind, kh, kw):
    """The port's ``(col, row)`` factors and JAX's (kh, kw) table: Gaussian (sigma 1.5 x 1.2), uniform
    (SSIM's ``ones / area``), SCC's (``ones / k²``) or VIF's."""
    if kind == "gaussian":
        return _gaussian_factors((kh, kw), (1.5, 1.2)), np.asarray(j_gaussian_kernel_2d(1, (kh, kw), (1.5, 1.2))[0, 0])
    if kind == "vif":
        factor = _vif_factor(float(kh), kh / 5)
        return (factor, factor), np.asarray(j_vif_filter(float(kh), kh / 5))
    if kind == "scc":
        return _uniform_factors((kh, kw), kh**2), np.asarray(jnp.ones((kh, kw)) / (kh**2))
    return _uniform_factors((kh, kw), kh * kw), np.asarray(jnp.ones((kh, kw)) / (kh * kw))


def _jax_moments(x, y, table):
    """JAX's filter: one depthwise conv over the stacked input, split into the five moments."""
    b, c = x.shape[:2]
    kernel = jnp.broadcast_to(jnp.asarray(table), (c, 1, *table.shape))
    out = j_conv2d(jnp.concatenate([x, y, x * x, y * y, x * y]), kernel, groups=c)
    return jnp.stack([out[i * b : (i + 1) * b] for i in range(5)])


CASES = [
    ("gaussian", 11, 11, (2, 3, 40, 36)),
    ("gaussian", 7, 5, (1, 1, 23, 30)),
    ("gaussian", 3, 9, (3, 5, 17, 19)),
    ("uniform", 7, 7, (2, 3, 30, 30)),
    ("uniform", 8, 8, (2, 2, 21, 25)),
    ("uniform", 1, 1, (1, 2, 5, 6)),
    ("vif", 17, 17, (2, 3, 41, 45)),
    ("vif", 9, 9, (4, 1, 20, 21)),
    ("gaussian", 11, 11, (1, 1, 11, 11)),
]


@pytest.mark.parametrize("kind,kh,kw,shape", CASES, ids=[f"{c[0]}{c[1]}x{c[2]}-{'x'.join(map(str, c[3]))}" for c in CASES])
def test_plain_route_against_jax_stacked_conv(kind, kh, kw, shape):
    rng = np.random.default_rng(sum(shape) + kh)
    x = rng.random(shape, dtype=np.float32)
    y = (rng.random(shape, dtype=np.float32) * 2 - 0.5).astype(np.float32)
    (col, row), jtable = _windows(kind, kh, kw)
    got = window_moments_plain(torch.from_numpy(x), torch.from_numpy(y), col, row)
    want = np.asarray(_jax_moments(jnp.asarray(x), jnp.asarray(y), jtable))
    assert got.shape == want.shape == (5, shape[0], shape[1], shape[2] - kh + 1, shape[3] - kw + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the wrapper on CPU tensors is the plain route, bit for bit, and launches nothing
    before = window_moments.launches
    assert torch.equal(window_moments(torch.from_numpy(x), torch.from_numpy(y), col, row), got)
    assert window_moments.launches == before


# Each factor function's outer product against JAX's 2-D table. The Gaussian table is JAX's outer product of
# the same 1-D tables (torch's and XLA's exp may differ in the last bit: 2 ulp at most); the uniform
# ones are exact; VIF's is exp(-(a² + b²)/2s²) normalised over the square, against exp(-a²/2s²) and
# exp(-b²/2s²) each normalised on its own: a few float32 roundings apart (4 ulp; measured 2.3e-7).
FACTOR_CASES = [
    ("gaussian", 11, 11, 2.4e-7),
    ("gaussian", 7, 5, 2.4e-7),
    ("uniform", 7, 7, 0.0),
    ("uniform", 3, 9, 0.0),
    ("scc", 8, 8, 0.0),
    ("vif", 17, 17, 4.8e-7),
    ("vif", 9, 9, 4.8e-7),
    ("vif", 3, 3, 4.8e-7),
]


@pytest.mark.parametrize("kind,kh,kw,rtol", FACTOR_CASES, ids=[f"{b[0]}{b[1]}x{b[2]}" for b in FACTOR_CASES])
def test_factor_functions_against_jax_tables(kind, kh, kw, rtol):
    (col, row), jtable = _windows(kind, kh, kw)
    assert col.shape == (kh,) and row.shape == (kw,) and col.dtype == row.dtype == torch.float32
    np.testing.assert_allclose(torch.outer(col, row).numpy(), jtable, rtol=rtol, atol=0)


def test_constant_images_give_constant_moments():
    x, y = torch.full((1, 2, 15, 15), 0.25), torch.full((1, 2, 15, 15), -2.0)
    out = window_moments(x, y, *_uniform_factors((5, 5), 25))
    for k, want in enumerate((0.25, -2.0, 0.0625, 4.0, -0.5)):
        torch.testing.assert_close(out[k], torch.full_like(out[k], want), rtol=1e-6, atol=0)


def test_refusal_of_a_window_whose_staged_tile_does_not_fit():
    """The wrapper refuses, on every device, a window whose staged tile exceeds a block's shared memory
    at the smallest tile; until then the tile's height shrinks with the window."""
    x = torch.zeros((1, 1, 210, 210))
    with pytest.raises(ValueError) as info:
        window_moments(x, x, torch.ones(201), torch.ones(201))
    assert str(info.value) == (
        "window_moments: a 201x201 window's staged tile needs 693696 bytes of shared memory at the smallest tile"
        " (1 x 64 outputs), more than the 232448 a block can have"
    )
    assert tile_height(11, 11) == 48 and staged_bytes(11, 11, 48) <= SMEM_PAIR  # two blocks an SM at SSIM's window
    assert tile_height(17, 17) == 32 and staged_bytes(17, 17, 48) > SMEM_PAIR >= staged_bytes(17, 17, 32)
    assert tile_height(33, 33) == 48 and staged_bytes(33, 33, 32) > SMEM_PAIR  # one block an SM: the tallest tile
    assert tile_height(60, 60) == 32 and tile_height(70, 70) == 16 and tile_height(80, 80) == 8
    assert staged_bytes(90, 90, 1) <= SMEM_MAX < staged_bytes(90, 90, 2) and tile_height(90, 90) == 1
    assert max(k for k in range(1, 200) if staged_bytes(k, k, 1) <= SMEM_MAX) == 90
    with pytest.raises(ValueError, match="a 91x91 window's staged tile"):
        tile_height(91, 91)


@pytest.mark.parametrize("bad", ["shape", "dtype", "window", "factor"])
def test_wrong_inputs_are_refused(bad):
    x = torch.zeros((1, 1, 8, 8))
    y = {"shape": torch.zeros((1, 1, 8, 9)), "dtype": torch.zeros((1, 1, 8, 8), dtype=torch.float64)}.get(bad, x)
    col = {"window": torch.ones(9), "factor": torch.ones((3, 3))}.get(bad, torch.ones(3))
    with pytest.raises(ValueError, match="window_moments"):
        window_moments(x, y, col, torch.ones(3))


def test_constants_match_the_kernel_source():
    src = CSRC.read_text()
    assert int(re.search(r"constexpr int kTileW = (\d+);", src).group(1)) == TILE_W
    heights = tuple(int(v) for v in re.findall(r"case (\d+): return static_cast<int>\(launch<", src))
    assert heights == TILE_HEIGHTS  # the wrapper's tile heights are the kernel's instantiations
    # the wrapper's staged bytes are the kernel's staged_floats, term by term
    assert int(re.search(r"constexpr int kColRun = (\d+);", src).group(1)) == COL_RUN
    formula = "round4(kh) + round4(kw) + 2LL * (th + kh - 1) * (kTileW + round4(kw)) + 5LL * (th + kh - 1) * kTileW +"
    assert formula in " ".join(src.split()) and "(kColRun - 1) * kTileW;" in src


def test_gradient_is_the_plain_adjoint():
    """The autograd route's backward (the transposed window over each moment's
    gradient) against autograd through the plain loop and against ``jax.grad``
    of JAX's stacked conv, for a weighted sum of the five moments."""
    rng = np.random.default_rng(5)
    x = rng.random((2, 3, 20, 22), dtype=np.float32)
    y = rng.random((2, 3, 20, 22), dtype=np.float32)
    (col, row), jtable = _windows("gaussian", 11, 11)
    coef = rng.standard_normal((5, 1, 1, 10, 12)).astype(np.float32)

    def loss(fn, a, b):
        return (fn(a, b, col, row) * torch.from_numpy(coef)).sum()

    grads = {}
    for name, fn in (("route", window_moments), ("plain", window_moments_plain)):
        a, b = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(y).requires_grad_(True)
        loss(fn, a, b).backward()
        grads[name] = (a.grad, b.grad)
    jgrads = jax.grad(lambda a, b: jnp.sum(_jax_moments(a, b, jtable) * coef), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y)
    )
    for i in range(2):
        torch.testing.assert_close(grads["route"][i], grads["plain"][i], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(grads["route"][i].numpy(), np.asarray(jgrads[i]), rtol=1e-5, atol=1e-6)
