# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K7's plain route (``window_moments_plain``, what CPU tensors take) against
the JAX package's depthwise convolution over the five-way stacked input
``(x, y, x*x, y*y, x*y)`` (``functional/image/ssim.py``'s filter), on seeded
numpy inputs: Gaussian and uniform windows, odd non-square windows, VIF's
17 x 17 VALID window, several batch and channel counts; the refusal of a
window whose halo cannot fit; the gradient of the autograd route.

Budget: XLA's CPU convolution adds the taps in its own order, the plain
route in row-major tap order (the kernel's), so each moment differs by the
rounding of a float32 sum of up to 289 terms (and the tables by torch's
and XLA's ``exp``, a bit at most): ``rtol=2e-6`` and ``atol=2e-7``
(measured at most 7.7e-7 absolute, 1.4e-6 relative where the moment is
above 1e-3, on values in [-0.5, 1.5]). On CPU tensors the wrapper is the
plain route, bit for bit.
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
from torchmetrics_tpu_torch.functional.image.helpers import _gaussian_kernel_2d
from torchmetrics_tpu_torch.functional.image.metrics import _vif_filter
from torchmetrics_tpu_torch.ops import window_moments, window_moments_plain
from torchmetrics_tpu_torch.ops.window_moments import SMEM_MAX, TILE_W, halo_bytes, tile_height

RTOL, ATOL = 2e-6, 2e-7
CSRC = Path(__file__).resolve().parent.parent / "torchmetrics_tpu_torch" / "csrc" / "window_moments.cu"


def _windows(kind, kh, kw):
    """The (kh, kw) table of each package: Gaussian (sigma 1.5 x 1.2), uniform, or VIF's."""
    if kind == "gaussian":
        return _gaussian_kernel_2d(1, (kh, kw), (1.5, 1.2))[0, 0], np.asarray(j_gaussian_kernel_2d(1, (kh, kw), (1.5, 1.2))[0, 0])
    if kind == "vif":
        return _vif_filter(float(kh), kh / 5), np.asarray(j_vif_filter(float(kh), kh / 5))
    return torch.ones((kh, kw)) / (kh * kw), np.asarray(jnp.ones((kh, kw)) / (kh * kw))


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
    table, jtable = _windows(kind, kh, kw)
    # the same float32 ops build both tables; torch's exp and XLA's may differ in the last bit (2 ulp at most)
    np.testing.assert_allclose(table.numpy(), jtable, rtol=2.4e-7, atol=0, err_msg="the window tables")
    got = window_moments_plain(torch.from_numpy(x), torch.from_numpy(y), table)
    want = np.asarray(_jax_moments(jnp.asarray(x), jnp.asarray(y), jtable))
    assert got.shape == want.shape == (5, shape[0], shape[1], shape[2] - kh + 1, shape[3] - kw + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the wrapper on CPU tensors is the plain route, bit for bit, and launches nothing
    before = window_moments.launches
    assert torch.equal(window_moments(torch.from_numpy(x), torch.from_numpy(y), table), got)
    assert window_moments.launches == before


def test_constant_images_give_constant_moments():
    x, y = torch.full((1, 2, 15, 15), 0.25), torch.full((1, 2, 15, 15), -2.0)
    out = window_moments(x, y, torch.ones((5, 5)) / 25)
    for k, want in enumerate((0.25, -2.0, 0.0625, 4.0, -0.5)):
        torch.testing.assert_close(out[k], torch.full_like(out[k], want), rtol=1e-6, atol=0)


def test_refusal_of_a_window_whose_halo_does_not_fit():
    """The wrapper refuses, on every device, a window whose halo exceeds a block's shared memory at the smallest tile."""
    x = torch.zeros((1, 1, 210, 210))
    with pytest.raises(ValueError) as info:
        window_moments(x, x, torch.ones((201, 201)))
    assert str(info.value) == (
        "window_moments: a 201x201 window's halo needs 373056 bytes of shared memory at the smallest tile"
        " (1 x 32 outputs), more than the 232448 a block can have"
    )
    assert tile_height(11, 11) == 8 and tile_height(155, 155) == 2
    assert halo_bytes(155, 155, 2) <= SMEM_MAX < halo_bytes(155, 155, 4)


@pytest.mark.parametrize("bad", ["shape", "dtype", "window"])
def test_wrong_inputs_are_refused(bad):
    x = torch.zeros((1, 1, 8, 8))
    y = {"shape": torch.zeros((1, 1, 8, 9)), "dtype": torch.zeros((1, 1, 8, 8), dtype=torch.float64)}.get(bad, x)
    w = torch.ones((9, 3)) if bad == "window" else torch.ones((3, 3))
    with pytest.raises(ValueError, match="window_moments"):
        window_moments(x, y, w)


def test_constants_match_the_kernel_source():
    src = CSRC.read_text()
    assert int(re.search(r"constexpr int kTileW = (\d+);", src).group(1)) == TILE_W
    assert "tile_h > 8" in src  # the wrapper's largest tile height


def test_gradient_is_the_plain_adjoint():
    """The autograd route's backward (the transposed window over each moment's
    gradient) against autograd through the plain loop and against ``jax.grad``
    of JAX's stacked conv, for a weighted sum of the five moments."""
    rng = np.random.default_rng(5)
    x = rng.random((2, 3, 20, 22), dtype=np.float32)
    y = rng.random((2, 3, 20, 22), dtype=np.float32)
    table, jtable = _windows("gaussian", 11, 11)
    coef = rng.standard_normal((5, 1, 1, 10, 12)).astype(np.float32)

    def loss(fn, a, b):
        return (fn(a, b, table) * torch.from_numpy(coef)).sum()

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

