# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's threefry2x32 (``torchmetrics_tpu_torch/sketch/_threefry.py``)
against ``jax.random``, bit for bit, on the CPU: ``PRNGKey``, ``split`` (the
order of the two output words under ``jax_threefry_partitionable``),
``fold_in`` (its seed layout) and float32 ``uniform`` (its mantissa shift),
for seeds 0, 1 and 2**31-1, ranks 0 and 3, and sizes 1, 7 and 4,096."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch.sketch import _threefry

SEEDS = [0, 1, 2**31 - 1]
CPU = torch.device("cpu")


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.dtype, x.shape, x.tobytes()


def test_jax_runs_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    key = _threefry.prng_key(seed, CPU)
    assert key.dtype == torch.uint32 and _bits(key) == _bits(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("rank", [0, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed, rank):
    got = _threefry.fold_in(_threefry.prng_key(seed, CPU), torch.tensor(rank))
    assert _bits(got) == _bits(jax.random.fold_in(jax.random.PRNGKey(seed), rank))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_twice(seed):
    key, jkey = _threefry.prng_key(seed, CPU), jax.random.PRNGKey(seed)
    for _ in range(2):
        (key, sub), (jkey, jsub) = _threefry.split(key), jax.random.split(jkey)
        assert _bits(key) == _bits(jkey) and _bits(sub) == _bits(jsub)


@pytest.mark.parametrize("n", [1, 7, 4096])
@pytest.mark.parametrize("rank", [0, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(seed, rank, n):
    key, jkey = _threefry.prng_key(seed, CPU), jax.random.PRNGKey(seed)
    if rank:
        key, jkey = _threefry.fold_in(key, torch.tensor(rank)), jax.random.fold_in(jkey, rank)
    _, sub = _threefry.split(key)
    _, jsub = jax.random.split(jkey)
    got = _threefry.uniform(sub, n)
    want = jax.random.uniform(jsub, (n,), jnp.float32)
    assert _bits(got) == _bits(want)
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.mark.parametrize("bounds", [(0, 10), (0, 1000), (3, 70000), (0, 1), (-5, 5), (7, 7), (0, 2**31 - 1)],
                         ids=lambda b: f"{b[0]}-{b[1]}")
@pytest.mark.parametrize("seed", SEEDS)
def test_randint(seed, bounds):
    """``jax.random.randint(PRNGKey(seed), (n,), lo, hi)`` (PPL's conditional labels), bit for bit: spans
    past 2**16 wrap the multiplier's uint32 square as JAX's does; an empty range gives ``lo``."""
    lo, hi = bounds
    got = _threefry.randint(_threefry.prng_key(seed, CPU), 257, lo, hi)
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (257,), lo, hi))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert np.array_equal(got.numpy(), want)
