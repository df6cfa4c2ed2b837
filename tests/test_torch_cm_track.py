# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K3's filter on the CPU: the tags the kernel steps through
(``ops.cm_track.cm_track_kept``: first occurrences whose estimate beats the
table's minimum at the start of their tile) give the table of the full scan.

Each case runs one seeded numpy batch through JAX's ``cm_update`` and through
the port's grid and estimates; the table of ``cm_track_plain`` over the kept
tags, over every tag, and JAX's must be bitwise equal. Tables that break the
filter's preconditions (a key live in two slots, a negative count) and a
batch where a tag has two estimates must keep every tag. The kernel's own
counters are held against the same trace on the card
(``tests/test_torch_kernels_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.sketch import countmin as jcm
from torchmetrics_tpu_torch.ops.cm_track import _TILE, cm_track_kept, cm_track_plain, cm_track_stats
from torchmetrics_tpu_torch.sketch.countmin import _columns, _int32_bits, _point
from torchmetrics_tpu_torch.sketch.hll import _tags_of

N = 2048  # tags a batch
DEPTH, WIDTH = 4, 256
_jax_update = jax.jit(jcm.cm_update)  # one compile per table size, not one per call


def _batch(stream, rng):
    if stream == "zipf":  # chip_smoke.py's density 1/k over a million keys: a few hot keys, a long tail
        return (np.floor(np.exp(rng.random(N) * np.log(1e6))) - 1).astype(np.int32)
    if stream == "uniform":
        return rng.integers(-(2**31), 2**31, N, dtype=np.int64).astype(np.int32)
    tags = (rng.zipf(1.5, N) % 300).astype(np.int32)  # "tag0": key 0 hot, against the empty slots' key 0
    tags[::3] = 0
    return tags


def _port_inputs(grid, tags_np):
    """The port's kernel inputs for a batch: int32 tag bits and estimates
    against the grid after the batch (as ``sketch.cm_update`` makes them)."""
    tags = _tags_of(torch.from_numpy(tags_np), torch.device("cpu"))
    cols = _columns(tags, DEPTH, WIDTH)
    flat = (cols + WIDTH * torch.arange(DEPTH)[:, None]).reshape(-1)
    counts = grid.reshape(-1).index_add(0, flat, torch.ones((), dtype=torch.int32).expand(flat.numel())).reshape(DEPTH, WIDTH)
    return _int32_bits(tags), _point(counts, tags)


def _table(state):
    return torch.from_numpy(np.asarray(state.hh_keys)), torch.from_numpy(np.asarray(state.hh_counts))


def _assert_tables_equal(got, want, what):
    for g, w in zip(got, want):
        assert torch.equal(g.to(torch.int64), w.to(torch.int64)), what


@pytest.mark.parametrize("table", ["empty", "filled", "live_duplicate", "negative_count"])
@pytest.mark.parametrize("k", [1, 32, 33, 1024])
@pytest.mark.parametrize("stream", ["zipf", "uniform", "tag0"])
def test_kept_tags_give_the_full_scan_and_jax(stream, k, table):
    rng = np.random.default_rng([k, len(stream), len(table)])
    state = jcm.cm_init(DEPTH, WIDTH, k)
    if table != "empty":
        state = _jax_update(state, jnp.asarray(_batch(stream, rng)))
    keys, counts = (np.asarray(a).copy() for a in (state.hh_keys, state.hh_counts))
    if table == "live_duplicate":  # two live slots hold one key (k = 1: a negative count instead)
        if k > 1:
            keys[-1], counts[-1], counts[0] = keys[0], max(counts[-1], 1), max(counts[0], 1)
        else:
            counts[0] = -1
    if table == "negative_count":
        counts[k // 2] = -1
    state = state._replace(hh_keys=jnp.asarray(keys), hh_counts=jnp.asarray(counts))
    tags_np = _batch(stream, rng)
    want = _table(_jax_update(state, jnp.asarray(tags_np)))

    tags, ests = _port_inputs(torch.from_numpy(np.asarray(state.counts)), tags_np)
    hh = _table(state)
    full = cm_track_plain(tags, ests, *hh)
    _assert_tables_equal(full, want, "the plain scan against JAX's cm_update")
    for tile in (_TILE, 32):  # the kernel's tile, and a small one where the minimum moves between tiles
        kept = cm_track_kept(tags, ests, *hh, tile=tile)
        assert bool((kept[1:] > kept[:-1]).all()), "kept indices are in order"
        if table in ("live_duplicate", "negative_count"):
            assert torch.equal(kept, torch.arange(N)), "a table that breaks the preconditions keeps every tag"
        else:
            assert torch.unique(tags[kept]).numel() == kept.numel(), "only first occurrences are kept"
        _assert_tables_equal(cm_track_plain(tags[kept], ests[kept], *hh), want, f"the kept tags (tile {tile})")


def test_a_tag_with_two_estimates_keeps_every_tag():
    """The filter needs one estimate per tag (the kernel checks it on the
    card); a batch that breaks that is scanned whole."""
    rng = np.random.default_rng(7)
    tags = torch.from_numpy((rng.zipf(1.3, N) % 500).astype(np.int32))
    ests = torch.from_numpy(rng.integers(0, 60, N).astype(np.int32))
    keys, counts = torch.zeros(32, dtype=torch.int64).to(torch.uint32), torch.zeros(32, dtype=torch.int32)
    assert torch.equal(cm_track_kept(tags, ests, keys, counts), torch.arange(N))
    *table, stats = cm_track_stats(tags, ests, keys, counts)
    assert stats.tolist() == [0, N, N]
    _assert_tables_equal(table, cm_track_plain(tags, ests, keys, counts), "the unfiltered scan")


def test_stats_count_the_steps_that_can_change_the_table():
    """The host trace's counters: the filtered mode, the survivors of the
    tile filters, and the steps run (a survivor whose estimate still beats
    the minimum at its turn); repeats and low estimates never step."""
    tags = torch.tensor([5, 5, 6, 7, 5, 8, 9], dtype=torch.int32)
    ests = torch.tensor([4, 4, 1, 3, 4, 2, 9], dtype=torch.int32)
    keys = torch.tensor([5, 0], dtype=torch.int64).to(torch.uint32)
    counts = torch.tensor([3, 2], dtype=torch.int32)  # minimum 2: estimates 1 and 2 cannot enter
    *table, stats = cm_track_stats(tags, ests, keys, counts)
    assert torch.equal(cm_track_kept(tags, ests, keys, counts), torch.tensor([0, 3, 6]))
    assert stats.tolist() == [1, 3, 3]
    _assert_tables_equal(table, (torch.tensor([5, 9]), torch.tensor([4, 9])), "the table")
    _assert_tables_equal(table, cm_track_plain(tags, ests, keys, counts), "the full scan")
