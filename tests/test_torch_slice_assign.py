# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K4's representative route against JAX's ``_assign_cells``, on the CPU.

The kernel (``csrc/slice_assign.cu``) runs the insertion rounds over one
representative per distinct new key, its lowest row, without JAX's third
step and only while a slot is empty, and fans each representative's cell
out to its key's rows. ``slice_assign_reps_plain`` takes that route on the
host; here it must give the table, the cells and the spill count of
``slice_assign_plain`` (JAX's while_loop as a host loop) and of JAX's own
``_assign_cells``, bit for bit, batch after batch from the same seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.parallel.sliced import SliceTable, _assign_cells
from torchmetrics_tpu_torch.ops.slice_assign import slice_assign_plain, slice_assign_reps_plain

# (key width, cells, cohorts, batch rows, batches, a filled table first)
CASES = {
    "width1_empty": (1, 24, 7, 300, 2, False),
    "width2_filled": (2, 24, 60, 300, 2, True),
    "width3_empty": (3, 5, 4, 50, 2, False),
    "width3_filled": (3, 40, 30, 200, 2, True),
    "full_table_1024": (1, 1024, 1024, 8192, 1, False),
    "spills": (1, 64, 200, 1000, 2, False),
    "one_key_repeated": (2, 16, 1, 500, 2, False),
}


def _table(n, w):
    return torch.zeros((n, w), dtype=torch.int32), torch.zeros(n, dtype=torch.bool), torch.zeros((), dtype=torch.int32)


def _batch(rng, cohorts, rows, w, one_key):
    if one_key:
        return np.repeat(rng.integers(-50, 50, (1, w)), rows, axis=0).astype(np.int32)
    ids = rng.integers(0, cohorts, rows)
    return (np.stack([ids * (i + 3) - 7 * i for i in range(w)], axis=1)).astype(np.int32)


@pytest.mark.parametrize("case", list(CASES))
def test_representative_route_equals_jax_rounds(case):
    """Table, cells and spills of the representative route equal the plain
    version's and JAX's, batch after batch; the route counts each distinct
    new key once."""
    w, n, cohorts, rows, batches, filled = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    reps_t, plain_t = _table(n, w), _table(n, w)
    jax_t = SliceTable(keys=jnp.zeros((n, w), jnp.int32), occupied=jnp.zeros(n, bool), spills=jnp.zeros((), jnp.int32))
    streams = [_batch(rng, cohorts, rows, w, case == "one_key_repeated") for _ in range(batches)]
    if filled:
        streams.insert(0, _batch(rng, cohorts, rows, w, False))
    for i, kmat in enumerate(streams):
        resident = {tuple(k) for k in reps_t[0][reps_t[1]].tolist()}
        stats = {}
        got = slice_assign_reps_plain(*reps_t, torch.from_numpy(kmat), stats=stats)
        want = slice_assign_plain(*plain_t, torch.from_numpy(kmat))
        jax_t, jax_cells = _assign_cells(jax_t, jnp.asarray(kmat))
        assert torch.equal(got, want), (case, i)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_cells))
        for mine, theirs, jx in zip(reps_t, plain_t, jax_t):
            assert torch.equal(mine, theirs), (case, i)
            np.testing.assert_array_equal(mine.numpy(), np.asarray(jx))
        assert stats["new_keys"] == len({tuple(k) for k in kmat.tolist()} - resident), (case, i)
        assert stats["rounds"] <= n
    if case == "spills":
        assert int(reps_t[2]) > 0
    if case == "full_table_1024":
        assert bool(reps_t[1].all())
