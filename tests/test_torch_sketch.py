# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's sketch plane against the JAX package's, on the CPU: the
counterparts of ``tests/unittests/bases/test_sketch.py``, each running the
same seeded numpy input through both packages, plus merges across the two
packages through checkpoints.

Budgets:

- integer leaves, the histogram, HyperLogLog's registers, the Count-Min grid
  and table, the reservoir (values, tags and key) and KLL's items are
  bitwise: sorts, selections, integer adds and the same float32 hashes;
- KLL quantile, rank and cdf are bitwise: they select values and divide in
  float32;
- the moments' ``mean``/``m2`` within ``rtol=1e-6, atol=1e-6`` (the batch
  sums add in another order than XLA's); their count is bitwise;
- HyperLogLog's cardinality within ``rtol=1e-6`` (the harmonic sum adds in
  another order).

The JAX tests' sharded cases run on a virtual 8-device mesh in one process;
the port's sharded regime is one process per rank. Here the port's side of
those cases is the same fold in one process (:func:`_emulated_sharded_update`:
each of 8 contiguous shards updates a fresh state, the states reduce in rank
order as ``mesh_reduce_tree`` reduces them, and the metric folds the result
as ``sharded_update`` does); the real two-rank collectives are in
``tests/test_torch_sketch_ranks.py``.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torchmetrics_tpu as J
import torchmetrics_tpu.drift as jdrift
import torchmetrics_tpu_torch as T
import torchmetrics_tpu_torch.drift as tdrift
from torchmetrics_tpu import sketch as jsk
from torchmetrics_tpu.parallel import ShardedMetric as JSharded
from torchmetrics_tpu.parallel.sharded import fold_jit_state as j_fold_jit_state
from torchmetrics_tpu.parallel.sharded import make_jit_update as j_make_jit_update
from torchmetrics_tpu_torch import sketch as tsk
from torchmetrics_tpu_torch.parallel import fold_jit_state, make_jit_update
from torchmetrics_tpu_torch.parallel.sharded import _deep_batch_update_state, deep_reductions, tree_merge
from torchmetrics_tpu_torch.robustness import SyncConfig, faults
from torchmetrics_tpu_torch.sketch.registry import reduce_merge_states
from torchmetrics_tpu_torch.utilities.exceptions import SyncError

QS = np.asarray([0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99], np.float32)
CPU = "cpu"


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    return np.ascontiguousarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def _bitwise(got, want, what=""):
    got, want = np.atleast_1d(_np(got)), np.atleast_1d(_np(want))
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), (what, got, want)


def _same_state(tstate, jstate, what="", float_tol=None):
    """Every leaf of a port sketch equals the JAX sketch's: bitwise, or within
    ``float_tol = (rtol, atol)`` for floating leaves."""
    assert type(tstate).__name__ == type(jstate).__name__ and tstate._fields == jstate._fields
    for field, got, want in zip(jstate._fields, tstate, jstate):
        if float_tol is not None and np.issubdtype(_np(want).dtype, np.floating):
            assert _np(got).dtype == _np(want).dtype and _np(got).shape == _np(want).shape, (what, field)
            np.testing.assert_allclose(_np(got), _np(want), rtol=float_tol[0], atol=float_tol[1], err_msg=f"{what} {field}")
        else:
            _bitwise(got, want, f"{what} {field}")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _kll_parts(chunks, capacity=256, levels=14):
    j = [jsk.kll_update(jsk.kll_init(capacity, levels), c) for c in chunks]
    t = [tsk.kll_update(tsk.kll_init(capacity, levels, device=CPU), _t(c)) for c in chunks]
    return j, t


def _emulated_sharded_update(metric, arrays, n_shards=8):
    """``sharded_update`` over ``n_shards`` ranks in one process: contiguous
    shards, fresh partial states, a reduction in rank order, one fold."""
    reductions = deep_reductions(metric)
    parts = [_deep_batch_update_state(metric, tuple(_t(a) for a in shard), {})
             for shard in zip(*[np.split(a, n_shards) for a in arrays])]
    merged = {}
    for key, red in reductions.items():
        if red == "merge":
            merged[key] = reduce_merge_states([p[key] for p in parts])
        else:
            merged[key] = parts[0][key]
            for p in parts[1:]:
                merged[key] = tree_merge({key: red}, {key: merged[key]}, {key: p[key]})[key]
    metric._fold_sharded_state(merged, metric._update_count)
    metric._computed = None
    metric._update_count += 1


# --------------------------------------------------------------- merge algebra


class TestMergeAlgebra:
    def test_kll_commutative(self):
        chunks = np.split(_rng(1).normal(size=20_000).astype(np.float32), 2)
        (ja, jb), (ta, tb) = _kll_parts(chunks)
        tab, tba = tsk.kll_merge(ta, tb), tsk.kll_merge(tb, ta)
        _same_state(tab, jsk.kll_merge(ja, jb), "ab")
        _same_state(tba, jsk.kll_merge(jb, ja), "ba")
        _bitwise(tsk.kll_quantile(tab, _t(QS)), tsk.kll_quantile(tba, _t(QS)), "commutes")
        assert int(tab.count) == int(tba.count) == 20_000

    def test_kll_associative_within_bound(self):
        data = _rng(2).normal(size=30_000).astype(np.float32)
        (ja, jb, jc), (ta, tb, tc) = _kll_parts(np.split(data, 3))
        left = tsk.kll_merge(tsk.kll_merge(ta, tb), tc)
        right = tsk.kll_merge(ta, tsk.kll_merge(tb, tc))
        _same_state(left, jsk.kll_merge(jsk.kll_merge(ja, jb), jc), "left")
        _same_state(right, jsk.kll_merge(ja, jsk.kll_merge(jb, jc)), "right")
        n = data.size
        tol = (float(tsk.kll_error_bound(left)) + float(tsk.kll_error_bound(right))) / n
        for lv, rv in zip(_np(tsk.kll_quantile(left, _t(QS))), _np(tsk.kll_quantile(right, _t(QS)))):
            assert abs((data <= lv).sum() - (data <= rv).sum()) <= tol * n + 2
        assert int(left.count) == int(right.count) == n

    def test_histogram_exactly_associative_commutative(self):
        chunks = np.split(_rng(3).normal(size=9_000).astype(np.float32), 3)
        jp = [jsk.hist_update(jsk.hist_init(64, -4.0, 4.0), c) for c in chunks]
        tp = [tsk.hist_update(tsk.hist_init(64, -4.0, 4.0, device=CPU), _t(c)) for c in chunks]
        for jst, tst in zip(jp, tp):
            _same_state(tst, jst, "part")
        left = tsk.hist_merge(tsk.hist_merge(tp[0], tp[1]), tp[2])
        right = tsk.hist_merge(tp[0], tsk.hist_merge(tp[1], tp[2]))
        _bitwise(left.counts, right.counts)
        _bitwise(tsk.hist_merge(tp[0], tp[1]).counts, tsk.hist_merge(tp[1], tp[0]).counts)
        _same_state(left, jsk.hist_merge(jsk.hist_merge(jp[0], jp[1]), jp[2]), "merged")
        v = _rng(31).normal(size=33).astype(np.float32) * 3
        _bitwise(tsk.hist_cdf(left, _t(v)), jsk.hist_cdf(jsk.hist_merge(jsk.hist_merge(jp[0], jp[1]), jp[2]), v), "cdf")
        _bitwise(tsk.hist_quantile(left, _t(QS)), jsk.hist_quantile(jsk.hist_merge(jsk.hist_merge(jp[0], jp[1]), jp[2]), QS))

    def test_reservoir_sample_set_commutative(self):
        data = _rng(4).normal(size=2_000).astype(np.float32)
        ja = jsk.reservoir_update(jsk.reservoir_init(64, seed=1), data[:1000])
        jb = jsk.reservoir_update(jsk.reservoir_init(64, seed=2), data[1000:])
        ta = tsk.reservoir_update(tsk.reservoir_init(64, seed=1, device=CPU), _t(data[:1000]))
        tb = tsk.reservoir_update(tsk.reservoir_init(64, seed=2, device=CPU), _t(data[1000:]))
        tab, tba = tsk.reservoir_merge(ta, tb), tsk.reservoir_merge(tb, ta)
        _same_state(tab, jsk.reservoir_merge(ja, jb), "ab")
        _same_state(tba, jsk.reservoir_merge(jb, ja), "ba")
        np.testing.assert_array_equal(np.sort(_np(tab.values)), np.sort(_np(tba.values)))
        assert int(tab.count) == int(tba.count) == 2_000
        vals, valid = tsk.reservoir_sample(tab)
        assert int(valid.sum()) == 64 and np.isin(_np(vals), data).all()

    def test_moments_associative_commutative_within_tolerance(self):
        data = _rng(5).normal(size=3_000).astype(np.float32) * 3 + 1
        jp = [jsk.moments_update(jsk.moments_init(()), c) for c in np.split(data, 3)]
        tp = [tsk.moments_update(tsk.moments_init((), device=CPU), _t(c)) for c in np.split(data, 3)]
        left = tsk.moments_merge(tsk.moments_merge(tp[0], tp[1]), tp[2])
        right = tsk.moments_merge(tp[0], tsk.moments_merge(tp[1], tp[2]))
        _same_state(left, jsk.moments_merge(jsk.moments_merge(jp[0], jp[1]), jp[2]), "left", (1e-6, 1e-6))
        np.testing.assert_allclose(float(tsk.moments_mean(left)), float(tsk.moments_mean(right)), rtol=1e-6)
        np.testing.assert_allclose(float(tsk.moments_variance(left)), float(tsk.moments_variance(right)), rtol=1e-5)
        np.testing.assert_allclose(float(tsk.moments_mean(left)), data.mean(), rtol=1e-5)
        np.testing.assert_allclose(float(tsk.moments_variance(left, ddof=1)), data.var(ddof=1), rtol=1e-4)
        np.testing.assert_allclose(
            _np(tsk.moments_std(left, ddof=1)), np.asarray(jsk.moments_std(jsk.moments_merge(jsk.moments_merge(jp[0], jp[1]), jp[2]), ddof=1)),
            rtol=1e-6,
        )

    def test_hll_exactly_associative_commutative_idempotent(self):
        chunks = np.split(np.arange(9_000, dtype=np.int32), 3)
        jp = [jsk.hll_update(jsk.hll_init(10), c) for c in chunks]
        tp = [tsk.hll_update(tsk.hll_init(10, device=CPU), _t(c)) for c in chunks]
        left = tsk.hll_merge(tsk.hll_merge(tp[0], tp[1]), tp[2])
        right = tsk.hll_merge(tp[0], tsk.hll_merge(tp[1], tp[2]))
        _same_state(left, jsk.hll_merge(jsk.hll_merge(jp[0], jp[1]), jp[2]), "left")
        _bitwise(left.registers, right.registers)
        _bitwise(tsk.hll_merge(tp[0], tp[1]).registers, tsk.hll_merge(tp[1], tp[0]).registers)
        _bitwise(tsk.hll_merge(tp[0], tp[0]).registers, tp[0].registers)
        assert int(left.count) == int(right.count) == 9_000
        np.testing.assert_allclose(_np(tsk.hll_cardinality(left)), np.asarray(jsk.hll_cardinality(jsk.hll_merge(jsk.hll_merge(jp[0], jp[1]), jp[2]))), rtol=1e-6)

    def test_hll_merge_equals_union_stream(self):
        a_data = np.arange(5_000, dtype=np.int32)
        b_data = np.arange(3_000, 8_000, dtype=np.int32)
        merged = tsk.hll_merge(tsk.hll_update(tsk.hll_init(12, device=CPU), _t(a_data)), tsk.hll_update(tsk.hll_init(12, device=CPU), _t(b_data)))
        union = tsk.hll_update(tsk.hll_init(12, device=CPU), _t(np.concatenate([a_data, b_data])))
        _bitwise(merged.registers, union.registers)
        _bitwise(union.registers, jsk.hll_update(jsk.hll_init(12), np.concatenate([a_data, b_data])).registers)

    def test_countmin_grid_exactly_associative_commutative(self):
        chunks = np.split(_rng(6).integers(0, 500, size=9_000).astype(np.int32), 3)
        jp = [jsk.cm_update(jsk.cm_init(4, 256, k=16), c) for c in chunks]
        tp = [tsk.cm_update(tsk.cm_init(4, 256, k=16, device=CPU), _t(c)) for c in chunks]
        for jst, tst in zip(jp, tp):
            _same_state(tst, jst, "part")
        left = tsk.cm_merge(tsk.cm_merge(tp[0], tp[1]), tp[2])
        right = tsk.cm_merge(tp[0], tsk.cm_merge(tp[1], tp[2]))
        _same_state(left, jsk.cm_merge(jsk.cm_merge(jp[0], jp[1]), jp[2]), "left")
        _same_state(right, jsk.cm_merge(jp[0], jsk.cm_merge(jp[1], jp[2])), "right")
        _bitwise(left.counts, right.counts)
        swapped = tsk.cm_merge(tp[1], tp[0])
        _bitwise(tsk.cm_merge(tp[0], tp[1]).counts, swapped.counts)
        _bitwise(tsk.cm_merge(tp[0], tp[1]).hh_keys, swapped.hh_keys)
        assert int(left.count) == int(right.count) == 9_000

    def test_mismatched_geometry_merges_refused(self):
        for jfn, tfn, (ja, jb), (ta, tb) in [
            (jsk.hll_merge, tsk.hll_merge, (jsk.hll_init(10), jsk.hll_init(12)), (tsk.hll_init(10, device=CPU), tsk.hll_init(12, device=CPU))),
            (jsk.cm_merge, tsk.cm_merge, (jsk.cm_init(4, 256), jsk.cm_init(4, 512)), (tsk.cm_init(4, 256, device=CPU), tsk.cm_init(4, 512, device=CPU))),
        ]:
            with pytest.raises(ValueError) as want:
                jfn(ja, jb)
            with pytest.raises(ValueError) as got:
                tfn(ta, tb)
            assert str(got.value) == str(want.value)


# ------------------------------------------------------- shape preservation


class TestJitShapePreservation:
    """update and merge keep every leaf's shape and dtype (the JAX test's
    ``jax.eval_shape``), and give the JAX package's states."""

    CASES = [
        ("kll", lambda d: tsk.kll_init(128, 12, device=d), lambda: jsk.kll_init(128, 12), "kll_update", "kll_merge", None),
        ("hist", lambda d: tsk.hist_init(32, -3.0, 3.0, device=d), lambda: jsk.hist_init(32, -3.0, 3.0), "hist_update", "hist_merge", None),
        ("reservoir", lambda d: tsk.reservoir_init(32, seed=0, device=d), lambda: jsk.reservoir_init(32, seed=0), "reservoir_update", "reservoir_merge", None),
        ("moments", lambda d: tsk.moments_init((), device=d), lambda: jsk.moments_init(()), "moments_update", "moments_merge", (1e-6, 1e-6)),
        ("hll", lambda d: tsk.hll_init(8, device=d), lambda: jsk.hll_init(8), "hll_update", "hll_merge", None),
        ("countmin", lambda d: tsk.cm_init(4, 128, k=8, device=d), lambda: jsk.cm_init(4, 128, k=8), "cm_update", "cm_merge", None),
    ]

    @staticmethod
    def _spec(state):
        return [(tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")) for leaf in state]

    @pytest.mark.parametrize("name,tinit,jinit,update,merge,tol", CASES, ids=[c[0] for c in CASES])
    def test_eval_shape_update_and_merge(self, name, tinit, jinit, update, merge, tol):
        state = tinit(CPU)
        batch = _rng(7).normal(size=500).astype(np.float32)
        out_update = getattr(tsk, update)(state, _t(batch))
        assert self._spec(out_update) == self._spec(state), f"{name}: update changed the state spec"
        assert self._spec(getattr(tsk, merge)(state, state)) == self._spec(state), f"{name}: merge changed the state spec"
        assert self._spec(state) == [(tuple(leaf.shape), str(leaf.dtype)) for leaf in jinit()]

    @pytest.mark.parametrize("name,tinit,jinit,update,merge,tol", CASES, ids=[c[0] for c in CASES])
    def test_jit_execution_matches_eager(self, name, tinit, jinit, update, merge, tol):
        batch = _rng(8).normal(size=500).astype(np.float32)
        tupd, tmerge = getattr(tsk, update), getattr(tsk, merge)
        jupd, jmerge = getattr(jsk, update), getattr(jsk, merge)
        got = tmerge(tupd(tinit(CPU), _t(batch)), tupd(tinit(CPU), _t(batch)))
        want = jax.jit(jmerge)(jax.jit(jupd)(jinit(), batch), jax.jit(jupd)(jinit(), batch))
        _same_state(got, want, name, tol)


# ------------------------------------------------------------- KLL error bound


def test_kll_rank_error_within_bound_1e6_stream():
    """A 1e6-point stream in 20 chunks: the port's state equals JAX's bitwise,
    and the measured rank error of every quantile stays under the bound."""
    eps = 0.01
    capacity, levels = tsk.kll_geometry(eps, max_n=2e6)
    assert (capacity, levels) == jsk.kll_geometry(eps, max_n=2e6)
    tstate, jstate = tsk.kll_init(capacity, levels, device=CPU), jsk.kll_init(capacity, levels)
    n = 1_000_000
    data = _rng(7).standard_normal(n).astype(np.float32)
    for chunk in np.split(data, 20):
        tstate = tsk.kll_update(tstate, _t(chunk))
        jstate = jsk.kll_update(jstate, chunk)
    _same_state(tstate, jstate, "1e6")
    assert int(tstate.count) == n and not bool(tstate.overflow)
    bound = float(tsk.kll_error_bound(tstate))
    assert bound <= eps * n
    data.sort()
    estimates = _np(tsk.kll_quantile(tstate, _t(QS)))
    _bitwise(estimates, jsk.kll_quantile(jstate, QS), "quantiles")
    for q, est in zip(QS, estimates):
        assert abs(np.searchsorted(data, est, side="right") - q * n) <= bound + 1
    assert float(tsk.kll_quantile(tstate, 0.0)) == data[0]
    assert float(tsk.kll_quantile(tstate, 1.0)) == data[-1]
    v = data[:: n // 17]
    _bitwise(tsk.kll_rank(tstate, _t(v)), jsk.kll_rank(jstate, v), "rank")
    _bitwise(tsk.kll_cdf(tstate, _t(v)), jsk.kll_cdf(jstate, v), "cdf")
    assert tsk.kll_state_bytes(tstate) == jsk.kll_state_bytes(jstate)


def test_kll_overflow_latches_and_voids_bound():
    tstate, jstate = tsk.kll_init(4, 2, device=CPU), jsk.kll_init(4, 2)
    for _ in range(8):
        tstate = tsk.kll_update(tstate, _t(np.arange(4, dtype=np.float32)))
        jstate = jsk.kll_update(jstate, np.arange(4, dtype=np.float32))
    _same_state(tstate, jstate)
    assert bool(tstate.overflow) and np.isinf(float(tsk.kll_error_bound(tstate)))


# ----------------------------------------------------- HLL / Count-Min bounds


def test_hll_cardinality_within_published_error_1e6_distinct():
    n = 1_000_000
    tstate, jstate = tsk.hll_init(12, device=CPU), jsk.hll_init(12)
    for chunk in np.split(np.arange(n, dtype=np.int32), 10):
        tstate = tsk.hll_update(tstate, _t(chunk))
        jstate = jsk.hll_update(jstate, chunk)
    _same_state(tstate, jstate, "1e6")
    est = float(tsk.hll_cardinality(tstate))
    np.testing.assert_allclose(est, float(jsk.hll_cardinality(jstate)), rtol=1e-6)
    bound = tsk.hll_error_bound(tstate)
    assert bound == pytest.approx(1.04 / 64.0)
    assert abs(est - n) / n <= 3 * bound
    again = tsk.hll_update(tstate, _t(np.arange(n // 2, dtype=np.int32)))
    assert float(tsk.hll_cardinality(again)) == est
    assert int(again.count) == n + n // 2


def test_hll_linear_counting_small_range_exact_ish():
    for n in (10, 100, 1_000):
        tstate = tsk.hll_update(tsk.hll_init(12, device=CPU), _t(np.arange(n, dtype=np.int32)))
        est = float(tsk.hll_cardinality(tstate))
        np.testing.assert_allclose(est, float(jsk.hll_cardinality(jsk.hll_update(jsk.hll_init(12), np.arange(n, dtype=np.int32)))), rtol=1e-6)
        assert abs(est - n) <= max(2.0, 0.02 * n)


def test_countmin_point_query_upper_bound_property():
    data = _rng(42).zipf(1.3, size=50_000).astype(np.int32) % 10_000
    tstate, jstate = tsk.cm_init(4, 1024, k=16, device=CPU), jsk.cm_init(4, 1024, k=16)
    for chunk in np.split(data, 10):
        tstate = tsk.cm_update(tstate, _t(chunk))
        jstate = jsk.cm_update(jstate, chunk)
    _same_state(tstate, jstate, "cm")
    universe = np.unique(data)
    truth = np.bincount(data, minlength=10_000)[universe]
    ests = _np(tsk.cm_point_query(tstate, _t(universe)))
    _bitwise(ests, jsk.cm_point_query(jstate, universe), "point")
    assert (ests >= truth).all()
    assert float(np.max(ests - truth)) <= tsk.cm_error_bound(tstate) == jsk.cm_error_bound(jstate)


def test_countmin_heavy_hitters_find_hot_keys():
    rng = _rng(3)
    background = rng.integers(100, 50_000, size=20_000).astype(np.int32)
    hot = np.repeat(np.arange(5, dtype=np.int32), 4_000)
    data = rng.permutation(np.concatenate([background, hot])).astype(np.int32)
    tstate = tsk.cm_update(tsk.cm_init(4, 2048, k=8, device=CPU), _t(data))
    jstate = jsk.cm_update(jsk.cm_init(4, 2048, k=8), data)
    _same_state(tstate, jstate, "cm")
    keys, counts = tsk.cm_heavy_hitters(tstate)
    for got, want in zip((keys, counts), jsk.cm_heavy_hitters(jstate)):
        _bitwise(got, want, "heavy hitters")
    assert set(_np(keys)[:5].tolist()) == set(range(5))
    for c in _np(counts)[:5]:
        assert 4_000 <= int(c) <= 4_000 + tsk.cm_error_bound(tstate)


# ----------------------------------------------------- Quantile/Median metrics


def test_quantile_metric_property_suite():
    """Below capacity the sketch is exact: streaming equals single-shot;
    forward returns each batch's own value; a clone and a pickle are
    independent; reset restores the default; the emulated 8-rank sharded
    fold equals JAX's 8-device ``ShardedMetric`` bitwise."""
    batches = [_rng(10 + i).normal(size=64).astype(np.float32) for i in range(3)]
    kw = {"q": 0.5, "capacity": 512, "levels": 12}
    stream, single = T.Quantile(device=CPU, **kw), T.Quantile(device=CPU, **kw)
    jm = J.Quantile(**kw)
    for b in batches:
        _bitwise(stream(_t(b)), jm(b), "forward")
    single.update(_t(np.concatenate(batches)))
    _bitwise(stream.compute(), single.compute(), "streaming == single shot")
    _bitwise(stream.compute(), jm.compute(), "value")
    clone = stream.clone()
    clone.update(_t(batches[0]))
    assert int(stream.sketch.count) == 192 and int(clone.sketch.count) == 256
    restored = pickle.loads(pickle.dumps(stream))
    _bitwise(restored.compute(), stream.compute(), "pickle")
    assert hash(restored) == hash(stream)
    stream.reset()
    _same_state(stream.sketch, J.Quantile(**kw).sketch, "reset")
    sharded, jsharded = T.Quantile(device=CPU, **kw), JSharded(J.Quantile(**kw), Mesh(np.array(jax.devices()[:8]), ("data",)))
    for b in batches:
        _emulated_sharded_update(sharded, [b])
        jsharded.update(b)
    _same_state(sharded.sketch, jsharded.sketch, "sharded")
    _bitwise(sharded.compute(), single.compute(), "sharded == plain")


def test_median_matches_numpy_order_statistic():
    data = _rng(11).normal(size=501).astype(np.float32)
    m, jm = T.Median(capacity=1024, device=CPU), J.Median(capacity=1024)
    m.update(_t(data))
    jm.update(data)
    want = np.sort(data)[int(np.ceil(0.5 * data.size)) - 1]
    assert float(m.compute()) == float(want)
    _bitwise(m.compute(), jm.compute())


def test_quantile_vector_q_and_error_bound():
    data = _rng(12).normal(size=40_000).astype(np.float32)
    m, jm = T.Quantile(q=[0.1, 0.5, 0.9], capacity=256, levels=14, device=CPU), J.Quantile(q=[0.1, 0.5, 0.9], capacity=256, levels=14)
    for chunk in np.split(data, 8):
        m.update(_t(chunk))
        jm.update(chunk)
    est = _np(m.compute())
    _bitwise(est, jm.compute(), "values")
    bound = float(m.error_bound())
    _bitwise(m.error_bound(), jm.error_bound(), "bound")
    assert np.isfinite(bound) and bound > 0
    for q, e in zip([0.1, 0.5, 0.9], est):
        assert abs((data <= e).sum() - q * data.size) <= bound + 1


def test_quantile_invalid_q_raises():
    with pytest.raises(ValueError) as want:
        J.Quantile(q=1.5)
    with pytest.raises(ValueError) as got:
        T.Quantile(q=1.5, device=CPU)
    assert str(got.value) == str(want.value) and "in [0, 1]" in str(got.value)


def test_quantile_nan_strategy_ignore():
    """Eager 'ignore' drops NaNs on the host; inside a fused plan's step it
    raises, as JAX raises under trace."""
    vals = np.asarray([1.0, np.nan, 2.0, 3.0, np.nan], np.float32)
    m, jm = T.Quantile(q=0.5, capacity=512, nan_strategy="ignore", device=CPU), J.Quantile(q=0.5, capacity=512, nan_strategy="ignore")
    m.update(_t(vals))
    jm.update(vals)
    assert int(m.sketch.count) == 3 and float(m.compute()) == 2.0
    _same_state(m.sketch, jm.sketch)
    step, state = make_jit_update(T.Quantile(q=0.5, capacity=512, nan_strategy="ignore", device=CPU))
    jstep, jstate = j_make_jit_update(J.Quantile(q=0.5, capacity=512, nan_strategy="ignore"))
    with pytest.raises(ValueError):
        jstep(jstate, vals)
    # JAX's update rollback unpacks the KLL state as a (list, length) pair, so
    # its ValueError reads "too many values to unpack"; the port raises the
    # refusal JAX's Quantile means to raise
    with pytest.raises(ValueError, match="cannot run inside a traced update"):
        step(state, _t(vals))


def test_quantile_merge_sync_equals_pairwise_merge():
    """A two-rank replica sync through an emulated gather: the synced sketch
    is the pairwise merge of both ranks', and unsync restores the local one."""
    data = _rng(13).normal(size=8_000).astype(np.float32)
    m0, m1 = (T.Quantile(q=0.5, capacity=256, levels=14, device=CPU) for _ in range(2))
    j0, j1 = (J.Quantile(q=0.5, capacity=256, levels=14) for _ in range(2))
    m0.update(_t(data[:5_000]))
    m1.update(_t(data[5_000:]))
    j0.update(data[:5_000])
    j1.update(data[5_000:])
    expected = tsk.kll_merge(m0.sketch, m1.sketch)
    leaf_iter, jleaf_iter = iter(list(m1.sketch)), iter(jax.tree_util.tree_leaves(j1.sketch))
    m0.sync(dist_sync_fn=lambda value, group=None: [value, next(leaf_iter)], distributed_available=lambda: True)
    j0.sync(dist_sync_fn=lambda value, group=None: [value, next(jleaf_iter)], distributed_available=lambda: True)
    for got, want in zip(m0.sketch, expected):
        _bitwise(got, want)
    _same_state(m0.sketch, j0.sketch, "synced")
    assert int(m0.sketch.count) == 8_000
    m0.unsync()
    assert int(m0.sketch.count) == 5_000


def test_quantile_corrupt_merge_payload_raises_syncerror_naming_rank():
    m = T.Quantile(q=0.5, capacity=256, sync_config=SyncConfig(retries=0), device=CPU)
    m.update(_t(_rng(14).normal(size=1_000).astype(np.float32)))
    before = int(m.sketch.count)
    with faults.inject(faults.Fault("corrupt", "sync.sketch_state", arg=1, count=1)):
        with pytest.raises(SyncError, match="rank 1") as err:
            m.sync(dist_sync_fn=lambda value, group=None: [value, value], distributed_available=lambda: True)
    assert "sketch" in str(err.value)
    assert not m._is_synced and int(m.sketch.count) == before


def test_quantile_jitted_update_loop():
    """make_jit_update: the streaming loop with the sketch riding the state
    dict; fold_jit_state restores it; equal to JAX's step and to eager updates."""
    data = _rng(15).normal(size=16_000).astype(np.float32)
    metric, jmetric = T.Quantile(q=0.5, capacity=256, levels=14, device=CPU), J.Quantile(q=0.5, capacity=256, levels=14)
    step, state = make_jit_update(metric)
    jstep, jstate = j_make_jit_update(jmetric)
    for chunk in np.split(data, 8):
        state = step(state, _t(chunk))
        jstate = jstep(jstate, chunk)
    fold_jit_state(metric, state)
    j_fold_jit_state(jmetric, jstate)
    assert metric._update_count == 8 and int(metric.sketch.count) == data.size
    _same_state(metric.sketch, jmetric.sketch, "step")
    eager = T.Quantile(q=0.5, capacity=256, levels=14, device=CPU)
    for chunk in np.split(data, 8):
        eager.update(_t(chunk))
    _same_state(metric.sketch, eager.sketch, "step == eager")
    _bitwise(metric.compute(), eager.compute())


def test_quantile_sharded_compacting_regime_within_bound():
    """With real compactions the sharded and replicated answers may differ,
    inside the summed bound; the emulated 8-rank fold equals JAX's 8-device
    one bitwise."""
    data = _rng(16).normal(size=16_000).astype(np.float32)
    plain = T.Quantile(q=QS, capacity=128, levels=14, device=CPU)
    shard = T.Quantile(q=QS, capacity=128, levels=14, device=CPU)
    jshard = JSharded(J.Quantile(q=QS, capacity=128, levels=14), Mesh(np.array(jax.devices()[:8]), ("data",)))
    for chunk in np.split(data, 4):
        plain.update(_t(chunk))
        _emulated_sharded_update(shard, [chunk])
        jshard.update(chunk)
    _same_state(shard.sketch, jshard.sketch, "sharded")
    bound = float(plain.error_bound()) + float(shard.error_bound())
    for a, b in zip(_np(plain.compute()), _np(shard.compute())):
        assert abs((data <= a).sum() - (data <= b).sum()) <= bound + 2


def test_add_state_merge_contract_errors():
    m, jm = T.MeanMetric(device=CPU), J.MeanMetric()
    for name, tdefault, jdefault, red in [
        ("bad", torch.zeros(3), jnp.zeros(3), "merge"),
        ("bad2", tsk.kll_init(32, 4, device=CPU), jsk.kll_init(32, 4), "sum"),
        ("bad3", torch.zeros(3), jnp.zeros(3), "avg"),
    ]:
        with pytest.raises(ValueError) as want:
            jm.add_state(name, jdefault, dist_reduce_fx=red)
        with pytest.raises(ValueError) as got:
            m.add_state(name, tdefault, dist_reduce_fx=red)
        want_text = str(want.value).replace("ArrayImpl", "Tensor").replace("pytree", "state")
        assert str(got.value).replace("torchmetrics_tpu_torch", "torchmetrics_tpu") == want_text


# test_obs_counters_cover_host_merges: the sketch obs counters and the merge
# span wait for ROADMAP A12 (the port has no tracing plane yet).


# -------------------------------------------------------- bounded Spearman


def test_bounded_spearman_matches_exact_within_tolerance():
    n = 12_000
    rng = _rng(11)
    x = rng.standard_normal(n).astype(np.float32)
    for rho_target in (0.9, -0.5):
        y = (rho_target * x + np.sqrt(max(1 - rho_target**2, 1e-6)) * rng.standard_normal(n)).astype(np.float32)
        exact, bounded, jbounded = T.SpearmanCorrCoef(device=CPU), T.SpearmanCorrCoef(num_bins=64, device=CPU), J.SpearmanCorrCoef(num_bins=64)
        for i in range(6):
            sl = slice(i * 2_000, (i + 1) * 2_000)
            exact.update(_t(x[sl]), _t(y[sl]))
            bounded.update(_t(x[sl]), _t(y[sl]))
            jbounded.update(x[sl], y[sl])
        _bitwise(bounded.joint, jbounded.joint, "joint")
        np.testing.assert_allclose(float(bounded.compute()), float(jbounded.compute()), rtol=1e-5)
        assert abs(float(exact.compute()) - float(bounded.compute())) <= 0.05


def test_bounded_spearman_monotone_transform_invariance():
    n = 8_000
    rng = _rng(12)
    x = rng.standard_normal(n).astype(np.float32)
    y = (0.7 * x + 0.5 * rng.standard_normal(n)).astype(np.float32)
    plain, warped = T.SpearmanCorrCoef(num_bins=64, device=CPU), T.SpearmanCorrCoef(num_bins=64, device=CPU)
    plain.update(_t(x), _t(y))
    warped.update(_t(np.exp(x)), _t(np.tanh(y) * 7))
    assert abs(float(plain.compute()) - float(warped.compute())) <= 0.02
    jwarped = J.SpearmanCorrCoef(num_bins=64)
    jwarped.update(np.exp(x), np.tanh(y) * 7)
    _bitwise(warped.joint, jwarped.joint, "joint")


def test_bounded_spearman_sharded_equals_replicated():
    n = 4_000
    rng = _rng(13)
    x = rng.standard_normal(n).astype(np.float32)
    y = (0.6 * x + 0.6 * rng.standard_normal(n)).astype(np.float32)
    plain, shard = T.SpearmanCorrCoef(num_bins=32, device=CPU), T.SpearmanCorrCoef(num_bins=32, device=CPU)
    jshard = JSharded(J.SpearmanCorrCoef(num_bins=32), Mesh(np.array(jax.devices()[:8]), ("data",)))
    for i in range(2):
        sl = slice(i * 2_000, (i + 1) * 2_000)
        plain.update(_t(x[sl]), _t(y[sl]))
        _emulated_sharded_update(shard, [x[sl], y[sl]])
        jshard.update(x[sl], y[sl])
    _bitwise(shard.joint, jshard.joint, "joint")
    _same_state(shard.preds_sketch, jshard.preds_sketch, "preds sketch")
    assert abs(float(plain.compute()) - float(shard.compute())) <= 0.03
    assert tuple(plain.joint.shape) == (32, 32)


def test_bounded_spearman_rejects_multioutput():
    with pytest.raises(ValueError) as want:
        J.SpearmanCorrCoef(num_outputs=3, num_bins=32)
    with pytest.raises(ValueError, match="num_outputs=1") as got:
        T.SpearmanCorrCoef(num_outputs=3, num_bins=32, device=CPU)
    assert str(got.value) == str(want.value)


def test_bounded_spearman_exact_mode_unchanged():
    from scipy import stats

    rng = _rng(14)
    x = rng.standard_normal(500).astype(np.float32)
    y = (0.5 * x + rng.standard_normal(500)).astype(np.float32)
    m = T.SpearmanCorrCoef(device=CPU)
    m.update(_t(x), _t(y))
    assert isinstance(m.preds, list)
    np.testing.assert_allclose(float(m.compute()), stats.spearmanr(x, y).statistic, atol=1e-5)


def test_quantile_explicit_capacity_sizes_levels_from_it():
    m = T.Quantile(q=0.5, capacity=256, device=CPU)
    levels, cap = m.sketch.items.shape
    assert (levels, cap) == tuple(J.Quantile(q=0.5, capacity=256).sketch.items.shape)
    assert cap == 256 and cap * 2 ** (levels - 1) >= 1e8
    assert tuple(T.Quantile(device=CPU).sketch.items.shape) == (18, 2048)


def test_kll_init_rejects_count_wrapping_geometry():
    for tfn, jfn in [(lambda: tsk.kll_init(2048, 24, device=CPU), lambda: jsk.kll_init(2048, 24)),
                     (lambda: tsk.kll_geometry(0.01, max_n=1e10), lambda: jsk.kll_geometry(0.01, max_n=1e10))]:
        with pytest.raises(ValueError) as want:
            jfn()
        with pytest.raises(ValueError, match="int32") as got:
            tfn()
        assert str(got.value) == str(want.value)


def test_moments_count_is_exact_int():
    tstate, jstate = tsk.moments_init((), device=CPU), jsk.moments_init(())
    assert tstate.count.dtype == torch.int32
    for v in range(5):
        tstate = tsk.moments_update(tstate, torch.tensor(float(v)))
        jstate = jsk.moments_update(jstate, np.float32(v))
    assert int(tstate.count) == 5
    _same_state(tstate, jstate, "moments", (1e-6, 1e-6))
    np.testing.assert_allclose(float(tsk.moments_mean(tstate)), 2.0, rtol=1e-6)


def test_reservoir_rank_decorrelates_tags():
    data = _rng(15).normal(size=200).astype(np.float32)
    r0 = tsk.reservoir_update(tsk.reservoir_init(100, seed=0, rank=0, device=CPU), _t(data))
    r1 = tsk.reservoir_update(tsk.reservoir_init(100, seed=0, rank=1, device=CPU), _t(data))
    assert not np.array_equal(_np(r0.tags), _np(r1.tags))
    _same_state(r1, jsk.reservoir_update(jsk.reservoir_init(100, seed=0, rank=1), data), "rank 1")
    same = tsk.reservoir_update(tsk.reservoir_init(100, seed=0, rank=0, device=CPU), _t(data))
    _bitwise(r0.tags, same.tags)


# ------------------------------------------------- across the two packages


CROSS = [
    ("kll", lambda: T.Quantile(q=[0.25, 0.75], capacity=128, levels=14, device=CPU), lambda: J.Quantile(q=[0.25, 0.75], capacity=128, levels=14), jsk.kll_merge, "float"),
    ("hist", lambda: tdrift.DriftScore(_t(np.linspace(0, 1, 500, dtype=np.float32)), bins=16, device=CPU),
     lambda: jdrift.DriftScore(np.linspace(0, 1, 500, dtype=np.float32), bins=16), jsk.hist_merge, "float"),
    ("hll", lambda: tdrift.Cardinality(precision=8, device=CPU), lambda: jdrift.Cardinality(precision=8), jsk.hll_merge, "int"),
    ("countmin", lambda: tdrift.HeavyHitters(depth=4, width=128, k=8, device=CPU), lambda: jdrift.HeavyHitters(depth=4, width=128, k=8), jsk.cm_merge, "int"),
]


@pytest.mark.parametrize("name,tmake,jmake,jmerge,kind", CROSS, ids=[c[0] for c in CROSS])
def test_a_jax_state_merged_with_a_port_state_equals_the_jax_merge(name, tmake, jmake, jmerge, kind):
    """A JAX state (through its checkpoint) merged into a port state, by the
    port's sync, equals JAX's merge of the two; and the other way round."""
    rng = _rng(17)
    a = (rng.random(600) * 1.2).astype(np.float32) if kind == "float" else rng.integers(0, 300, 600).astype(np.int32)
    b = (rng.random(700) * 1.2).astype(np.float32) if kind == "float" else rng.integers(100, 400, 700).astype(np.int32)
    tm_, jm_ = tmake(), jmake()
    tm_.update(_t(a))
    jm_.update(jnp.asarray(b))
    state = next(iter(tm_._reductions))
    jm_a = jmake()
    jm_a.update(jnp.asarray(a))
    want = jmerge(getattr(jm_a, state), getattr(jm_, state))
    # the JAX metric's state crosses through its checkpoint into a port metric
    peer = tmake()
    peer.load_checkpoint(pickle.loads(pickle.dumps(jm_.save_checkpoint())))
    leaves = iter(list(getattr(peer, state)))
    tm_.sync(dist_sync_fn=lambda value, group=None: [value, next(leaves)], distributed_available=lambda: True)
    _same_state(getattr(tm_, state), want, name)
    tm_.unsync()
    # and back: the port's merged state restores into a JAX metric leaf for leaf
    tm_.sync(dist_sync_fn=lambda value, group=None: [value, value], distributed_available=lambda: True)
    back = jmake()
    back.load_checkpoint(pickle.loads(pickle.dumps(tm_.save_checkpoint())))
    _same_state(getattr(tm_, state), getattr(back, state), name + " back")
    tm_.unsync()


def test_a_failed_update_rolls_a_sketch_state_back():
    """An update that raises restores the sketch state it replaced and the
    count (a sketch state is a NamedTuple, not a list state's snapshot)."""

    class _Failing(T.Quantile):
        def update(self, value, fail=False):
            super().update(value)
            if fail:
                raise RuntimeError("update failed half way")

    m = _Failing(capacity=64, levels=10, device=CPU)
    m.update(torch.randn(100))
    before = m.sketch
    with pytest.raises(RuntimeError, match="half way"):
        m.update(torch.randn(10), fail=True)
    assert m.sketch is before and m._update_count == 1 and int(m.sketch.count) == 100
