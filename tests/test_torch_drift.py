# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's drift family against the JAX package's, on the CPU: the
counterparts of ``tests/unittests/drift/test_drift.py`` on the same seeded
numpy inputs, plus references read across the packages' checkpoints.

Budgets: histograms, HyperLogLog registers and the Count-Min table are
bitwise; PSI and KL within ``rtol=1e-5`` (a sum of logs, added in another
order than XLA's); KS within ``atol=1e-7`` plus one float32 ulp of its
value (``rtol=2**-23``): XLA's CPU cumsum is a rewritten reduce-window whose
association torch's sequential ``cumsum`` does not reproduce, and near 1.0
one ulp (1.19e-7) exceeds 1e-7; HyperLogLog's cardinality within
``rtol=1e-6``.

``test_sliced_plan_scores_cohorts_in_one_dispatch``'s counterpart is in
``tests/test_torch_sliced.py`` beside the rest of the sliced plane.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu import drift as jdr
from torchmetrics_tpu import sketch as jsk
from torchmetrics_tpu.drift.metrics import reference_from_checkpoint as j_reference_from_checkpoint
from torchmetrics_tpu_torch import drift as tdr
from torchmetrics_tpu_torch import sketch as tsk
from torchmetrics_tpu_torch.drift.metrics import reference_from_checkpoint

CPU = "cpu"
PSI_RTOL, KS_ATOL, KS_RTOL = 1e-5, 1e-7, 2.0**-23


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    return np.ascontiguousarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _hists(data, bins=32, lo=-4.0, hi=4.0):
    data = np.asarray(data, np.float32)
    j = jsk.hist_update(jsk.hist_init(bins, lo, hi), jnp.asarray(data))
    t = tsk.hist_update(tsk.hist_init(bins, lo, hi, device=CPU), _t(data))
    for field, got, want in zip(j._fields, t, j):
        assert np.array_equal(_np(got), _np(want)) and _np(got).dtype == _np(want).dtype, field
    return j, t


def _same_scores(got, want):
    np.testing.assert_allclose(float(got.psi), float(want.psi), rtol=PSI_RTOL)
    np.testing.assert_allclose(float(got.kl), float(want.kl), rtol=PSI_RTOL)
    np.testing.assert_allclose(float(got.ks), float(want.ks), rtol=KS_RTOL, atol=KS_ATOL)


def _same_gauges(got, want):
    assert set(got) == set(want) and got["severity"] == want["severity"]
    for k in ("psi", "kl"):
        np.testing.assert_allclose(got[k], want[k], rtol=PSI_RTOL)
    np.testing.assert_allclose(got["ks"], want["ks"], rtol=KS_RTOL, atol=KS_ATOL)


# ------------------------------------------------------------------- scores


class TestDriftScores:
    def test_identical_windows_score_near_zero(self):
        data = _rng(1).normal(size=20_000).astype(np.float32)
        (jref, tref), (jlive, tlive) = _hists(data[:10_000]), _hists(data[10_000:])
        s = tdr.drift_scores(tref, tlive)
        _same_scores(s, jdr.drift_scores(jref, jlive))
        assert 0.0 <= float(s.psi) < 0.02 and 0.0 <= float(s.ks) < 0.02
        assert float(s.kl) == pytest.approx(float(s.psi) / 2)

    def test_shifted_window_scores_large(self):
        (jref, tref), (jlive, tlive) = _hists(_rng(2).normal(size=10_000)), _hists(_rng(3).normal(loc=2.0, size=10_000))
        s = tdr.drift_scores(tref, tlive)
        _same_scores(s, jdr.drift_scores(jref, jlive))
        assert float(s.psi) > 0.25 and float(s.ks) > 0.3

    def test_individual_functions_match_bundle(self):
        (jref, tref), (jlive, tlive) = _hists(_rng(4).normal(size=5_000)), _hists(_rng(5).normal(loc=0.5, size=5_000))
        s = tdr.drift_scores(tref, tlive)
        np.testing.assert_allclose(float(tdr.psi_score(tref, tlive)), float(jdr.psi_score(jref, jlive)), rtol=PSI_RTOL)
        np.testing.assert_allclose(float(tdr.symmetric_kl(tref, tlive)), float(jdr.symmetric_kl(jref, jlive)), rtol=PSI_RTOL)
        np.testing.assert_allclose(float(tdr.ks_statistic(tref, tlive)), float(jdr.ks_statistic(jref, jlive)), rtol=KS_RTOL, atol=KS_ATOL)
        assert float(tdr.psi_score(tref, tlive)) == pytest.approx(float(s.psi))
        assert float(tdr.symmetric_kl(tref, tlive)) == pytest.approx(float(s.kl))
        assert float(tdr.ks_statistic(tref, tlive)) == pytest.approx(float(s.ks))

    def test_empty_window_policy_is_zero_not_max(self):
        _, ref = _hists(_rng(6).normal(size=1_000))
        empty = tsk.hist_init(32, -4.0, 4.0, device=CPU)
        for a, b in ((ref, empty), (empty, ref), (empty, empty)):
            s = tdr.drift_scores(a, b)
            assert float(s.psi) == float(s.kl) == float(s.ks) == 0.0
            assert float(tdr.psi_score(a, b)) == float(tdr.ks_statistic(a, b)) == 0.0

    def test_out_of_range_mass_is_drift_signal(self):
        (jref, tref), (jlive, tlive) = _hists(_rng(7).normal(size=10_000)), _hists(_rng(8).normal(loc=10.0, size=10_000))
        s = tdr.drift_scores(tref, tlive)
        _same_scores(s, jdr.drift_scores(jref, jlive))
        assert float(s.psi) > 1.0 and float(s.ks) > 0.9

    def test_mismatched_edges_refused(self):
        with pytest.raises(ValueError) as want:
            jdr.psi_score(_hists([], bins=32)[0], _hists([], bins=64)[0])
        with pytest.raises(ValueError, match="identical bin edges") as got:
            tdr.psi_score(_hists([], bins=32)[1], _hists([], bins=64)[1])
        assert str(got.value) == str(want.value)

    def test_scores_are_jit_safe(self):
        """The JAX test jits the scores; the port's counterpart: the scores
        read nothing back to the host (they run under a fused plan's step)
        and equal JAX's jitted ones."""
        (jref, tref), (jlive, tlive) = _hists(_rng(9).normal(size=2_000)), _hists(_rng(10).normal(loc=1.0, size=2_000))
        _same_scores(tdr.drift_scores(tref, tlive), jax.jit(jdr.drift_scores)(jref, jlive))


# ---------------------------------------------------------------- DriftScore


def _pair(**kw):
    kw.setdefault("reference", _rng(100).normal(size=20_000).astype(np.float32))
    kw.setdefault("bins", 32)
    kw.setdefault("lo", -4.0)
    kw.setdefault("hi", 4.0)
    kw.setdefault("distributed_available_fn", lambda: False)
    tkw = dict(kw, device=CPU)
    if not isinstance(tkw["reference"], (tsk.HistogramSketch, type(None))):
        tkw["reference"] = _t(tkw["reference"])
    return tdr.DriftScore(**tkw), jdr.DriftScore(**kw)


def _update_both(t, j, x):
    t.update(_t(x))
    j.update(jnp.asarray(np.asarray(x, np.float32)))


class TestDriftScoreMetric:
    def test_in_distribution_stream_stays_ok(self):
        t, j = _pair(patience=1)
        for i in range(5):
            _update_both(t, j, _rng(20 + i).normal(size=2_000))
            _same_gauges(t.serve_gauges(), j.serve_gauges())
        assert t.severity() == 0 == j.severity()
        g = t.serve_gauges()
        assert set(g) == {"psi", "kl", "ks", "severity"} and g["psi"] < 0.1 and g["severity"] == 0.0

    def test_severity_needs_patience_then_recovers_immediately(self):
        t, j = _pair(patience=3, thresholds={"psi": (0.1, 0.25)})
        drifted = _rng(30).normal(loc=3.0, size=2_000).astype(np.float32)
        severities = []
        for _ in range(3):
            _update_both(t, j, drifted)
            assert t.severity() == j.severity()
            severities.append(t.severity())
        assert severities == [0, 0, 2]
        t.reset()
        j.reset()
        _update_both(t, j, _rng(31).normal(size=2_000))
        assert t.severity() == 0 == j.severity()

    def test_warn_band_maps_to_severity_one(self):
        t, j = _pair(patience=1, thresholds={"ks": (0.05, 0.9)})
        _update_both(t, j, _rng(32).normal(loc=0.3, size=4_000))
        assert t.severity() == 1 == j.severity()

    def test_compute_returns_scores_namedtuple(self):
        t, j = _pair()
        _update_both(t, j, _rng(33).normal(loc=2.0, size=4_000))
        s = t.compute()
        assert isinstance(s, tdr.DriftScores) and float(s.psi) > 0.25
        _same_scores(s, j.compute())

    def test_reference_is_required_and_exclusive(self):
        cases = [
            ({}, {}),
            ({"reference": [0.5], "reference_checkpoint": {"metrics": {}}}, {"reference": [0.5], "reference_checkpoint": {"metrics": {}}}),
        ]
        for jkw, tkw in cases:
            with pytest.raises(ValueError) as want:
                jdr.DriftScore(**jkw)
            with pytest.raises(ValueError) as got:
                tdr.DriftScore(device=CPU, **tkw)
            assert str(got.value) == str(want.value)
        for kw in ({"thresholds": {"mmd": 0.1}}, {"patience": 0}):
            with pytest.raises(ValueError) as want:
                _pair(**kw)
            with pytest.raises(ValueError) as got:
                tdr.DriftScore(reference=_t([0.5]), device=CPU, **kw)
            assert str(got.value) == str(want.value)

    def test_reference_from_checkpoint_roundtrip(self):
        """A checkpoint pins the reference, in each package from either
        package's checkpoint; scores agree with the directly pinned one."""
        t, j = _pair(patience=1)
        ref_data = _rng(34).normal(size=10_000).astype(np.float32)
        _update_both(t, j, ref_data)
        for payload in (pickle.loads(pickle.dumps(t.save_checkpoint())), pickle.loads(pickle.dumps(j.save_checkpoint()))):
            ref = reference_from_checkpoint(payload, state_name="live", device=CPU)
            assert isinstance(ref, tsk.HistogramSketch)
            jref = j_reference_from_checkpoint(payload, state_name="live")
            for got, want in zip(ref, jref):
                assert np.array_equal(_np(got), _np(want)) and _np(got).dtype == _np(want).dtype
            m = tdr.DriftScore(reference_checkpoint=payload, reference_state="live", patience=1, distributed_available_fn=lambda: False, device=CPU)
            jm = jdr.DriftScore(reference_checkpoint=payload, reference_state="live", patience=1, distributed_available_fn=lambda: False)
            _update_both(m, jm, ref_data)
            assert float(m.compute().psi) < 1e-3
            _same_scores(m.compute(), jm.compute())
        for bad in ({"metrics": {"": {"state": {}}}}, {}):
            with pytest.raises(ValueError) as want:
                j_reference_from_checkpoint(bad)
            with pytest.raises(ValueError) as got:
                reference_from_checkpoint(bad, device=CPU)
            assert str(got.value) == str(want.value)

    def test_checkpoint_roundtrip_preserves_live_window(self):
        reference = _rng(35).normal(size=20_000).astype(np.float32)
        t, j = _pair(reference=reference, patience=1)
        _update_both(t, j, _rng(36).normal(loc=2.0, size=4_000))
        before = float(t.compute().psi)
        for ck in (t.save_checkpoint(), j.save_checkpoint()):
            fresh, _ = _pair(reference=reference, patience=1)
            fresh.load_checkpoint(pickle.loads(pickle.dumps(ck)))
            assert float(fresh.compute().psi) == pytest.approx(before)
        jfresh = _pair(reference=reference, patience=1)[1]
        jfresh.load_checkpoint(pickle.loads(pickle.dumps(t.save_checkpoint())))
        _same_scores(t.compute(), jfresh.compute())

    def test_merge_sync_pools_live_windows(self):
        (t0, j0), (t1, j1) = _pair(), _pair()
        _update_both(t0, j0, _rng(37).normal(size=3_000))
        _update_both(t1, j1, _rng(38).normal(size=5_000))
        leaves, jleaves = iter(list(t1.live)), iter(jax.tree_util.tree_leaves(j1.live))
        t0.sync(dist_sync_fn=lambda value, group=None: [value, next(leaves)], distributed_available=lambda: True)
        j0.sync(dist_sync_fn=lambda value, group=None: [value, next(jleaves)], distributed_available=lambda: True)
        assert int(t0.live.count) == 8_000
        for got, want in zip(t0.live, j0.live):
            assert np.array_equal(_np(got), _np(want))
        t0.unsync()
        assert int(t0.live.count) == 3_000


# ------------------------------------------------- Cardinality / HeavyHitters


def _card_pair(precision):
    return tdr.Cardinality(precision=precision, distributed_available_fn=lambda: False, device=CPU), jdr.Cardinality(
        precision=precision, distributed_available_fn=lambda: False
    )


class TestCardinality:
    def test_estimate_within_published_bound(self):
        t, j = _card_pair(12)
        n = 100_000
        for chunk in np.split(np.arange(n, dtype=np.int32), 4):
            t.update(torch.from_numpy(chunk))
            j.update(chunk)
        assert np.array_equal(_np(t.sketch.registers), _np(j.sketch.registers))
        est = float(t.compute())
        np.testing.assert_allclose(est, float(j.compute()), rtol=1e-6)
        assert abs(est - n) / n <= 3 * t.error_bound() and t.error_bound() == j.error_bound()
        assert t.serve_gauges()["cardinality"] == pytest.approx(est)

    def test_duplicates_do_not_inflate(self):
        t, _ = _card_pair(10)
        tags = torch.arange(500, dtype=torch.int32)
        t.update(tags)
        first = float(t.compute())
        t.update(tags)
        assert float(t.compute()) == first

    def test_merge_sync_counts_union_distinct(self):
        (t0, j0), (t1, j1) = _card_pair(12), _card_pair(12)
        for t, j, data in ((t0, j0, np.arange(0, 6_000, dtype=np.int32)), (t1, j1, np.arange(4_000, 10_000, dtype=np.int32))):
            t.update(torch.from_numpy(data))
            j.update(data)
        leaves, jleaves = iter(list(t1.sketch)), iter(jax.tree_util.tree_leaves(j1.sketch))
        t0.sync(dist_sync_fn=lambda value, group=None: [value, next(leaves)], distributed_available=lambda: True)
        j0.sync(dist_sync_fn=lambda value, group=None: [value, next(jleaves)], distributed_available=lambda: True)
        assert np.array_equal(_np(t0.sketch.registers), _np(j0.sketch.registers))
        est = float(tsk.hll_cardinality(t0.sketch))
        assert abs(est - 10_000) / 10_000 <= 3 * t0.error_bound()
        t0.unsync()
        assert int(t0.sketch.count) == 6_000

    def test_checkpoint_roundtrip(self):
        t, j = _card_pair(10)
        t.update(torch.arange(5_000, dtype=torch.int32))
        j.update(np.arange(5_000, dtype=np.int32))
        for ck in (t.save_checkpoint(), j.save_checkpoint()):
            fresh, _ = _card_pair(10)
            fresh.load_checkpoint(pickle.loads(pickle.dumps(ck)))
            assert float(fresh.compute()) == float(t.compute())


class TestHeavyHitters:
    def test_hot_keys_surface_with_upper_bound_counts(self):
        t = tdr.HeavyHitters(depth=4, width=2048, k=8, distributed_available_fn=lambda: False, device=CPU)
        j = jdr.HeavyHitters(depth=4, width=2048, k=8, distributed_available_fn=lambda: False)
        rng = _rng(5)
        hot = np.repeat(np.arange(3, dtype=np.int32), 2_000)
        noise = rng.integers(10, 30_000, size=10_000).astype(np.int32)
        data = rng.permutation(np.concatenate([hot, noise]))
        t.update(torch.from_numpy(data))
        j.update(data)
        keys, counts = t.compute()
        for got, want in zip((keys, counts), j.compute()):
            assert np.array_equal(_np(got), _np(want)) and _np(got).dtype == _np(want).dtype
        assert set(_np(keys)[:3].tolist()) == {0, 1, 2}
        assert (_np(t.count_of(torch.arange(3, dtype=torch.int32))) >= 2_000).all()

    def test_checkpoint_roundtrip(self):
        t = tdr.HeavyHitters(depth=4, width=512, k=8, distributed_available_fn=lambda: False, device=CPU)
        j = jdr.HeavyHitters(depth=4, width=512, k=8, distributed_available_fn=lambda: False)
        t.update(torch.from_numpy(np.repeat(np.arange(4, dtype=np.int32), 100)))
        j.update(np.repeat(np.arange(4, dtype=np.int32), 100))
        for ck in (t.save_checkpoint(), j.save_checkpoint()):
            fresh = tdr.HeavyHitters(depth=4, width=512, k=8, distributed_available_fn=lambda: False, device=CPU)
            fresh.load_checkpoint(pickle.loads(pickle.dumps(ck)))
            assert np.array_equal(_np(fresh.compute()[1]), _np(t.compute()[1]))
            assert fresh.sketch.hh_keys.dtype == torch.uint32
