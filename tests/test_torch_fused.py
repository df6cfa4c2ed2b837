# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's fused plan (``MetricCollection.fused()``) against the JAX package's, on the CPU.

The same seeded numpy batches go through ``torchmetrics_tpu`` (its fused
plan, a jitted step on JAX's CPU backend) and ``torchmetrics_tpu_torch``
(``device="cpu"``: the same step run eagerly). Mirrors
``tests/unittests/bases/test_fused.py`` case by case (its two step-cache
cases are in ``tests/test_torch_plan_cache.py``, telemetry in
``tests/test_torch_device_telemetry.py``); the
sharded plan's cases are in ``tests/test_torch_sharded.py`` and, for sketch
members (``test_fused_sharded_sketch_parity``), in
``tests/test_torch_sketch_ranks.py``.

Budgets: integer states are bitwise; CatBuffer ``data``/``count``/
``overflowed`` are bitwise on probability inputs; values from probabilities
within ``rtol=1e-6, atol=1e-7`` and from logits within 2e-3 (a softmax ulp
can carry a probability across a threshold), the budgets of
``tests/test_torch_slice.py``. Port-fused against port-unfused is bitwise,
states and values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as T
from torchmetrics_tpu.parallel import fusion_report as j_fusion_report
from torchmetrics_tpu_torch.interop import state_to_numpy
from torchmetrics_tpu_torch.parallel import FusedCollectionPlan, fusion_ineligibility, fusion_report

C, L, THR, N = 5, 4, 16, 48
RTOL, ATOL = 1e-6, 1e-7
KINDS = ["headline", "shared_group", "exact", "multilabel", "families"]
FAMILY_CLASSES = {
    "prec": "Precision",
    "rec": "Recall",
    "npv": "NegativePredictiveValue",
    "spec": "Specificity",
    "ham": "HammingDistance",
    "cm": "ConfusionMatrix",
    "jac": "JaccardIndex",
    "mcc": "MatthewsCorrCoef",
    "kappa": "CohenKappa",
    "em": "ExactMatch",
}


def _members(pkg, kind):
    """The five suites: the headline suite; a real compute group (macro accuracy,
    F1 and F-beta share their tp/fp/tn/fn); the exact AUROC + AP group (cat
    states, CatBuffer carries); the multilabel suite; the stat-scores and
    confusion-matrix families (two compute groups, one tp/fp/tn/fn and one
    C x C ``confmat``) beside exact match."""
    cls = pkg.classification if pkg is J else pkg
    kw = {} if pkg is J else {"device": "cpu"}
    if kind == "families":
        macro = {"average": "macro"}
        return {
            key: getattr(cls, f"Multiclass{name}")(num_classes=C, **(macro if key in ("prec", "rec", "npv", "spec", "ham") else {}), **kw)
            for key, name in FAMILY_CLASSES.items()
        }
    if kind == "headline":
        return {
            "acc": cls.MulticlassAccuracy(num_classes=C, average="micro", **kw),
            "f1": cls.MulticlassF1Score(num_classes=C, average="macro", **kw),
            "auroc": cls.MulticlassAUROC(num_classes=C, thresholds=THR, **kw),
        }
    if kind == "shared_group":
        return {
            "acc": cls.MulticlassAccuracy(num_classes=C, average="macro", **kw),
            "f1": cls.MulticlassF1Score(num_classes=C, average="macro", **kw),
            "f2": cls.MulticlassFBetaScore(beta=2.0, num_classes=C, average="macro", **kw),
            "auroc": cls.MulticlassAUROC(num_classes=C, thresholds=THR, **kw),
        }
    if kind == "exact":
        return {
            "auroc": cls.MulticlassAUROC(num_classes=C, **kw),
            "ap": cls.MulticlassAveragePrecision(num_classes=C, **kw),
        }
    return {
        "acc": cls.MultilabelAccuracy(num_labels=L, **kw),
        "f1": cls.MultilabelF1Score(num_labels=L, average="macro", **kw),
        "auroc": cls.MultilabelAUROC(num_labels=L, thresholds=THR, **kw),
    }


def _suite(pkg, kind):
    return pkg.MetricCollection(_members(pkg, kind))


def _batches(kind, n, seed, logits=False):
    """``n`` numpy (preds, target) batches: softmax rows (multiclass) or
    probabilities (multilabel), or raw logits."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if kind == "multilabel":
            x = rng.standard_normal((N, L)).astype(np.float32) if logits else rng.random((N, L)).astype(np.float32)
            out.append((x, rng.integers(0, 2, (N, L)).astype(np.int32)))
            continue
        x = rng.standard_normal((N, C)).astype(np.float32)
        if not logits:
            x = (np.exp(x) / np.exp(x).sum(1, keepdims=True)).astype(np.float32)
        out.append((x, rng.integers(0, C, N).astype(np.int32)))
    return out


def _j(batch):
    return tuple(jnp.asarray(x) for x in batch)


def _t(batch):
    return tuple(torch.from_numpy(x) for x in batch)


def _fuse(col, kind, batches, to):
    opts = {"cat_capacity": N * len(batches) + 8, "example_batch": to(batches[0])} if kind == "exact" else {}
    return col.fused(**opts)


def _drive(plan, batches, to, mode):
    if mode == "update":
        for b in batches:
            plan.update(*to(b))
    else:
        plan.run_scan([to(b) for b in batches])


def _assert_carry_matches_jax(jstate, tstate):
    assert sorted(tstate["members"]) == sorted(jstate["members"])
    assert int(tstate["_update_count"]) == int(jstate["_update_count"])
    for key, jm in jstate["members"].items():
        tm = tstate["members"][key]
        assert sorted(tm) == sorted(jm), key
        for name, jv in jm.items():
            tv = tm[name]
            if isinstance(jv, tuple):  # CatBuffer: data, count, overflowed
                for part, (a, b) in zip(jv._fields, zip(tv, jv)):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{key}.{name}.{part}")
                    assert str(a.dtype).removeprefix("torch.") == str(np.asarray(b).dtype)
            else:
                assert tv.dtype == torch.int32 and np.asarray(jv).dtype == np.int32, f"{key}.{name}"
                np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=f"{key}.{name}")


def _assert_values_close(want, got, atol):
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(want[k], np.float64), rtol=RTOL, atol=atol, err_msg=k)


def _assert_values_bitwise(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _assert_states_bitwise(ref, fus):
    for key in ref.keys(keep_base=True):
        a, b = dict.__getitem__(ref, key), dict.__getitem__(fus, key)
        assert a._update_count == b._update_count, key
        sa, sb = state_to_numpy(a), state_to_numpy(b)
        for name in sa:
            x, y = sa[name], sb[name]
            if isinstance(x, list):
                # the fused CatBuffer folds back as ONE chunk; the eager list holds one per update
                x, y = np.concatenate([np.atleast_1d(v) for v in x]), np.concatenate([np.atleast_1d(v) for v in y])
            assert x.dtype == y.dtype and x.shape == y.shape and (x == y).all(), f"{key}.{name}"


# ------------------------------------------------------------- against JAX


@pytest.mark.parametrize("mode", ["update", "scan"])
@pytest.mark.parametrize("kind", KINDS)
def test_fused_carry_and_values_match_jax_on_probabilities(kind, mode):
    batches = _batches(kind, 6, seed=KINDS.index(kind))
    jc, tc = _suite(J, kind), _suite(T, kind)
    for b in batches[:2]:  # let the compute groups form
        jc.update(*_j(b))
        tc.update(*_t(b))
    jplan, tplan = _fuse(jc, kind, batches, _j), _fuse(tc, kind, batches, _t)
    assert [sorted(g) for g in tplan.groups] == [sorted(g) for g in jplan.groups]
    if kind in ("shared_group", "exact", "multilabel", "families"):
        assert len(tplan._infos) < len(tc)  # a real group: one leader runs for several members
    _drive(jplan, batches[2:], _j, mode)
    _drive(tplan, batches[2:], _t, mode)
    _assert_carry_matches_jax(jplan.state, tplan.state)
    jplan.fold_back()
    tplan.fold_back()
    _assert_values_close(jc.compute(), tc.compute(), ATOL)


def test_fused_headline_matches_jax_on_logits():
    batches = _batches("headline", 5, seed=11, logits=True)
    jc, tc = _suite(J, "headline"), _suite(T, "headline")
    for b in batches[:2]:
        jc.update(*_j(b))
        tc.update(*_t(b))
    jplan, tplan = jc.fused(), tc.fused()
    _drive(jplan, batches[2:], _j, "update")
    _drive(tplan, batches[2:], _t, "update")
    for key in ("acc", "f1"):  # the argmax of the same logits: bitwise
        for name, jv in jplan.state["members"][key].items():
            np.testing.assert_array_equal(tplan.state["members"][key][name].numpy(), np.asarray(jv))
    jplan.fold_back()
    tplan.fold_back()
    _assert_values_close(jc.compute(), tc.compute(), 2e-3)


# -------------------------------------------------------- fused vs unfused


@pytest.mark.parametrize("mode", ["update", "scan", "stream"])
@pytest.mark.parametrize("kind", KINDS)
def test_fused_equals_unfused_bitwise(kind, mode):
    batches = _batches(kind, 6, seed=20 + KINDS.index(kind))
    ref, fus = _suite(T, kind), _suite(T, kind)
    for b in batches:
        ref.update(*_t(b))
    for b in batches[:2]:
        fus.update(*_t(b))
    plan = _fuse(fus, kind, batches, _t)
    if mode == "stream":
        plan.run_stream(batches[2:])  # numpy batches through the feed
    else:
        _drive(plan, batches[2:], _t, mode)
    assert plan.updates_applied == 4
    plan.fold_back()
    _assert_values_bitwise(ref.compute(), fus.compute())
    _assert_states_bitwise(ref, fus)


def test_fused_mid_stream_seed_and_refold():
    """Fusing picks up the members' CURRENT state (mid-stream), fold_back is
    idempotent, and the plan stays drivable after a fold."""
    batches = _batches("exact", 6, seed=5)
    ref, fus = _suite(T, "exact"), _suite(T, "exact")
    for b in batches[:3]:
        ref.update(*_t(b))
        fus.update(*_t(b))
    plan = fus.fused(cat_capacity=N * 6, example_batch=_t(batches[0]))
    plan.update(*_t(batches[3]))
    plan.fold_back()
    plan.fold_back()  # idempotent
    plan.update(*_t(batches[4]))
    plan.update(*_t(batches[5]))
    plan.fold_back()
    for b in batches[3:]:
        ref.update(*_t(b))
    _assert_values_bitwise(ref.compute(), fus.compute())
    _assert_states_bitwise(ref, fus)


def test_fused_bare_metric_and_new_batch_shape():
    """A bare Metric fuses as a one-member collection; a short last batch
    (a new input signature) goes through the same step."""
    batches = _batches("headline", 3, seed=6)
    short = tuple(x[:7] for x in batches[2])
    ref, fus = T.MulticlassF1Score(num_classes=C, device="cpu"), T.MulticlassF1Score(num_classes=C, device="cpu")
    for b in batches[:2] + [short]:
        ref.update(*_t(b))
    plan = FusedCollectionPlan(fus)
    for b in batches[:2] + [short]:
        plan.update(*b)  # numpy batches
    plan.fold_back()
    assert torch.equal(ref.compute(), fus.compute()) and fus._update_count == 3


def _sketch_suite(pkg):
    """A collection of sketch ("merge") members: Quantile, DriftScore,
    Cardinality and HeavyHitters."""
    kw = {} if pkg is J else {"device": "cpu"}
    drift = pkg.drift
    ref = np.linspace(-2.0, 2.0, 200, dtype=np.float32)
    return pkg.MetricCollection({
        "q": pkg.Quantile(q=[0.1, 0.9], capacity=64, levels=12, **kw),
        "drift": drift.DriftScore(ref if pkg is J else torch.from_numpy(ref), bins=16, lo=-2.0, hi=2.0, **kw),
        "card": drift.Cardinality(precision=6, **kw),
        "hh": drift.HeavyHitters(depth=2, width=64, k=4, **kw),
    }, compute_groups=False)


@pytest.mark.parametrize("mode", ["update", "scan"])
def test_fused_sketch_members_equal_unfused_and_jax(mode):
    """Sketch members ride the fused carry leaf by leaf: fused == unfused
    bitwise in the port, and the fused carry equals JAX's fused plan's."""
    import torchmetrics_tpu.drift  # noqa: F401 - J.drift
    import torchmetrics_tpu_torch.drift  # noqa: F401 - T.drift

    rng = np.random.default_rng(31)
    batches = [(rng.standard_normal(40).astype(np.float32),) for _ in range(5)]
    members = ("q", "drift", "card", "hh")
    ref, fus, jfus = _sketch_suite(T), _sketch_suite(T), _sketch_suite(J)
    for name in members:
        for b in batches:
            dict.__getitem__(ref, name).update(torch.from_numpy(b[0]))
    plan, jplan = fus.fused(), jfus.fused()
    if mode == "update":
        for b in batches:
            plan.update(torch.from_numpy(b[0]))
            jplan.update(jnp.asarray(b[0]))
    else:
        plan.run_scan([(torch.from_numpy(b[0]),) for b in batches])
        jplan.run_scan([(jnp.asarray(b[0]),) for b in batches])
    for name in members:
        carried, jcarried = plan.state["members"][name], jplan.state["members"][name]
        for state, value in carried.items():
            if state == "_update_count":
                assert int(value) == int(jcarried[state]) == 5
                continue
            for field, got, want in zip(value._fields, value, jcarried[state]):
                got, want = np.atleast_1d(got.numpy()), np.atleast_1d(np.asarray(want))
                assert got.dtype == want.dtype and np.array_equal(got.view(np.uint8), want.view(np.uint8)), (name, state, field)
    plan.fold_back()
    for name in members:
        t_ref, t_fus = dict.__getitem__(ref, name), dict.__getitem__(fus, name)
        for state in t_ref._defaults:
            for got, want in zip(getattr(t_fus, state), getattr(t_ref, state)):
                assert torch.equal(got, want), (name, state)
        assert t_fus._update_count == 5


@pytest.fixture
def single_rank_mesh():
    """A one-rank gloo group (an in-process store, no port) and its DeviceMesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def test_fused_sharded_sketch_parity(single_rank_mesh):
    """Sketch ("merge") members of the sharded fused plan == ``sharded_update``
    bitwise, the first event loaded rather than merged into the empty
    default; both == JAX's ``FusedCollectionPlan(mesh=...)`` on a one-device
    mesh. Two ranks: ``tests/test_torch_sketch_ranks.py``."""
    import jax
    from jax.sharding import Mesh

    from torchmetrics_tpu.parallel import FusedCollectionPlan as JPlan
    from torchmetrics_tpu_torch.parallel import sharded_update

    rng = np.random.default_rng(33)
    batches = [(rng.standard_normal(256).astype(np.float32),) for _ in range(4)]
    ref = T.Quantile(q=[0.25, 0.75], capacity=64, levels=10, device="cpu")
    fus = T.Quantile(q=[0.25, 0.75], capacity=64, levels=10, device="cpu")
    jfus = J.Quantile(q=[0.25, 0.75], capacity=64, levels=10)
    plan = T.MetricCollection({"q": fus}).fused(mesh=single_rank_mesh)
    jplan = JPlan(jfus, mesh=Mesh(np.array(jax.devices()[:1]), ("data",)))
    for (x,) in batches:
        sharded_update(ref, single_rank_mesh, torch.from_numpy(x))
        plan.update(torch.from_numpy(x))
        jplan.update(jnp.asarray(x))
    plan.fold_back()
    jplan.fold_back()
    for field, got, want, jax_leaf in zip(ref.sketch._fields, fus.sketch, ref.sketch, jfus.sketch):
        assert torch.equal(got, want), field
        assert np.array_equal(np.atleast_1d(got.numpy()), np.atleast_1d(np.asarray(jax_leaf))), field
    assert torch.equal(fus.compute(), ref.compute()) and fus._update_count == 4


# ------------------------------------------------------- donation & buffers


def test_fused_plan_donate_rewrites_the_carry_in_place():
    batches = _batches("headline", 2, seed=6)
    col = T.MetricCollection({"acc": T.MulticlassAccuracy(num_classes=C, device="cpu")})
    plan = col.fused()  # donate=True default
    old = plan.state["members"]["acc"]["tp"]
    was = old.clone()
    plan.update(*_t(batches[0]))
    assert plan.state["members"]["acc"]["tp"] is old and not torch.equal(old, was)
    # the live metric's own states were never touched
    assert int(dict.__getitem__(col, "acc").tp.sum()) == 0


def test_fused_plan_donate_false_keeps_old_state():
    batches = _batches("headline", 2, seed=6)
    col = T.MetricCollection({"acc": T.MulticlassAccuracy(num_classes=C, device="cpu")})
    plan = col.fused(donate=False)
    old = plan.state["members"]["acc"]["tp"]
    was = old.clone()
    plan.update(*_t(batches[0]))
    assert torch.equal(old, was)  # still readable and unchanged
    assert not torch.equal(plan.state["members"]["acc"]["tp"], was)


def test_fold_back_installs_copies():
    """fold_back installs COPIES: later in-place steps must not change what the metrics hold."""
    batches = _batches("exact", 3, seed=7)
    col = _suite(T, "exact")
    plan = col.fused(cat_capacity=N * 3, example_batch=_t(batches[0]))
    plan.update(*_t(batches[0]))
    plan.fold_back()
    auroc = dict.__getitem__(col, "auroc")
    held = auroc.preds[0]
    was = held.clone()
    plan.update(*_t(batches[1]))
    plan.update(*_t(batches[2]))
    assert torch.equal(held, was)
    leader = plan._infos[0].key
    assert held.untyped_storage().data_ptr() != plan.state["members"][leader]["preds"].data.untyped_storage().data_ptr()


def test_failed_update_leaves_the_carry_alone():
    """A member's update that raises (an eager value check) leaves every carry untouched."""
    batches = _batches("headline", 2, seed=8)
    col = T.MetricCollection(
        {
            "acc": T.MulticlassAccuracy(num_classes=C, average="micro", device="cpu"),
            "f1": T.MulticlassF1Score(num_classes=C, device="cpu"),
        }
    )
    plan = col.fused()
    plan.update(*_t(batches[0]))
    before = {k: {n: v.clone() for n, v in m.items()} for k, m in plan.state["members"].items()}
    bad = (torch.from_numpy(batches[1][0]), torch.full((N,), C + 3, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="outside the expected range"):
        plan.update(*bad)
    for key, states in before.items():
        for name, value in states.items():
            assert torch.equal(plan.state["members"][key][name], value), f"{key}.{name}"


# ------------------------------------------------------------- eligibility


def _probe_classes(pkg):
    """The JAX test's refused constructions, in ``pkg``."""
    kw = {} if pkg is J else {"device": "cpu"}
    zeros = jnp.zeros(()) if pkg is J else torch.zeros(())

    class _KwOnly(pkg.Metric):
        def __init__(self):
            super().__init__(**kw)
            self.add_state("total", zeros, dist_reduce_fx="sum")

        def update(self, *, preds=None):
            self.total = self.total + preds.sum()

        def compute(self):
            return self.total

    class _HostCounters(pkg.Metric):
        _host_counters = ("_seen",)

        def __init__(self):
            super().__init__(**kw)
            self.add_state("total", zeros, dist_reduce_fx="sum")
            self._seen = 0

        def update(self, preds, target):
            self._seen += 1
            self.total = self.total + preds.sum()

        def compute(self):
            return self.total

    class _Wrapper(pkg.Metric):
        def __init__(self):
            super().__init__(**kw)
            self.add_state("total", zeros, dist_reduce_fx="sum")
            cls = pkg.classification if pkg is J else pkg
            self.child = cls.MulticlassAccuracy(num_classes=2, **kw)

        def update(self, preds, target):
            self.child.update(preds, target)

        def compute(self):
            return self.child.compute()

    class _Stateless(pkg.Metric):
        def __init__(self):
            super().__init__(**kw)

        def update(self, preds, target):
            pass

        def compute(self):
            return None

    cls = pkg.classification if pkg is J else pkg
    return pkg.MetricCollection(
        {
            "ok": cls.MulticlassAccuracy(num_classes=C, **kw),
            "kw": _KwOnly(),
            "hc": _HostCounters(),
            "wrap": _Wrapper(),
            "none": _Stateless(),
        },
        compute_groups=False,
    )


def test_fusion_report_and_refusal_match_jax():
    report = fusion_report(_probe_classes(T))
    assert report == j_fusion_report(_probe_classes(J))  # the same reasons, word for word
    assert report["ok"] is None
    assert "kwargs-only" in report["kw"]
    assert "host-side counters" in report["hc"]
    assert "child metrics" in report["wrap"]
    assert report["none"] == "declares no registered states"
    with pytest.raises(ValueError, match="kw: .*kwargs-only"):
        _probe_classes(T).fused()


def test_fusion_report_of_the_families_matches_jax():
    """Every stat-scores and confusion-matrix family and exact match, in each
    of its tasks, is fusable in both packages, with the same report."""
    def members(pkg):
        cls = pkg.classification if pkg is J else pkg
        kw = {} if pkg is J else {"device": "cpu"}
        out = {}
        for name in FAMILY_CLASSES.values():
            for task, args in (("binary", {}), ("multiclass", {"num_classes": C}), ("multilabel", {"num_labels": L})):
                klass = getattr(cls, f"{task.capitalize()}{name}", None)
                if klass is not None:
                    out[f"{task}_{name}"] = klass(**args, **kw)
        out["samplewise_exact_match"] = cls.MulticlassExactMatch(num_classes=C, multidim_average="samplewise", **kw)
        return pkg.MetricCollection(out, compute_groups=False)

    report = fusion_report(members(T))
    assert report == j_fusion_report(members(J))
    assert len(report) == 29 and all(reason is None for reason in report.values()), report


def test_fusion_report_is_read_only():
    batches = _batches("headline", 3, seed=14)
    col = _suite(T, "shared_group")
    col.update(*_t(batches[0]))
    col.update(*_t(batches[1]))
    list(col.items())  # copy_state=True propagation marks members as copies
    assert col._state_is_copy
    report = fusion_report(col)
    assert set(report) == set(col.keys(keep_base=True)) and all(r is None for r in report.values())
    assert col._state_is_copy  # untouched by the report
    col.fused()
    assert not col._state_is_copy  # the plan build runs the update entry protocol


def test_fusion_ineligibility_host_state_flag():
    metric = T.MulticlassAccuracy(num_classes=C, device="cpu")
    assert fusion_ineligibility(metric) is None
    metric._sharded_update_unsupported = "per-update host resampling"
    assert "host-state update" in fusion_ineligibility(metric)


def test_fused_cat_state_requires_capacity():
    col = T.MetricCollection({"ex": T.MulticlassAUROC(num_classes=C, device="cpu")})
    with pytest.raises(ValueError, match="cat_capacity"):
        col.fused()


def test_fused_cat_overflow_raises_on_fold_back():
    batches = _batches("exact", 3, seed=8)
    col = T.MetricCollection({"ex": T.MulticlassAUROC(num_classes=C, device="cpu")})
    plan = col.fused(cat_capacity=N + 4, example_batch=_t(batches[0]))
    for b in batches:
        plan.update(*_t(b))
    with pytest.raises(RuntimeError, match="overflow"):
        plan.fold_back()


class _StackedSum(T.Metric):
    """An array state whose reduction stacks (``dist_reduce_fx=None``)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx=None)

    def update(self, preds, target):
        self.total = self.total + preds.sum()

    def compute(self):
        return self.total


def test_fused_mesh_is_not_ported():
    """The sharded plan is ported (tests/test_torch_sharded.py); what it still
    refuses, as JAX's does, is an array state whose fold would stack."""
    col = T.MetricCollection({"acc": T.MulticlassAccuracy(num_classes=C, device="cpu"), "st": _StackedSum(device="cpu")})
    with pytest.raises(ValueError, match="cannot fuse 'st'.*array state 'total'.*dist_reduce_fx=None"):
        col.fused(mesh=object())
