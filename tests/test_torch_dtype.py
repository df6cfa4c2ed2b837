# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""``Metric.set_dtype`` and its family (``type``, ``float``, ``double``,
``half``, the ``dtype`` property, ``cpu()``), ``MetricCollection.set_dtype``,
and low-precision inputs, on the CPU: the counterparts of
``tests/unittests/bases/test_metric.py::test_set_dtype`` and of the rows of
``tests/unittests/bases/test_dtype_properties.py::_DTYPE_SUITE`` outside the
domains not ported yet (image, audio).

set_dtype casts floating states and their defaults, sketch states leaf by
leaf; integer and boolean states keep their dtype, as in the JAX package.
The JAX package without 64-bit types keeps ``double()`` at float32; the port
has float64, so that case is held to the rule, not to JAX. Low-precision
inputs: every floating accumulator keeps its default dtype, and the value
lands within the JAX row's relative tolerance of the float32 run, in both
packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu.classification as JC
import torchmetrics_tpu_torch as T
import torchmetrics_tpu_torch.classification as TC
from torchmetrics_tpu.metric import Metric as JMetric
from torchmetrics_tpu_torch.metric import Metric

CPU = "cpu"
_RNG = np.random.RandomState(55)
N, BATCHES = 32, 3


class _Sum(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("x", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("n", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, v):
        self.x = self.x + v
        self.n = self.n + 1

    def compute(self):
        return self.x


class _JSum(JMetric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("x", jnp.asarray(0.0), dist_reduce_fx="sum")
        self.add_state("n", jnp.asarray(0, jnp.int32), dist_reduce_fx="sum")

    def update(self, v):
        self.x = self.x + v
        self.n = self.n + 1

    def compute(self):
        return self.x


@pytest.mark.parametrize("tdt,jdt", [(torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16)], ids=["bf16", "f16"])
def test_set_dtype(tdt, jdt):
    m, jm = _Sum(device=CPU), _JSum()
    m.update(torch.tensor(1.0))
    jm.update(1.0)
    assert m.set_dtype(tdt) is m
    jm.set_dtype(jdt)
    assert m.x.dtype == tdt and str(m.x.dtype).removeprefix("torch.") == str(jm.x.dtype)
    assert m._defaults["x"].dtype == tdt and m.n.dtype == torch.int32 == m._defaults["n"].dtype
    assert m.dtype == tdt
    m.reset()
    assert m.x.dtype == tdt


def test_dtype_family_and_cpu():
    m = _Sum(device=CPU)
    assert m.dtype == torch.float32
    assert m.double().x.dtype == torch.float64 and m.n.dtype == torch.int32
    assert m.half().x.dtype == torch.float16
    assert m.float().x.dtype == torch.float32
    assert m.type(torch.bfloat16).x.dtype == torch.bfloat16
    assert m.cpu() is m and m.device.type == "cpu" and m.x.device.type == "cpu"


def test_set_dtype_casts_sketch_leaves_one_by_one():
    """A Quantile's KLL items, min and max become float64; its sizes,
    compactions, count and overflow keep int32 and bool; default and live
    state alike, and the metric keeps working."""
    m = T.Quantile(q=[0.25, 0.75], capacity=64, levels=10, device=CPU)
    m.update(torch.randn(500))
    m.set_dtype(torch.float64)
    for state in (m.sketch, m._defaults["sketch"]):
        assert state.items.dtype == state.minimum.dtype == state.maximum.dtype == torch.float64
        assert state.sizes.dtype == state.compactions.dtype == state.count.dtype == torch.int32
        assert state.overflow.dtype == torch.bool
    m.update(torch.randn(300, dtype=torch.float64))
    assert int(m.sketch.count) == 800 and m.compute().dtype == torch.float64
    m.reset()
    assert m.sketch.items.dtype == torch.float64


def test_collection_set_dtype():
    col = T.MetricCollection({"sum": T.SumMetric(device=CPU), "mean": T.MeanMetric(device=CPU)})
    jcol = J.MetricCollection({"sum": J.SumMetric(), "mean": J.MeanMetric()})
    assert col.set_dtype(torch.float16) is col
    jcol.set_dtype(jnp.float16)
    for name in ("sum", "mean"):
        for key in col[name]._defaults:
            assert str(getattr(col[name], key).dtype).removeprefix("torch.") == str(getattr(jcol[name], key).dtype)


# ---------------------------------------------------- low-precision inputs


def _prob_batches():
    return [(_RNG.rand(N).astype(np.float32), _RNG.randint(0, 2, N)) for _ in range(BATCHES)]


def _logit_batches(c=5):
    return [(_RNG.randn(N, c).astype(np.float32), _RNG.randint(0, c, N)) for _ in range(BATCHES)]


def _reg_batches():
    return [(_RNG.randn(N).astype(np.float32), _RNG.randn(N).astype(np.float32)) for _ in range(BATCHES)]


# (id, port class, JAX class, args, batches, relative tolerance): the JAX rows
_DTYPE_SUITE = [
    ("binary_accuracy", TC.BinaryAccuracy, JC.BinaryAccuracy, {}, _prob_batches(), 5e-2),
    ("multiclass_accuracy", TC.MulticlassAccuracy, JC.MulticlassAccuracy, {"num_classes": 5}, _logit_batches(), 2e-2),
    ("multiclass_confmat_f1", TC.MulticlassF1Score, JC.MulticlassF1Score, {"num_classes": 5}, _logit_batches(), 2e-2),
    ("multiclass_confmat", TC.MulticlassConfusionMatrix, JC.MulticlassConfusionMatrix, {"num_classes": 5}, _logit_batches(), 2e-2),
    ("binary_auroc_binned", TC.BinaryAUROC, JC.BinaryAUROC, {"thresholds": 11}, _prob_batches(), 5e-2),
    ("mse", T.MeanSquaredError, J.MeanSquaredError, {}, _reg_batches(), 3e-2),
    ("mae", T.MeanAbsoluteError, J.MeanAbsoluteError, {}, _reg_batches(), 2e-2),
    ("pearson", T.PearsonCorrCoef, J.PearsonCorrCoef, {}, _reg_batches(), 5e-2),
    ("explained_variance", T.ExplainedVariance, J.ExplainedVariance, {}, _reg_batches(), 8e-2),
    ("cosine_similarity", T.CosineSimilarity, J.CosineSimilarity, {"reduction": "mean"},
     [(_RNG.randn(8, 6).astype(np.float32), _RNG.randn(8, 6).astype(np.float32)) for _ in range(BATCHES)], 3e-2),
    ("mean_metric", T.MeanMetric, J.MeanMetric, {}, [(_RNG.randn(N).astype(np.float32),) for _ in range(BATCHES)], 2e-2),
    ("sum_metric", T.SumMetric, J.SumMetric, {}, [(_RNG.randn(N).astype(np.float32),) for _ in range(BATCHES)], 2e-2),
]


def _value(x):
    return np.asarray(x.detach().to(torch.float32).numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32), np.float64)


@pytest.mark.parametrize("name,tcls,jcls,args,batches,tol", _DTYPE_SUITE, ids=[c[0] for c in _DTYPE_SUITE])
@pytest.mark.parametrize("tdt,jdt", [(torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16)], ids=["bf16", "f16"])
def test_dtype_robustness(name, tcls, jcls, args, batches, tol, tdt, jdt):
    base, low = tcls(device=CPU, **args), tcls(device=CPU, **args)
    jlow = jcls(**args)
    for batch in batches:
        base.update(*[torch.from_numpy(a) for a in batch])
        low.update(*[torch.from_numpy(a).to(tdt) if a.dtype.kind == "f" else torch.from_numpy(a) for a in batch])
        jlow.update(*[jnp.asarray(a).astype(jdt) if a.dtype.kind == "f" else jnp.asarray(a) for a in batch])
    for key, default in low._defaults.items():
        value = getattr(low, key)
        if isinstance(value, list):
            continue
        if value.dtype.is_floating_point:
            assert value.dtype == default.dtype, f"{name}.{key}: accumulator dtype degraded to {value.dtype}"
        assert str(value.dtype).removeprefix("torch.") == str(jnp.asarray(getattr(jlow, key)).dtype), (name, key)
    ref, got, jgot = _value(base.compute()), _value(low.compute()), _value(jlow.compute())
    scale = max(1.0, float(np.max(np.abs(ref))))
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale, err_msg=name)
    np.testing.assert_allclose(got, jgot, rtol=tol, atol=tol * scale, err_msg=f"{name} against JAX")


# ------------------------------- set_dtype, then float32 inputs (ROADMAP C4)
#
# JAX promotes by the dtype lattice alone: a ``(1,)`` bfloat16 state plus a
# 0-d float32 batch sum is float32. Torch would keep the state narrow. Every
# exported metric with a float state is narrowed, then fed one float32 batch
# from a seed; its state dtypes must equal JAX's and its states and value lie
# within _C4_BUDGET (absolute, scaled by max(1, |reference|)) of JAX's.

_C4_BUDGET = 1e-5
# SRMR's own budget against JAX (tests/test_torch_audio.py): XLA contracts its IIR step into FMAs, the port does not
_C4_CASE_BUDGET = {"SpeechReverberationModulationEnergyRatio": 1e-4}
_C4_N, _C4_C = 32, 5
_C4_BIN = {"task": "binary"}
_C4_MC = {"task": "multiclass", "num_classes": _C4_C}


def _c4_batch(kind, seed):
    r = np.random.default_rng(seed)
    n, c = _C4_N, _C4_C
    if kind == "prob":
        return r.random(n).astype(np.float32), r.integers(0, 2, n)
    if kind == "logit":
        return r.standard_normal((n, c)).astype(np.float32), r.integers(0, c, n)
    if kind == "reg":
        return r.standard_normal(n).astype(np.float32), r.standard_normal(n).astype(np.float32)
    if kind == "pos":
        return (r.random(n) + 0.1).astype(np.float32), (r.random(n) + 0.1).astype(np.float32)
    if kind == "dist":
        p, q = r.random((n, 6)), r.random((n, 6))
        return (p / p.sum(1, keepdims=True)).astype(np.float32), (q / q.sum(1, keepdims=True)).astype(np.float32)
    if kind == "rows":
        return r.standard_normal((n, 6)).astype(np.float32), r.standard_normal((n, 6)).astype(np.float32)
    if kind == "labels":  # segmentation label maps
        return r.integers(0, c, (4, 6, 5)).astype(np.int32), r.integers(0, c, (4, 6, 5)).astype(np.int32)
    if kind == "counts":  # Fleiss' kappa: 4 ratings a subject over c categories
        return (np.eye(c, dtype=np.int32)[r.integers(0, c, (n, 4))].sum(1),)
    if kind == "retrieval":
        return r.random(n).astype(np.float32), r.integers(0, 2, n), r.integers(0, 4, n)
    if kind == "clusters":  # two clusterings of n samples
        return r.integers(0, c, n).astype(np.int32), r.integers(0, c, n).astype(np.int32)
    if kind == "embedded":  # (n, 3) float32 data and its cluster labels
        labels = r.integers(0, 3, n).astype(np.int32)
        return (r.standard_normal((n, 3)) + 2 * labels[:, None]).astype(np.float32), labels
    if kind in ("audio", "speakers", "stft"):  # a degraded signal and its reference
        shape = {"audio": (4, 400), "speakers": (4, 2, 200), "stft": (4, 6, 10, 2)}[kind]
        target = r.standard_normal(shape).astype(np.float32)
        return (target + 0.3 * r.standard_normal(shape)).astype(np.float32), target
    if kind == "wave":  # SRMR's single input: 4 waves of 0.1 s at 8 kHz
        return (r.standard_normal((4, 800)).astype(np.float32),)
    if kind in ("img", "gray", "vif", "one", "lambda"):  # image pairs in [0, 1] (VIF needs 41 x 41, PSNRB one channel)
        shape = {"img": (2, 3, 16, 16), "gray": (2, 1, 16, 16), "vif": (2, 1, 44, 44), "one": (2, 3, 16, 16),
                 "lambda": (2, 3, 16, 16)}[kind]
        target = r.random(shape, dtype=np.float32)
        preds = np.clip(target + 0.1 * r.standard_normal(shape), 0, 1).astype(np.float32)
        return (preds,) if kind == "one" else (preds, target)
    if kind == "pan":  # D_s and QNR: a fused image and its ms/pan references
        pan = r.random((2, 3, 32, 32), dtype=np.float32)
        return pan * 0.9, {"ms": r.random((2, 3, 8, 8), dtype=np.float32), "pan": pan}
    if kind in ("real", "fake"):  # the generative metrics' images, through _c4_features
        return r.random((6, 3, 4, 4), dtype=np.float32), kind == "real"
    if kind == "lpips":
        return tuple(r.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32) for _ in range(2))
    if kind == "panoptic":  # (B, H, W, 2) (category, instance) maps over things {0, 1} and stuff {6}
        target = np.stack([r.choice([0, 1, 6], (3, 6, 5)), r.integers(0, 3, (3, 6, 5))], -1)
        preds = target.copy()
        preds[..., 0] = np.where(r.random((3, 6, 5)) < 0.3, r.choice([0, 1, 6], (3, 6, 5)), preds[..., 0])
        return preds, target
    if kind in ("text", "text_multi"):  # ASR/MT strings: hypotheses and their references (one each)
        words = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran", "Hello,", "world.", "it's", "3.5"]
        refs = [" ".join(r.choice(words, int(r.integers(2, 9)))) for _ in range(6)]
        hyps = [" ".join(w for w in ref.split() if r.random() > 0.2) + " dog" for ref in refs]
        return (hyps, refs) if kind == "text" else (hyps, [[ref] for ref in refs])
    if kind == "squad":
        answers = [["the cat", "a cat"], ["blue sky"], ["ran"]]
        preds = [{"prediction_text": p, "id": str(i)} for i, p in enumerate(["cat", "blue skies", "ran"])]
        return preds, [{"answers": {"answer_start": [0] * len(a), "text": a}, "id": str(i)} for i, a in enumerate(answers)]
    if kind == "ppl":  # Perplexity's (B, T, V) logits and targets, one ignored
        target = r.integers(0, 11, (4, 6))
        target[0, 0] = -100
        return r.standard_normal((4, 6, 11)).astype(np.float32), target
    return (r.standard_normal(n).astype(np.float32),)


def _c4_pit_si_sdr(preds, target):
    """PIT's metric function in either package: the port's SI-SDR on tensors, JAX's on arrays."""
    if isinstance(preds, torch.Tensor):
        return T.functional.scale_invariant_signal_distortion_ratio(preds, target)
    return J.functional.scale_invariant_signal_distortion_ratio(preds, target)


def _c4_features(imgs):
    """The generative metrics' feature callable in either package: the first 8 values of each image."""
    if isinstance(imgs, torch.Tensor):
        return imgs.reshape(imgs.shape[0], -1)[:, :8].to(torch.float32)
    return jnp.reshape(imgs, (imgs.shape[0], -1))[:, :8].astype(jnp.float32)


def _c4_lpips_tree():
    """A seeded flax tree of JAX's alex LPIPS net, which both packages load."""
    import functools

    import jax

    from torchmetrics_tpu.image.lpip import _LPIPSNet

    init = functools.partial(_LPIPSNet(net_type="alex").init, normalize=False)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(8)
    return jax.tree_util.tree_map(lambda leaf: (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32), shapes)


def _c4_as(arg, convert):
    """A batch argument as a package's array (dicts item by item; flags as they are)."""
    if isinstance(arg, dict):
        return {k: convert(v) for k, v in arg.items()}
    return convert(arg) if isinstance(arg, np.ndarray) else arg


# (exported class, kwargs, input kind) for every exported metric class
# outside the wrappers: the float-state ones form the sweep below
_C4_CASES = [
    ("AUROC", _C4_MC, "logit"), ("Accuracy", _C4_MC, "logit"), ("AveragePrecision", _C4_BIN, "prob"),
    ("CalibrationError", _C4_BIN, "prob"), ("CalibrationError", _C4_MC, "logit"), ("CohenKappa", _C4_MC, "logit"),
    ("ConfusionMatrix", _C4_MC, "logit"), ("Dice", {"num_classes": _C4_C}, "logit"), ("ExactMatch", _C4_MC, "logit"),
    ("F1Score", _C4_MC, "logit"), ("FBetaScore", dict(_C4_MC, beta=2.0), "logit"), ("HammingDistance", _C4_MC, "logit"),
    ("HingeLoss", _C4_BIN, "prob"), ("HingeLoss", _C4_MC, "logit"), ("JaccardIndex", _C4_MC, "logit"),
    ("MatthewsCorrCoef", _C4_MC, "logit"), ("NegativePredictiveValue", _C4_MC, "logit"), ("Precision", _C4_MC, "logit"),
    ("PrecisionAtFixedRecall", dict(_C4_BIN, min_recall=0.5, thresholds=11), "prob"),
    ("PrecisionRecallCurve", dict(_C4_BIN, thresholds=11), "prob"), ("ROC", dict(_C4_BIN, thresholds=11), "prob"),
    ("Recall", _C4_MC, "logit"), ("RecallAtFixedPrecision", dict(_C4_BIN, min_precision=0.5, thresholds=11), "prob"),
    ("SensitivityAtSpecificity", dict(_C4_BIN, min_specificity=0.5, thresholds=11), "prob"),
    ("Specificity", _C4_MC, "logit"), ("SpecificityAtSensitivity", dict(_C4_BIN, min_sensitivity=0.5, thresholds=11), "prob"),
    ("StatScores", _C4_MC, "logit"),
    ("ConcordanceCorrCoef", {}, "reg"), ("CosineSimilarity", {"reduction": "mean"}, "rows"),
    ("CriticalSuccessIndex", {"threshold": 0.5}, "pos"), ("ExplainedVariance", {}, "reg"), ("KLDivergence", {}, "dist"),
    ("KendallRankCorrCoef", {}, "reg"), ("LogCoshError", {}, "reg"), ("MeanAbsoluteError", {}, "reg"),
    ("MeanAbsolutePercentageError", {}, "pos"), ("MeanSquaredError", {}, "reg"), ("MeanSquaredLogError", {}, "pos"),
    ("MinkowskiDistance", {"p": 3.0}, "reg"), ("PearsonCorrCoef", {}, "reg"), ("R2Score", {}, "reg"),
    ("RelativeSquaredError", {}, "reg"), ("SpearmanCorrCoef", {}, "reg"), ("SymmetricMeanAbsolutePercentageError", {}, "pos"),
    ("TweedieDevianceScore", {"power": 1.5}, "pos"), ("WeightedMeanAbsolutePercentageError", {}, "pos"),
    ("CatMetric", {}, "one"), ("MaxMetric", {}, "one"), ("MinMetric", {}, "one"), ("MeanMetric", {}, "one"),
    ("SumMetric", {}, "one"), ("RunningMean", {"window": 3}, "one"), ("RunningSum", {"window": 3}, "one"),
    ("Median", {}, "one"), ("Quantile", {"q": 0.5}, "one"),
    ("MeanIoU", {"num_classes": _C4_C, "input_format": "index"}, "labels"),
    ("GeneralizedDiceScore", {"num_classes": _C4_C, "input_format": "index"}, "labels"),
    ("CramersV", {"num_classes": _C4_C}, "logit"), ("PearsonsContingencyCoefficient", {"num_classes": _C4_C}, "logit"),
    ("TheilsU", {"num_classes": _C4_C}, "logit"), ("TschuprowsT", {"num_classes": _C4_C}, "logit"),
    ("FleissKappa", {}, "counts"),
    ("RetrievalAUROC", {}, "retrieval"), ("RetrievalFallOut", {}, "retrieval"), ("RetrievalHitRate", {}, "retrieval"),
    ("RetrievalMAP", {}, "retrieval"), ("RetrievalMRR", {}, "retrieval"), ("RetrievalNormalizedDCG", {}, "retrieval"),
    ("RetrievalPrecision", {}, "retrieval"), ("RetrievalPrecisionRecallCurve", {}, "retrieval"),
    ("RetrievalRecall", {}, "retrieval"), ("RetrievalRecallAtFixedPrecision", {}, "retrieval"),
    ("RetrievalRPrecision", {}, "retrieval"),
    ("AdjustedMutualInfoScore", {}, "clusters"), ("AdjustedRandScore", {}, "clusters"),
    ("CompletenessScore", {}, "clusters"), ("FowlkesMallowsIndex", {}, "clusters"), ("HomogeneityScore", {}, "clusters"),
    ("MutualInfoScore", {}, "clusters"), ("NormalizedMutualInfoScore", {}, "clusters"), ("RandScore", {}, "clusters"),
    ("VMeasureScore", {}, "clusters"), ("CalinskiHarabaszScore", {}, "embedded"), ("DaviesBouldinScore", {}, "embedded"),
    ("DunnIndex", {}, "embedded"),
    ("SignalNoiseRatio", {}, "audio"), ("ScaleInvariantSignalNoiseRatio", {}, "audio"),
    ("ScaleInvariantSignalDistortionRatio", {}, "audio"), ("SignalDistortionRatio", {"filter_length": 32}, "audio"),
    ("SourceAggregatedSignalDistortionRatio", {}, "speakers"), ("ComplexScaleInvariantSignalNoiseRatio", {}, "stft"),
    ("PermutationInvariantTraining", {"metric_func": _c4_pit_si_sdr}, "speakers"),
    ("ShortTimeObjectiveIntelligibility", {"fs": 8000}, "audio"),
    ("SpeechReverberationModulationEnergyRatio", {"fs": 8000}, "wave"),
    # detection: the IoU family and the mAP hold list states alone (no float leaf, so not swept)
    ("IntersectionOverUnion", {}, "boxes"), ("GeneralizedIntersectionOverUnion", {}, "boxes"),
    ("DistanceIntersectionOverUnion", {}, "boxes"), ("CompleteIntersectionOverUnion", {}, "boxes"),
    ("MeanAveragePrecision", {}, "boxes"),
    ("PanopticQuality", {"things": {0, 1}, "stuffs": {6}}, "panoptic"),
    ("ModifiedPanopticQuality", {"things": {0, 1}, "stuffs": {6}}, "panoptic"),
    # image: the generative metrics through a feature callable, LPIPS on a carried tree
    ("PeakSignalNoiseRatio", {}, "img"), ("PeakSignalNoiseRatioWithBlockedEffect", {}, "gray"),
    ("StructuralSimilarityIndexMeasure", {}, "img"),
    ("MultiScaleStructuralSimilarityIndexMeasure", {"kernel_size": 3, "betas": (0.5, 0.5)}, "img"),
    ("UniversalImageQualityIndex", {}, "img"), ("ErrorRelativeGlobalDimensionlessSynthesis", {}, "img"),
    ("SpectralAngleMapper", {}, "img"), ("SpatialCorrelationCoefficient", {}, "img"),
    ("RelativeAverageSpectralError", {}, "img"), ("RootMeanSquaredErrorUsingSlidingWindow", {}, "img"),
    ("TotalVariation", {}, "one"), ("SpectralDistortionIndex", {}, "lambda"), ("SpatialDistortionIndex", {}, "pan"),
    ("QualityWithNoReference", {}, "pan"), ("VisualInformationFidelity", {}, "vif"),
    ("FrechetInceptionDistance", {"feature": _c4_features}, "real"),
    ("KernelInceptionDistance", {"feature": _c4_features, "subsets": 2, "subset_size": 4}, "fake"),
    ("InceptionScore", {"feature": _c4_features, "splits": 2}, "one"),
    ("MemorizationInformedFrechetInceptionDistance", {"feature": _c4_features}, "real"),
    ("LearnedPerceptualImagePatchSimilarity", {"net_params": _c4_lpips_tree()}, "lpips"),
    # text: host strings (the list states of ROUGE and EED start empty: not swept), Perplexity's logits
    ("BLEUScore", {}, "text_multi"), ("SacreBLEUScore", {}, "text_multi"), ("CHRFScore", {}, "text_multi"),
    ("ROUGEScore", {}, "text_multi"), ("TranslationEditRate", {}, "text_multi"), ("ExtendedEditDistance", {}, "text_multi"),
    ("WordErrorRate", {}, "text"), ("CharErrorRate", {}, "text"), ("MatchErrorRate", {}, "text"),
    ("WordInfoLost", {}, "text"), ("WordInfoPreserved", {}, "text"), ("EditDistance", {}, "text"),
    ("SQuAD", {}, "squad"), ("Perplexity", {"ignore_index": -100}, "ppl"),
]
_C4_WRAPPERS = {
    "BinaryTargetTransformer", "BootStrapper", "ClasswiseWrapper", "CompositionalMetric", "LambdaInputTransformer",
    "Metric", "MetricInputTransformer", "MinMaxMetric", "MultioutputWrapper", "MultitaskWrapper", "Running",
}
# exported metrics whose constructor needs a backend this machine lacks (``pesq``, ``onnxruntime``; a
# transformer model, which BERTScore, InfoLM and the CLIP metrics load at construction unless given one);
# both packages raise there (tests/test_torch_audio.py, tests/test_torch_text_models.py); the CLIP metrics'
# set_dtype is swept with a tiny CLIP in tests/test_torch_multimodal.py::test_set_dtype_then_update_as_jax
_C4_NEEDS_BACKEND = {"PerceptualEvaluationSpeechQuality", "DeepNoiseSuppressionMeanOpinionScore", "BERTScore", "InfoLM",
                     "CLIPScore", "CLIPImageQualityAssessment"}


def _c4_computed(value):
    """A compute's value as float64 numpy (a dict's entries in key order: ROUGE, SQuAD)."""
    if isinstance(value, dict):
        return np.stack([_value(value[k]) for k in sorted(value)])
    return _value(value)


def _c4_id(case):
    return case[0] + (f"-{case[1]['task']}" if "task" in case[1] else "")


def _c4_leaves(metric, walk):
    """Every tensor leaf of the deep state, keyed by path."""
    out = {}
    for path, m in walk(metric):
        for key, value in m.state_tree().items():
            items = value if isinstance(value, list) else ([value] if hasattr(value, "dtype") else list(value))
            for i, leaf in enumerate(items):
                out[f"{path}.{key}.{i}"] = leaf
    return out


def _c4_has_float_state(case):
    from torchmetrics_tpu_torch.parallel.sharded import _walk_metrics

    metric = getattr(T, case[0])(device=CPU, **case[1])
    return any(leaf.dtype.is_floating_point for leaf in _c4_leaves(metric, _walk_metrics).values())


_C4_FLOAT = [case for case in _C4_CASES if _c4_has_float_state(case)]


def test_c4_sweep_covers_every_exported_metric():
    exported = {n for n in T.__all__ if isinstance(getattr(T, n), type) and issubclass(getattr(T, n), Metric)}
    assert exported - _C4_WRAPPERS - _C4_NEEDS_BACKEND == {case[0] for case in _C4_CASES}
    assert len(_C4_FLOAT) >= 25


@pytest.mark.parametrize("case", _C4_FLOAT, ids=[_c4_id(c) for c in _C4_FLOAT])
@pytest.mark.parametrize("tdt,jdt", [(torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16)], ids=["bf16", "f16"])
def test_set_dtype_then_float32_update_promotes_as_jax(case, tdt, jdt):
    from torchmetrics_tpu.parallel.sharded import _walk_metrics as jwalk
    from torchmetrics_tpu_torch.parallel.sharded import _walk_metrics as twalk

    name, kwargs, kind = case
    batches = [_c4_batch(kind, seed=sum(map(ord, name)))]
    if kind == "real":  # the Frechet distances need fake samples too
        batches.append(_c4_batch("fake", seed=sum(map(ord, name)) + 1))
    m, jm = getattr(T, name)(device=CPU, **kwargs), getattr(J, name)(**kwargs)
    m.set_dtype(tdt)
    jm.set_dtype(jdt)
    for batch in batches:
        m.update(*[_c4_as(a, torch.from_numpy) for a in batch])
        jm.update(*[_c4_as(a, jnp.asarray) for a in batch])
    got, want = _c4_leaves(m, twalk), _c4_leaves(jm, jwalk)
    budget = _C4_CASE_BUDGET.get(name, _C4_BUDGET)
    assert sorted(got) == sorted(want)
    for key, leaf in got.items():
        assert str(leaf.dtype).removeprefix("torch.") == str(want[key].dtype), (name, key)
        if leaf.dtype.is_floating_point:
            ref = np.asarray(want[key], np.float64)
            np.testing.assert_allclose(
                _value(leaf), ref, rtol=0, atol=budget * max(1.0, float(np.max(np.abs(ref), initial=0.0))),
                err_msg=f"{name} {key}",
            )
    ref = _c4_computed(jm.compute())
    np.testing.assert_allclose(_c4_computed(m.compute()), ref, rtol=0, atol=budget * max(1.0, float(np.max(np.abs(ref)))))
