# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Runnable usage examples attached to metric class docstrings (counterpart
of ``torchmetrics_tpu/_examples.py``).

The examples of the non-factory classes live in one table, with the JAX
package's keys, and are appended to each class's docstring at import time;
``tests/test_torch_doctests.py`` walks every module of the port and runs
whatever ``>>>`` blocks it finds. Each entry is the JAX package's with the
port's module and ``device='cpu'`` given to every metric that takes a
device (so the examples run on a machine with or without a card); the
pinned outputs are JAX's letter for letter. The custom-metric examples
write their arithmetic in torch where JAX's write ``jnp``.
"""
from __future__ import annotations

_EXAMPLES = {
    # --------------------------------------------------------- classification
    "classification.f_beta.MulticlassF1Score": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MulticlassF1Score
    >>> metric = MulticlassF1Score(num_classes=3, average='macro', device='cpu')
    >>> metric.update(np.array([0, 1, 2, 1]), np.array([0, 1, 2, 1]))
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    "classification.f_beta.BinaryFBetaScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinaryFBetaScore
    >>> metric = BinaryFBetaScore(beta=2.0, device='cpu')
    >>> metric.update(np.array([0.2, 0.8, 0.9]), np.array([0, 1, 1]))
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    "classification.auroc.BinaryAUROC": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinaryAUROC
    >>> metric = BinaryAUROC(device='cpu')
    >>> metric.update(np.array([0.1, 0.4, 0.35, 0.8]), np.array([0, 0, 1, 1]))
    >>> round(float(metric.compute()), 4)
    0.75
    """,
    "classification.confusion_matrix.MulticlassConfusionMatrix": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix
    >>> metric = MulticlassConfusionMatrix(num_classes=2, device='cpu')
    >>> metric.update(np.array([0, 1, 1]), np.array([0, 1, 0]))
    >>> np.asarray(metric.compute()).tolist()
    [[1, 1], [0, 1]]
    """,
    "classification.matthews_corrcoef.BinaryMatthewsCorrCoef": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinaryMatthewsCorrCoef
    >>> metric = BinaryMatthewsCorrCoef(device='cpu')
    >>> metric.update(np.array([0, 1, 1, 0]), np.array([0, 1, 1, 0]))
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    "classification.cohen_kappa.BinaryCohenKappa": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinaryCohenKappa
    >>> metric = BinaryCohenKappa(device='cpu')
    >>> metric.update(np.array([0, 1, 1, 0]), np.array([0, 1, 1, 0]))
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    "classification.jaccard.MulticlassJaccardIndex": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MulticlassJaccardIndex
    >>> metric = MulticlassJaccardIndex(num_classes=3, device='cpu')
    >>> metric.update(np.array([0, 1, 2, 1]), np.array([0, 1, 2, 1]))
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    # -------------------------------------------------------------- regression
    "regression.mse.MeanSquaredError": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import MeanSquaredError
    >>> metric = MeanSquaredError(device='cpu')
    >>> metric.update(np.array([2.5, 0.0, 2.0, 8.0]), np.array([3.0, -0.5, 2.0, 7.0]))
    >>> round(float(metric.compute()), 4)
    0.375
    """,
    "regression.mae.MeanAbsoluteError": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import MeanAbsoluteError
    >>> metric = MeanAbsoluteError(device='cpu')
    >>> metric.update(np.array([2.5, 0.0, 2.0, 8.0]), np.array([3.0, -0.5, 2.0, 7.0]))
    >>> round(float(metric.compute()), 4)
    0.5
    """,
    "regression.pearson.PearsonCorrCoef": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import PearsonCorrCoef
    >>> metric = PearsonCorrCoef(device='cpu')
    >>> metric.update(np.array([1.0, 2.0, 3.0, 4.0]), np.array([2.0, 4.0, 6.0, 8.0]))
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    "regression.r2.R2Score": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import R2Score
    >>> metric = R2Score(device='cpu')
    >>> metric.update(np.array([1.0, 2.0, 3.0]), np.array([1.0, 2.0, 3.0]))
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    "regression.spearman.SpearmanCorrCoef": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import SpearmanCorrCoef
    >>> metric = SpearmanCorrCoef(device='cpu')
    >>> metric.update(np.array([1.0, 2.0, 3.0, 4.0]), np.array([10.0, 20.0, 30.0, 40.0]))
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    # ------------------------------------------------------------- aggregation
    "aggregation.MeanMetric": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import MeanMetric
    >>> metric = MeanMetric(device='cpu')
    >>> metric.update(np.array([1.0, 2.0, 3.0]))
    >>> round(float(metric.compute()), 4)
    2.0
    """,
    "aggregation.SumMetric": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import SumMetric
    >>> metric = SumMetric(device='cpu')
    >>> metric.update(np.array([1.0, 2.0, 3.0]))
    >>> round(float(metric.compute()), 4)
    6.0
    """,
    "aggregation.MaxMetric": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import MaxMetric
    >>> metric = MaxMetric(device='cpu')
    >>> metric.update(np.array([1.0, 3.0, 2.0]))
    >>> round(float(metric.compute()), 4)
    3.0
    """,
    "aggregation.MinMetric": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import MinMetric
    >>> metric = MinMetric(device='cpu')
    >>> metric.update(np.array([1.0, 3.0, 2.0]))
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    "aggregation.CatMetric": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import CatMetric
    >>> metric = CatMetric(device='cpu')
    >>> metric.update(np.array([1.0, 2.0]))
    >>> metric.update(np.array([3.0]))
    >>> np.asarray(metric.compute()).tolist()
    [1.0, 2.0, 3.0]
    """,
    # below the sketch capacity the KLL state is exact: the q-quantile is the
    # ceil(q*n)-th order statistic, so these pins are analytic
    "aggregation.Quantile": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import Quantile
    >>> metric = Quantile(q=[0.25, 0.75], device='cpu')
    >>> metric.update(np.array([1.0, 4.0, 2.0, 3.0]))
    >>> np.asarray(metric.compute()).tolist()
    [1.0, 3.0]
    """,
    "aggregation.Median": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import Median
    >>> metric = Median(device='cpu')
    >>> metric.update(np.array([7.0, 1.0, 3.0]))
    >>> round(float(metric.compute()), 4)
    3.0
    """,
    # -------------------------------------------------------------------- text
    "text.metrics.WordErrorRate": """
    >>> from torchmetrics_tpu_torch import WordErrorRate
    >>> metric = WordErrorRate(device='cpu')
    >>> metric.update(["the cat sat"], ["the cat sat down"])
    >>> round(float(metric.compute()), 4)
    0.25
    """,
    "text.metrics.CharErrorRate": """
    >>> from torchmetrics_tpu_torch import CharErrorRate
    >>> metric = CharErrorRate(device='cpu')
    >>> metric.update(["abc"], ["abcd"])
    >>> round(float(metric.compute()), 4)
    0.25
    """,
    "text.metrics.BLEUScore": """
    >>> from torchmetrics_tpu_torch import BLEUScore
    >>> metric = BLEUScore(device='cpu')
    >>> metric.update(["the cat is on the mat"], [["the cat sat on the mat", "a cat is on the mat"]])
    >>> round(float(metric.compute()), 4)
    0.8409
    """,
    "text.metrics.EditDistance": """
    >>> from torchmetrics_tpu_torch import EditDistance
    >>> metric = EditDistance(reduction='mean', device='cpu')
    >>> metric.update(["abc"], ["abcd"])
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    # ------------------------------------------------------------------- image
    "image.metrics.PeakSignalNoiseRatio": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import PeakSignalNoiseRatio
    >>> metric = PeakSignalNoiseRatio(data_range=1.0, device='cpu')
    >>> metric.update(np.full((1, 1, 8, 8), 0.5), np.full((1, 1, 8, 8), 0.75))
    >>> round(float(metric.compute()), 4)
    12.0412
    """,
    "image.metrics.TotalVariation": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import TotalVariation
    >>> metric = TotalVariation(device='cpu')
    >>> metric.update(np.ones((1, 1, 8, 8), np.float32))
    >>> round(float(metric.compute()), 4)
    0.0
    """,
    "image.metrics.StructuralSimilarityIndexMeasure": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import StructuralSimilarityIndexMeasure
    >>> rng = np.random.RandomState(0)
    >>> img = rng.rand(1, 1, 16, 16).astype(np.float32)
    >>> metric = StructuralSimilarityIndexMeasure(data_range=1.0, device='cpu')
    >>> metric.update(img, img)
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    # ------------------------------------------------------------------- audio
    "audio.metrics.SignalNoiseRatio": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import SignalNoiseRatio
    >>> metric = SignalNoiseRatio(device='cpu')
    >>> target = np.ones(4, np.float32)
    >>> metric.update(target + 1.0, target)  # noise power == signal power
    >>> round(float(metric.compute()), 4)
    0.0
    """,
    "audio.metrics.ScaleInvariantSignalDistortionRatio": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import ScaleInvariantSignalDistortionRatio
    >>> metric = ScaleInvariantSignalDistortionRatio(device='cpu')
    >>> target = np.array([1.0, -1.0, 1.0, -1.0])
    >>> metric.update(2.0 * target, target)  # scaling leaves SI-SDR unchanged
    >>> float(metric.compute()) > 30
    True
    """,
    # --------------------------------------------------------------- retrieval
    "retrieval.metrics.RetrievalMAP": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import RetrievalMAP
    >>> metric = RetrievalMAP(device='cpu')
    >>> metric.update(np.array([0.9, 0.2, 0.7]), np.array([1, 0, 1]), indexes=np.array([0, 0, 0]))
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    "retrieval.metrics.RetrievalNormalizedDCG": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import RetrievalNormalizedDCG
    >>> metric = RetrievalNormalizedDCG(device='cpu')
    >>> metric.update(np.array([0.9, 0.2, 0.7]), np.array([1, 0, 1]), indexes=np.array([0, 0, 0]))
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    # -------------------------------------------------------------- clustering
    "clustering.metrics.MutualInfoScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import MutualInfoScore
    >>> metric = MutualInfoScore(device='cpu')
    >>> metric.update(np.array([0, 1, 0, 1]), np.array([0, 1, 0, 1]))
    >>> round(float(metric.compute()), 4)
    0.6931
    """,
    "clustering.metrics.AdjustedRandScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import AdjustedRandScore
    >>> metric = AdjustedRandScore(device='cpu')
    >>> metric.update(np.array([0, 0, 1, 1]), np.array([1, 1, 0, 0]))
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    # ------------------------------------------------------------ segmentation
    "segmentation.metrics.MeanIoU": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import MeanIoU
    >>> metric = MeanIoU(num_classes=2, input_format='index', device='cpu')
    >>> seg = np.array([[[0, 1], [1, 0]]])
    >>> metric.update(seg, seg)
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    "classification.exact_match.MulticlassExactMatch": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MulticlassExactMatch
    >>> metric = MulticlassExactMatch(num_classes=3, device='cpu')
    >>> metric.update(np.array([[0, 1], [2, 1]]), np.array([[0, 1], [2, 1]]))
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    "regression.explained_variance.ExplainedVariance": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import ExplainedVariance
    >>> metric = ExplainedVariance(device='cpu')
    >>> metric.update(np.array([1.0, 2.0, 3.0]), np.array([1.0, 2.0, 3.0]))
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    "regression.cosine_similarity.CosineSimilarity": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import CosineSimilarity
    >>> metric = CosineSimilarity(reduction='mean', device='cpu')
    >>> v = np.array([[1.0, 2.0, 3.0]])
    >>> metric.update(2.0 * v, v)  # cosine ignores magnitude
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    "regression.mape.MeanAbsolutePercentageError": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import MeanAbsolutePercentageError
    >>> metric = MeanAbsolutePercentageError(device='cpu')
    >>> metric.update(np.array([1.0, 2.0, 4.0]), np.array([1.0, 2.0, 4.0]))
    >>> round(float(metric.compute()), 4)
    0.0
    """,
    "image.metrics.UniversalImageQualityIndex": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import UniversalImageQualityIndex
    >>> rng = np.random.RandomState(0)
    >>> img = rng.rand(1, 1, 16, 16).astype(np.float32)
    >>> metric = UniversalImageQualityIndex(device='cpu')
    >>> metric.update(img, img)
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    "classification.f_beta.BinaryF1Score": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinaryF1Score
    >>> metric = BinaryF1Score(device='cpu')
    >>> metric.update(np.array([0.2, 0.8, 0.7, 0.3]), np.array([0, 1, 1, 1]))
    >>> round(float(metric.compute()), 4)
    0.8
    """,
    "classification.jaccard.BinaryJaccardIndex": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinaryJaccardIndex
    >>> metric = BinaryJaccardIndex(device='cpu')
    >>> metric.update(np.array([0.2, 0.8, 0.7, 0.3]), np.array([0, 1, 1, 1]))
    >>> round(float(metric.compute()), 4)
    0.6667
    """,
    "classification.stat_scores.BinaryStatScores": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinaryStatScores
    >>> metric = BinaryStatScores(device='cpu')
    >>> metric.update(np.array([0.2, 0.8, 0.7, 0.3]), np.array([0, 1, 1, 1]))
    >>> np.asarray(metric.compute()).tolist()  # [tp, fp, tn, fn, support]
    [2, 0, 1, 1, 3]
    """,
    "classification.stat_scores.MulticlassStatScores": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MulticlassStatScores
    >>> metric = MulticlassStatScores(num_classes=3, average=None, device='cpu')
    >>> metric.update(np.array([0, 1, 2, 1]), np.array([0, 1, 2, 2]))
    >>> np.asarray(metric.compute()).tolist()
    [[1, 0, 3, 0, 1], [1, 1, 2, 0, 1], [1, 0, 2, 1, 2]]
    """,
    "detection.mean_ap.MeanAveragePrecision": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.detection import MeanAveragePrecision
    >>> metric = MeanAveragePrecision(device='cpu')
    >>> metric.update(
    ...     [{"boxes": np.array([[0.0, 0.0, 10.0, 10.0]]), "scores": np.array([0.9]), "labels": np.array([0])}],
    ...     [{"boxes": np.array([[0.0, 0.0, 10.0, 10.0]]), "labels": np.array([0])}],
    ... )
    >>> round(float(metric.compute()["map"]), 4)
    1.0
    """,
    "wrappers.minmax.MinMaxMetric": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import MinMaxMetric, MeanSquaredError
    >>> metric = MinMaxMetric(MeanSquaredError(device='cpu'))
    >>> metric.update(np.array([1.0, 2.0]), np.array([1.0, 3.0]))
    >>> {k: round(float(v), 4) for k, v in sorted(metric.compute().items())}
    {'max': 0.5, 'min': 0.5, 'raw': 0.5}
    """,
    "wrappers.multioutput.MultioutputWrapper": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import MultioutputWrapper, MeanSquaredError
    >>> metric = MultioutputWrapper(MeanSquaredError(device='cpu'), num_outputs=2)
    >>> metric.update(np.array([[1.0, 2.0], [2.0, 4.0]]), np.array([[1.0, 3.0], [2.0, 3.0]]))
    >>> [round(float(v), 4) for v in np.asarray(metric.compute()).ravel()]
    [0.0, 1.0]
    """,
    "wrappers.classwise.ClasswiseWrapper": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import ClasswiseWrapper
    >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
    >>> metric = ClasswiseWrapper(MulticlassAccuracy(num_classes=2, average=None, device='cpu'))
    >>> metric.update(np.array([0, 1, 1]), np.array([0, 1, 0]))
    >>> {k: round(float(v), 4) for k, v in sorted(metric.compute().items())}
    {'multiclassaccuracy_0': 0.5, 'multiclassaccuracy_1': 1.0}
    """,
    "wrappers.multitask.MultitaskWrapper": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import MultitaskWrapper, MeanSquaredError, MeanAbsoluteError
    >>> metric = MultitaskWrapper({"mse": MeanSquaredError(device='cpu'), "mae": MeanAbsoluteError(device='cpu')})
    >>> metric.update(
    ...     {"mse": np.array([1.0, 2.0]), "mae": np.array([1.0, 2.0])},
    ...     {"mse": np.array([1.0, 4.0]), "mae": np.array([1.0, 4.0])},
    ... )
    >>> {k: round(float(v), 4) for k, v in sorted(metric.compute().items())}
    {'mae': 1.0, 'mse': 2.0}
    """,
    "audio.metrics.PermutationInvariantTraining": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.audio import PermutationInvariantTraining
    >>> from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_noise_ratio
    >>> rng = np.random.RandomState(42)
    >>> metric = PermutationInvariantTraining(scale_invariant_signal_noise_ratio, device='cpu')
    >>> metric.update(rng.randn(2, 2, 64).astype(np.float32), rng.randn(2, 2, 64).astype(np.float32))
    >>> round(float(metric.compute()), 4)
    -14.4344
    """,
    # ------------------------------------- bases (subclassing contracts)
    "metric.Metric": """
    >>> import numpy as np
    >>> import torch
    >>> from torchmetrics_tpu_torch import Metric
    >>> class CountPositives(Metric):
    ...     def __init__(self, **kwargs):
    ...         super().__init__(**kwargs)
    ...         self.add_state("count", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
    ...     def update(self, values):
    ...         self.count = self.count + (torch.as_tensor(values, device=self.device) > 0).sum()
    ...     def compute(self):
    ...         return self.count
    >>> metric = CountPositives(device='cpu')
    >>> metric.update(np.array([1.0, -2.0, 3.0]))
    >>> metric.update(np.array([4.0, -5.0]))
    >>> int(metric.compute())
    3
    """,
    "metric.CompositionalMetric": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import MeanSquaredError
    >>> metric = MeanSquaredError(device='cpu') * 2  # arithmetic on metrics builds a CompositionalMetric
    >>> metric.update(np.array([2.5, 0.0, 2.0, 8.0]), np.array([3.0, -0.5, 2.0, 7.0]))
    >>> round(float(metric.compute()), 4)
    0.75
    """,
    "retrieval.base.RetrievalMetric": """
    >>> import numpy as np
    >>> import torch
    >>> from torchmetrics_tpu_torch.retrieval import RetrievalMetric
    >>> class RetrievalFirstRelevant(RetrievalMetric):  # rank of first relevant doc
    ...     def _metric_rows(self, preds, target, valid):
    ...         # masked-grid kernel over every row of the padded (queries, docs) grid at once
    ...         key = torch.where(valid, preds, -torch.inf)
    ...         order = torch.argsort(-key, dim=-1, stable=True)
    ...         hit = (target.gather(-1, order) > 0) & valid.gather(-1, order)
    ...         return torch.argmax(hit.to(torch.int32), dim=-1).to(torch.float32) + 1.0
    >>> metric = RetrievalFirstRelevant(device='cpu')
    >>> metric.update(np.array([0.9, 0.2, 0.8]), np.array([0, 0, 1]), indexes=np.array([0, 0, 0]))
    >>> round(float(metric.compute()), 4)
    2.0
    """,
    # ----------------------------------------------------------- wrappers
    "wrappers.abstract.WrapperMetric": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.wrappers import WrapperMetric
    >>> from torchmetrics_tpu_torch import MeanSquaredError
    >>> class NegatedMetric(WrapperMetric):  # wraps any metric, negates compute()
    ...     def __init__(self, base, **kwargs):
    ...         super().__init__(**kwargs)
    ...         self.base = base
    ...     def update(self, *args, **kwargs):
    ...         self.base.update(*args, **kwargs)
    ...     def compute(self):
    ...         return -self.base.compute()
    >>> metric = NegatedMetric(MeanSquaredError(device='cpu'), device='cpu')
    >>> metric.update(np.array([2.5, 0.0, 2.0, 8.0]), np.array([3.0, -0.5, 2.0, 7.0]))
    >>> round(float(metric.compute()), 4)
    -0.375
    """,
    "wrappers.bootstrapping.BootStrapper": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.wrappers import BootStrapper
    >>> from torchmetrics_tpu_torch import MeanSquaredError
    >>> metric = BootStrapper(MeanSquaredError(device='cpu'), num_bootstraps=4, seed=7)
    >>> metric.update(np.array([2.5, 0.0, 2.0, 8.0], np.float32), np.array([3.0, -0.5, 2.0, 7.0], np.float32))
    >>> sorted(metric.compute())
    ['mean', 'std']
    """,
    "wrappers.running.Running": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.wrappers import Running
    >>> from torchmetrics_tpu_torch import MeanMetric
    >>> metric = Running(MeanMetric(device='cpu'), window=2)
    >>> for v in (1.0, 2.0, 3.0):
    ...     metric.update(np.array([v], np.float32))
    >>> round(float(metric.compute()), 4)  # mean of the last 2 updates
    2.5
    """,
    "wrappers.transformations.BinaryTargetTransformer": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.wrappers import BinaryTargetTransformer
    >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
    >>> metric = BinaryTargetTransformer(BinaryAccuracy(device='cpu'), threshold=2)
    >>> metric.update(np.array([1, 0, 1, 1]), np.array([0.0, 1.0, 4.0, 3.0]))  # targets binarize at > 2
    >>> round(float(metric.compute()), 4)
    0.75
    """,
    "wrappers.transformations.LambdaInputTransformer": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.wrappers import LambdaInputTransformer
    >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
    >>> metric = LambdaInputTransformer(BinaryAccuracy(device='cpu'), transform_pred=lambda p: 1 - p)
    >>> metric.update(np.array([0.9, 0.1, 0.2]), np.array([0, 1, 1]))
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    "wrappers.transformations.MetricInputTransformer": """
    >>> import numpy as np
    >>> import torch
    >>> from torchmetrics_tpu_torch.wrappers import MetricInputTransformer
    >>> from torchmetrics_tpu_torch import MeanSquaredError
    >>> class ClampInputs(MetricInputTransformer):  # subclass the transform hook
    ...     def transform_pred(self, pred):
    ...         return torch.clamp(torch.as_tensor(pred), 0.0, 1.0)
    >>> metric = ClampInputs(MeanSquaredError(device='cpu'))
    >>> metric.update(np.array([1.5, 0.5], np.float32), np.array([1.0, 0.5], np.float32))
    >>> round(float(metric.compute()), 4)
    0.0
    """,
    # ------------------------- tower / dep-gated classes (usage contracts;
    # values need pretrained weights or optional deps, so examples are +SKIP
    # like the reference's pretrained-model docstrings)
    "image.fid.FrechetInceptionDistance": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.image import FrechetInceptionDistance
    >>> metric = FrechetInceptionDistance(feature=2048, device='cpu')  # doctest: +SKIP
    >>> imgs = np.random.randint(0, 255, (8, 3, 299, 299), dtype=np.uint8)  # doctest: +SKIP
    >>> metric.update(imgs, real=True)  # doctest: +SKIP
    >>> metric.update(imgs, real=False)  # doctest: +SKIP
    >>> float(metric.compute())  # doctest: +SKIP
    """,
    "image.inception_score.InceptionScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.image import InceptionScore
    >>> metric = InceptionScore(device='cpu')  # doctest: +SKIP
    >>> metric.update(np.random.randint(0, 255, (8, 3, 299, 299), dtype=np.uint8))  # doctest: +SKIP
    >>> mean, std = metric.compute()  # doctest: +SKIP
    """,
    "image.kid.KernelInceptionDistance": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.image import KernelInceptionDistance
    >>> metric = KernelInceptionDistance(subset_size=4, device='cpu')  # doctest: +SKIP
    >>> imgs = np.random.randint(0, 255, (8, 3, 299, 299), dtype=np.uint8)  # doctest: +SKIP
    >>> metric.update(imgs, real=True)  # doctest: +SKIP
    >>> metric.update(imgs, real=False)  # doctest: +SKIP
    >>> mean, std = metric.compute()  # doctest: +SKIP
    """,
    "image.lpip.LearnedPerceptualImagePatchSimilarity": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity
    >>> metric = LearnedPerceptualImagePatchSimilarity(net_type='alex', device='cpu')  # doctest: +SKIP
    >>> a = np.random.rand(4, 3, 64, 64).astype(np.float32) * 2 - 1  # doctest: +SKIP
    >>> b = np.random.rand(4, 3, 64, 64).astype(np.float32) * 2 - 1  # doctest: +SKIP
    >>> metric.update(a, b)  # doctest: +SKIP
    >>> float(metric.compute())  # doctest: +SKIP
    """,
    "image.mifid.MemorizationInformedFrechetInceptionDistance": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.image import MemorizationInformedFrechetInceptionDistance
    >>> metric = MemorizationInformedFrechetInceptionDistance(feature=2048, device='cpu')  # doctest: +SKIP
    >>> imgs = np.random.randint(0, 255, (8, 3, 299, 299), dtype=np.uint8)  # doctest: +SKIP
    >>> metric.update(imgs, real=True)  # doctest: +SKIP
    >>> metric.update(imgs, real=False)  # doctest: +SKIP
    >>> float(metric.compute())  # doctest: +SKIP
    """,
    "image.perceptual_path_length.PerceptualPathLength": """
    >>> from torchmetrics_tpu_torch.image import PerceptualPathLength
    >>> metric = PerceptualPathLength(num_samples=8, device='cpu')  # doctest: +SKIP
    >>> metric.update(generator)  # a GeneratorLike with sample()/forward  # doctest: +SKIP
    >>> mean, std, lengths = metric.compute()  # doctest: +SKIP
    """,
    "audio.metrics.DeepNoiseSuppressionMeanOpinionScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.audio import DeepNoiseSuppressionMeanOpinionScore
    >>> metric = DeepNoiseSuppressionMeanOpinionScore(fs=16000, personalized=False, device='cpu')  # doctest: +SKIP
    >>> metric.update(np.random.randn(16000).astype(np.float32))  # doctest: +SKIP
    >>> metric.compute()  # p808_mos, sig, bak, ovr  # doctest: +SKIP
    """,
    "audio.metrics.PerceptualEvaluationSpeechQuality": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.audio import PerceptualEvaluationSpeechQuality
    >>> metric = PerceptualEvaluationSpeechQuality(16000, 'wb', device='cpu')  # doctest: +SKIP
    >>> target = np.random.randn(16000).astype(np.float32)  # doctest: +SKIP
    >>> metric.update(target + 0.01 * np.random.randn(16000).astype(np.float32), target)  # doctest: +SKIP
    >>> float(metric.compute())  # doctest: +SKIP
    """,
    "audio.metrics.ShortTimeObjectiveIntelligibility": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.audio import ShortTimeObjectiveIntelligibility
    >>> metric = ShortTimeObjectiveIntelligibility(fs=16000, device='cpu')  # doctest: +SKIP
    >>> target = np.random.randn(16000).astype(np.float32)  # doctest: +SKIP
    >>> metric.update(target + 0.1 * np.random.randn(16000).astype(np.float32), target)  # doctest: +SKIP
    >>> float(metric.compute())  # doctest: +SKIP
    """,
    "audio.metrics.SpeechReverberationModulationEnergyRatio": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.audio import SpeechReverberationModulationEnergyRatio
    >>> metric = SpeechReverberationModulationEnergyRatio(fs=8000, device='cpu')  # doctest: +SKIP
    >>> metric.update(np.random.randn(8000).astype(np.float32))  # doctest: +SKIP
    >>> float(metric.compute())  # doctest: +SKIP
    """,
    "text.bert.BERTScore": """
    >>> from torchmetrics_tpu_torch.text import BERTScore
    >>> metric = BERTScore(model_name_or_path='bert-base-uncased', device='cpu')  # doctest: +SKIP
    >>> metric.update(['the cat sat on the mat'], ['a cat sat on the mat'])  # doctest: +SKIP
    >>> metric.compute()  # {'precision': ..., 'recall': ..., 'f1': ...}  # doctest: +SKIP
    """,
    "text.infolm.InfoLM": """
    >>> from torchmetrics_tpu_torch.text import InfoLM
    >>> metric = InfoLM('google/bert_uncased_L-2_H-128_A-2', idf=False, device='cpu')  # doctest: +SKIP
    >>> metric.update(['the cat sat on the mat'], ['a cat sat on the mat'])  # doctest: +SKIP
    >>> float(metric.compute())  # doctest: +SKIP
    """,
    "multimodal.clip_score.CLIPScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.multimodal import CLIPScore
    >>> metric = CLIPScore(model_name_or_path='openai/clip-vit-base-patch16', device='cpu')  # doctest: +SKIP
    >>> imgs = np.random.randint(0, 255, (1, 3, 224, 224), dtype=np.uint8)  # doctest: +SKIP
    >>> metric.update(list(imgs), ['a photo of a cat'])  # doctest: +SKIP
    >>> float(metric.compute())  # doctest: +SKIP
    """,
    "multimodal.clip_iqa.CLIPImageQualityAssessment": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.multimodal import CLIPImageQualityAssessment
    >>> metric = CLIPImageQualityAssessment(prompts=('quality',), device='cpu')  # doctest: +SKIP
    >>> metric.update(np.random.rand(1, 3, 224, 224).astype(np.float32))  # doctest: +SKIP
    >>> metric.compute()  # doctest: +SKIP
    """,
    # ------------------------------------------------------------- collections
    "collections.MetricCollection": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch import MetricCollection, MeanSquaredError, MeanAbsoluteError
    >>> col = MetricCollection([MeanSquaredError(device='cpu'), MeanAbsoluteError(device='cpu')])
    >>> col.update(np.array([2.5, 0.0, 2.0, 8.0]), np.array([3.0, -0.5, 2.0, 7.0]))
    >>> {k: round(float(v), 4) for k, v in sorted(col.compute().items())}
    {'MeanAbsoluteError': 0.5, 'MeanSquaredError': 0.375}
    """,
}


def attach_examples() -> None:
    """Append each example to its class docstring (idempotent).

    Two tables feed one loop: the manual ``_EXAMPLES`` above (keys are
    ``module.path.ClassName``) and the generated per-class table from
    the JAX package's generator (keys are ``subpackage:ClassName``).
    """
    import importlib

    from torchmetrics_tpu_torch._examples_generated import _GENERATED

    pairs = [(*path.rpartition(".")[::2], example) for path, example in _EXAMPLES.items()]
    pairs += [(*key.partition(":")[::2], example) for key, example in _GENERATED.items()]
    for module_path, cls_name, example in pairs:
        module = importlib.import_module(f"torchmetrics_tpu_torch.{module_path}")
        cls = getattr(module, cls_name)
        if cls.__doc__ and ">>>" in cls.__doc__:
            continue
        cls.__doc__ = (cls.__doc__ or "") + "\n\n    Example:" + example
