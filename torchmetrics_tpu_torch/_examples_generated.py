# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Generated doctest examples, one per public class without a manual or
factory example (counterpart of ``torchmetrics_tpu/_examples_generated.py``).

The JAX package's table with the port's module and ``device='cpu'`` given
to every metric; the pinned outputs and ``_PROVENANCE`` (how each pin was
checked when the JAX package generated it: ``oracle-verified`` against the
reference torchmetrics, ``self-pin: <reason>`` or ``shape-only``) are JAX's
letter for letter, so each entry that runs here holds the port to the JAX
package's value."""

_GENERATED = {
    # oracle-verified (max|delta|=0.0e+00)
    "classification:AUROC": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import AUROC
    >>> metric = AUROC(task='binary', device='cpu')
    >>> metric.update(np.array([0.1, 0.8, 0.3, 0.7, 0.4, 0.2], np.float32), np.array([0, 1, 0, 1, 0, 1]))
    >>> round(float(metric.compute()), 4)
    0.7778
    """,
    # oracle-verified (max|delta|=1.4e-07)
    "clustering:AdjustedMutualInfoScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.clustering import AdjustedMutualInfoScore
    >>> rng = np.random.RandomState(42)
    >>> metric = AdjustedMutualInfoScore(device='cpu')
    >>> metric.update(rng.randint(0, 3, 16), rng.randint(0, 3, 16))
    >>> round(float(metric.compute()), 4)
    -0.0202
    """,
    # oracle-verified (max|delta|=6.0e-08)
    "classification:AveragePrecision": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import AveragePrecision
    >>> rng = np.random.RandomState(42)
    >>> metric = AveragePrecision(task='binary', device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> round(float(metric.compute()), 4)
    0.7857
    """,
    # oracle-verified (max|delta|=6.0e-08)
    "classification:BinaryAveragePrecision": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinaryAveragePrecision
    >>> rng = np.random.RandomState(42)
    >>> metric = BinaryAveragePrecision(device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> round(float(metric.compute()), 4)
    0.7857
    """,
    # oracle-verified (max|delta|=6.0e-08)
    "classification:BinaryCalibrationError": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinaryCalibrationError
    >>> rng = np.random.RandomState(42)
    >>> metric = BinaryCalibrationError(device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> round(float(metric.compute()), 4)
    0.57
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:BinaryConfusionMatrix": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinaryConfusionMatrix
    >>> rng = np.random.RandomState(42)
    >>> metric = BinaryConfusionMatrix(device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> [round(float(v), 4) for v in np.asarray(metric.compute()).reshape(-1)]
    [0.0, 1.0, 4.0, 5.0]
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:BinaryFairness": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinaryFairness
    >>> rng = np.random.RandomState(42)
    >>> metric = BinaryFairness(num_groups=2, device='cpu')
    >>> metric.update(rng.randint(0, 2, 12), rng.randint(0, 2, 12), rng.randint(0, 2, 12))
    >>> {k: np.round(np.asarray(v, np.float64), 4).tolist() for k, v in sorted(metric.compute().items())}
    {'DP_0_1': 0.0, 'EO_0_1': 0.0}
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:BinaryGroupStatRates": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinaryGroupStatRates
    >>> rng = np.random.RandomState(42)
    >>> metric = BinaryGroupStatRates(num_groups=2, device='cpu')
    >>> metric.update(rng.randint(0, 2, 12), rng.randint(0, 2, 12), rng.randint(0, 2, 12))
    >>> {k: np.round(np.asarray(v, np.float64), 4).tolist() for k, v in sorted(metric.compute().items())}
    {'group_0': [0.0, 0.0, 0.3333, 0.6667], 'group_1': [0.1111, 0.2222, 0.2222, 0.4444]}
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:BinaryHingeLoss": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinaryHingeLoss
    >>> rng = np.random.RandomState(42)
    >>> metric = BinaryHingeLoss(device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> round(float(metric.compute()), 4)
    0.67
    """,
    # shape-only (no value pinned)
    "classification:BinaryPrecisionAtFixedRecall": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinaryPrecisionAtFixedRecall
    >>> rng = np.random.RandomState(42)
    >>> metric = BinaryPrecisionAtFixedRecall(min_recall=0.5, device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((), ())
    """,
    # shape-only (no value pinned)
    "classification:BinaryPrecisionRecallCurve": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinaryPrecisionRecallCurve
    >>> rng = np.random.RandomState(42)
    >>> metric = BinaryPrecisionRecallCurve(thresholds=5, device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((6,), (6,), (5,))
    """,
    # shape-only (no value pinned)
    "classification:BinaryROC": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinaryROC
    >>> rng = np.random.RandomState(42)
    >>> metric = BinaryROC(thresholds=5, device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((5,), (5,), (5,))
    """,
    # shape-only (no value pinned)
    "classification:BinaryRecallAtFixedPrecision": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinaryRecallAtFixedPrecision
    >>> rng = np.random.RandomState(42)
    >>> metric = BinaryRecallAtFixedPrecision(min_precision=0.5, device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((), ())
    """,
    # shape-only (no value pinned)
    "classification:BinarySensitivityAtSpecificity": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinarySensitivityAtSpecificity
    >>> rng = np.random.RandomState(42)
    >>> metric = BinarySensitivityAtSpecificity(min_specificity=0.5, device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((), ())
    """,
    # shape-only (no value pinned)
    "classification:BinarySpecificityAtSensitivity": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import BinarySpecificityAtSensitivity
    >>> rng = np.random.RandomState(42)
    >>> metric = BinarySpecificityAtSensitivity(min_sensitivity=0.5, device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((), ())
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "text:CHRFScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.text import CHRFScore
    >>> metric = CHRFScore(device='cpu')
    >>> metric.update(["the squirrel eats the nut"], [["the squirrel is eating the nut"]])
    >>> round(float(metric.compute()), 4)
    0.5833
    """,
    # oracle-verified (max|delta|=6.0e-08)
    "classification:CalibrationError": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import CalibrationError
    >>> rng = np.random.RandomState(42)
    >>> metric = CalibrationError(task='binary', device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> round(float(metric.compute()), 4)
    0.57
    """,
    # oracle-verified (max|delta|=6.0e-08)
    "clustering:CalinskiHarabaszScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.clustering import CalinskiHarabaszScore
    >>> rng = np.random.RandomState(42)
    >>> metric = CalinskiHarabaszScore(device='cpu')
    >>> metric.update(rng.randn(12, 3).astype(np.float32), rng.randint(0, 2, 12))
    >>> round(float(metric.compute()), 4)
    0.9886
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:CohenKappa": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import CohenKappa
    >>> rng = np.random.RandomState(42)
    >>> metric = CohenKappa(task='binary', device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> round(float(metric.compute()), 4)
    -0.1905
    """,
    # self-pin: reference class unresolved (AttributeError)
    "detection:CompleteIntersectionOverUnion": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.detection import CompleteIntersectionOverUnion
    >>> metric = CompleteIntersectionOverUnion(device='cpu')
    >>> metric.update([{'boxes': np.array([[0.0, 0.0, 10.0, 10.0]]), 'scores': np.array([0.9]), 'labels': np.array([0])}], [{'boxes': np.array([[0.0, 0.0, 10.0, 12.0]]), 'labels': np.array([0])}])
    >>> {k: np.round(np.asarray(v, np.float64), 4).tolist() for k, v in sorted(metric.compute().items())}
    {'ciou': 0.8292}
    """,
    # oracle-verified (max|delta|=1.6e-07)
    "clustering:CompletenessScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.clustering import CompletenessScore
    >>> rng = np.random.RandomState(42)
    >>> metric = CompletenessScore(device='cpu')
    >>> metric.update(rng.randint(0, 3, 16), rng.randint(0, 3, 16))
    >>> round(float(metric.compute()), 4)
    0.1535
    """,
    # self-pin: agrees to 3.8e-06 but sits on a 4dp rounding boundary
    # (platform BLAS flips the last digit) — pinned ELLIPSIS-safe at 3dp
    "audio:ComplexScaleInvariantSignalNoiseRatio": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.audio import ComplexScaleInvariantSignalNoiseRatio
    >>> rng = np.random.RandomState(42)
    >>> metric = ComplexScaleInvariantSignalNoiseRatio(device='cpu')
    >>> metric.update(rng.randn(2, 8, 16, 2).astype(np.float32), rng.randn(2, 8, 16, 2).astype(np.float32))
    >>> round(float(metric.compute()), 4)
    -23.830...
    """,
    # oracle-verified (max|delta|=3.7e-09)
    "regression:ConcordanceCorrCoef": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.regression import ConcordanceCorrCoef
    >>> rng = np.random.RandomState(42)
    >>> metric = ConcordanceCorrCoef(device='cpu')
    >>> metric.update(rng.randn(10).astype(np.float32), rng.randn(10).astype(np.float32))
    >>> round(float(metric.compute()), 4)
    -0.0459
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:ConfusionMatrix": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import ConfusionMatrix
    >>> rng = np.random.RandomState(42)
    >>> metric = ConfusionMatrix(task='binary', device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> [round(float(v), 4) for v in np.asarray(metric.compute()).reshape(-1)]
    [0.0, 1.0, 4.0, 5.0]
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "nominal:CramersV": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.nominal import CramersV
    >>> rng = np.random.RandomState(42)
    >>> metric = CramersV(num_classes=3, device='cpu')
    >>> metric.update(rng.randint(0, 3, 16), rng.randint(0, 3, 16))
    >>> round(float(metric.compute()), 4)
    0.0
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "regression:CriticalSuccessIndex": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.regression import CriticalSuccessIndex
    >>> rng = np.random.RandomState(42)
    >>> metric = CriticalSuccessIndex(threshold=0.5, device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32) + 0.5, rng.rand(10).astype(np.float32) + 0.5)
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    # oracle-verified (max|delta|=1.2e-07)
    "clustering:DaviesBouldinScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.clustering import DaviesBouldinScore
    >>> rng = np.random.RandomState(42)
    >>> metric = DaviesBouldinScore(device='cpu')
    >>> metric.update(rng.randn(12, 3).astype(np.float32), rng.randint(0, 2, 12))
    >>> round(float(metric.compute()), 4)
    1.3477
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:Dice": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import Dice
    >>> rng = np.random.RandomState(42)
    >>> metric = Dice(num_classes=5, average='micro', device='cpu')
    >>> metric.update(rng.rand(8, 5).astype(np.float32), rng.randint(0, 5, 8))
    >>> round(float(metric.compute()), 4)
    0.0
    """,
    # self-pin: reference class unresolved (AttributeError)
    "detection:DistanceIntersectionOverUnion": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.detection import DistanceIntersectionOverUnion
    >>> metric = DistanceIntersectionOverUnion(device='cpu')
    >>> metric.update([{'boxes': np.array([[0.0, 0.0, 10.0, 10.0]]), 'scores': np.array([0.9]), 'labels': np.array([0])}], [{'boxes': np.array([[0.0, 0.0, 10.0, 12.0]]), 'labels': np.array([0])}])
    >>> {k: np.round(np.asarray(v, np.float64), 4).tolist() for k, v in sorted(metric.compute().items())}
    {'diou': 0.8292}
    """,
    # oracle-verified (max|delta|=6.0e-08)
    "clustering:DunnIndex": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.clustering import DunnIndex
    >>> rng = np.random.RandomState(42)
    >>> metric = DunnIndex(device='cpu')
    >>> metric.update(rng.randn(12, 3).astype(np.float32), rng.randint(0, 2, 12))
    >>> round(float(metric.compute()), 4)
    0.5471
    """,
    # oracle-verified (max|delta|=1.9e-06)
    "image:ErrorRelativeGlobalDimensionlessSynthesis": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.image import ErrorRelativeGlobalDimensionlessSynthesis
    >>> rng = np.random.RandomState(42)
    >>> metric = ErrorRelativeGlobalDimensionlessSynthesis(device='cpu')
    >>> metric.update(rng.rand(2, 3, 16, 16).astype(np.float32) + 0.1, rng.rand(2, 3, 16, 16).astype(np.float32) + 0.1)
    >>> round(float(metric.compute()), 4)
    17.5301
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:ExactMatch": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import ExactMatch
    >>> rng = np.random.RandomState(42)
    >>> metric = ExactMatch(task='multiclass', num_classes=5, device='cpu')
    >>> metric.update(rng.randint(0, 5, (4, 6)), rng.randint(0, 5, (4, 6)))
    >>> round(float(metric.compute()), 4)
    0.0
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "text:ExtendedEditDistance": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.text import ExtendedEditDistance
    >>> metric = ExtendedEditDistance(device='cpu')
    >>> metric.update(["the cat sat on the mat"], ["the cat sat on a mat"])
    >>> round(float(metric.compute()), 4)
    0.1452
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:F1Score": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import F1Score
    >>> rng = np.random.RandomState(42)
    >>> metric = F1Score(task='binary', device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> round(float(metric.compute()), 4)
    0.6667
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:FBetaScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import FBetaScore
    >>> rng = np.random.RandomState(42)
    >>> metric = FBetaScore(task='binary', beta=0.5, device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> round(float(metric.compute()), 4)
    0.7576
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "nominal:FleissKappa": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.nominal import FleissKappa
    >>> rng = np.random.RandomState(42)
    >>> metric = FleissKappa(mode='counts', device='cpu')
    >>> metric.update(rng.multinomial(10, [0.25] * 4, size=6))
    >>> round(float(metric.compute()), 4)
    0.0299
    """,
    # oracle-verified (max|delta|=3.0e-08)
    "clustering:FowlkesMallowsIndex": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.clustering import FowlkesMallowsIndex
    >>> rng = np.random.RandomState(42)
    >>> metric = FowlkesMallowsIndex(device='cpu')
    >>> metric.update(rng.randint(0, 3, 16), rng.randint(0, 3, 16))
    >>> round(float(metric.compute()), 4)
    0.3117
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "segmentation:GeneralizedDiceScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.segmentation import GeneralizedDiceScore
    >>> rng = np.random.RandomState(42)
    >>> metric = GeneralizedDiceScore(num_classes=3, input_format='index', device='cpu')
    >>> metric.update(rng.randint(0, 3, (2, 8, 8)), rng.randint(0, 3, (2, 8, 8)))
    >>> round(float(metric.compute()), 4)
    0.426
    """,
    # self-pin: reference class unresolved (AttributeError)
    "detection:GeneralizedIntersectionOverUnion": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.detection import GeneralizedIntersectionOverUnion
    >>> metric = GeneralizedIntersectionOverUnion(device='cpu')
    >>> metric.update([{'boxes': np.array([[0.0, 0.0, 10.0, 10.0]]), 'scores': np.array([0.9]), 'labels': np.array([0])}], [{'boxes': np.array([[0.0, 0.0, 10.0, 12.0]]), 'labels': np.array([0])}])
    >>> {k: np.round(np.asarray(v, np.float64), 4).tolist() for k, v in sorted(metric.compute().items())}
    {'giou': 0.8333}
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:HingeLoss": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import HingeLoss
    >>> rng = np.random.RandomState(42)
    >>> metric = HingeLoss(task='binary', device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> round(float(metric.compute()), 4)
    0.67
    """,
    # oracle-verified (max|delta|=1.5e-07)
    "clustering:HomogeneityScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.clustering import HomogeneityScore
    >>> rng = np.random.RandomState(42)
    >>> metric = HomogeneityScore(device='cpu')
    >>> metric.update(rng.randint(0, 3, 16), rng.randint(0, 3, 16))
    >>> round(float(metric.compute()), 4)
    0.1356
    """,
    # self-pin: reference class unresolved (AttributeError)
    "detection:IntersectionOverUnion": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.detection import IntersectionOverUnion
    >>> metric = IntersectionOverUnion(device='cpu')
    >>> metric.update([{'boxes': np.array([[0.0, 0.0, 10.0, 10.0]]), 'scores': np.array([0.9]), 'labels': np.array([0])}], [{'boxes': np.array([[0.0, 0.0, 10.0, 12.0]]), 'labels': np.array([0])}])
    >>> {k: np.round(np.asarray(v, np.float64), 4).tolist() for k, v in sorted(metric.compute().items())}
    {'iou': 0.8333}
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:JaccardIndex": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import JaccardIndex
    >>> rng = np.random.RandomState(42)
    >>> metric = JaccardIndex(task='binary', device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> round(float(metric.compute()), 4)
    0.5
    """,
    # oracle-verified (max|delta|=3.0e-08)
    "regression:KLDivergence": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.regression import KLDivergence
    >>> rng = np.random.RandomState(42)
    >>> metric = KLDivergence(device='cpu')
    >>> metric.update((lambda p: p / p.sum(1, keepdims=True))(rng.rand(4, 5).astype(np.float32) + 0.1), (lambda p: p / p.sum(1, keepdims=True))(rng.rand(4, 5).astype(np.float32) + 0.1))
    >>> round(float(metric.compute()), 4)
    0.4772
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "regression:KendallRankCorrCoef": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.regression import KendallRankCorrCoef
    >>> rng = np.random.RandomState(42)
    >>> metric = KendallRankCorrCoef(device='cpu')
    >>> metric.update(rng.randn(10).astype(np.float32), rng.randn(10).astype(np.float32))
    >>> round(float(metric.compute()), 4)
    0.1556
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "regression:LogCoshError": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.regression import LogCoshError
    >>> rng = np.random.RandomState(42)
    >>> metric = LogCoshError(device='cpu')
    >>> metric.update(rng.randn(10).astype(np.float32), rng.randn(10).astype(np.float32))
    >>> round(float(metric.compute()), 4)
    0.7559
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "text:MatchErrorRate": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.text import MatchErrorRate
    >>> metric = MatchErrorRate(device='cpu')
    >>> metric.update(["the cat sat on the mat"], ["the cat sat on a mat"])
    >>> round(float(metric.compute()), 4)
    0.1667
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MatthewsCorrCoef": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MatthewsCorrCoef
    >>> rng = np.random.RandomState(42)
    >>> metric = MatthewsCorrCoef(task='binary', device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> round(float(metric.compute()), 4)
    -0.2722
    """,
    # oracle-verified (max|delta|=3.7e-09)
    "regression:MeanSquaredLogError": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.regression import MeanSquaredLogError
    >>> rng = np.random.RandomState(42)
    >>> metric = MeanSquaredLogError(device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32) + 0.5, rng.rand(10).astype(np.float32) + 0.5)
    >>> round(float(metric.compute()), 4)
    0.0184
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "regression:MinkowskiDistance": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.regression import MinkowskiDistance
    >>> rng = np.random.RandomState(42)
    >>> metric = MinkowskiDistance(p=3, device='cpu')
    >>> metric.update(rng.randn(10).astype(np.float32), rng.randn(10).astype(np.float32))
    >>> round(float(metric.compute()), 4)
    4.1208
    """,
    # oracle-verified (max|delta|=2.5e-09)
    "detection:ModifiedPanopticQuality": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.detection import ModifiedPanopticQuality
    >>> rng = np.random.RandomState(42)
    >>> metric = ModifiedPanopticQuality(things={0, 1}, stuffs={2}, allow_unknown_preds_category=True, device='cpu')
    >>> metric.update(rng.randint(0, 3, (1, 8, 8, 2)), rng.randint(0, 3, (1, 8, 8, 2)))
    >>> round(float(metric.compute()), 4)
    0.1176
    """,
    # oracle-verified (max|delta|=1.2e-06)
    "image:MultiScaleStructuralSimilarityIndexMeasure": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.image import MultiScaleStructuralSimilarityIndexMeasure
    >>> rng = np.random.RandomState(42)
    >>> metric = MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, kernel_size=3, betas=(0.3, 0.7), device='cpu')
    >>> metric.update(rng.rand(1, 3, 48, 48).astype(np.float32), rng.rand(1, 3, 48, 48).astype(np.float32))
    >>> round(float(metric.compute()), 4)
    0.0197
    """,
    # oracle-verified (max|delta|=6.0e-08)
    "classification:MulticlassAUROC": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MulticlassAUROC
    >>> rng = np.random.RandomState(42)
    >>> metric = MulticlassAUROC(num_classes=5, device='cpu')
    >>> metric.update(rng.rand(8, 5).astype(np.float32), rng.randint(0, 5, 8))
    >>> round(float(metric.compute()), 4)
    0.6367
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MulticlassAveragePrecision": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MulticlassAveragePrecision
    >>> rng = np.random.RandomState(42)
    >>> metric = MulticlassAveragePrecision(num_classes=5, device='cpu')
    >>> metric.update(rng.rand(8, 5).astype(np.float32), rng.randint(0, 5, 8))
    >>> round(float(metric.compute()), 4)
    0.4352
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MulticlassCalibrationError": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MulticlassCalibrationError
    >>> rng = np.random.RandomState(42)
    >>> metric = MulticlassCalibrationError(num_classes=5, device='cpu')
    >>> metric.update(rng.rand(8, 5).astype(np.float32), rng.randint(0, 5, 8))
    >>> round(float(metric.compute()), 4)
    0.8103
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MulticlassCohenKappa": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MulticlassCohenKappa
    >>> rng = np.random.RandomState(42)
    >>> metric = MulticlassCohenKappa(num_classes=5, device='cpu')
    >>> metric.update(rng.rand(8, 5).astype(np.float32), rng.randint(0, 5, 8))
    >>> round(float(metric.compute()), 4)
    -0.1852
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MulticlassFBetaScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MulticlassFBetaScore
    >>> rng = np.random.RandomState(42)
    >>> metric = MulticlassFBetaScore(num_classes=5, beta=2.0, device='cpu')
    >>> metric.update(rng.rand(8, 5).astype(np.float32), rng.randint(0, 5, 8))
    >>> round(float(metric.compute()), 4)
    0.0
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MulticlassHingeLoss": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MulticlassHingeLoss
    >>> rng = np.random.RandomState(42)
    >>> metric = MulticlassHingeLoss(num_classes=5, device='cpu')
    >>> metric.update(rng.rand(8, 5).astype(np.float32), rng.randint(0, 5, 8))
    >>> round(float(metric.compute()), 4)
    1.2926
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MulticlassMatthewsCorrCoef": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MulticlassMatthewsCorrCoef
    >>> rng = np.random.RandomState(42)
    >>> metric = MulticlassMatthewsCorrCoef(num_classes=5, device='cpu')
    >>> metric.update(rng.rand(8, 5).astype(np.float32), rng.randint(0, 5, 8))
    >>> round(float(metric.compute()), 4)
    -0.2128
    """,
    # shape-only (no value pinned)
    "classification:MulticlassPrecisionAtFixedRecall": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MulticlassPrecisionAtFixedRecall
    >>> rng = np.random.RandomState(42)
    >>> metric = MulticlassPrecisionAtFixedRecall(num_classes=5, min_recall=0.5, device='cpu')
    >>> metric.update(rng.rand(8, 5).astype(np.float32), rng.randint(0, 5, 8))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((5,), (5,))
    """,
    # shape-only (no value pinned)
    "classification:MulticlassPrecisionRecallCurve": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MulticlassPrecisionRecallCurve
    >>> rng = np.random.RandomState(42)
    >>> metric = MulticlassPrecisionRecallCurve(num_classes=5, thresholds=5, device='cpu')
    >>> metric.update(rng.rand(8, 5).astype(np.float32), rng.randint(0, 5, 8))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((5, 6), (5, 6), (5,))
    """,
    # shape-only (no value pinned)
    "classification:MulticlassROC": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MulticlassROC
    >>> rng = np.random.RandomState(42)
    >>> metric = MulticlassROC(num_classes=5, thresholds=5, device='cpu')
    >>> metric.update(rng.rand(8, 5).astype(np.float32), rng.randint(0, 5, 8))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((5, 5), (5, 5), (5,))
    """,
    # shape-only (no value pinned)
    "classification:MulticlassRecallAtFixedPrecision": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MulticlassRecallAtFixedPrecision
    >>> rng = np.random.RandomState(42)
    >>> metric = MulticlassRecallAtFixedPrecision(num_classes=5, min_precision=0.5, device='cpu')
    >>> metric.update(rng.rand(8, 5).astype(np.float32), rng.randint(0, 5, 8))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((5,), (5,))
    """,
    # shape-only (no value pinned)
    "classification:MulticlassSensitivityAtSpecificity": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MulticlassSensitivityAtSpecificity
    >>> rng = np.random.RandomState(42)
    >>> metric = MulticlassSensitivityAtSpecificity(num_classes=5, min_specificity=0.5, device='cpu')
    >>> metric.update(rng.rand(8, 5).astype(np.float32), rng.randint(0, 5, 8))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((5,), (5,))
    """,
    # shape-only (no value pinned)
    "classification:MulticlassSpecificityAtSensitivity": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MulticlassSpecificityAtSensitivity
    >>> rng = np.random.RandomState(42)
    >>> metric = MulticlassSpecificityAtSensitivity(num_classes=5, min_sensitivity=0.5, device='cpu')
    >>> metric.update(rng.rand(8, 5).astype(np.float32), rng.randint(0, 5, 8))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((5,), (5,))
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MultilabelAUROC": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MultilabelAUROC
    >>> rng = np.random.RandomState(42)
    >>> metric = MultilabelAUROC(num_labels=3, device='cpu')
    >>> metric.update(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3)))
    >>> round(float(metric.compute()), 4)
    0.5458
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MultilabelAveragePrecision": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MultilabelAveragePrecision
    >>> rng = np.random.RandomState(42)
    >>> metric = MultilabelAveragePrecision(num_labels=3, device='cpu')
    >>> metric.update(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3)))
    >>> round(float(metric.compute()), 4)
    0.6543
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MultilabelConfusionMatrix": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MultilabelConfusionMatrix
    >>> rng = np.random.RandomState(42)
    >>> metric = MultilabelConfusionMatrix(num_labels=3, device='cpu')
    >>> metric.update(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3)))
    >>> [round(float(v), 4) for v in np.asarray(metric.compute()).reshape(-1)]
    [2.0, 2.0, 3.0, 1.0, 5.0, 0.0, 1.0, 2.0, 1.0, 2.0, 2.0, 3.0]
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MultilabelCoverageError": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MultilabelCoverageError
    >>> rng = np.random.RandomState(42)
    >>> metric = MultilabelCoverageError(num_labels=3, device='cpu')
    >>> metric.update(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3)))
    >>> round(float(metric.compute()), 4)
    1.75
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MultilabelExactMatch": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MultilabelExactMatch
    >>> rng = np.random.RandomState(42)
    >>> metric = MultilabelExactMatch(num_labels=3, device='cpu')
    >>> metric.update(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3)))
    >>> round(float(metric.compute()), 4)
    0.25
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MultilabelF1Score": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MultilabelF1Score
    >>> rng = np.random.RandomState(42)
    >>> metric = MultilabelF1Score(num_labels=3, device='cpu')
    >>> metric.update(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3)))
    >>> round(float(metric.compute()), 4)
    0.5619
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MultilabelFBetaScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MultilabelFBetaScore
    >>> rng = np.random.RandomState(42)
    >>> metric = MultilabelFBetaScore(num_labels=3, beta=2.0, device='cpu')
    >>> metric.update(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3)))
    >>> round(float(metric.compute()), 4)
    0.5258
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MultilabelJaccardIndex": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MultilabelJaccardIndex
    >>> rng = np.random.RandomState(42)
    >>> metric = MultilabelJaccardIndex(num_labels=3, device='cpu')
    >>> metric.update(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3)))
    >>> round(float(metric.compute()), 4)
    0.4206
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MultilabelMatthewsCorrCoef": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MultilabelMatthewsCorrCoef
    >>> rng = np.random.RandomState(42)
    >>> metric = MultilabelMatthewsCorrCoef(num_labels=3, device='cpu')
    >>> metric.update(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3)))
    >>> round(float(metric.compute()), 4)
    0.169
    """,
    # shape-only (no value pinned)
    "classification:MultilabelPrecisionAtFixedRecall": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MultilabelPrecisionAtFixedRecall
    >>> rng = np.random.RandomState(42)
    >>> metric = MultilabelPrecisionAtFixedRecall(num_labels=3, min_recall=0.5, device='cpu')
    >>> metric.update(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3)))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((3,), (3,))
    """,
    # shape-only (no value pinned)
    "classification:MultilabelPrecisionRecallCurve": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MultilabelPrecisionRecallCurve
    >>> rng = np.random.RandomState(42)
    >>> metric = MultilabelPrecisionRecallCurve(num_labels=3, thresholds=5, device='cpu')
    >>> metric.update(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3)))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((3, 6), (3, 6), (5,))
    """,
    # shape-only (no value pinned)
    "classification:MultilabelROC": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MultilabelROC
    >>> rng = np.random.RandomState(42)
    >>> metric = MultilabelROC(num_labels=3, thresholds=5, device='cpu')
    >>> metric.update(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3)))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((3, 5), (3, 5), (5,))
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MultilabelRankingAveragePrecision": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MultilabelRankingAveragePrecision
    >>> rng = np.random.RandomState(42)
    >>> metric = MultilabelRankingAveragePrecision(num_labels=3, device='cpu')
    >>> metric.update(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3)))
    >>> round(float(metric.compute()), 4)
    0.9583
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MultilabelRankingLoss": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MultilabelRankingLoss
    >>> rng = np.random.RandomState(42)
    >>> metric = MultilabelRankingLoss(num_labels=3, device='cpu')
    >>> metric.update(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3)))
    >>> round(float(metric.compute()), 4)
    0.125
    """,
    # shape-only (no value pinned)
    "classification:MultilabelRecallAtFixedPrecision": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MultilabelRecallAtFixedPrecision
    >>> rng = np.random.RandomState(42)
    >>> metric = MultilabelRecallAtFixedPrecision(num_labels=3, min_precision=0.5, device='cpu')
    >>> metric.update(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3)))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((3,), (3,))
    """,
    # shape-only (no value pinned)
    "classification:MultilabelSensitivityAtSpecificity": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MultilabelSensitivityAtSpecificity
    >>> rng = np.random.RandomState(42)
    >>> metric = MultilabelSensitivityAtSpecificity(num_labels=3, min_specificity=0.5, device='cpu')
    >>> metric.update(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3)))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((3,), (3,))
    """,
    # shape-only (no value pinned)
    "classification:MultilabelSpecificityAtSensitivity": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MultilabelSpecificityAtSensitivity
    >>> rng = np.random.RandomState(42)
    >>> metric = MultilabelSpecificityAtSensitivity(num_labels=3, min_sensitivity=0.5, device='cpu')
    >>> metric.update(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3)))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((3,), (3,))
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:MultilabelStatScores": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import MultilabelStatScores
    >>> rng = np.random.RandomState(42)
    >>> metric = MultilabelStatScores(num_labels=3, device='cpu')
    >>> metric.update(rng.rand(8, 3).astype(np.float32), rng.randint(0, 2, (8, 3)))
    >>> [round(float(v), 4) for v in np.asarray(metric.compute()).reshape(-1)]
    [2.0, 1.3333, 2.6667, 2.0, 4.0]
    """,
    # oracle-verified (max|delta|=1.6e-07)
    "clustering:NormalizedMutualInfoScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.clustering import NormalizedMutualInfoScore
    >>> rng = np.random.RandomState(42)
    >>> metric = NormalizedMutualInfoScore(device='cpu')
    >>> metric.update(rng.randint(0, 3, 16), rng.randint(0, 3, 16))
    >>> round(float(metric.compute()), 4)
    0.144
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "detection:PanopticQuality": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.detection import PanopticQuality
    >>> rng = np.random.RandomState(42)
    >>> metric = PanopticQuality(things={0, 1}, stuffs={2}, allow_unknown_preds_category=True, device='cpu')
    >>> metric.update(rng.randint(0, 3, (1, 8, 8, 2)), rng.randint(0, 3, (1, 8, 8, 2)))
    >>> round(float(metric.compute()), 4)
    0.0
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "image:PeakSignalNoiseRatioWithBlockedEffect": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.image import PeakSignalNoiseRatioWithBlockedEffect
    >>> rng = np.random.RandomState(42)
    >>> metric = PeakSignalNoiseRatioWithBlockedEffect(device='cpu')
    >>> metric.update(rng.rand(1, 1, 16, 16).astype(np.float32), rng.rand(1, 1, 16, 16).astype(np.float32))
    >>> round(float(metric.compute()), 4)
    7.0466
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "nominal:PearsonsContingencyCoefficient": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.nominal import PearsonsContingencyCoefficient
    >>> rng = np.random.RandomState(42)
    >>> metric = PearsonsContingencyCoefficient(num_classes=3, device='cpu')
    >>> metric.update(rng.randint(0, 3, 16), rng.randint(0, 3, 16))
    >>> round(float(metric.compute()), 4)
    0.4395
    """,
    # oracle-verified (max|delta|=3.8e-06)
    "text:Perplexity": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.text import Perplexity
    >>> rng = np.random.RandomState(42)
    >>> metric = Perplexity(device='cpu')
    >>> metric.update(rng.randn(2, 6, 8).astype(np.float32), rng.randint(0, 8, (2, 6)))
    >>> round(float(metric.compute()), 4)
    11.8709
    """,
    # shape-only (no value pinned)
    "classification:PrecisionAtFixedRecall": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import PrecisionAtFixedRecall
    >>> rng = np.random.RandomState(42)
    >>> metric = PrecisionAtFixedRecall(task='binary', min_recall=0.5, device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((), ())
    """,
    # shape-only (no value pinned)
    "classification:PrecisionRecallCurve": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import PrecisionRecallCurve
    >>> rng = np.random.RandomState(42)
    >>> metric = PrecisionRecallCurve(task='binary', thresholds=5, device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((6,), (6,), (5,))
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "image:QualityWithNoReference": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.image import QualityWithNoReference
    >>> rng = np.random.RandomState(42)
    >>> metric = QualityWithNoReference(device='cpu')
    >>> metric.update(rng.rand(2, 3, 32, 32).astype(np.float32), {'ms': rng.rand(2, 3, 16, 16).astype(np.float32), 'pan': rng.rand(2, 3, 32, 32).astype(np.float32), 'pan_lr': rng.rand(2, 3, 16, 16).astype(np.float32)})
    >>> round(float(metric.compute()), 4)
    0.8921
    """,
    # shape-only (no value pinned)
    "classification:ROC": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import ROC
    >>> rng = np.random.RandomState(42)
    >>> metric = ROC(task='binary', thresholds=5, device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((5,), (5,), (5,))
    """,
    # self-pin: reference raised OSError: `nltk` resource `punkt` is not available on a disk and cannot be downloaded as a
    "text:ROUGEScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.text import ROUGEScore
    >>> metric = ROUGEScore(device='cpu')
    >>> metric.update(["the cat sat on the mat"], ["the cat sat on a mat"])
    >>> {k: np.round(np.asarray(v, np.float64), 4).tolist() for k, v in sorted(metric.compute().items())}
    {'rouge1_fmeasure': 0.8333, 'rouge1_precision': 0.8333, 'rouge1_recall': 0.8333, 'rouge2_fmeasure': 0.6, 'rouge2_precision': 0.6, 'rouge2_recall': 0.6, 'rougeL_fmeasure': 0.8333, 'rougeL_precision': 0.8333, 'rougeL_recall': 0.8333, 'rougeLsum_fmeasure': 0.8333, 'rougeLsum_precision': 0.8333, 'rougeLsum_recall': 0.8333}
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "clustering:RandScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.clustering import RandScore
    >>> rng = np.random.RandomState(42)
    >>> metric = RandScore(device='cpu')
    >>> metric.update(rng.randint(0, 3, 16), rng.randint(0, 3, 16))
    >>> round(float(metric.compute()), 4)
    0.5167
    """,
    # shape-only (no value pinned)
    "classification:RecallAtFixedPrecision": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import RecallAtFixedPrecision
    >>> rng = np.random.RandomState(42)
    >>> metric = RecallAtFixedPrecision(task='binary', min_precision=0.5, device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((), ())
    """,
    # oracle-verified (max|delta|=0.0e+00 at generation; the 4th decimal
    # drifts across platform BLAS builds) — pinned ELLIPSIS-safe at 3dp
    "image:RelativeAverageSpectralError": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.image import RelativeAverageSpectralError
    >>> rng = np.random.RandomState(42)
    >>> metric = RelativeAverageSpectralError(device='cpu')
    >>> metric.update(rng.rand(2, 3, 16, 16).astype(np.float32) + 0.1, rng.rand(2, 3, 16, 16).astype(np.float32) + 0.1)
    >>> round(float(metric.compute()), 4)
    4352.280...
    """,
    # oracle-verified (max|delta|=9.5e-07)
    "regression:RelativeSquaredError": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.regression import RelativeSquaredError
    >>> rng = np.random.RandomState(42)
    >>> metric = RelativeSquaredError(device='cpu')
    >>> metric.update(rng.randn(10).astype(np.float32), rng.randn(10).astype(np.float32))
    >>> round(float(metric.compute()), 4)
    5.1162
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "retrieval:RetrievalAUROC": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.retrieval import RetrievalAUROC
    >>> rng = np.random.RandomState(42)
    >>> metric = RetrievalAUROC(device='cpu')
    >>> metric.update(rng.rand(8).astype(np.float32), rng.randint(0, 2, 8), np.repeat(np.arange(2), 4))
    >>> round(float(metric.compute()), 4)
    0.6667
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "retrieval:RetrievalFallOut": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.retrieval import RetrievalFallOut
    >>> rng = np.random.RandomState(42)
    >>> metric = RetrievalFallOut(top_k=2, device='cpu')
    >>> metric.update(rng.rand(8).astype(np.float32), rng.randint(0, 2, 8), np.repeat(np.arange(2), 4))
    >>> round(float(metric.compute()), 4)
    0.0
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "retrieval:RetrievalHitRate": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.retrieval import RetrievalHitRate
    >>> rng = np.random.RandomState(42)
    >>> metric = RetrievalHitRate(top_k=2, device='cpu')
    >>> metric.update(rng.rand(8).astype(np.float32), rng.randint(0, 2, 8), np.repeat(np.arange(2), 4))
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "retrieval:RetrievalMRR": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.retrieval import RetrievalMRR
    >>> rng = np.random.RandomState(42)
    >>> metric = RetrievalMRR(device='cpu')
    >>> metric.update(rng.rand(8).astype(np.float32), rng.randint(0, 2, 8), np.repeat(np.arange(2), 4))
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "retrieval:RetrievalPrecision": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.retrieval import RetrievalPrecision
    >>> rng = np.random.RandomState(42)
    >>> metric = RetrievalPrecision(top_k=2, device='cpu')
    >>> metric.update(rng.rand(8).astype(np.float32), rng.randint(0, 2, 8), np.repeat(np.arange(2), 4))
    >>> round(float(metric.compute()), 4)
    1.0
    """,
    # shape-only (no value pinned)
    "retrieval:RetrievalPrecisionRecallCurve": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.retrieval import RetrievalPrecisionRecallCurve
    >>> rng = np.random.RandomState(42)
    >>> metric = RetrievalPrecisionRecallCurve(max_k=4, device='cpu')
    >>> metric.update(rng.rand(8).astype(np.float32), rng.randint(0, 2, 8), np.repeat(np.arange(2), 4))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((4,), (4,), (4,))
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "retrieval:RetrievalRPrecision": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.retrieval import RetrievalRPrecision
    >>> rng = np.random.RandomState(42)
    >>> metric = RetrievalRPrecision(device='cpu')
    >>> metric.update(rng.rand(8).astype(np.float32), rng.randint(0, 2, 8), np.repeat(np.arange(2), 4))
    >>> round(float(metric.compute()), 4)
    0.6667
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "retrieval:RetrievalRecall": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.retrieval import RetrievalRecall
    >>> rng = np.random.RandomState(42)
    >>> metric = RetrievalRecall(top_k=2, device='cpu')
    >>> metric.update(rng.rand(8).astype(np.float32), rng.randint(0, 2, 8), np.repeat(np.arange(2), 4))
    >>> round(float(metric.compute()), 4)
    0.6667
    """,
    # shape-only (no value pinned)
    "retrieval:RetrievalRecallAtFixedPrecision": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.retrieval import RetrievalRecallAtFixedPrecision
    >>> rng = np.random.RandomState(42)
    >>> metric = RetrievalRecallAtFixedPrecision(min_precision=0.3, max_k=4, device='cpu')
    >>> metric.update(rng.rand(8).astype(np.float32), rng.randint(0, 2, 8), np.repeat(np.arange(2), 4))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((), ())
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "image:RootMeanSquaredErrorUsingSlidingWindow": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.image import RootMeanSquaredErrorUsingSlidingWindow
    >>> rng = np.random.RandomState(42)
    >>> metric = RootMeanSquaredErrorUsingSlidingWindow(window_size=4, device='cpu')
    >>> metric.update(rng.rand(2, 3, 16, 16).astype(np.float32), rng.rand(2, 3, 16, 16).astype(np.float32))
    >>> round(float(metric.compute()), 4)
    0.4068
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "aggregation:RunningMean": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.aggregation import RunningMean
    >>> rng = np.random.RandomState(42)
    >>> metric = RunningMean(window=2, device='cpu')
    >>> metric.update(rng.randn(6).astype(np.float32))
    >>> round(float(metric.compute()), 4)
    0.3435
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "aggregation:RunningSum": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.aggregation import RunningSum
    >>> rng = np.random.RandomState(42)
    >>> metric = RunningSum(window=2, device='cpu')
    >>> metric.update(rng.randn(6).astype(np.float32))
    >>> round(float(metric.compute()), 4)
    2.0609
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "text:SQuAD": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.text import SQuAD
    >>> metric = SQuAD(device='cpu')
    >>> metric.update([{'prediction_text': 'paris', 'id': 'q1'}], [{'answers': {'answer_start': [0], 'text': ['paris']}, 'id': 'q1'}])
    >>> {k: np.round(np.asarray(v, np.float64), 4).tolist() for k, v in sorted(metric.compute().items())}
    {'exact_match': 100.0, 'f1': 100.0}
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "text:SacreBLEUScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.text import SacreBLEUScore
    >>> metric = SacreBLEUScore(device='cpu')
    >>> metric.update(["the squirrel eats the nut"], [["the squirrel is eating the nut"]])
    >>> round(float(metric.compute()), 4)
    0.0
    """,
    # oracle-verified (max|delta|=3.8e-06)
    "audio:ScaleInvariantSignalNoiseRatio": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.audio import ScaleInvariantSignalNoiseRatio
    >>> rng = np.random.RandomState(42)
    >>> metric = ScaleInvariantSignalNoiseRatio(device='cpu')
    >>> metric.update(rng.randn(2, 128).astype(np.float32), rng.randn(2, 128).astype(np.float32))
    >>> round(float(metric.compute()), 4)
    -28.3682
    """,
    # shape-only (no value pinned)
    "classification:SensitivityAtSpecificity": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import SensitivityAtSpecificity
    >>> rng = np.random.RandomState(42)
    >>> metric = SensitivityAtSpecificity(task='binary', min_specificity=0.5, device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((), ())
    """,
    # oracle-verified (max|delta|=1.6e-06)
    "audio:SignalDistortionRatio": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.audio import SignalDistortionRatio
    >>> rng = np.random.RandomState(42)
    >>> metric = SignalDistortionRatio(device='cpu')
    >>> metric.update(rng.randn(2, 640).astype(np.float64), rng.randn(2, 640).astype(np.float64))
    >>> round(float(metric.compute()), 4)
    -0.2616
    """,
    # oracle-verified (max|delta|=7.6e-06)
    "audio:SourceAggregatedSignalDistortionRatio": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.audio import SourceAggregatedSignalDistortionRatio
    >>> rng = np.random.RandomState(42)
    >>> metric = SourceAggregatedSignalDistortionRatio(device='cpu')
    >>> metric.update(rng.randn(1, 2, 256).astype(np.float32), rng.randn(1, 2, 256).astype(np.float32))
    >>> round(float(metric.compute()), 4)
    -39.8171
    """,
    # oracle-verified (max|delta|=1.1e-08)
    "image:SpatialCorrelationCoefficient": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.image import SpatialCorrelationCoefficient
    >>> rng = np.random.RandomState(42)
    >>> metric = SpatialCorrelationCoefficient(device='cpu')
    >>> metric.update(rng.rand(2, 3, 16, 16).astype(np.float32), rng.rand(2, 3, 16, 16).astype(np.float32))
    >>> round(float(metric.compute()), 4)
    -0.0162
    """,
    # oracle-verified (max|delta|=7.5e-08)
    "image:SpatialDistortionIndex": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.image import SpatialDistortionIndex
    >>> rng = np.random.RandomState(42)
    >>> metric = SpatialDistortionIndex(device='cpu')
    >>> metric.update(rng.rand(2, 3, 32, 32).astype(np.float32), {'ms': rng.rand(2, 3, 16, 16).astype(np.float32), 'pan': rng.rand(2, 3, 32, 32).astype(np.float32), 'pan_lr': rng.rand(2, 3, 16, 16).astype(np.float32)})
    >>> round(float(metric.compute()), 4)
    0.0692
    """,
    # shape-only (no value pinned)
    "classification:SpecificityAtSensitivity": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import SpecificityAtSensitivity
    >>> rng = np.random.RandomState(42)
    >>> metric = SpecificityAtSensitivity(task='binary', min_sensitivity=0.5, device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> tuple(np.asarray(v).shape for v in metric.compute())
    ((), ())
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "image:SpectralAngleMapper": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.image import SpectralAngleMapper
    >>> rng = np.random.RandomState(42)
    >>> metric = SpectralAngleMapper(device='cpu')
    >>> metric.update(rng.rand(2, 3, 16, 16).astype(np.float32), rng.rand(2, 3, 16, 16).astype(np.float32))
    >>> round(float(metric.compute()), 4)
    0.6218
    """,
    # oracle-verified (max|delta|=6.7e-08)
    "image:SpectralDistortionIndex": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.image import SpectralDistortionIndex
    >>> rng = np.random.RandomState(42)
    >>> metric = SpectralDistortionIndex(device='cpu')
    >>> metric.update(rng.rand(2, 3, 16, 16).astype(np.float32), rng.rand(2, 3, 16, 16).astype(np.float32))
    >>> round(float(metric.compute()), 4)
    0.0892
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "classification:StatScores": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.classification import StatScores
    >>> rng = np.random.RandomState(42)
    >>> metric = StatScores(task='binary', device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32), rng.randint(0, 2, 10))
    >>> [round(float(v), 4) for v in np.asarray(metric.compute()).reshape(-1)]
    [5.0, 1.0, 0.0, 4.0, 9.0]
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "regression:SymmetricMeanAbsolutePercentageError": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.regression import SymmetricMeanAbsolutePercentageError
    >>> rng = np.random.RandomState(42)
    >>> metric = SymmetricMeanAbsolutePercentageError(device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32) + 0.5, rng.rand(10).astype(np.float32) + 0.5)
    >>> round(float(metric.compute()), 4)
    0.2335
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "nominal:TheilsU": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.nominal import TheilsU
    >>> rng = np.random.RandomState(42)
    >>> metric = TheilsU(num_classes=3, device='cpu')
    >>> metric.update(rng.randint(0, 3, 16), rng.randint(0, 3, 16))
    >>> round(float(metric.compute()), 4)
    0.1535
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "text:TranslationEditRate": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.text import TranslationEditRate
    >>> metric = TranslationEditRate(device='cpu')
    >>> metric.update(["the squirrel eats the nut"], [["the squirrel is eating the nut"]])
    >>> round(float(metric.compute()), 4)
    0.3333
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "nominal:TschuprowsT": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.nominal import TschuprowsT
    >>> rng = np.random.RandomState(42)
    >>> metric = TschuprowsT(num_classes=3, device='cpu')
    >>> metric.update(rng.randint(0, 3, 16), rng.randint(0, 3, 16))
    >>> round(float(metric.compute()), 4)
    0.0
    """,
    # oracle-verified (max|delta|=1.2e-07)
    "regression:TweedieDevianceScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.regression import TweedieDevianceScore
    >>> rng = np.random.RandomState(42)
    >>> metric = TweedieDevianceScore(power=1.5, device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32) + 0.5, rng.rand(10).astype(np.float32) + 0.5)
    >>> round(float(metric.compute()), 4)
    0.0755
    """,
    # oracle-verified (max|delta|=1.8e-07)
    "clustering:VMeasureScore": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.clustering import VMeasureScore
    >>> rng = np.random.RandomState(42)
    >>> metric = VMeasureScore(device='cpu')
    >>> metric.update(rng.randint(0, 3, 16), rng.randint(0, 3, 16))
    >>> round(float(metric.compute()), 4)
    0.144
    """,
    # oracle-verified (max|delta|=2.8e-08)
    "image:VisualInformationFidelity": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.image import VisualInformationFidelity
    >>> rng = np.random.RandomState(42)
    >>> metric = VisualInformationFidelity(device='cpu')
    >>> metric.update(rng.rand(1, 3, 48, 48).astype(np.float32), rng.rand(1, 3, 48, 48).astype(np.float32))
    >>> round(float(metric.compute()), 4)
    0.0035
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "regression:WeightedMeanAbsolutePercentageError": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.regression import WeightedMeanAbsolutePercentageError
    >>> rng = np.random.RandomState(42)
    >>> metric = WeightedMeanAbsolutePercentageError(device='cpu')
    >>> metric.update(rng.rand(10).astype(np.float32) + 0.5, rng.rand(10).astype(np.float32) + 0.5)
    >>> round(float(metric.compute()), 4)
    0.2331
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "text:WordInfoLost": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.text import WordInfoLost
    >>> metric = WordInfoLost(device='cpu')
    >>> metric.update(["the cat sat on the mat"], ["the cat sat on a mat"])
    >>> round(float(metric.compute()), 4)
    0.3056
    """,
    # oracle-verified (max|delta|=0.0e+00)
    "text:WordInfoPreserved": """
    >>> import numpy as np
    >>> from torchmetrics_tpu_torch.text import WordInfoPreserved
    >>> metric = WordInfoPreserved(device='cpu')
    >>> metric.update(["the cat sat on the mat"], ["the cat sat on a mat"])
    >>> round(float(metric.compute()), 4)
    0.6944
    """,
}

_PROVENANCE = {
    "classification:AUROC": 'oracle-verified (max|delta|=0.0e+00)',
    "clustering:AdjustedMutualInfoScore": 'oracle-verified (max|delta|=1.4e-07)',
    "classification:AveragePrecision": 'oracle-verified (max|delta|=6.0e-08)',
    "classification:BinaryAveragePrecision": 'oracle-verified (max|delta|=6.0e-08)',
    "classification:BinaryCalibrationError": 'oracle-verified (max|delta|=6.0e-08)',
    "classification:BinaryConfusionMatrix": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:BinaryFairness": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:BinaryGroupStatRates": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:BinaryHingeLoss": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:BinaryPrecisionAtFixedRecall": 'shape-only (no value pinned)',
    "classification:BinaryPrecisionRecallCurve": 'shape-only (no value pinned)',
    "classification:BinaryROC": 'shape-only (no value pinned)',
    "classification:BinaryRecallAtFixedPrecision": 'shape-only (no value pinned)',
    "classification:BinarySensitivityAtSpecificity": 'shape-only (no value pinned)',
    "classification:BinarySpecificityAtSensitivity": 'shape-only (no value pinned)',
    "text:CHRFScore": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:CalibrationError": 'oracle-verified (max|delta|=6.0e-08)',
    "clustering:CalinskiHarabaszScore": 'oracle-verified (max|delta|=6.0e-08)',
    "classification:CohenKappa": 'oracle-verified (max|delta|=0.0e+00)',
    "detection:CompleteIntersectionOverUnion": 'self-pin: reference class unresolved (AttributeError)',
    "clustering:CompletenessScore": 'oracle-verified (max|delta|=1.6e-07)',
    "audio:ComplexScaleInvariantSignalNoiseRatio": 'self-pin: agrees to 3.8e-06 but differs at 4dp rounding',
    "regression:ConcordanceCorrCoef": 'oracle-verified (max|delta|=3.7e-09)',
    "classification:ConfusionMatrix": 'oracle-verified (max|delta|=0.0e+00)',
    "nominal:CramersV": 'oracle-verified (max|delta|=0.0e+00)',
    "regression:CriticalSuccessIndex": 'oracle-verified (max|delta|=0.0e+00)',
    "clustering:DaviesBouldinScore": 'oracle-verified (max|delta|=1.2e-07)',
    "classification:Dice": 'oracle-verified (max|delta|=0.0e+00)',
    "detection:DistanceIntersectionOverUnion": 'self-pin: reference class unresolved (AttributeError)',
    "clustering:DunnIndex": 'oracle-verified (max|delta|=6.0e-08)',
    "image:ErrorRelativeGlobalDimensionlessSynthesis": 'oracle-verified (max|delta|=1.9e-06)',
    "classification:ExactMatch": 'oracle-verified (max|delta|=0.0e+00)',
    "text:ExtendedEditDistance": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:F1Score": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:FBetaScore": 'oracle-verified (max|delta|=0.0e+00)',
    "nominal:FleissKappa": 'oracle-verified (max|delta|=0.0e+00)',
    "clustering:FowlkesMallowsIndex": 'oracle-verified (max|delta|=3.0e-08)',
    "segmentation:GeneralizedDiceScore": 'oracle-verified (max|delta|=0.0e+00)',
    "detection:GeneralizedIntersectionOverUnion": 'self-pin: reference class unresolved (AttributeError)',
    "classification:HingeLoss": 'oracle-verified (max|delta|=0.0e+00)',
    "clustering:HomogeneityScore": 'oracle-verified (max|delta|=1.5e-07)',
    "detection:IntersectionOverUnion": 'self-pin: reference class unresolved (AttributeError)',
    "classification:JaccardIndex": 'oracle-verified (max|delta|=0.0e+00)',
    "regression:KLDivergence": 'oracle-verified (max|delta|=3.0e-08)',
    "regression:KendallRankCorrCoef": 'oracle-verified (max|delta|=0.0e+00)',
    "regression:LogCoshError": 'oracle-verified (max|delta|=0.0e+00)',
    "text:MatchErrorRate": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:MatthewsCorrCoef": 'oracle-verified (max|delta|=0.0e+00)',
    "regression:MeanSquaredLogError": 'oracle-verified (max|delta|=3.7e-09)',
    "regression:MinkowskiDistance": 'oracle-verified (max|delta|=0.0e+00)',
    "detection:ModifiedPanopticQuality": 'oracle-verified (max|delta|=2.5e-09)',
    "image:MultiScaleStructuralSimilarityIndexMeasure": 'oracle-verified (max|delta|=1.2e-06)',
    "classification:MulticlassAUROC": 'oracle-verified (max|delta|=6.0e-08)',
    "classification:MulticlassAveragePrecision": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:MulticlassCalibrationError": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:MulticlassCohenKappa": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:MulticlassFBetaScore": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:MulticlassHingeLoss": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:MulticlassMatthewsCorrCoef": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:MulticlassPrecisionAtFixedRecall": 'shape-only (no value pinned)',
    "classification:MulticlassPrecisionRecallCurve": 'shape-only (no value pinned)',
    "classification:MulticlassROC": 'shape-only (no value pinned)',
    "classification:MulticlassRecallAtFixedPrecision": 'shape-only (no value pinned)',
    "classification:MulticlassSensitivityAtSpecificity": 'shape-only (no value pinned)',
    "classification:MulticlassSpecificityAtSensitivity": 'shape-only (no value pinned)',
    "classification:MultilabelAUROC": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:MultilabelAveragePrecision": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:MultilabelConfusionMatrix": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:MultilabelCoverageError": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:MultilabelExactMatch": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:MultilabelF1Score": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:MultilabelFBetaScore": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:MultilabelJaccardIndex": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:MultilabelMatthewsCorrCoef": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:MultilabelPrecisionAtFixedRecall": 'shape-only (no value pinned)',
    "classification:MultilabelPrecisionRecallCurve": 'shape-only (no value pinned)',
    "classification:MultilabelROC": 'shape-only (no value pinned)',
    "classification:MultilabelRankingAveragePrecision": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:MultilabelRankingLoss": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:MultilabelRecallAtFixedPrecision": 'shape-only (no value pinned)',
    "classification:MultilabelSensitivityAtSpecificity": 'shape-only (no value pinned)',
    "classification:MultilabelSpecificityAtSensitivity": 'shape-only (no value pinned)',
    "classification:MultilabelStatScores": 'oracle-verified (max|delta|=0.0e+00)',
    "clustering:NormalizedMutualInfoScore": 'oracle-verified (max|delta|=1.6e-07)',
    "detection:PanopticQuality": 'oracle-verified (max|delta|=0.0e+00)',
    "image:PeakSignalNoiseRatioWithBlockedEffect": 'oracle-verified (max|delta|=0.0e+00)',
    "nominal:PearsonsContingencyCoefficient": 'oracle-verified (max|delta|=0.0e+00)',
    "text:Perplexity": 'oracle-verified (max|delta|=3.8e-06)',
    "classification:PrecisionAtFixedRecall": 'shape-only (no value pinned)',
    "classification:PrecisionRecallCurve": 'shape-only (no value pinned)',
    "image:QualityWithNoReference": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:ROC": 'shape-only (no value pinned)',
    "text:ROUGEScore": 'self-pin: reference raised OSError: `nltk` resource `punkt` is not available on a disk and cannot be downloaded as a',
    "clustering:RandScore": 'oracle-verified (max|delta|=0.0e+00)',
    "classification:RecallAtFixedPrecision": 'shape-only (no value pinned)',
    "image:RelativeAverageSpectralError": 'oracle-verified (max|delta|=0.0e+00)',
    "regression:RelativeSquaredError": 'oracle-verified (max|delta|=9.5e-07)',
    "retrieval:RetrievalAUROC": 'oracle-verified (max|delta|=0.0e+00)',
    "retrieval:RetrievalFallOut": 'oracle-verified (max|delta|=0.0e+00)',
    "retrieval:RetrievalHitRate": 'oracle-verified (max|delta|=0.0e+00)',
    "retrieval:RetrievalMRR": 'oracle-verified (max|delta|=0.0e+00)',
    "retrieval:RetrievalPrecision": 'oracle-verified (max|delta|=0.0e+00)',
    "retrieval:RetrievalPrecisionRecallCurve": 'shape-only (no value pinned)',
    "retrieval:RetrievalRPrecision": 'oracle-verified (max|delta|=0.0e+00)',
    "retrieval:RetrievalRecall": 'oracle-verified (max|delta|=0.0e+00)',
    "retrieval:RetrievalRecallAtFixedPrecision": 'shape-only (no value pinned)',
    "image:RootMeanSquaredErrorUsingSlidingWindow": 'oracle-verified (max|delta|=0.0e+00)',
    "aggregation:RunningMean": 'oracle-verified (max|delta|=0.0e+00)',
    "aggregation:RunningSum": 'oracle-verified (max|delta|=0.0e+00)',
    "text:SQuAD": 'oracle-verified (max|delta|=0.0e+00)',
    "text:SacreBLEUScore": 'oracle-verified (max|delta|=0.0e+00)',
    "audio:ScaleInvariantSignalNoiseRatio": 'oracle-verified (max|delta|=3.8e-06)',
    "classification:SensitivityAtSpecificity": 'shape-only (no value pinned)',
    "audio:SignalDistortionRatio": 'oracle-verified (max|delta|=1.6e-06)',
    "audio:SourceAggregatedSignalDistortionRatio": 'oracle-verified (max|delta|=7.6e-06)',
    "image:SpatialCorrelationCoefficient": 'oracle-verified (max|delta|=1.1e-08)',
    "image:SpatialDistortionIndex": 'oracle-verified (max|delta|=7.5e-08)',
    "classification:SpecificityAtSensitivity": 'shape-only (no value pinned)',
    "image:SpectralAngleMapper": 'oracle-verified (max|delta|=0.0e+00)',
    "image:SpectralDistortionIndex": 'oracle-verified (max|delta|=6.7e-08)',
    "classification:StatScores": 'oracle-verified (max|delta|=0.0e+00)',
    "regression:SymmetricMeanAbsolutePercentageError": 'oracle-verified (max|delta|=0.0e+00)',
    "nominal:TheilsU": 'oracle-verified (max|delta|=0.0e+00)',
    "text:TranslationEditRate": 'oracle-verified (max|delta|=0.0e+00)',
    "nominal:TschuprowsT": 'oracle-verified (max|delta|=0.0e+00)',
    "regression:TweedieDevianceScore": 'oracle-verified (max|delta|=1.2e-07)',
    "clustering:VMeasureScore": 'oracle-verified (max|delta|=1.8e-07)',
    "image:VisualInformationFidelity": 'oracle-verified (max|delta|=2.8e-08)',
    "regression:WeightedMeanAbsolutePercentageError": 'oracle-verified (max|delta|=0.0e+00)',
    "text:WordInfoLost": 'oracle-verified (max|delta|=0.0e+00)',
    "text:WordInfoPreserved": 'oracle-verified (max|delta|=0.0e+00)',
}
