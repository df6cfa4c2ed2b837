# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Functional metrics of the port: a flat namespace, as the JAX package's."""
from torchmetrics_tpu_torch.functional.audio import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.audio import __all__ as _audio_all
from torchmetrics_tpu_torch.functional.classification import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.classification import __all__ as _classification_all
from torchmetrics_tpu_torch.functional.clustering import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.clustering import __all__ as _clustering_all
from torchmetrics_tpu_torch.functional.detection import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.detection import __all__ as _detection_all
from torchmetrics_tpu_torch.functional.image import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.image import __all__ as _image_all
from torchmetrics_tpu_torch.functional.multimodal import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.multimodal import __all__ as _multimodal_all
from torchmetrics_tpu_torch.functional.nominal import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.nominal import __all__ as _nominal_all
from torchmetrics_tpu_torch.functional.pairwise import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.pairwise import __all__ as _pairwise_all
from torchmetrics_tpu_torch.functional.regression import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.regression import __all__ as _regression_all
from torchmetrics_tpu_torch.functional.retrieval import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.retrieval import __all__ as _retrieval_all
from torchmetrics_tpu_torch.functional.segmentation import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.segmentation import __all__ as _segmentation_all
from torchmetrics_tpu_torch.functional.text import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.text import __all__ as _text_all

__all__ = (
    list(_audio_all)
    + list(_classification_all)
    + list(_clustering_all)
    + list(_detection_all)
    + list(_image_all)
    + list(_multimodal_all)
    + list(_nominal_all)
    + list(_pairwise_all)
    + list(_regression_all)
    + list(_retrieval_all)
    + list(_segmentation_all)
    + list(_text_all)
)
