# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""FeatureShare wrapper (counterpart of ``torchmetrics_tpu/wrappers/feature_share.py``)."""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric


class NetworkCache:
    """An LRU-cached feature network.

    The cache key of a call is a fingerprint of each tensor or array input
    (shape, dtype, a hash of its bytes): each call copies its tensor inputs
    to the host once to hash them. Capacity-bounded via an ordered dict.
    """

    def __init__(self, network: Any, max_size: int = 100) -> None:
        self.max_size = max_size
        self.network = network
        self._cache: "OrderedDict[tuple, Any]" = OrderedDict()

    @staticmethod
    def _key(*args: Any, **kwargs: Any) -> tuple:
        parts = []
        for a in list(args) + [x for kv in sorted(kwargs.items()) for x in kv]:
            if isinstance(a, (torch.Tensor, np.ndarray)):
                host = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                parts.append((host.shape, str(host.dtype), hash(host.tobytes())))
            else:
                parts.append(a)
        return tuple(parts)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        key = self._key(*args, **kwargs)
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        out = self.network(*args, **kwargs)
        self._cache[key] = out
        if len(self._cache) > self.max_size:
            self._cache.popitem(last=False)
        return out


class FeatureShare(MetricCollection):
    """Collection that shares one cached feature network between metrics.

    Each member metric must expose ``feature_network: str`` naming the
    attribute holding its feature extractor; the first member's network is
    wrapped in :class:`NetworkCache` and installed on every member.
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        max_cache_size: Optional[int] = None,
    ) -> None:
        # feature sharing replaces compute-group dedup
        super().__init__(metrics=metrics, compute_groups=False)

        if max_cache_size is None:
            max_cache_size = len(self)
        if not isinstance(max_cache_size, int):
            raise TypeError(f"max_cache_size should be an integer, but got {max_cache_size}")

        try:
            first_net = next(iter(self.values()))
            network_to_share = getattr(first_net, first_net.feature_network)
        except AttributeError as err:
            raise AttributeError(
                "Tried to extract the network to share from the first metric, but it did not have a `feature_network`"
                " attribute. Please make sure that the metric has an attribute with that name,"
                " else it cannot be shared."
            ) from err
        cached_net = NetworkCache(network_to_share, max_size=max_cache_size)

        for metric_name, metric in self.items():
            if not hasattr(metric, "feature_network"):
                raise AttributeError(
                    f"Tried to set the cached network to all metrics, but the metric {metric_name} did not have a"
                    " `feature_network` attribute. Please make sure that the metric has an attribute with that name,"
                    " else it cannot be shared."
                )
            setattr(metric, metric.feature_network, cached_net)
