# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Adjusted mutual information (counterpart of
``torchmetrics_tpu/functional/clustering/adjusted_mutual_info_score.py``)."""
from __future__ import annotations

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.clustering.mutual_info_score import (
    _mutual_info_score_compute,
    _mutual_info_score_update,
)
from torchmetrics_tpu_torch.functional.clustering.utils import (
    _validate_average_method_arg,
    calculate_entropy,
    calculate_generalized_mean,
)
from torchmetrics_tpu_torch.utilities.data import _jnp_dtype, _to_tensors

Tensor = torch.Tensor


def expected_mutual_info_score(contingency: Tensor, n_samples: int) -> Tensor:
    """Expected MI of two random clusterings with fixed marginals (sklearn's
    hypergeometric model), a float32 tensor on ``contingency``'s device.

    The JAX package's host computation copied as it is: numpy float64 with
    ``scipy.special.gammaln`` over a dense masked grid, the nij axis chunked
    to bound the temporaries at about 128 MB. The same numpy on the same
    integers gives JAX's value bit for bit.
    """
    from scipy.special import gammaln

    cont = np.asarray(contingency.cpu())
    a = np.ravel(cont.sum(axis=1)).astype(np.float64)
    b = np.ravel(cont.sum(axis=0)).astype(np.float64)
    if a.shape[0] == 1 or b.shape[0] == 1:
        return torch.tensor(0.0, device=contingency.device)

    n = float(n_samples)
    max_nij = int(min(a.max(), b.max()))
    log_a = np.log(a)[:, None, None]
    log_b = np.log(b)[None, :, None]
    gln_a = gammaln(a + 1)[:, None, None]
    gln_b = gammaln(b + 1)[None, :, None]
    gln_na = gammaln(n - a + 1)[:, None, None]
    gln_nb = gammaln(n - b + 1)[None, :, None]
    gln_n = gammaln(n + 1)
    aij = a[:, None, None]
    bij = b[None, :, None]

    emi = 0.0
    chunk = max(1, (1 << 24) // (a.shape[0] * b.shape[0]))
    for lo in range(1, max_nij + 1, chunk):
        nij = np.arange(lo, min(lo + chunk, max_nij + 1), dtype=np.float64)[None, None, :]
        # valid hypergeometric support: max(1, a+b-n) <= nij <= min(a, b)
        start = np.maximum(1.0, aij + bij - n)
        end = np.minimum(aij, bij)
        valid = (nij >= start) & (nij <= end)
        nij_c = np.where(valid, nij, 1.0)  # clamp so lgamma args stay positive
        term1 = nij_c / n
        term2 = np.log(n) + np.log(nij_c) - log_a - log_b
        gln = (
            gln_a + gln_b + gln_na + gln_nb - (gammaln(nij_c + 1) + gln_n)
            - gammaln(aij - nij_c + 1)
            - gammaln(bij - nij_c + 1)
            - gammaln(n - aij - bij + nij_c + 1)
        )
        emi += float(np.where(valid, term1 * term2 * np.exp(gln), 0.0).sum())
    return torch.tensor(emi, dtype=torch.float32, device=contingency.device)


def adjusted_mutual_info_score(preds: Tensor, target: Tensor, average_method: str = "arithmetic") -> Tensor:
    """Adjusted mutual information."""
    preds, target = map(_jnp_dtype, _to_tensors(preds, target))
    _validate_average_method_arg(average_method)
    contingency = _mutual_info_score_update(preds, target)
    mutual_info = _mutual_info_score_compute(contingency)
    expected_mutual_info = expected_mutual_info_score(contingency, preds.numel())
    normalizer = calculate_generalized_mean(
        torch.stack([calculate_entropy(preds), calculate_entropy(target)]), average_method
    )
    denominator = normalizer - expected_mutual_info
    eps = torch.finfo(torch.float32).eps
    denominator = torch.where(
        denominator < 0, torch.clamp(denominator, max=-eps), torch.clamp(denominator, min=eps)
    )
    return (mutual_info - expected_mutual_info) / denominator
