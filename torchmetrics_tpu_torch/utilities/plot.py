# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Matplotlib-optional plotting renderers (counterpart of
``torchmetrics_tpu/utilities/plot.py``, which the port copies rather than
imports: the port imports nothing of the JAX package).

Values may be tensors on any device: each goes to the host with
``.detach().cpu()`` before numpy sees it (``np.asarray`` of a CUDA tensor
raises).
"""
from __future__ import annotations

import importlib.util
from math import ceil, floor, sqrt
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

_error_msg = "matplotlib is required to plot metrics. Install with `pip install matplotlib`."


def _get_plt():
    if importlib.util.find_spec("matplotlib") is None:
        raise ModuleNotFoundError(_error_msg)
    import matplotlib.pyplot as plt

    return plt


def _host(value: Any) -> np.ndarray:
    """A value (tensor on any device, array, number) as a host numpy array."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def plot_single_or_multi_val(
    val,
    ax=None,
    higher_is_better: Optional[bool] = None,
    lower_bound: Optional[float] = None,
    upper_bound: Optional[float] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
):
    """Plot a single/multiple scalar value(s)."""
    plt = _get_plt()
    fig, ax = (None, ax) if ax is not None else plt.subplots(1, 1)
    if isinstance(val, dict):
        for i, (k, v) in enumerate(val.items()):
            v = _host(v)
            if v.ndim == 0:
                ax.plot([i], [float(v)], marker="o", markersize=10, linestyle="None", label=k)
            else:
                ax.plot(np.ravel(v), label=k)
    elif isinstance(val, Sequence) and not isinstance(val, str):
        arr = np.stack([np.atleast_1d(_host(v)) for v in val])
        if arr.ndim == 2 and arr.shape[1] > 1:
            for c in range(arr.shape[1]):
                ax.plot(arr[:, c], marker="o", label=f"{legend_name or 'class'} {c}")
        else:
            ax.plot(np.ravel(arr), marker="o")
    else:
        arr = np.atleast_1d(_host(val))
        ax.plot(np.arange(arr.size), np.ravel(arr), marker="o", markersize=10, linestyle="None")
    if lower_bound is not None or upper_bound is not None:
        ax.set_ylim(bottom=lower_bound, top=upper_bound)
    if name is not None:
        ax.set_title(name)
    handles, labels = ax.get_legend_handles_labels()
    if labels:
        ax.legend()
    ax.grid(True)
    return fig, ax


def trim_axs(axs, nb: int):
    """Trim a grid of axes to ``nb`` used axes."""
    if not isinstance(axs, np.ndarray):
        return axs
    axs = axs.flat
    for ax in axs[nb:]:
        ax.remove()
    return axs[:nb]


def plot_confusion_matrix(
    confmat,
    ax=None,
    add_text: bool = True,
    labels: Optional[List[Union[str, int]]] = None,
    cmap=None,
):
    """Render one or several confusion matrices."""
    plt = _get_plt()
    confmat = _host(confmat)
    if confmat.ndim == 3:  # multilabel
        nb, n_classes = confmat.shape[0], 2
        rows, cols = floor(sqrt(nb)), ceil(nb / floor(sqrt(nb)))
    else:
        nb, n_classes, rows, cols = 1, confmat.shape[0], 1, 1
        confmat = confmat[None]
    if labels is not None and confmat.ndim == 3 and len(labels) != n_classes:
        raise ValueError("Expected number of elements in arg `labels` to match number of labels in confmat")
    labels = labels or np.arange(n_classes).tolist()
    if ax is None:
        fig, axs = plt.subplots(nrows=rows, ncols=cols)
    else:
        fig, axs = None, ax
    axs = trim_axs(axs, nb) if nb > 1 else [axs]
    for i in range(nb):
        ax_i = axs[i] if nb > 1 else axs[0]
        ax_i.imshow(confmat[i], cmap=cmap)
        if nb > 1:
            ax_i.set_title(f"Label {i}", fontsize=15)
        ax_i.set_xlabel("Predicted class", fontsize=15)
        ax_i.set_ylabel("True class", fontsize=15)
        ax_i.set_xticks(list(range(n_classes)))
        ax_i.set_yticks(list(range(n_classes)))
        ax_i.set_xticklabels(labels, rotation=45, fontsize=10)
        ax_i.set_yticklabels(labels, rotation=25, fontsize=10)
        if add_text:
            for ii in range(n_classes):
                for jj in range(n_classes):
                    val = confmat[i, ii, jj]
                    text = str(round(float(val), 2) if np.issubdtype(confmat.dtype, np.floating) else int(val))
                    ax_i.text(jj, ii, text, ha="center", va="center", fontsize=15)
    return fig, axs if nb > 1 else axs[0]


def plot_curve(
    curve: Tuple,
    score=None,
    ax=None,
    label_names: Optional[Tuple[str, str]] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
):
    """Plot a ROC/PR-style curve."""
    plt = _get_plt()
    x, y = _host(curve[0]), _host(curve[1])
    fig, ax = (None, ax) if ax is not None else plt.subplots(1, 1)
    if y.ndim > x.ndim:  # per-class curves share x
        for c in range(y.shape[0]):
            ax.plot(x, y[c], linestyle="-", linewidth=2, label=f"{legend_name or 'class'} {c}")
    elif x.ndim == 2:
        for c in range(x.shape[0]):
            ax.plot(x[c], y[c], linestyle="-", linewidth=2, label=f"{legend_name or 'class'} {c}")
    else:
        label = f"AUC={float(_host(score)):0.3f}" if score is not None else None
        ax.plot(x, y, linestyle="-", linewidth=2, label=label)
    if label_names is not None:
        ax.set_xlabel(label_names[0], fontsize=12)
        ax.set_ylabel(label_names[1], fontsize=12)
    if name is not None:
        ax.set_title(name)
    handles, labels = ax.get_legend_handles_labels()
    if labels:
        ax.legend()
    ax.grid(True)
    return fig, ax
