# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The image domain's pure-math metrics of the port (SSIM, MS-SSIM, UQI,
VIF, SCC, PSNR, PSNRB, ERGAS, SAM, RMSE-SW, RASE, TV, the image gradients,
D_lambda, D_s, QNR and their 15 module classes) against the JAX package's,
on the same seeded numpy inputs on the CPU, where the windowed moments take
K7's plain route.

Budgets:

- ``total`` counts, the ``cat`` states (copies of the inputs) and the
  image gradients (one float32 difference each) are bitwise;
- the other float32 values: ``rtol=1e-5, atol=1e-6`` (sums in another
  order than XLA's, and torch's ``exp``/``log`` against XLA's);
- SSIM, MS-SSIM, UQI, VIF, SCC and the pan-sharpening indices subtract
  ``mu²`` from ``E[x²]``: the variance cancels most of the moment, so the
  moments' rounding (``tests/test_torch_window_moments.py``: 1.4e-6
  relative) grows by the ratio ``E[x²] / var``, up to about 30 on these
  images: ``atol=2e-5`` (measured at most 2.7e-6).
"""
from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu.functional.image as JF
import torchmetrics_tpu_torch as T
import torchmetrics_tpu_torch.functional.image as TF
from torchmetrics_tpu.parallel.fused import fusion_ineligibility as j_fusion_ineligibility
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy
from torchmetrics_tpu_torch.parallel.fused import fusion_ineligibility

RTOL, ATOL = 1e-5, 1e-6
CANCEL_ATOL = 2e-5
#: the per-pixel spectral angle: arccos near 1 turns a cosine that differs in its last bit into an angle
#: that differs by ulp / sin(angle) (measured 4.9e-5 at angles near 0.002)
SAM_ATOL = 1e-4
#: functions and classes whose value subtracts mu² from E[x²]
CANCELLING = ("structural", "multiscale", "universal", "visual", "spatial", "spectral_distortion", "quality",
              "Structural", "MultiScale", "Universal", "Visual", "Spatial", "SpectralDistortion", "Quality")


def _np(x):
    return np.ascontiguousarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def _bitwise(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8), err_msg=what)


def _close(got, want, what="", atol=ATOL):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what, equal_nan=True)


def _budget(name):
    return CANCEL_ATOL if any(name.startswith(p) for p in CANCELLING) else ATOL


def _pair(seed, shape, noise=0.08):
    rng = np.random.default_rng(seed)
    target = rng.random(shape, dtype=np.float32)
    preds = np.clip(target + noise * rng.standard_normal(shape).astype(np.float32), 0.0, 1.0).astype(np.float32)
    return preds, target


def _both(x):
    """A numpy input as each package's array: (torch tensor, jnp array)."""
    if isinstance(x, dict):
        return {k: _both(v)[0] for k, v in x.items()}, {k: _both(v)[1] for k, v in x.items()}
    return torch.from_numpy(np.array(x)), jnp.asarray(x)


def _pansharpening(seed, bands=4, size=64, ratio=4):
    rng = np.random.default_rng(seed)
    ms = rng.random((2, bands, size // ratio, size // ratio), dtype=np.float32)
    pan = rng.random((2, bands, size, size), dtype=np.float32)
    preds = np.clip(pan * 0.7 + 0.3 * np.repeat(np.repeat(ms, ratio, 2), ratio, 3), 0, 1).astype(np.float32)
    pan_lr = rng.random((2, bands, size // ratio, size // ratio), dtype=np.float32)
    return preds, ms, pan, pan_lr


def _inputs(kind, seed):
    if kind == "rgb":
        return _pair(seed, (2, 3, 48, 52))
    if kind == "gray":
        return _pair(seed, (2, 1, 40, 44))
    if kind == "big":
        return _pair(seed, (2, 3, 80, 84), noise=0.03)
    if kind == "vol":
        return _pair(seed, (2, 1, 12, 14, 16))
    if kind == "one":
        return _pair(seed, (2, 3, 20, 24))[:1]
    preds, ms, pan, pan_lr = _pansharpening(seed)
    if kind == "pan":
        return preds, {"ms": ms, "pan": pan}
    if kind == "pan_lr":
        return preds, {"ms": ms, "pan": pan, "pan_lr": pan_lr}
    return preds, ms  # "lambda": D_lambda's fused image and its low-resolution reference


# ---------------------------------------------------------------- functions

FUNCTION_CASES = [
    ("structural_similarity_index_measure", "rgb", {}),
    ("structural_similarity_index_measure", "rgb", {"reduction": "none", "data_range": 1.0}),
    ("structural_similarity_index_measure", "rgb", {"reduction": "sum", "data_range": (0.1, 0.9)}),
    ("structural_similarity_index_measure", "rgb", {"gaussian_kernel": False, "kernel_size": 7}),
    ("structural_similarity_index_measure", "rgb", {"sigma": (1.0, 2.0), "k1": 0.02, "k2": 0.05}),
    ("structural_similarity_index_measure", "rgb", {"return_full_image": True}),
    ("structural_similarity_index_measure", "rgb", {"return_contrast_sensitivity": True, "data_range": 1.0}),
    ("structural_similarity_index_measure", "vol", {"kernel_size": 5, "sigma": 0.8}),
    ("structural_similarity_index_measure", "vol", {"gaussian_kernel": False, "kernel_size": 3, "return_full_image": True}),
    ("multiscale_structural_similarity_index_measure", "big", {"kernel_size": 5}),
    ("multiscale_structural_similarity_index_measure", "big", {"kernel_size": 5, "normalize": "simple", "reduction": "none"}),
    ("multiscale_structural_similarity_index_measure", "big", {"kernel_size": 5, "normalize": None, "data_range": 1.0}),
    ("multiscale_structural_similarity_index_measure", "big", {"kernel_size": 3, "betas": (0.5, 0.5), "gaussian_kernel": False}),
    ("universal_image_quality_index", "rgb", {}),
    ("universal_image_quality_index", "rgb", {"kernel_size": (5, 7), "sigma": (1.0, 1.5), "reduction": "none"}),
    ("universal_image_quality_index", "rgb", {"reduction": "sum"}),
    ("peak_signal_noise_ratio", "rgb", {}),
    ("peak_signal_noise_ratio", "rgb", {"data_range": 1.0, "base": 2.0}),
    ("peak_signal_noise_ratio", "rgb", {"data_range": (0.2, 0.8)}),
    ("peak_signal_noise_ratio", "rgb", {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}),
    ("peak_signal_noise_ratio", "rgb", {"data_range": 1.0, "dim": 1, "reduction": "sum"}),
    ("peak_signal_noise_ratio_with_blocked_effect", "gray", {}),
    ("peak_signal_noise_ratio_with_blocked_effect", "gray", {"block_size": 5}),
    ("error_relative_global_dimensionless_synthesis", "rgb", {}),
    ("error_relative_global_dimensionless_synthesis", "rgb", {"ratio": 2, "reduction": "none"}),
    ("spectral_angle_mapper", "rgb", {}),
    ("spectral_angle_mapper", "rgb", {"reduction": "none"}),
    ("spatial_correlation_coefficient", "rgb", {}),
    ("spatial_correlation_coefficient", "rgb", {"window_size": 7, "reduction": "none"}),
    ("spatial_correlation_coefficient", "rgb", {"hp_filter": [[0.0, -1.0], [-1.0, 2.0]], "window_size": 5}),
    ("root_mean_squared_error_using_sliding_window", "rgb", {}),
    ("root_mean_squared_error_using_sliding_window", "rgb", {"window_size": 5, "return_rmse_map": True}),
    ("relative_average_spectral_error", "rgb", {}),
    ("relative_average_spectral_error", "rgb", {"window_size": 5}),
    ("total_variation", "one", {}),
    ("total_variation", "one", {"reduction": "mean"}),
    ("total_variation", "one", {"reduction": "none"}),
    ("visual_information_fidelity", "rgb", {}),
    ("visual_information_fidelity", "rgb", {"sigma_n_sq": 0.5}),
    ("image_gradients", "one", {}),
    ("spectral_distortion_index", "lambda", {}),
    ("spectral_distortion_index", "lambda", {"p": 2, "reduction": "sum"}),
    ("spatial_distortion_index", "pan", {}),
    ("spatial_distortion_index", "pan_lr", {"norm_order": 2, "window_size": 5}),
    ("quality_with_no_reference", "pan", {}),
    ("quality_with_no_reference", "pan_lr", {"alpha": 0.5, "beta": 2.0}),
]


def _call_args(kind, inputs, pkg_index):
    if kind in ("pan", "pan_lr"):
        preds, target = inputs
        t = _both(target)[pkg_index]
        return (_both(preds)[pkg_index], t["ms"], t["pan"]) + ((t["pan_lr"],) if "pan_lr" in t else ())
    return tuple(_both(x)[pkg_index] for x in inputs)


@pytest.mark.parametrize("name,kind,kw", FUNCTION_CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(FUNCTION_CASES)])
def test_function_against_jax(name, kind, kw):
    inputs = _inputs(kind, seed=len(name) + len(kw))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = getattr(TF, name)(*_call_args(kind, inputs, 0), **kw)
        want = getattr(JF, name)(*_call_args(kind, inputs, 1), **kw)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if name == "image_gradients":
            _bitwise(g, w, name)
        else:
            _close(g, w, name, atol=SAM_ATOL if name == "spectral_angle_mapper" else _budget(name))


def test_functions_accept_integer_images_and_float64_as_jax():
    """Integer images become float32; float64 becomes float32 (JAX keeps 64-bit types off)."""
    rng = np.random.default_rng(3)
    a, b = rng.integers(0, 255, (2, 3, 30, 30)), rng.integers(0, 255, (2, 3, 30, 30))
    got = TF.structural_similarity_index_measure(torch.from_numpy(a), torch.from_numpy(b), data_range=255.0)
    _close(got, JF.structural_similarity_index_measure(jnp.asarray(a), jnp.asarray(b), data_range=255.0), atol=CANCEL_ATOL)
    p, t = _pair(4, (2, 3, 30, 30))
    got = TF.universal_image_quality_index(torch.from_numpy(p.astype(np.float64)), torch.from_numpy(t.astype(np.float64)))
    assert got.dtype == torch.float32
    _close(got, JF.universal_image_quality_index(jnp.asarray(p), jnp.asarray(t)), atol=CANCEL_ATOL)


def test_ds_resize_is_jax_s_antialiased_bilinear():
    """D_s degrades ``pan`` with ``jax.image.resize(..., "bilinear")``, which
    antialiases when it downsamples: held on a 4:1 and a non-integer
    downscale and an upscale (weights normalised in another order: the general budget)."""
    import jax

    x = np.random.default_rng(5).random((2, 4, 64, 64), dtype=np.float32)
    for size in ((16, 16), (20, 50), (96, 64)):
        got = TF.helpers.resize_bilinear(torch.from_numpy(x), size)
        want = jax.image.resize(jnp.asarray(x), (2, 4, *size), method="bilinear")
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=str(size))


ERROR_CASES = [
    ("structural_similarity_index_measure", ((2, 3, 20, 20), (2, 3, 20, 21)), {}),
    ("structural_similarity_index_measure", ((2, 3, 20, 20), (2, 3, 20, 20)), {"kernel_size": 4}),
    ("structural_similarity_index_measure", ((2, 3, 20, 20), (2, 3, 20, 20)), {"sigma": -1.0}),
    ("structural_similarity_index_measure", ((2, 3, 20, 20), (2, 3, 20, 20)), {"return_full_image": True,
                                                                             "return_contrast_sensitivity": True}),
    ("multiscale_structural_similarity_index_measure", ((2, 3, 30, 30), (2, 3, 30, 30)), {}),
    ("multiscale_structural_similarity_index_measure", ((2, 3, 90, 90), (2, 3, 90, 90)), {"normalize": "bad"}),
    ("universal_image_quality_index", ((2, 3, 20, 20), (2, 3, 20, 20)), {"kernel_size": (3,)}),
    ("spectral_angle_mapper", ((2, 1, 20, 20), (2, 1, 20, 20)), {}),
    ("spatial_correlation_coefficient", ((2, 3, 8, 8), (2, 3, 8, 8)), {"window_size": 9}),
    ("spatial_correlation_coefficient", ((2, 3, 8, 8), (2, 3, 8, 8)), {"reduction": "sum"}),
    ("root_mean_squared_error_using_sliding_window", ((2, 3, 8, 8), (2, 3, 8, 8)), {"window_size": 0}),
    ("visual_information_fidelity", ((2, 3, 30, 30), (2, 3, 30, 30)), {}),
    ("peak_signal_noise_ratio", ((2, 3, 8, 8), (2, 3, 8, 8)), {"dim": 1}),
    ("peak_signal_noise_ratio_with_blocked_effect", ((2, 3, 8, 8), (2, 3, 8, 8)), {}),
    ("spectral_distortion_index", ((2, 3, 8, 8), (2, 3, 8, 8)), {"p": 0}),
    ("quality_with_no_reference", ((2, 3, 16, 16), (2, 3, 4, 4), (2, 3, 16, 16)), {"alpha": -1.0}),
    ("spatial_distortion_index", ((2, 3, 16, 16), (2, 3, 5, 5), (2, 3, 16, 16)), {}),
    ("spatial_distortion_index", ((2, 3, 16, 16), (2, 3, 4, 4), (2, 3, 16, 16)), {"window_size": 4}),
]


@pytest.mark.parametrize("name,shapes,kw", ERROR_CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(ERROR_CASES)])
def test_refusals_match_jax(name, shapes, kw):
    arrays = [np.random.default_rng(i).random(s, dtype=np.float32) for i, s in enumerate(shapes)]
    errors = []
    for fn, conv in ((getattr(TF, name), torch.from_numpy), (getattr(JF, name), jnp.asarray)):
        with pytest.raises(Exception) as info, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fn(*[conv(a) for a in arrays], **kw)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


# ----------------------------------------------------------------- modules

MODULE_CASES = [
    ("PeakSignalNoiseRatio", {}, "rgb"),
    ("PeakSignalNoiseRatio", {"data_range": (0.0, 1.0), "base": 2.0}, "rgb"),
    ("PeakSignalNoiseRatio", {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}, "rgb"),
    ("PeakSignalNoiseRatioWithBlockedEffect", {}, "gray"),
    ("StructuralSimilarityIndexMeasure", {}, "rgb"),
    ("StructuralSimilarityIndexMeasure", {"reduction": "none", "data_range": 1.0}, "rgb"),
    ("StructuralSimilarityIndexMeasure", {"reduction": "sum", "return_full_image": True}, "rgb"),
    ("StructuralSimilarityIndexMeasure", {"return_contrast_sensitivity": True, "gaussian_kernel": False, "kernel_size": 5}, "rgb"),
    ("StructuralSimilarityIndexMeasure", {"kernel_size": 5, "sigma": 0.8}, "vol"),
    ("MultiScaleStructuralSimilarityIndexMeasure", {"kernel_size": 5}, "big"),
    ("MultiScaleStructuralSimilarityIndexMeasure", {"kernel_size": 5, "normalize": "simple", "reduction": None}, "big"),
    ("UniversalImageQualityIndex", {}, "rgb"),
    ("UniversalImageQualityIndex", {"reduction": "none"}, "rgb"),
    ("ErrorRelativeGlobalDimensionlessSynthesis", {}, "rgb"),
    ("SpectralAngleMapper", {"reduction": "sum"}, "rgb"),
    ("SpatialCorrelationCoefficient", {}, "rgb"),
    ("RelativeAverageSpectralError", {}, "rgb"),
    ("RootMeanSquaredErrorUsingSlidingWindow", {"window_size": 5}, "rgb"),
    ("TotalVariation", {}, "one"),
    ("TotalVariation", {"reduction": "none"}, "one"),
    ("SpectralDistortionIndex", {}, "lambda"),
    ("SpatialDistortionIndex", {}, "pan"),
    ("SpatialDistortionIndex", {"norm_order": 2}, "pan_lr"),
    ("QualityWithNoReference", {}, "pan"),
    ("VisualInformationFidelity", {}, "rgb"),
]


def _update_args(kind, seed, pkg_index):
    inputs = _inputs(kind, seed)
    return tuple(_both(x)[pkg_index] for x in inputs)


def _state_leaves(tree):
    for key, value in tree.items():
        if isinstance(value, list):
            for i, v in enumerate(value):
                yield f"{key}[{i}]", v
        else:
            yield key, value


@pytest.mark.parametrize("cls,kw,kind", MODULE_CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(MODULE_CASES)])
def test_module_states_values_and_trees_across(cls, kw, kind):
    """Two batches into both packages: ``total`` and the ``cat`` states bitwise,
    the sums within the budget, the fingerprint, each state tree into a fresh
    metric of the other package, and the fused plan's eligibility."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm, tm = getattr(J, cls)(**kw), getattr(T, cls)(device="cpu", **kw)
        for seed in (1, 2):
            jm.update(*_update_args(kind, seed, 1))
            tm.update(*_update_args(kind, seed, 0))
        jstates, tstates = jm.state_tree(), state_to_numpy(tm)
        assert sorted(jstates) == sorted(tstates)
        jleaves, tleaves = dict(_state_leaves(jstates)), dict(_state_leaves(tstates))
        assert sorted(jleaves) == sorted(tleaves)
        for key, want in jleaves.items():
            exact = key.startswith(("total", "num_elements", "preds", "target", "ms", "pan"))
            if exact:
                _bitwise(tleaves[key], np.asarray(want), key)
            else:
                _close(tleaves[key], np.asarray(want), key, atol=_budget(cls))
        assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
        want, got = jm.compute(), tm.compute()
        for g, w in zip(*((got, want) if isinstance(want, tuple) else ((got,), (want,)))):
            _close(g, w, cls, atol=_budget(cls))
        fresh, jfresh = getattr(T, cls)(device="cpu", **kw), getattr(J, cls)(**kw)
        state_from_numpy(fresh, dict(jm.state_tree(include_count=True)), fingerprint=jm.state_spec()["fingerprint"])
        jfresh.load_state_tree({k: v if k == "_update_count" else
                                ([jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v))
                                for k, v in state_to_numpy(tm, include_count=True).items()})
        across = (fresh.compute(), jfresh.compute())
    for value, reference in ((across[0], want), (across[1], got)):
        value, reference = (value, reference) if isinstance(value, tuple) else ((value,), (reference,))
        for v, r in zip(value, reference):
            _close(v, r, f"{cls} across the packages", atol=_budget(cls))
    assert fusion_ineligibility(tm) == j_fusion_ineligibility(jm)


@pytest.mark.parametrize("cls,kw", [
    ("PeakSignalNoiseRatio", {"dim": 1}), ("StructuralSimilarityIndexMeasure", {"reduction": "bad"}),
    ("MultiScaleStructuralSimilarityIndexMeasure", {"betas": (1, 2)}), ("TotalVariation", {"reduction": "max"}),
    ("SpectralDistortionIndex", {"reduction": "bad"}), ("SpatialDistortionIndex", {"window_size": 0}),
    ("QualityWithNoReference", {"beta": -1.0}), ("VisualInformationFidelity", {"sigma_n_sq": -1.0}),
    ("RelativeAverageSpectralError", {"window_size": 0}), ("PeakSignalNoiseRatioWithBlockedEffect", {"block_size": 0}),
])
def test_module_refusals_match_jax(cls, kw):
    errors = []
    for make in (lambda: getattr(T, cls)(device="cpu", **kw), lambda: getattr(J, cls)(**kw)):
        with pytest.raises(Exception) as info, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            make()
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


def test_classes_and_exports_equal_jax():
    """The 21 module names and the 18 functional names of JAX's image namespaces,
    with JAX's plot attributes and differentiability."""
    import torchmetrics_tpu.image as JI
    import torchmetrics_tpu_torch.image as TI

    assert sorted(TI.__all__) == sorted(JI.__all__) and len(TI.__all__) == 21
    assert sorted(TF.__all__) == sorted(JF.__all__) and len(TF.__all__) == 18
    for name in TI.__all__:
        tcls, jcls = getattr(TI, name), getattr(JI, name)
        assert tcls.__module__.startswith("torchmetrics_tpu_torch.image.")
        for attr in ("is_differentiable", "higher_is_better", "full_state_update", "plot_lower_bound", "plot_upper_bound"):
            assert getattr(tcls, attr, "missing") == getattr(jcls, attr, "missing"), (name, attr)
    for name in TF.__all__:
        assert getattr(T.functional, name) is getattr(TF, name)


def test_ssim_is_differentiable_through_k7_s_route():
    """SSIM, MS-SSIM and UQI are differentiable in ``preds``: the port's
    gradient (K7's plain adjoint) against ``jax.grad`` of JAX's SSIM."""
    import jax

    p, t = _pair(9, (1, 3, 32, 36))
    leaf = torch.from_numpy(p).requires_grad_(True)
    TF.structural_similarity_index_measure(leaf, torch.from_numpy(t)).backward()
    want = jax.grad(lambda a: JF.structural_similarity_index_measure(a, jnp.asarray(t)))(jnp.asarray(p))
    np.testing.assert_allclose(_np(leaf.grad), np.asarray(want), rtol=1e-4, atol=1e-7)
    p, t = _pair(10, (1, 3, 96, 96), noise=0.03)
    for name, kw in (("universal_image_quality_index", {}), ("multiscale_structural_similarity_index_measure", {"kernel_size": 5})):
        leaf = torch.from_numpy(p).requires_grad_(True)
        getattr(TF, name)(leaf, torch.from_numpy(t), **kw).backward()
        want = jax.grad(lambda a: getattr(JF, name)(a, jnp.asarray(t), **kw))(jnp.asarray(p))
        assert torch.isfinite(leaf.grad).all(), name
        want = np.asarray(want)
        np.testing.assert_allclose(_np(leaf.grad), want, rtol=1e-3, atol=2e-3 * np.abs(want).max(), err_msg=name)
