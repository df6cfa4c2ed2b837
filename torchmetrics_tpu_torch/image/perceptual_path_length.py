# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Perceptual path length (counterpart of ``torchmetrics_tpu/image/perceptual_path_length.py``).

``PPL = E[ D(G(I(z1,z2,t)), G(I(z1,z2,t+eps))) / eps² ]`` over latent
interpolations of a user generator: an ``nn.Module`` (or any callable) with
``sample(num_samples) -> (n, z)`` latents and ``__call__(z[, labels]) ->
(n, C, H, W)`` images in ``[0, 255]`` (and ``num_classes`` when
conditional). The similarity net defaults to the port's LPIPS; images are
resized as ``jax.image.resize(..., "bilinear")`` resizes them. The
conditional labels are ``jax.random.randint(PRNGKey(seed), ...)``, drawn
with the port's threefry copy, bit for bit.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.image.helpers import resize_bilinear
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.sketch import _threefry
from torchmetrics_tpu_torch.utilities.data import _to_tensor

Tensor = torch.Tensor


def _validate_generator_model(generator: Any, conditional: bool = False) -> None:
    """Duck-type checks of the generator."""
    if not hasattr(generator, "sample"):
        raise NotImplementedError(
            "The generator must have a `sample` method with signature `sample(num_samples: int) -> Tensor` where the"
            " returned tensor has shape `(num_samples, z_size)`."
        )
    if not callable(generator):
        raise NotImplementedError("The generator must be callable: `generator(z) -> images`.")
    if conditional and not hasattr(generator, "num_classes"):
        raise AttributeError("The generator must have a `num_classes` attribute when `conditional=True`.")


def _perceptual_path_length_validate_arguments(
    num_samples: int,
    conditional: bool,
    batch_size: int,
    interpolation_method: str,
    epsilon: float,
    resize: Optional[int],
    lower_discard: Optional[float],
    upper_discard: Optional[float],
) -> None:
    """Argument validation."""
    if not (isinstance(num_samples, int) and num_samples > 0):
        raise ValueError(f"Argument `num_samples` must be a positive integer, but got {num_samples}.")
    if not isinstance(conditional, bool):
        raise ValueError(f"Argument `conditional` must be a boolean, but got {conditional}.")
    if not (isinstance(batch_size, int) and batch_size > 0):
        raise ValueError(f"Argument `batch_size` must be a positive integer, but got {batch_size}.")
    if interpolation_method not in ("lerp", "slerp_any", "slerp_unit"):
        raise ValueError(
            f"Argument `interpolation_method` must be one of 'lerp', 'slerp_any', 'slerp_unit',"
            f" got {interpolation_method}."
        )
    if not (isinstance(epsilon, float) and epsilon > 0):
        raise ValueError(f"Argument `epsilon` must be a positive float, but got {epsilon}.")
    if resize is not None and not (isinstance(resize, int) and resize > 0):
        raise ValueError(f"Argument `resize` must be a positive integer or `None`, but got {resize}.")
    if lower_discard is not None and not (isinstance(lower_discard, float) and 0 <= lower_discard <= 1):
        raise ValueError(f"Argument `lower_discard` must be a float between 0 and 1 or `None`, but got {lower_discard}.")
    if upper_discard is not None and not (isinstance(upper_discard, float) and 0 <= upper_discard <= 1):
        raise ValueError(f"Argument `upper_discard` must be a float between 0 and 1 or `None`, but got {upper_discard}.")


def _interpolate(latents1: Tensor, latents2: Tensor, epsilon: float = 1e-4, interpolation_method: str = "lerp") -> Tensor:
    """One lerp / slerp interpolation step."""
    eps = 1e-7
    if latents1.shape != latents2.shape:
        raise ValueError("Latents must have the same shape.")
    if interpolation_method == "lerp":
        return latents1 + (latents2 - latents1) * epsilon
    if interpolation_method in ("slerp_any", "slerp_unit"):
        def norm(v):
            return torch.linalg.vector_norm(v, dim=-1, keepdim=True)

        l1n = latents1 / torch.clamp(norm(latents1), min=eps)
        l2n = latents2 / torch.clamp(norm(latents2), min=eps)
        d = (l1n * l2n).sum(dim=-1, keepdim=True)
        mask_degenerate = (norm(l1n) < eps) | (norm(l2n) < eps) | (d > 1 - eps) | (d < -1 + eps)
        omega = torch.arccos(torch.clamp(d, -1, 1))
        denom = torch.clamp(torch.sin(omega), min=eps)
        coef1 = torch.sin((1 - epsilon) * omega) / denom
        coef2 = torch.sin(epsilon * omega) / denom
        out = coef1 * latents1 + coef2 * latents2
        lerped = latents1 + (latents2 - latents1) * epsilon
        out = torch.where(mask_degenerate, lerped, out)
        if interpolation_method == "slerp_unit":
            out = out / torch.clamp(norm(out), min=eps)
        return out
    raise ValueError(
        f"Interpolation method {interpolation_method} not supported. Choose from 'lerp', 'slerp_any', 'slerp_unit'."
    )


def _quantile_lower(x: Tensor, q: float) -> Tensor:
    """``jnp.quantile(x, q, method="lower")``: the sorted value at ``floor(q * (n - 1))``."""
    return torch.sort(x).values[int(math.floor(q * (x.numel() - 1)))]


def perceptual_path_length(
    generator: Any,
    num_samples: int = 10_000,
    conditional: bool = False,
    batch_size: int = 64,
    interpolation_method: str = "lerp",
    epsilon: float = 1e-4,
    resize: Optional[int] = 64,
    lower_discard: Optional[float] = 0.01,
    upper_discard: Optional[float] = 0.99,
    sim_net: Union[Callable, str] = "vgg",
    seed: int = 42,
) -> Tuple[Tensor, Tensor, Tensor]:
    """PPL of a generator: ``(mean, std, distances)`` after the quantile discards.

    Everything runs on the device of the generator's latents (a numpy
    ``sample`` puts them on the card).
    """
    _perceptual_path_length_validate_arguments(
        num_samples, conditional, batch_size, interpolation_method, epsilon, resize, lower_discard, upper_discard
    )
    _validate_generator_model(generator, conditional)

    latent1 = _to_tensor(generator.sample(num_samples))
    latent2 = _to_tensor(generator.sample(num_samples), latent1.device)
    if callable(sim_net) and not isinstance(sim_net, str):
        net = sim_net
    elif sim_net in ("alex", "vgg"):
        from torchmetrics_tpu_torch.image.lpip import LearnedPerceptualImagePatchSimilarity

        lpips = LearnedPerceptualImagePatchSimilarity(net_type=sim_net, device=latent1.device)

        def net(a: Tensor, b: Tensor) -> Tensor:
            if resize is not None:
                a = resize_bilinear(a, (resize, resize))
                b = resize_bilinear(b, (resize, resize))
            return lpips.net(a, b)
    else:
        raise ValueError(f"sim_net must be a callable or one of 'alex', 'vgg', got {sim_net}")

    latent2 = _interpolate(latent1, latent2, epsilon, interpolation_method=interpolation_method)
    if conditional:
        labels = _threefry.randint(_threefry.prng_key(seed, latent1.device), num_samples, 0, int(generator.num_classes))

    distances = []
    num_batches = math.ceil(num_samples / batch_size)
    with torch.no_grad():
        for batch_idx in range(num_batches):
            sl = slice(batch_idx * batch_size, (batch_idx + 1) * batch_size)
            z = torch.cat([latent1[sl], latent2[sl]])
            if conditional:
                outputs = _to_tensor(generator(z, torch.cat([labels[sl], labels[sl]])), latent1.device)
            else:
                outputs = _to_tensor(generator(z), latent1.device)
            out1, out2 = torch.chunk(outputs, 2, dim=0)
            # to LPIPS's domain: [0, 255] -> [-1, 1]
            out1 = 2 * (out1 / 255) - 1
            out2 = 2 * (out2 / 255) - 1
            distances.append(_to_tensor(net(out1, out2), latent1.device) / epsilon**2)

    distances = torch.cat(distances)
    lower = _quantile_lower(distances, lower_discard) if lower_discard is not None else 0.0
    upper = _quantile_lower(distances, upper_discard) if upper_discard is not None else distances.max()
    kept = distances[(distances >= lower) & (distances <= upper)]
    return kept.mean(), kept.std(correction=1), kept


class PerceptualPathLength(Metric):
    """PPL: ``update(generator)`` stores the generator and ``compute`` runs the sampling loop."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    # the stored generator is host-side state: declared so snapshot/restore sees it
    _host_counters = ("_generator",)
    _sharded_update_unsupported = "update() stores a host-side generator model; there is no array state to shard"

    def __init__(
        self,
        num_samples: int = 10_000,
        conditional: bool = False,
        batch_size: int = 128,
        interpolation_method: str = "lerp",
        epsilon: float = 1e-4,
        resize: Optional[int] = 64,
        lower_discard: Optional[float] = 0.01,
        upper_discard: Optional[float] = 0.99,
        sim_net: Union[Callable, str] = "vgg",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _perceptual_path_length_validate_arguments(
            num_samples, conditional, batch_size, interpolation_method, epsilon, resize, lower_discard, upper_discard
        )
        self.num_samples = num_samples
        self.conditional = conditional
        self.batch_size = batch_size
        self.interpolation_method = interpolation_method
        self.epsilon = epsilon
        self.resize = resize
        self.lower_discard = lower_discard
        self.upper_discard = upper_discard
        self.sim_net = sim_net
        self._generator = None

    def update(self, generator: Any) -> None:
        """Store the generator to evaluate."""
        _validate_generator_model(generator, self.conditional)
        self._generator = generator

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        if self._generator is None:
            raise RuntimeError("Generator must be provided via `update` before calling `compute`.")
        return perceptual_path_length(
            self._generator,
            num_samples=self.num_samples,
            conditional=self.conditional,
            batch_size=self.batch_size,
            interpolation_method=self.interpolation_method,
            epsilon=self.epsilon,
            resize=self.resize,
            lower_discard=self.lower_discard,
            upper_discard=self.upper_discard,
            sim_net=self.sim_net,
        )
