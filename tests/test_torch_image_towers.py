# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The image domain's towers in the port against the JAX package's, on the
CPU: the FID InceptionV3 (every tap, at 299 x 299 and through the TF1
resize from 64 x 64), FID, KID, IS and MiFID over it, LPIPS with each of
its three trunks (values and the gradient in ``img1``), and PPL.

No pretrained weights exist offline, so JAX's flax trees are made once per
module from a seed (``jax.eval_shape`` of the flax init gives the layout;
He-normal kernels and non-trivial BatchNorm statistics keep the activations'
scale) and carried into the port: ``inception_params_from_jax`` and
``lpips_params_from_jax``.

Budgets: the towers are float32 convolutions of other libraries (XLA's and
oneDNN's, other summation orders) stacked ~100 deep: taps within
``rtol=1e-4`` of the largest value of their row (measured 6e-7 of it at the
2048 tap); LPIPS distances within ``rtol=1e-5, atol=1e-7``; the generative
scores from each package's own features within ``SCORE_BUDGET`` (reasons
there) and, from JAX's own states, bitwise for FID and MiFID (the same host
float64 numpy) and within ``STATE_ATOL`` for KID and IS. Sample counts are
integers: bitwise.
"""
from __future__ import annotations

import functools
import hashlib
import importlib.util
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as T
from torchmetrics_tpu.image.backbones.inception import FIDInceptionV3 as JInception
from torchmetrics_tpu.image.backbones.inception import InceptionFeatureExtractor as JExtractor
from torchmetrics_tpu.image.lpip import _LPIPSNet as JLPIPSNet
from torchmetrics_tpu_torch.image.backbones.inception import (
    FEATURE_TAPS,
    FIDInceptionV3,
    InceptionFeatureExtractor,
    inception_params_from_jax,
    load_inception_weights,
)
from torchmetrics_tpu_torch.image.lpip import _build_net, lpips_params_from_jax
from torchmetrics_tpu_torch.interop import state_to_numpy

ROOT = Path(__file__).resolve().parent.parent
TAP_RTOL = 1e-4
LPIPS_RTOL, LPIPS_ATOL = 1e-5, 1e-7
#: the scores from each package's own features: FID's and MiFID's trace square root over covariances of
#: fewer samples than dimensions (rank-deficient: a float32 rounding delta on a zero eigenvalue moves its
#: root by about sqrt(delta); measured 7.1e-4 relative), KID's difference of O(1) kernel means and IS's
#: exp(KL) near 1 and its spread (measured 7.8e-7 absolute)
SCORE_BUDGET = {
    "FrechetInceptionDistance": {"rtol": 2e-3, "atol": 0},
    "MemorizationInformedFrechetInceptionDistance": {"rtol": 2e-3, "atol": 0},
    "KernelInceptionDistance": {"rtol": 0, "atol": 1e-5},
    "InceptionScore": {"rtol": 0, "atol": 1e-5},
}
#: KID and IS computed by the port from JAX's own features: matmuls and softmax in another order
#: over kernels of O(10^3) on these features (measured 1.05e-6 absolute)
STATE_ATOL = 1e-5


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _seeded_tree(shapes, seed):
    """A flax variable tree of ``shapes``' layout, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def inception_tree():
    shapes = jax.eval_shape(JInception(features_list=FEATURE_TAPS).init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32), jnp.uint8))
    return _seeded_tree(shapes, 11)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(12)
    return rng.integers(0, 256, (8, 3, 48, 48)).astype(np.uint8)


def _close_rows(got, want, what):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= TAP_RTOL * scale), (what, float(np.max(np.abs(got - want) / scale)))


# --------------------------------------------------------------- Inception

@pytest.mark.parametrize("size", [299, 64])
def test_inception_taps_against_jax(inception_tree, size):
    rng = np.random.default_rng(size)
    imgs = rng.integers(0, 256, (2, 3, size, size)).astype(np.uint8)
    want = JExtractor(FEATURE_TAPS, params=inception_tree, dtype=jnp.float32)(jnp.asarray(imgs))
    got = InceptionFeatureExtractor(FEATURE_TAPS, params=inception_tree, device="cpu")(torch.from_numpy(imgs))
    for tap, g, w in zip(FEATURE_TAPS, got, want):
        _close_rows(g, w, f"{tap} at {size}")
    # NHWC input is read as JAX reads it
    nhwc = InceptionFeatureExtractor(("64",), params=inception_tree, device="cpu")(torch.from_numpy(imgs.transpose(0, 2, 3, 1).copy()))
    assert torch.equal(nhwc, got[0])


def _torch_fidelity_state_dict(tree):
    """JAX's tree under torch-fidelity's names and layouts, with a torch BatchNorm's counters."""
    state = {}
    for name, value in inception_params_from_jax(tree).items():
        state[name] = value.clone()
        if name.endswith(".bn.running_var"):
            state[name.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
    return state


def test_torch_fidelity_state_dict_loads_and_tools_round_trip(inception_tree, tmp_path):
    """A state dict named as torch-fidelity names it (``Conv2d_1a_3x3.conv.weight``,
    ``Mixed_5b.branch1x1.bn.running_mean``, ``fc.weight``, the BatchNorms'
    ``num_batches_tracked``) loads with ``load_state_dict``; through
    ``tools/convert_inception_weights.py`` to the flax ``.npz`` it loads
    with ``load_inception_weights`` to the same tower."""
    state = _torch_fidelity_state_dict(inception_tree)
    assert {"Conv2d_1a_3x3.conv.weight", "Mixed_5b.branch1x1.bn.running_mean", "fc.weight", "fc.bias"} <= set(state)
    tower = FIDInceptionV3(features_list=("2048", "logits"))
    tower.load_state_dict(state)
    imgs = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 3, 40, 40)).astype(np.uint8))
    want = InceptionFeatureExtractor(("2048", "logits"), params=inception_tree, device="cpu")(imgs)
    with torch.no_grad():
        out = tower(imgs)
    assert torch.equal(out["2048"], want[0]) and torch.equal(out["logits"], want[1])

    spec = importlib.util.spec_from_file_location("convert_inception_weights", ROOT / "tools" / "convert_inception_weights.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    npz = tmp_path / "inception.npz"
    np.savez(npz, **tool.convert_state_dict({k: v.numpy() for k, v in state.items()}))
    loaded = load_inception_weights(str(npz), ("2048", "logits"), device="cpu")(imgs)
    assert torch.equal(loaded[0], want[0]) and torch.equal(loaded[1], want[1])


def test_default_tower_is_seeded_and_frozen():
    a = InceptionFeatureExtractor(("64",), device="cpu")
    b = InceptionFeatureExtractor(("64",), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.module.state_dict().values(), b.module.state_dict().values()))
    assert not any(p.requires_grad for p in a.module.parameters())
    with pytest.raises(KeyError, match="do not fit"):
        InceptionFeatureExtractor(("logits",), params={"params": {"Conv2d_1a_3x3": {"conv": {"kernel": np.zeros((3, 3, 3, 32))}}}},
                                  device="cpu")


# ------------------------------------------------------ FID, KID, IS, MiFID

GENERATIVE_CASES = [
    ("FrechetInceptionDistance", {"feature": 192}),
    ("KernelInceptionDistance", {"feature": 64, "subsets": 4, "subset_size": 3}),
    ("InceptionScore", {"splits": 3}),
    ("MemorizationInformedFrechetInceptionDistance", {"feature": 64}),
]


@pytest.mark.parametrize("cls,kw", GENERATIVE_CASES, ids=[c[0] for c in GENERATIVE_CASES])
def test_generative_metrics_against_jax(inception_tree, images, cls, kw):
    """The same uint8 batches (real, then fake) into both with JAX's tree:
    the states (counts bitwise, feature sums and lists within the taps'
    budget) and the values."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = getattr(J, cls)(feature_extractor_params=inception_tree, tower_dtype=jnp.float32, **kw)
        tm = getattr(T, cls)(feature_extractor_params=inception_tree, device="cpu", **kw)
    takes_real = cls != "InceptionScore"
    for i, real in ((0, True), (4, False)) if takes_real else ((0, None), (4, None)):
        batch = images[i : i + 4]
        args = (real,) if takes_real else ()
        jm.update(jnp.asarray(batch), *args)
        tm.update(torch.from_numpy(batch), *args)
    jstates, tstates = jm.state_tree(), state_to_numpy(tm)
    assert sorted(jstates) == sorted(tstates)
    for key, want in jstates.items():
        got = tstates[key]
        if isinstance(want, list):
            assert len(got) == len(want), key
            for g, w in zip(got, want):
                _close_rows(g, w, key)
        elif "num_samples" in key:
            assert got.dtype == np.asarray(want).dtype and int(got) == int(want), key
        else:
            np.testing.assert_allclose(got, np.asarray(want), rtol=TAP_RTOL, atol=TAP_RTOL * float(np.abs(want).max()), err_msg=key)
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    want, got = jm.compute(), tm.compute()
    for g, w in zip(*((got, want) if isinstance(want, tuple) else ((got,), (want,)))):
        np.testing.assert_allclose(_np(g), np.asarray(w), **SCORE_BUDGET[cls], err_msg=cls)
    # the port's compute of JAX's own states: FID and MiFID are the same host float64 numpy, bitwise
    fresh = getattr(T, cls)(feature_extractor_params=inception_tree, device="cpu", **kw)
    fresh.load_state_tree({k: [np.asarray(x) for x in v] if isinstance(v, list) else np.asarray(v) for k, v in jstates.items()})
    for g, w in zip(*((fresh.compute(), want) if isinstance(want, tuple) else ((fresh.compute(),), (want,)))):
        if cls in ("FrechetInceptionDistance", "MemorizationInformedFrechetInceptionDistance"):
            assert _np(g).tobytes() == np.asarray(w).tobytes(), cls
        else:
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=STATE_ATOL, err_msg=cls)


def test_fid_normalize_reset_and_custom_feature():
    """``normalize=True`` scales [0, 1] floats to uint8 as JAX does; a callable
    feature sets the width; ``reset_real_features=False`` keeps the real statistics."""
    rng = np.random.default_rng(4)
    real, fake = rng.random((6, 8)).astype(np.float32), (rng.random((6, 8)) + 0.2).astype(np.float32)

    def feature(pkg_array):
        return lambda x: x.reshape(x.shape[0], -1)[:, :8] if x.ndim == 4 else x

    jm = J.FrechetInceptionDistance(feature=feature(jnp), reset_real_features=False)
    tm = T.FrechetInceptionDistance(feature=feature(torch), reset_real_features=False, device="cpu")
    for pkg, m in ((jnp.asarray, jm), (torch.from_numpy, tm)):
        m.update(pkg(real), real=True)
        m.update(pkg(fake), real=False)
    np.testing.assert_allclose(_np(tm.compute()), np.asarray(jm.compute()), **SCORE_BUDGET["FrechetInceptionDistance"])
    tm.reset()
    jm.reset()
    assert int(tm.real_features_num_samples) == int(jm.real_features_num_samples) == 6
    assert int(tm.fake_features_num_samples) == int(jm.fake_features_num_samples) == 0


# ------------------------------------------------------------------- LPIPS

def _lpips_tree(net_type, seed):
    init = functools.partial(JLPIPSNet(net_type=net_type).init, normalize=False)
    return _seeded_tree(jax.eval_shape(init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 3))), seed)


@pytest.mark.parametrize("net_type", ["alex", "vgg", "squeeze"])
def test_lpips_trunks_and_gradient_against_jax(net_type):
    """Each trunk with JAX's tree carried across: the class (two batches,
    ``reduction="sum"``, ``normalize``), the functional's value and its
    gradient in ``img1`` against ``jax.value_and_grad``."""
    tree = _lpips_tree(net_type, {"alex": 21, "vgg": 22, "squeeze": 23}[net_type])
    rng = np.random.default_rng(24)
    a = rng.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32)
    b = np.clip(a + 0.3 * rng.standard_normal(a.shape), -1, 1).astype(np.float32)
    x, y = (a + 1) / 2, (b + 1) / 2
    jm = J.LearnedPerceptualImagePatchSimilarity(net_type=net_type, reduction="sum", normalize=True, net_params=tree)
    tm = T.LearnedPerceptualImagePatchSimilarity(net_type=net_type, reduction="sum", normalize=True, net_params=tree, device="cpu")
    for sl in (slice(0, 2), slice(2, 4)):
        jm.update(jnp.asarray(x[sl]), jnp.asarray(y[sl]))
        tm.update(torch.from_numpy(x[sl]), torch.from_numpy(y[sl]))
    assert float(tm.total) == float(jm.total) == 4.0
    np.testing.assert_allclose(_np(tm.compute()), np.asarray(jm.compute()), rtol=LPIPS_RTOL, atol=LPIPS_ATOL)

    leaf = torch.from_numpy(a[:2]).requires_grad_(True)
    got = T.functional.learned_perceptual_image_patch_similarity(leaf, torch.from_numpy(b[:2]), net_type, net_params=tree)
    got.backward()
    want, jgrad = jax.value_and_grad(lambda v: J.functional.learned_perceptual_image_patch_similarity(
        v, jnp.asarray(b[:2]), net_type, net_params=tree))(jnp.asarray(a[:2]))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=LPIPS_RTOL, atol=LPIPS_ATOL)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(_np(leaf.grad), jgrad, rtol=1e-3, atol=1e-3 * np.abs(jgrad).max())


def test_lpips_heads_are_byte_equal_copies_and_load_by_default():
    for net_type in ("alex", "vgg", "squeeze"):
        port = ROOT / "torchmetrics_tpu_torch" / "image" / "weights" / f"lpips_heads_{net_type}.npz"
        jax_copy = ROOT / "torchmetrics_tpu" / "image" / "weights" / f"lpips_heads_{net_type}.npz"
        assert hashlib.sha256(port.read_bytes()).digest() == hashlib.sha256(jax_copy.read_bytes()).digest()
        net = _build_net(net_type, None, torch.device("cpu"))
        with np.load(jax_copy) as heads:
            for key in heads.files:
                lin = key.split("/")[0]
                assert np.array_equal(getattr(net, lin).weight.numpy(), heads[key].transpose(3, 2, 0, 1)), (net_type, key)
        assert not any(p.requires_grad for p in net.parameters())
    state = lpips_params_from_jax(_lpips_tree("alex", 25), "alex")
    assert sorted(state) == sorted(_build_net("alex", None, torch.device("cpu")).state_dict())


def test_lpips_refusals_match_jax():
    bad = np.full((1, 3, 32, 32), 2.0, np.float32)
    errors = []
    for fn, conv in ((T.functional.learned_perceptual_image_patch_similarity, torch.from_numpy),
                     (J.functional.learned_perceptual_image_patch_similarity, jnp.asarray)):
        for args, kw in (((bad, bad), {"net_params": _lpips_tree("alex", 26)}), ((bad[:, :2], bad[:, :2]), {}),
                         ((bad, bad), {"net_type": "resnet"})):
            with pytest.raises(ValueError) as info:
                fn(*[conv(x) for x in args], **kw)
            errors.append(str(info.value))
    assert errors[:3] == errors[3:]


# --------------------------------------------------------------------- PPL

class _Generator(torch.nn.Module):
    """A seeded linear generator; ``sample`` hands out pre-drawn latents, so both packages see the same."""

    def __init__(self, latents, weight, as_array, num_classes=None):
        super().__init__()
        self.latents, self.weight, self.as_array = list(latents), weight, as_array
        self.labels_seen = []
        if num_classes is not None:
            self.num_classes = num_classes

    def sample(self, n):
        return self.as_array(self.latents.pop(0)[:n])

    def forward(self, z, labels=None):
        if labels is not None:
            self.labels_seen.append(np.asarray(labels.cpu() if isinstance(labels, torch.Tensor) else labels))
            z = z + 0.01 * labels[:, None]
        img = (z @ self.as_array(self.weight)).reshape(z.shape[0], 3, 16, 16)
        return 255.0 / (1.0 + (np.e ** -img if isinstance(img, torch.Tensor) else jnp.exp(-img)))


def _sim(xp):
    return lambda a, b: ((a - b) ** 2).reshape(a.shape[0], -1).mean(1)


@pytest.mark.parametrize("conditional,method", [(False, "lerp"), (True, "slerp_any"), (False, "slerp_unit")])
def test_ppl_against_jax_on_the_same_latents(conditional, method):
    rng = np.random.default_rng(31)
    latents = [rng.standard_normal((40, 8)).astype(np.float32) for _ in range(2)]
    weight = (0.5 * rng.standard_normal((8, 768))).astype(np.float32)
    kw = {"num_samples": 40, "batch_size": 16, "conditional": conditional, "interpolation_method": method, "resize": None,
          "epsilon": 1e-2, "lower_discard": 0.1, "upper_discard": 0.9}
    gens = [_Generator(latents, weight, torch.from_numpy, 5 if conditional else None),
            _Generator(latents, weight, jnp.asarray, 5 if conditional else None)]
    got = T.functional.perceptual_path_length(gens[0], sim_net=_sim(torch), **kw)
    want = J.image.perceptual_path_length.perceptual_path_length(gens[1], sim_net=_sim(jnp), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-6)
    if conditional:  # jax.random.randint(PRNGKey(42), ...) drawn by the port's threefry, bit for bit
        assert len(gens[0].labels_seen) == len(gens[1].labels_seen) == 3
        for g, w in zip(gens[0].labels_seen, gens[1].labels_seen):
            assert g.dtype == w.dtype == np.int32 and np.array_equal(g, w)


def test_ppl_module_with_lpips_vgg_and_resize():
    """The module with the default similarity net (LPIPS vgg on the port's
    seeded trunk) and JAX's antialiased resize: finite, the kept distances
    between the quantile bounds, ``num_samples`` latents drawn."""
    rng = np.random.default_rng(32)
    latents = [rng.standard_normal((12, 8)).astype(np.float32) for _ in range(2)]
    gen = _Generator(latents, (0.5 * rng.standard_normal((8, 768))).astype(np.float32), torch.from_numpy)
    metric = T.image.PerceptualPathLength(num_samples=12, batch_size=6, resize=32, device="cpu")
    metric.update(gen)
    mean, std, kept = metric.compute()
    assert torch.isfinite(mean) and torch.isfinite(std) and 0 < kept.numel() <= 12
    with pytest.raises(RuntimeError, match="Generator must be provided"):
        T.image.PerceptualPathLength(device="cpu").compute()


def test_feature_share_runs_one_forward_for_fid_kid_and_is():
    """``FeatureShare`` over FID, KID and IS with one feature network, as
    JAX's own test drives it: one forward a batch for the three members,
    and the three values equal JAX's."""
    calls = {"n": 0}

    def counting(xp):
        def feature(x):
            calls["n"] += 1
            return x if x.ndim == 2 else xp.zeros((x.shape[0], 8), dtype=xp.float32)
        return feature

    rng = np.random.default_rng(33)
    feats = rng.standard_normal((16, 8)).astype(np.float32)
    values = []
    for pkg, xp, conv, kw in ((T, torch, torch.from_numpy, {"device": "cpu"}), (J, jnp, jnp.asarray, {})):
        shared = counting(xp)
        members = [pkg.FrechetInceptionDistance(feature=shared, **kw),
                   pkg.KernelInceptionDistance(feature=shared, subsets=2, subset_size=8, **kw),
                   pkg.InceptionScore(feature=shared, **kw)]
        fs = pkg.wrappers.FeatureShare(members)
        calls["n"] = 0
        fs.update(conv(feats), real=True)
        assert calls["n"] == 1
        fs.update(conv(feats + 0.5), real=False)
        values.append(fs.compute())
    for key, want in values[1].items():
        got = values[0][key]
        for g, w in zip(*((got, want) if isinstance(want, tuple) else ((got,), (want,)))):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-6, err_msg=key)
