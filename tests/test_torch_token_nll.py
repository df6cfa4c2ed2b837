# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K8's plain route (``ops.token_nll_plain``, what ``token_nll`` computes on
CPU tensors) and Perplexity against the JAX package's ``log_softmax`` and
``take_along_axis`` (``_perplexity_update``), on seeded logits.

Budgets: the per-token values in float32 run JAX's ops in JAX's order, but
the sum of exponentials over V adds in another order and each library has
its own ``exp`` and ``log``: ``1e-6`` of ``max(1, |value|)``. In 16-bit
types the plain route rounds where XLA rounds; the ``exp``'s last bits can
still move a rounding: at most one unit in the last place of the 16-bit
value. Totals add the per-token values in XLA's order: ``rtol=1e-6``
(float32), one 16-bit ulp (16-bit). Counts are int32 and bitwise. The
gradient is held against ``jax.grad`` within ``1e-6``.
"""
from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
from torchmetrics_tpu.functional.text.perplexity import _perplexity_update as jax_update
from torchmetrics_tpu.functional.text.perplexity import perplexity as jax_perplexity
from torchmetrics_tpu.parallel.fused import fusion_ineligibility as j_fusion_ineligibility
import torchmetrics_tpu_torch as T
from torchmetrics_tpu_torch.functional.text.perplexity import _perplexity_update, perplexity
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy
from torchmetrics_tpu_torch.ops import token_nll, token_nll_plain
from torchmetrics_tpu_torch.parallel.fused import fusion_ineligibility

token_nll_module = importlib.import_module("torchmetrics_tpu_torch.ops.token_nll")
F32_TOL = 1e-6
_DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}
_EPS16 = {"bfloat16": 2.0**-7, "float16": 2.0**-10}


def _logits(seed, shape, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _targets(seed, shape, vocab, ignore=None, share=0.05):
    rng = np.random.default_rng(seed + 1)
    t = rng.integers(0, vocab, shape)
    if ignore is not None:
        t = np.where(rng.random(shape) < share, ignore, t)
    return t


def _jax_rows(x, t, ignore_index, jdt):
    """JAX's per-token -log p, 0 where ignored (the terms of ``_perplexity_update``'s sum)."""
    logp = jax.nn.log_softmax(jnp.asarray(x).astype(jdt).reshape(-1, x.shape[-1]), axis=-1)
    t = jnp.asarray(t).reshape(-1)
    mask = t != ignore_index if ignore_index is not None else jnp.ones_like(t, dtype=bool)
    tok = jnp.take_along_axis(logp, jnp.where(mask, t, 0)[:, None], axis=1)[:, 0]
    return np.asarray((-jnp.where(mask, tok, 0.0)).astype(jnp.float32)), np.asarray(mask)


def _budget(want, name):
    if name == "float32":
        return F32_TOL * np.maximum(1.0, np.abs(want))
    return _EPS16[name] * np.maximum(2.0 ** -6, np.abs(want))  # one ulp (bf16 / f16 normal range)


@pytest.mark.parametrize("name", list(_DTYPES))
@pytest.mark.parametrize("ignore_index", [None, -100, 3])
def test_plain_rows_match_jax(name, ignore_index):
    tdt, jdt = _DTYPES[name]
    x, t = _logits(1, (4, 33, 57)), _targets(1, (4, 33), 57, ignore_index if ignore_index is not None else None)
    nll, valid = token_nll_plain(torch.from_numpy(x).to(tdt).reshape(-1, 57), torch.from_numpy(t).reshape(-1), ignore_index)
    want, mask = _jax_rows(x, t, ignore_index, jdt)
    assert nll.dtype == tdt and valid.dtype == torch.bool
    np.testing.assert_array_equal(valid.numpy(), mask)
    err = np.abs(nll.to(torch.float32).numpy() - want)
    assert (err <= _budget(want, name)).all(), (name, err.max())


@pytest.mark.parametrize("name", list(_DTYPES))
def test_update_and_functional_match_jax(name):
    tdt, jdt = _DTYPES[name]
    x, t = _logits(2, (3, 40, 101)), _targets(2, (3, 40), 101, -100)
    total, count = _perplexity_update(torch.from_numpy(x).to(tdt), torch.from_numpy(t), -100)
    jtotal, jcount = jax_update(jnp.asarray(x).astype(jdt), jnp.asarray(t), -100)
    assert total.dtype == tdt and str(jtotal.dtype) == name
    assert count.dtype == torch.int32 and int(count) == int(jcount)
    want = float(np.asarray(jtotal, np.float32))
    tol = F32_TOL * abs(want) if name == "float32" else _EPS16[name] * abs(want)
    assert abs(float(total.to(torch.float32)) - want) <= tol, (name, float(total), want)
    got = perplexity(torch.from_numpy(x).to(tdt), torch.from_numpy(t), ignore_index=-100)
    ref = jax_perplexity(jnp.asarray(x).astype(jdt), jnp.asarray(t), ignore_index=-100)
    np.testing.assert_allclose(float(got.to(torch.float32)), float(np.asarray(ref, np.float32)), rtol=F32_TOL if name == "float32" else 8 * _EPS16[name])


def test_jax_s_target_rules():
    """Negative targets wrap once (-1 is the last class), a class outside
    [0, V) after that is NaN (the ignored rows excepted), counts are int32."""
    x = _logits(3, (2, 6, 5))
    cases = {
        "wrapped": np.array([[0, 4, -1, -5, 1, -3], [1, 2, 3, -100, 0, 1]]),
        "too large": np.array([[0, 5, 1, 1, 1, 1], [1, 2, 3, 0, 0, 1]]),
        "too negative": np.array([[0, -6, 1, 1, 1, 1], [1, 2, 3, 0, 0, 1]]),
        "bad but ignored": np.array([[0, -100, 1, 1, 1, 1], [1, 2, 3, -100, 0, 1]]),
    }
    for what, t in cases.items():
        for ignore_index in (None, -100):
            total, count = _perplexity_update(torch.from_numpy(x), torch.from_numpy(t), ignore_index)
            jtotal, jcount = jax_update(jnp.asarray(x), jnp.asarray(t), ignore_index)
            assert int(count) == int(jcount), what
            want = float(jtotal)
            assert (np.isnan(want) and np.isnan(float(total))) or abs(float(total) - want) <= F32_TOL * abs(want), (what, ignore_index, float(total), want)
    total, _ = _perplexity_update(torch.from_numpy(x), torch.from_numpy(cases["too large"]), None)
    assert np.isnan(float(total))
    rows, _ = token_nll(torch.from_numpy(x[0]), torch.from_numpy(cases["wrapped"][0]))
    assert rows[2] == token_nll(torch.from_numpy(x[0]), torch.tensor([0, 0, 4, 0, 0, 0]))[0][2]


def test_logits_rows_of_inf_and_nan_as_jax():
    x = _logits(4, (1, 6, 7))
    x[0, 1, 2] = np.inf
    x[0, 2, :] = -np.inf
    x[0, 3, 0] = np.nan
    x[0, 4, 3] = -np.inf  # one -inf is a zero probability, not a NaN
    t = np.array([[1, 1, 1, 1, 3, 2]])
    got, _ = token_nll_plain(torch.from_numpy(x).reshape(-1, 7), torch.from_numpy(t).reshape(-1))
    want, _ = _jax_rows(x, t, None, jnp.float32)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[finite], want[finite], rtol=F32_TOL, atol=F32_TOL)


def test_all_ignored_stream_and_a_single_class():
    x, t = _logits(5, (2, 3, 9)), np.full((2, 3), -100)
    tm, jm = T.Perplexity(ignore_index=-100, device="cpu"), J.Perplexity(ignore_index=-100)
    for _ in range(2):
        tm.update(torch.from_numpy(x), torch.from_numpy(t))
        jm.update(jnp.asarray(x), jnp.asarray(t))
    for key, want in jm.state_tree().items():
        got = state_to_numpy(tm)[key]
        assert got.dtype == np.asarray(want).dtype and float(got) == float(want) == 0.0, key
    assert np.isnan(float(tm.compute())) and np.isnan(float(jm.compute()))
    x1 = _logits(6, (2, 4, 1))
    got = _perplexity_update(torch.from_numpy(x1), torch.zeros((2, 4), dtype=torch.int64))
    want = jax_update(jnp.asarray(x1), jnp.zeros((2, 4), jnp.int32))
    assert float(got[0]) == float(want[0]) == 0.0 and int(got[1]) == int(want[1]) == 8


@pytest.mark.parametrize("ignore_index", [None, -100])
def test_gradient_matches_jax_grad(ignore_index):
    x, t = _logits(7, (2, 9, 13)), _targets(7, (2, 9), 13, ignore_index, share=0.2)
    xt = torch.from_numpy(x).requires_grad_(True)
    total, _ = _perplexity_update(xt, torch.from_numpy(t), ignore_index)
    total.backward()
    want = jax.grad(lambda a: jax_update(a, jnp.asarray(t), ignore_index)[0])(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_kernel_backward_formula_matches_jax_grad(monkeypatch):
    """The CUDA route's backward (``g * (softmax - onehot)`` from the kept
    log-sum-exp) run on the CPU, with the launch standing in by the plain
    route's values: the gradient JAX takes, 0 on ignored rows."""
    x, t = _logits(8, (2, 7, 11)), _targets(8, (2, 7), 11, -100, share=0.3)

    def plain_launch(logits, target, ignore_index):
        nll, valid = token_nll_plain(logits, target, ignore_index)
        return nll, valid, torch.logsumexp(logits.to(torch.float32), dim=1)

    monkeypatch.setattr(token_nll_module, "_launch", plain_launch)
    xt = torch.from_numpy(x.reshape(-1, 11)).requires_grad_(True)
    nll, valid = token_nll_module._TokenNll.apply(xt, torch.from_numpy(t.reshape(-1)), -100)
    (nll * torch.linspace(0.5, 1.5, nll.shape[0])).sum().backward()
    weights = jnp.linspace(0.5, 1.5, nll.shape[0])

    def weighted(a):
        rows = jax.nn.log_softmax(a, axis=-1)
        tt = jnp.asarray(t.reshape(-1))
        mask = tt != -100
        tok = jnp.take_along_axis(rows, jnp.where(mask, tt, 0)[:, None], axis=1)[:, 0]
        return jnp.sum(-jnp.where(mask, tok, 0.0) * weights)

    want = jax.grad(weighted)(jnp.asarray(x.reshape(-1, 11)))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_module_streaming_states_checkpoints_and_fusion_as_jax():
    tm, jm = T.Perplexity(ignore_index=-100, device="cpu"), J.Perplexity(ignore_index=-100)
    one = T.Perplexity(ignore_index=-100, device="cpu")
    xs = [_logits(10 + i, (2, 16, 31)) for i in range(3)]
    ts = [_targets(10 + i, (2, 16), 31, -100) for i in range(3)]
    for x, t in zip(xs, ts):
        tm.update(torch.from_numpy(x), torch.from_numpy(t))
        jm.update(jnp.asarray(x), jnp.asarray(t))
    one.update(torch.from_numpy(np.concatenate(xs)), torch.from_numpy(np.concatenate(ts)))
    got, want = state_to_numpy(tm), jm.state_tree()
    assert sorted(got) == sorted(want)
    assert got["count"].dtype == np.float32 and float(got["count"]) == float(want["count"])
    assert got["total_log_probs"].dtype == np.asarray(want["total_log_probs"]).dtype == np.float32
    np.testing.assert_allclose(got["total_log_probs"], np.asarray(want["total_log_probs"]), rtol=F32_TOL)
    np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), rtol=F32_TOL)
    np.testing.assert_allclose(float(one.compute()), float(tm.compute()), rtol=F32_TOL)
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    fresh = T.Perplexity(ignore_index=-100, device="cpu")
    state_from_numpy(fresh, dict(jm.state_tree(include_count=True)), fingerprint=jm.state_spec()["fingerprint"])
    assert float(fresh.compute()) == float(jm.compute())
    jfresh = J.Perplexity(ignore_index=-100)
    jfresh.load_state_tree({k: v if k == "_update_count" else jnp.asarray(v) for k, v in state_to_numpy(tm, include_count=True).items()})
    assert float(jfresh.compute()) == float(tm.compute())
    assert fusion_ineligibility(tm) == j_fusion_ineligibility(jm)


def test_module_bfloat16_stream_as_jax():
    tm, jm = T.Perplexity(device="cpu"), J.Perplexity()
    for i in range(2):
        x, t = _logits(20 + i, (2, 8, 19)), _targets(20 + i, (2, 8), 19)
        tm.update(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(t))
        jm.update(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(t))
    got = state_to_numpy(tm)
    assert got["total_log_probs"].dtype == np.float32 and got["count"].dtype == np.float32
    want = float(jm.state_tree()["total_log_probs"])
    assert abs(float(got["total_log_probs"]) - want) <= _EPS16["bfloat16"] * abs(want)
    assert float(got["count"]) == float(jm.state_tree()["count"])


def test_refusals_match_jax():
    def raised(fn, *args):
        with pytest.raises(Exception) as info:
            fn(*args)
        return type(info.value), str(info.value)

    x = _logits(9, (2, 3, 4))
    cases = [
        (x[0], np.zeros((2, 3), np.int64)), (x, np.zeros((2, 3, 1), np.int64)), (x, np.zeros((2, 4), np.int64)),
        (x.astype(np.int32), np.zeros((2, 3), np.int64)), (x, np.zeros((2, 3), np.float32)),
    ]
    for p, t in cases:
        assert raised(perplexity, torch.from_numpy(p), torch.from_numpy(t)) == raised(jax_perplexity, jnp.asarray(p), jnp.asarray(t))
    with pytest.raises(ValueError, match="token_nll: expected"):
        token_nll(torch.zeros((3, 0)), torch.zeros(3, dtype=torch.int64))
    assert np.float32(ml_dtypes.bfloat16(1.0)) == 1.0  # ml_dtypes is what JAX's bfloat16 arrays are


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 65, 100, 1000, 8191, 8192])
def test_sum_in_xla_order_is_the_recursive_order_bit_for_bit(n):
    """The update's vectorized sum (``_sum_in_xla_order``) adds in ``_sum_last_in_xla_order``'s order, and the
    1-D mean rides it; -0.0 padding adds nothing, signed zeros included."""
    from torchmetrics_tpu_torch.utilities.compute import _mean_last_in_xla_order, _sum_in_xla_order, _sum_last_in_xla_order

    x = torch.from_numpy((np.random.default_rng(n).standard_normal(n) * 10.0 ** np.random.default_rng(n + 1).integers(-3, 4, n)).astype(np.float32))
    for v in (x, -torch.zeros(n), torch.zeros(n)):
        assert torch.equal(_sum_in_xla_order(v).view(torch.int32), _sum_last_in_xla_order(v).view(torch.int32))
    recip = torch.full((), 1.0 / n, dtype=torch.float32)
    assert torch.equal(_mean_last_in_xla_order(x).view(torch.int32), (_sum_last_in_xla_order(x) * recip).view(torch.int32))
