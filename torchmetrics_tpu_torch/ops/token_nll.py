# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K8 ``token_nll``: each row's negative log-likelihood of its target under
the softmax of its logits, and its plain version.

Counterpart of ``jax.nn.log_softmax`` over the ``(B*T, V)`` logits and the
``jnp.take_along_axis`` of one entry a row in
``torchmetrics_tpu/functional/text/perplexity.py`` (``_perplexity_update``).
The kernel is ``csrc/token_nll.cu``; its source note gives the function,
the bound and the design. On CPU tensors :func:`token_nll` computes
:func:`token_nll_plain`; on CUDA tensors it launches the kernel or raises.
Neither checks the targets on the host, so a CUDA graph can hold the call.

The result is differentiable in the logits (Perplexity is): the backward is
``g * (softmax - onehot(target))`` of each valid in-range row, in PyTorch,
from the row's log-sum-exp the kernel keeps.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.ops import _build

Tensor = torch.Tensor

_ARGTYPES = [
    ctypes.c_void_p,  # logits
    ctypes.c_longlong,  # row_stride
    ctypes.c_void_p,  # target (int64)
    ctypes.c_longlong,  # n_rows
    ctypes.c_int,  # V
    ctypes.c_longlong,  # ignore_index
    ctypes.c_int,  # has_ignore
    ctypes.c_void_p,  # nll
    ctypes.c_void_p,  # valid
    ctypes.c_void_p,  # lse
    ctypes.c_void_p,  # stream
]
#: the kernel's C entry point for each logits type
_ENTRY = {torch.float32: "token_nll_f32", torch.bfloat16: "token_nll_bf16", torch.float16: "token_nll_f16"}


def _check(logits: Tensor, target: Tensor) -> None:
    if logits.ndim != 2 or logits.dtype not in _ENTRY or logits.shape[1] < 1:
        raise ValueError(
            f"token_nll: expected (N, V) logits of float32, bfloat16 or float16 with V >= 1, got {tuple(logits.shape)}"
            f" {logits.dtype}"
        )
    if target.shape != logits.shape[:1] or target.dtype.is_floating_point or target.dtype == torch.bool:
        raise ValueError(f"token_nll: expected (N,) integer targets for {tuple(logits.shape)} logits, got {tuple(target.shape)} {target.dtype}")


def _indices(target: Tensor, vocab: int, ignore_index: Optional[int]) -> Tuple[Tensor, Tensor, Tensor]:
    """JAX's gather rules on the host's ops: the kept rows, each row's class (a
    negative target wraps once, an ignored row reads class 0) and whether that
    class lies outside ``[0, V)`` (JAX's gather fills NaN there)."""
    target = target.to(torch.int64)
    valid = target != ignore_index if ignore_index is not None else torch.ones_like(target, dtype=torch.bool)
    idx = torch.where(valid, target, torch.zeros_like(target))
    idx = torch.where(idx < 0, idx + vocab, idx)
    outside = (idx < 0) | (idx >= vocab)
    return valid, torch.where(outside, torch.zeros_like(idx), idx), outside


def token_nll_plain(logits: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """``(nll, valid)``: see :func:`token_nll`. JAX's arithmetic, op for op:
    ``m = max(x)``, ``shifted = x - m``, ``s = sum(exp(shifted))``, the log
    probability ``shifted[t] - log(s)``, negated. For 16-bit logits each of
    XLA's steps computes in float32 and rounds to the logits' type, as XLA
    lowers ``jax.nn.log_softmax`` there: ``shifted`` and ``exp(shifted)``
    rounded, their sum kept in float32 and rounded before its log, the log
    rounded, the difference rounded."""
    _check(logits, target)
    dtype = logits.dtype
    valid, idx, outside = _indices(target.to(logits.device), logits.shape[1], ignore_index)
    x = logits.to(torch.float32)
    m = torch.amax(x.detach(), dim=1, keepdim=True)  # JAX stops the max's gradient
    shifted = x - m
    if dtype != torch.float32:
        shifted = shifted.to(dtype).to(torch.float32)
        exps = torch.exp(shifted).to(dtype).to(torch.float32)
        log_s = torch.log(exps.sum(dim=1).to(dtype).to(torch.float32)).to(dtype).to(torch.float32)
    else:
        log_s = torch.log(torch.exp(shifted).sum(dim=1))
    picked = torch.gather(shifted, 1, idx[:, None])[:, 0]
    log_prob = (picked - log_s).to(dtype)
    log_prob = torch.where(outside, torch.full_like(log_prob, float("nan")), log_prob)
    return torch.where(valid, -log_prob, torch.zeros_like(log_prob)), valid


def _launch(logits: Tensor, target: Tensor, ignore_index: Optional[int]) -> Tuple[Tensor, Tensor, Tensor]:
    if logits.stride(1) != 1:
        logits = logits.contiguous()
    n, vocab = logits.shape
    target = target.to(logits.device, torch.int64).contiguous()
    nll = torch.empty(n, dtype=logits.dtype, device=logits.device)
    valid = torch.empty(n, dtype=torch.bool, device=logits.device)
    lse = torch.empty(n, dtype=torch.float32, device=logits.device)
    if n == 0:  # nothing to score: no launch, and none is counted
        return nll, valid, lse
    fn = _build.function(_ENTRY[logits.dtype], _ARGTYPES, library="token_nll")
    with torch.cuda.device(logits.device):
        status = fn(
            logits.data_ptr(), max(logits.stride(0), vocab), target.data_ptr(), n, vocab,
            0 if ignore_index is None else int(ignore_index), int(ignore_index is not None), nll.data_ptr(),
            valid.data_ptr(), lse.data_ptr(), torch.cuda.current_stream(logits.device).cuda_stream,
        )
    _build.check(status, "token_nll")
    token_nll.launches += 1
    return nll, valid, lse


class _TokenNll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits: Tensor, target: Tensor, ignore_index: Optional[int]):
        nll, valid, lse = _launch(logits, target, ignore_index)
        ctx.save_for_backward(logits, target, lse)
        ctx.ignore_index = ignore_index
        ctx.mark_non_differentiable(valid)
        return nll, valid

    @staticmethod
    def backward(ctx, grad_nll: Tensor, _grad_valid: Optional[Tensor]):
        logits, target, lse = ctx.saved_tensors
        valid, idx, outside = _indices(target, logits.shape[1], ctx.ignore_index)
        g = torch.where(valid & ~outside, grad_nll.to(torch.float32), torch.zeros_like(lse))
        grad = torch.exp(logits.to(torch.float32) - lse[:, None]) * g[:, None]
        grad.scatter_add_(1, idx[:, None], -g[:, None])
        return grad.to(logits.dtype), None, None


def token_nll(logits: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """``(nll, valid)`` of ``(N, V)`` logits (float32, bfloat16 or float16)
    and ``(N,)`` integer targets: ``valid`` is ``target != ignore_index``
    (every row without one), ``nll`` the row's ``-log softmax(logits)[t]`` in
    the logits' type, 0 where the row is ignored. JAX's rules: a negative
    target wraps once (-1 reads the last class), a class outside ``[0, V)``
    after that gives NaN, and a row with a NaN or a +inf logit, or only -inf
    ones, gives NaN. CUDA input goes through the hand kernel (one launch),
    CPU input through :func:`token_nll_plain`; they agree within the budget
    ``tests/test_torch_kernels_cuda.py`` states."""
    _check(logits, target)
    if logits.device.type == "cpu":
        return token_nll_plain(logits, target, ignore_index)
    if logits.device.type != "cuda":
        raise ValueError(f"token_nll: input on {logits.device}; expected a CUDA device or the CPU")
    return _TokenNll.apply(logits, target, ignore_index)


token_nll.launches = 0  # launches of the CUDA kernel (the plain version is not counted)
