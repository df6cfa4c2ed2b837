# A sum over a computed dim tuple that is empty for 1-D input: torch then
# reduces every dim where jnp.sum(axis=()) reduces none.
# PINNED: ML014 must fire here (and nothing else may).
import torch

Tensor = torch.Tensor


def sum_but(x: Tensor, keep: int) -> Tensor:
    dims = tuple(d for d in range(x.ndim) if d != keep)
    return x.sum(dim=dims)
