# Clean twin of ml014_computed_dim: the empty case is tested first, as
# functional/regression/csi.py's _count does.
# PINNED: no rule may fire here.
import torch

Tensor = torch.Tensor


def sum_but(x: Tensor, keep: int) -> Tensor:
    dims = tuple(d for d in range(x.ndim) if d != keep)
    if not dims:
        return x
    return x.sum(dim=dims)


def sum_rows(x: Tensor, dim: int) -> Tensor:
    return x.sum(dim=dim)
