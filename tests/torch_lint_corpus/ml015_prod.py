# torch.prod on a device tensor: its kernel compiles at run time, the first
# time in a process.
# PINNED: ML015 must fire here (and nothing else may).
import torch

Tensor = torch.Tensor


def scale_product(x: Tensor) -> Tensor:
    return torch.prod(x, dim=0)


def side_product(x: Tensor) -> Tensor:
    return x.prod()
