# Clean twin of ml015_prod: rows multiplied in a loop, and host sizes with
# math.prod.
# PINNED: no rule may fire here.
import math

import torch

Tensor = torch.Tensor


def scale_product(x: Tensor) -> Tensor:
    out = x[0]
    for row in x[1:]:
        out = out * row
    return out


def area(sides) -> float:
    return float(math.prod(sides))
