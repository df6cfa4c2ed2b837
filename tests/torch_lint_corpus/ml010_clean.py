# Clean twin of ml010_reaches_jax: a port module may import torch and numpy;
# jax only inside a function that is never on the port's path.
# PINNED: no rule may fire here.
import numpy as np
import torch


def total(x):
    return torch.sum(torch.from_numpy(np.asarray(x)))


def jax_total(x):
    import jax.numpy as jnp

    return jnp.sum(x)
