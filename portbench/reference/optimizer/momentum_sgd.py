"""Classical momentum, per tensor in the stored dtype: u <- mu·u + g, the
update −lr·u, each stored in ``dtype`` (float32 arithmetic)."""
from __future__ import annotations

import numpy as np
import torch


def init(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(t)


def update(u: torch.Tensor, g: torch.Tensor, dtype: torch.dtype, *, lr: float,
           mu: float = 0.9, nesterov: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(the new state, the update) of one tensor."""
    if nesterov:
        raise NotImplementedError("the reference has no Nesterov momentum")
    u = (u.float() * mu + g.float()).to(dtype)
    return u, (u.float() * np.float32(-lr)).to(dtype)


def first_gradient(state):
    """The gradient of the first step, read from the state after it: from
    zero, u = g. Takes a tree of the program's state or the reference's."""
    return state
