"""Batched start selection for per-site fits.

Counterpart of ``grid_best_starts`` in ``hyphy_tpu/optimize/batched.py``
(the reference's OPTIMIZATION_START_GRID semantics, ``FEL.bf:609-734``).
``vmapped_maximize`` has no caller in the ported methods and is not ported.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from hyphy_tpu_torch.models.parameters import Params


def grid_best_starts(
    objective: Callable[[torch.Tensor, Params], torch.Tensor],
    grid: Dict[str, torch.Tensor],
    idx,
):
    """Evaluate G candidate starting points for every item and return the
    best per item (the first maximum wins).

    ``objective(idx [N], params {k: [N, ...]}) -> [N]`` is batched over
    items; ``grid``: dict of ``[G]``-shaped (or ``[G, ...]``) tensors;
    ``idx``: ``[N]`` item indices or an int.  The grid points are evaluated
    one after another, so one point's working set is live at a time.
    Returns (``{k: [N, ...]}`` chosen starts, values ``[G, N]``).
    """
    if isinstance(idx, int):
        idx = torch.arange(idx)
    n = idx.shape[0]
    n_grid = next(iter(grid.values())).shape[0]
    values = torch.stack([
        objective(idx, {k: v[g].expand((n,) + v.shape[1:]) for k, v in grid.items()})
        for g in range(n_grid)
    ])                                                   # [G, N]
    best = torch.argmax(values, dim=0)                   # [N]
    return {k: v[best] for k, v in grid.items()}, values
