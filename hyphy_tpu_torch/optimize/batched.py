"""Batched start selection and site-chunked solves for per-site fits.

Counterpart of ``grid_best_starts`` in ``hyphy_tpu/optimize/batched.py``
(the reference's OPTIMIZATION_START_GRID semantics, ``FEL.bf:609-734``),
and :func:`chunked_site_solve`, the solve of one block, which
``parallel/mesh.py::sharded_site_solve`` runs for each block of a mesh.
``vmapped_maximize`` has no caller in the ported methods and is not
ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

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


# share of the card's free memory one chunk of a site solve may take
_FREE_MEMORY_SHARE = 0.5


def site_chunk(n_items: int, bytes_per_item: float, device, free: Optional[float] = None) -> int:
    """Items per chunk of a site solve on ``device``: on the card, as many
    as half of ``free`` holds at ``bytes_per_item`` each (``free``: the
    bytes of the card's free memory that this solve may count on, by
    default all of it, read now); on the CPU, every item at once."""
    device = torch.device(device)
    if device.type != "cuda":
        return max(n_items, 1)
    if free is None:
        free, _ = torch.cuda.mem_get_info(device)
    return max(1, min(n_items, int(_FREE_MEMORY_SHARE * free // max(bytes_per_item, 1))))


def chunked_site_solve(
    solver: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
    n_items: int,
    bytes_per_item: float,
    device,
    chunk: Optional[int] = None,
    free: Optional[float] = None,
    max_chunk: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Run ``solver(idx [n]) -> {k: [n, ...]}`` over consecutive chunks of
    ``range(n_items)`` and join the outputs along axis 0.

    The solve of one block: ``parallel/mesh.py::sharded_site_solve`` splits
    the items over the devices of a mesh first and runs this on each, with
    the block's share ``free`` of its device's free memory.  The batch is
    split in time, in chunks of :func:`site_chunk` items (``chunk`` forces
    the items per chunk, to hold a split against one batch), never more
    than ``max_chunk``.  A batched per-site solver whose items are
    independent — grid starts and the Nelder-Mead, which freezes converged
    items by mask — gives every item the same result whatever the
    chunking."""
    if chunk is None:
        chunk = site_chunk(n_items, bytes_per_item, device, free)
    if max_chunk is not None:
        chunk = max(1, min(chunk, max_chunk))
    parts = [
        solver(torch.arange(lo, min(lo + chunk, n_items), device=device))
        for lo in range(0, n_items, chunk)
    ]
    if len(parts) == 1:
        return parts[0]
    return {k: torch.cat([p[k] for p in parts], dim=0) for k in parts[0]}
