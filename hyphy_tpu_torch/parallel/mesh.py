"""Device mesh: the pattern axis of a likelihood and the items of every
per-site solve split over several devices.

Counterpart of ``hyphy_tpu/parallel/mesh.py`` (the reference's MPI
site-template mode, ``likefunc.h:109``, and its OpenMP site-range split,
``likefunc.cpp:11016``).  The JAX package shards over a single-controller
``Mesh``; here one process drives an ordered tuple of ``torch.device``s,
which needs neither ``torch.distributed`` nor a launcher.  The rules:

- items (patterns, or a per-site solve's sites, grid points or jobs) are
  split into contiguous blocks, one per device, whose sizes differ by at
  most one (:func:`shards`), so nothing is padded and every site-level
  output keeps its true width (the JAX package pads to a device multiple
  instead);
- what depends only on the parameters (the propagators) is built once on
  the first device, where the model lives, and copied to each block's
  device (:func:`to_device`; autograd differentiates the copy);
- each block's work runs on its own device, K1 included;
- the blocks' outputs are joined on the first device in item order, so a
  sharded result differs from an unsharded one only where a block's own
  values do.

A mesh may name one device more than once (four shards of one card, or
``("cpu",) * 3`` in the tests) and may mix devices (``(cuda:0, cpu)``).
A likelihood's blocks are issued one after another from the calling
thread: on distinct cards they overlap as far as no block waits on the
host, which the gene pruning never does.  A per-site solve's blocks each
read their Nelder-Mead's convergence on the host, so
:func:`sharded_site_solve` runs each block from a host thread of its own.
So a mesh of cards is engaged on its own only for a likelihood that one
card cannot hold (:meth:`config.Settings.default_mesh`); ``settings.mesh``
names one for anything else.  ``pad_to_multiple`` is not ported: nothing
pads.
"""

from __future__ import annotations

import collections
import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hyphy_tpu_torch.config import canonical_device, resolve_device, settings
from hyphy_tpu_torch.optimize import batched

Mesh = Tuple[torch.device, ...]


def data_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """An ordered tuple of devices: ``devices``, or every visible card;
    each resolved through :func:`resolve_device` (a CUDA name without a
    card raises)."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())] or ["cuda"]
    return tuple(canonical_device(resolve_device(d)) for d in devices)


def resolve_mesh(mesh, device, nbytes=None) -> Optional[Mesh]:
    """The mesh of a likelihood on ``device``: ``"auto"`` is
    ``settings.default_mesh(device, nbytes)`` (``nbytes``: its estimated
    working set), ``None`` no mesh, a sequence of devices that mesh (its
    first device must be ``device``).  A mesh of one device is no mesh."""
    if isinstance(mesh, str) and mesh == "auto":
        return settings.default_mesh(device, nbytes)
    if mesh is None:
        return None
    mesh = data_mesh(mesh)
    if mesh[0] != canonical_device(device):
        raise ValueError(f"the mesh starts on {mesh[0]}, the model lives on {device}")
    return mesh if len(mesh) > 1 else None


def shards(n_items: int, mesh: Mesh) -> List[Tuple[torch.device, int, int]]:
    """``(device, lo, hi)`` per non-empty block of ``range(n_items)``:
    contiguous, in mesh order, the first ``n_items % len(mesh)`` blocks one
    item longer."""
    bounds = np.cumsum([0] + [len(b) for b in np.array_split(np.arange(n_items), len(mesh))])
    return [(dev, int(lo), int(hi)) for dev, lo, hi in zip(mesh, bounds, bounds[1:]) if hi > lo]


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device``; the copy does not make the host wait where the
    destination is a card (a copy to the host would hand back memory the
    card has not yet written, so that one waits)."""
    device = torch.device(device)
    return x.to(device, non_blocking=device.type == "cuda")


def per_device(build: Callable[[torch.device], object]) -> Callable[[torch.device], object]:
    """``build`` memoised per device: a solve's closures, built once on
    each device of its mesh and reused by every solve that follows.  Not
    thread-safe: :func:`sharded_site_solve` calls ``make_solver`` for every
    block in the calling thread, before any block runs."""
    made: Dict[str, object] = {}

    def get(device):
        device = canonical_device(device)
        if str(device) not in made:
            made[str(device)] = build(device)
        return made[str(device)]

    return get


def block_budgets(blocks: Sequence[Tuple[torch.device, int, int]]) -> List[Optional[float]]:
    """Per block of :func:`shards`, the bytes of its card's free memory
    that its chunks may count on: the card's free memory, read once, over
    the number of blocks on that card (``None`` on the host, where a
    block takes its items at once).  Blocks that share a card run at the
    same time, so each reading the whole would ask for up to its count
    times the card."""
    counts = collections.Counter(str(dev) for dev, _, _ in blocks)
    free: Dict[str, float] = {}
    for dev, _, _ in blocks:
        if dev.type == "cuda" and str(dev) not in free:
            free[str(dev)] = float(torch.cuda.mem_get_info(dev)[0])
    return [free[str(dev)] / counts[str(dev)] if dev.type == "cuda" else None
            for dev, _, _ in blocks]


def _run_block(solver, n_items, bytes_per_item, device, chunk, free, max_chunk, grad, inference):
    """One block of :func:`sharded_site_solve` on a worker thread, with the
    caller's grad and inference modes (both are thread-local) and its card
    as the thread's current device (a new thread starts on card 0)."""
    card = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
    with torch.inference_mode(inference), torch.set_grad_enabled(grad), card:
        return batched.chunked_site_solve(solver, n_items, bytes_per_item, device, chunk, free,
                                          max_chunk)


def sharded_site_solve(
    make_solver: Callable[[torch.device], Callable[[torch.Tensor], Dict[str, torch.Tensor]]],
    n_items: int,
    bytes_per_item: float,
    device,
    chunk: Optional[int] = None,
    max_chunk: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Run a batched per-item solve on ``device``, its items split over the
    mesh that ``settings.mesh`` names (the automatic mesh never splits a
    per-site solve: :func:`batched.chunked_site_solve` already fits it to
    one card's memory, and four H100s ran FEL's per-site stage 6.4x slower
    than one at 1000 x 2048, PERF.md).

    ``make_solver(dev)`` gives ``solver(idx [n]) -> {k: [n, ...]}`` whose
    tensors live on ``dev`` (given with its CUDA index filled in; ``idx``
    holds global item indices, on ``dev``).  Every block's solver is made
    here, in the calling thread and in mesh order; then each block runs as
    :func:`batched.chunked_site_solve` from a thread of its own (also where
    the mesh names one device more than once), in chunks that half of its
    share of its device's free memory holds at ``bytes_per_item``
    (:func:`block_budgets`; ``chunk`` forces one size, ``max_chunk`` caps
    it).  Once every block has ended, a block's exception is raised here;
    else every output is joined on the first device in item order.
    Without a mesh the whole solve is one such block on ``device``, run in
    the calling thread.  A solver draws from no random generator: what is
    drawn is drawn before the solve, so that the blocks' order cannot
    change it."""
    mesh = settings.default_mesh(device)
    if mesh is None:
        mesh = (canonical_device(device),)
    blocks = shards(n_items, mesh)
    if len(blocks) < 2:
        dev = mesh[0]
        return batched.chunked_site_solve(make_solver(dev), n_items, bytes_per_item, dev,
                                          chunk, block_budgets(blocks)[0] if blocks else None,
                                          max_chunk)
    solvers = [make_solver(dev) for dev, _, _ in blocks]
    modes = (torch.is_grad_enabled(), torch.is_inference_mode_enabled())
    with ThreadPoolExecutor(max_workers=len(blocks)) as pool:
        futures = [
            pool.submit(_run_block, lambda idx, solver=solver, lo=lo: solver(idx + lo), hi - lo,
                        bytes_per_item, dev, chunk, free, max_chunk, *modes)
            for solver, (dev, lo, hi), free in zip(solvers, blocks, block_budgets(blocks))
        ]
    # the pool's exit has waited for every block; result() raises a block's
    # exception in mesh order
    first = mesh[0]
    parts = [{k: to_device(v, first) for k, v in f.result().items()} for f in futures]
    return {k: torch.cat([p[k] for p in parts], dim=0) for k in parts[0]}
