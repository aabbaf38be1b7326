"""Batched bounded Nelder-Mead with convergence masking / early exit.

Counterpart of ``hyphy_tpu/optimize/nelder_mead.py``.  The reference's
per-site fits use Nelder-Mead at precision 1e-3 (``FEL.bf:726-734``,
``likefunc.cpp:9456`` SimplexMethod); here every site's simplex advances
in one batch:

  * the loop runs while any row's simplex value-spread exceeds ``tol`` (so
    it runs max-over-sites iterations, not a fixed worst case), up to
    ``max_iterations``; under ``settings.warmup`` it stops after 32, the
    JAX package's first device chunk;
  * each iteration costs THREE batched objective evaluations: reflect; one
    adaptive second probe (expansion when the reflection leads, else the
    outside contraction); and a rank-1 worst-toward-best fallback in place
    of the classic full shrink;
  * converged rows are frozen (masked updates), so their values are
    bit-stable once done.

Fused probes (the JAX package's opt-in, ``HYPHY_TPU_NM_FUSED=1``, taken
only on the card): reflection, expansion, contraction and fallback go in
ONE batched call of 4N items — one evaluation's launches per iteration
instead of three, at 4x its peak memory.  The objective's items are
independent, so every row takes the same decisions and values as with the
three sequential probes.

Parameters are optimized in logit-transformed (unbounded) space.  The
objective is batched: ``objective(idx [N], params {k: [N, ...]}) -> [N]``,
where the JAX package ``vmap``s a per-item objective.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.models.parameters import (
    Params,
    Specs,
    clip_to_bounds,
    to_bounded,
    to_unbounded,
)

_WARMUP_ITERATIONS = 32


def _pack(specs: Specs):
    """Batched (vector <-> dict) maps in sorted key order: ``to_vec`` takes
    ``{k: [N, *shape]}`` to ``[N, n]``, ``to_dict`` back."""
    keys = sorted(specs)
    sizes = [int(np.prod(specs[k].shape)) if specs[k].shape else 1 for k in keys]

    def to_vec(params: Params) -> torch.Tensor:
        return torch.cat([params[k].reshape(params[k].shape[0], -1) for k in keys], dim=1)

    def to_dict(vec: torch.Tensor) -> Params:
        out, ofs = {}, 0
        for k, sz in zip(keys, sizes):
            val = vec[:, ofs : ofs + sz]
            out[k] = val.reshape((vec.shape[0],) + specs[k].shape) if specs[k].shape else val[:, 0]
            ofs += sz
        return out

    return to_vec, to_dict


def _finite_or_minus_inf(v: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(v), v, torch.full_like(v, -torch.inf))


def fused_probes(device) -> bool:
    """The JAX package's rule for the fused body: opted in by
    ``HYPHY_TPU_NM_FUSED=1``, and only off the CPU."""
    return torch.device(device).type == "cuda" and os.environ.get("HYPHY_TPU_NM_FUSED") == "1"


def _batched_nelder_mead(
    f_batch: Callable[[torch.Tensor], torch.Tensor],  # [m*N, n] -> [m*N]
    u0: torch.Tensor,                                 # [N, n]
    max_iterations: int,
    tol: float,
    initial_step: float,
    fused: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximize ``f_batch`` per row; returns (u_best [N, n], value [N]).
    ``fused``: the four probes of an iteration in one call of 4N rows."""
    n = u0.shape[1]
    offsets = torch.cat([
        torch.zeros((1, n), dtype=u0.dtype, device=u0.device),
        initial_step * torch.eye(n, dtype=u0.dtype, device=u0.device),
    ])
    simplex = u0[:, None, :] + offsets[None]                       # [N, n+1, n]
    values = torch.stack([f_batch(simplex[:, k]) for k in range(n + 1)], dim=1)

    def spread(values):
        return torch.amax(values, dim=1) - torch.amin(values, dim=1)

    if settings.warmup:
        max_iterations = min(max_iterations, _WARMUP_ITERATIONS)
    it = 0
    while it < max_iterations and bool((spread(values) > tol).any()):
        done = spread(values) <= tol                                # [N]
        # stable, as jnp.argsort: non-finite objectives tie at -inf
        order = torch.argsort(-values, dim=1, stable=True)          # best first
        simplex = torch.take_along_dim(simplex, order[..., None], dim=1)
        values = torch.take_along_dim(values, order, dim=1)
        best, worst = simplex[:, 0], simplex[:, -1]
        centroid = torch.mean(simplex[:, :-1], dim=1)

        reflected = centroid + (centroid - worst)
        expanded = centroid + 2.0 * (centroid - worst)
        contracted = centroid - 0.5 * (centroid - worst)
        fallback = best + 0.5 * (worst - best)                      # rank-1 shrink
        if fused:
            f_r, f_e, f_c, f_s = f_batch(
                torch.cat([reflected, expanded, contracted, fallback])).chunk(4)
            want_expand = f_r > values[:, 0]
            f_2 = torch.where(want_expand, f_e, f_c)
        else:
            f_r = f_batch(reflected)
            want_expand = f_r > values[:, 0]
            f_2 = f_batch(torch.where(want_expand[:, None], expanded, contracted))
            f_s = f_batch(fallback)
        second = torch.where(want_expand[:, None], expanded, contracted)

        minus_inf = torch.full_like(f_2, -torch.inf)
        f_e = torch.where(want_expand, f_2, minus_inf)
        f_c = torch.where(want_expand, minus_inf, f_2)
        use_expand = want_expand & (f_e > f_r)
        use_reflect = (f_r > values[:, -2]) & ~use_expand
        use_contract = ~use_expand & ~use_reflect & (f_c > values[:, -1])
        new_point = torch.where(
            use_expand[:, None], second,
            torch.where(use_reflect[:, None], reflected,
                        torch.where(use_contract[:, None], second, fallback)),
        )
        new_value = torch.where(
            use_expand, f_2,
            torch.where(use_reflect, f_r, torch.where(use_contract, f_2, f_s)),
        )
        new_simplex = torch.cat([simplex[:, :-1], new_point[:, None]], dim=1)
        new_values = torch.cat([values[:, :-1], new_value[:, None]], dim=1)

        # freeze converged rows so finished sites stay bit-stable
        simplex = torch.where(done[:, None, None], simplex, new_simplex)
        values = torch.where(done[:, None], values, new_values)
        it += 1
    best_idx = torch.argmax(values, dim=1)                          # [N]
    u_best = torch.take_along_dim(simplex, best_idx[:, None, None], dim=1)[:, 0]
    return u_best, torch.amax(values, dim=1)


def nelder_mead(
    objective: Callable[[Params], torch.Tensor],
    specs: Specs,
    init: Params,
    max_iterations: int = 200,
    initial_step: float = 0.5,
    tol: float = 1e-6,
) -> Tuple[Params, torch.Tensor]:
    """Maximize ``objective`` over bounded params; returns (params, value)."""
    to_vec, to_dict = _pack(specs)

    def one(u_vec: torch.Tensor) -> Params:
        return {k: v[0] for k, v in to_bounded(to_dict(u_vec[None]), specs).items()}

    def f_batch(u_mat: torch.Tensor) -> torch.Tensor:
        return _finite_or_minus_inf(torch.stack([objective(one(u)) for u in u_mat]))

    start = clip_to_bounds(
        {k: torch.as_tensor(init[k], dtype=torch.float64)[None] for k in specs}, specs)
    u_best, value = _batched_nelder_mead(
        f_batch, to_vec(to_unbounded(start, specs)), max_iterations, tol, initial_step)
    return one(u_best[0]), value[0]


def vmapped_nelder_mead(
    objective: Callable[[torch.Tensor, Params], torch.Tensor],
    specs: Specs,
    init_batch: Params,
    idx,
    max_iterations: int = 200,
    tol: float = 1e-6,
    initial_step: float = 0.5,
    fused: Optional[bool] = None,
):
    """Per-item Nelder-Mead of the batched ``objective(idx, params)``.

    ``idx``: ``[N]`` item indices (an int for ``torch.arange``-style use);
    ``init_batch``: ``{k: [N, ...]}`` starts.  Returns (params ``{k: [N,
    ...]}`` fp64, values ``[N]`` in the objective's dtype).  All items
    iterate in lockstep; the loop exits as soon as EVERY item's simplex
    value-spread is <= ``tol`` (converged items are frozen while stragglers
    finish).  ``fused``: the four probes in one call per iteration, with
    ``idx`` repeated (None: :func:`fused_probes` of ``idx``'s device).
    """
    if isinstance(idx, int):
        idx = torch.arange(idx)
    if fused is None:
        fused = fused_probes(idx.device)
    to_vec, to_dict = _pack(specs)

    def f_batch(u_mat: torch.Tensor) -> torch.Tensor:
        # [m * N, n]: the probes stacked over the item batch
        reps = u_mat.shape[0] // idx.shape[0]
        idx_m = idx.repeat(reps) if reps > 1 else idx
        return _finite_or_minus_inf(objective(idx_m, to_bounded(to_dict(u_mat), specs)))

    start = clip_to_bounds({
        k: torch.as_tensor(init_batch[k], dtype=torch.float64, device=idx.device)
        for k in specs
    }, specs)
    u_best, values = _batched_nelder_mead(
        f_batch, to_vec(to_unbounded(start, specs)), max_iterations, tol, initial_step, fused)
    return to_bounded(to_dict(u_best), specs), values
