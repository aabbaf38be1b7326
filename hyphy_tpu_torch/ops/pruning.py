"""Felsenstein pruning, one tree level at a time.

Counterpart of the gene path of ``hyphy_tpu/ops/pruning.py``: the exact-
width unrolled variant (``_site_log_likelihoods_unrolled``), with every
level's sibling product going through the K1 kernel
(:func:`hyphy_tpu_torch.ops.level_products.level_products`).  The padded
``lax.scan`` variant (``schedule_pad``) and the per-site routes are not
ported yet.

Numerics kept from the reference, which make fp32 usable on deep trees:
the identity propagator at the scratch index, max-renormalisation per
(node, pattern) with ``mx > 0 ? mx : 1``, the fp64 log-scale accumulator,
and the ``finfo.tiny`` clamp at the root.

Buffer design.  The JAX package writes each level into one CLV buffer with
``dynamic_update_slice``, which is functional there.  In torch, writing
into one buffer in place would put every level's gradient through a
buffer-sized copy (autograd's CopySlices) and risks version-counter errors.
Instead each level's output is its own tensor, kept in a list; a level's
children are gathered from their source tensors (``index_select`` per
source level) and joined with ``torch.cat``, then put into ``[W, K]``
order by one permutation.  The backward of each gather scatters only into
its source level.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from hyphy_tpu_torch.ops.level_products import level_products
from hyphy_tpu_torch.tree.topology import Tree

# source id of the all-ones scratch row gathered by padded child slots
_SCRATCH = -1


class LevelPlan(NamedTuple):
    """How one level gathers its children: ``pieces`` is a list of
    ``(source, rows)`` — ``source`` 0 for the leaves, ``l + 1`` for the
    output of level ``l``, ``_SCRATCH`` for the all-ones row — and ``perm``
    (or None when the concatenated pieces are already in order) reorders
    the joined rows into flat ``[W * K]`` child order."""

    pieces: List[Tuple[int, torch.Tensor]]
    perm: "torch.Tensor | None"
    child_branch: torch.Tensor   # [W, K] int64 propagator row per child


class PruningData(NamedTuple):
    """Static (per-topology) arrays driving the pruning loop."""

    n_nodes: int
    n_leaves: int
    # exact-width schedule as in the JAX package: per level
    # (storage_offset, child_storage [W,K], child_branch [W,K]), with
    # internal-node CLVs stored level-contiguously after the leaves
    ulevels: tuple
    plans: Tuple[LevelPlan, ...]   # the same schedule as per-level gathers


def build_pruning_data(tree: Tree, device) -> PruningData:
    n_nodes, n_leaves = tree.n_nodes, tree.n_leaves
    arity = max(len(tree.children[nd]) for nd in range(n_leaves, n_nodes))
    storage = np.full(n_nodes + 1, n_nodes, dtype=np.int64)
    storage[:n_leaves] = np.arange(n_leaves)
    # storage slot -> (source, row): leaves are source 0, level l is l + 1
    source_of = np.full(n_nodes + 1, _SCRATCH, dtype=np.int64)
    row_of = np.zeros(n_nodes + 1, dtype=np.int64)
    source_of[:n_leaves] = 0
    row_of[:n_leaves] = np.arange(n_leaves)
    next_slot = n_leaves
    levels, plans = [], []
    for li, lv in enumerate(tree.levels()):
        w = len(lv)
        storage[lv] = next_slot + np.arange(w)
        child_storage = np.full((w, arity), n_nodes, dtype=np.int32)
        child_branch = np.full((w, arity), n_nodes, dtype=np.int32)
        for slot, nd in enumerate(lv):
            for k, c in enumerate(tree.children[nd]):
                child_storage[slot, k] = storage[c]
                child_branch[slot, k] = c
        levels.append((next_slot, child_storage, child_branch))
        plans.append(_level_plan(child_storage, child_branch, source_of, row_of, device))
        source_of[next_slot : next_slot + w] = li + 1
        row_of[next_slot : next_slot + w] = np.arange(w)
        next_slot += w
    return PruningData(n_nodes, n_leaves, tuple(levels), tuple(plans))


def _level_plan(child_storage, child_branch, source_of, row_of, device) -> LevelPlan:
    flat = child_storage.reshape(-1)
    src = source_of[flat]
    pieces, order = [], []
    for s in sorted(set(src.tolist())):
        pos = np.nonzero(src == s)[0]            # flat child positions, in order
        rows = np.zeros(len(pos), dtype=np.int64) if s == _SCRATCH else row_of[flat[pos]]
        pieces.append((s, torch.as_tensor(rows, device=device)))
        order.append(pos)
    order = np.concatenate(order)
    perm = None
    if not np.array_equal(order, np.arange(len(flat))):
        perm = torch.as_tensor(np.argsort(order, kind="stable"), device=device)
    branch = torch.as_tensor(child_branch.astype(np.int64), device=device)
    return LevelPlan(pieces, perm, branch)


def site_log_likelihoods(
    p_matrices: torch.Tensor,     # [n_nodes(+1), S, S]; row above each node
    leaf_partials: torch.Tensor,  # [n_leaves, patterns, S]
    root_freqs: torch.Tensor,     # [S]
    data: PruningData,
) -> torch.Tensor:
    """Per-pattern log-likelihood ``log sum_s pi_s CLV_root[p, s]`` (fp64).

    ``p_matrices`` may have ``n_nodes`` rows (root row unused) or
    ``n_nodes + 1``; the row at the scratch index is the identity, so padded
    child slots are no-ops.
    """
    n_nodes = data.n_nodes
    patterns, states = leaf_partials.shape[1], leaf_partials.shape[2]
    dtype, device = leaf_partials.dtype, leaf_partials.device

    p_own = p_matrices[:n_nodes].to(dtype)
    eye = torch.eye(states, dtype=dtype, device=device)
    pad = eye.expand(n_nodes + 1 - p_own.shape[0], states, states)
    p_all = torch.cat([p_own, pad], dim=0)                 # [n_nodes + 1, S, S]
    scratch = torch.ones((1, patterns, states), dtype=dtype, device=device)

    outputs = [leaf_partials]
    # the running log-scale sums ~O(tree depth) terms to a large magnitude;
    # accumulate in fp64 (per-level log/sum stay in the compute dtype) so an
    # fp32 CLV path does not quantize site lnL at the accumulator
    log_scale = torch.zeros((patterns,), dtype=torch.float64, device=device)
    for plan in data.plans:
        w, k = plan.child_branch.shape
        gathered = [
            (scratch if s == _SCRATCH else outputs[s]).index_select(0, rows)
            for s, rows in plan.pieces
        ]
        cc = gathered[0] if len(gathered) == 1 else torch.cat(gathered, dim=0)
        if plan.perm is not None:
            cc = cc.index_select(0, plan.perm)
        cc = cc.reshape(w, k, patterns, states)
        cp = p_all[plan.child_branch]                      # [W, K, S, S]
        prod = level_products(cc, cp)                      # [W, patterns, S]
        mx = torch.amax(prod, dim=-1, keepdim=True)
        mx = torch.where(mx > 0, mx, torch.ones((), dtype=dtype, device=device))
        outputs.append(prod / mx)
        log_scale = log_scale + torch.sum(torch.log(mx[..., 0]), dim=0).to(torch.float64)

    # the root is the last node of the last level
    root_like = outputs[-1][-1] @ root_freqs.to(dtype)    # [patterns]
    tiny = torch.tensor(torch.finfo(dtype).tiny, dtype=dtype, device=device)
    root_like = torch.maximum(root_like, tiny)
    return torch.log(root_like.to(torch.float64)) + log_scale


def total_log_likelihood(site_loglik: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """lnL = sum_patterns freq_p * lnL_p (reference: likefunc.cpp:11123)."""
    return torch.dot(site_loglik, weights)
