"""Ancestral state reconstruction: joint maximum likelihood and sampling.

Counterpart of ``joint_reconstruct`` and ``sample_ancestors`` in
``hyphy_tpu/ops/ancestral.py`` (reference: ``_TheTree::
RecoverAncestralSequences``, the joint max-product DP of Pupko et al.,
``src/core/tree.cpp:4209``; ``SampleAncestorsBySequence``,
``tree.cpp:4086``), vectorized over site patterns:

  * up pass: per child, per pattern, per parent state ``i``:
    ``max_c P[i, c] * child[c]`` with the first argmax cached; a completely
    unresolved child vector (all ones) contributes 1 and caches state -1;
  * root: the first argmax of ``pi_c * cond[c]`` (-1 when unresolved);
  * traceback: child state = cache[child, pattern, parent state].

The up pass runs on the port's level schedule (:func:`pruning.build_pruning
_data`: each launch padded to its own arity, not the tree's largest).  The
JAX package forms a whole level's ``[children, patterns, S, S]`` product at
once (39 GB in fp64 at 640 children x 2048 codon patterns); here it is
formed ``_CHUNK_BYTES`` at a time.  A node of more than four children
multiplies its children's messages four at a time and renormalises between
chunks (:func:`pruning._chunked_product`), where the reference's product of
~1000 children underflows; every scale is uniform over the parent's states,
so no argmax moves, and nodes of at most four children keep the
reference's arithmetic exactly.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from hyphy_tpu_torch.ops.pruning import _CHUNK, PruningData, _chunked_product

# bytes of one piece of a level's [children, patterns, S, S] max-product
_CHUNK_BYTES = 1 << 29


class JointReconstruction(NamedTuple):
    internal_states: torch.Tensor  # [n_internal, patterns] int32, -1 = unresolved
    root_loglik: torch.Tensor      # [patterns] max-product log-likelihood (fp64)


def _max_messages(p_child: torch.Tensor, cond: torch.Tensor, slots: torch.Tensor):
    """``vals[f, p, i] = max_c p_child[f, i, c] * cond[slots[f], p, c]`` and
    its first argmax over ``c`` (int16), -1 / 1 for unresolved children,
    in pieces of at most ``_CHUNK_BYTES`` of the product."""
    n_rows = slots.shape[0]
    patterns, states = cond.shape[1], cond.shape[2]
    per_pair = states * states * cond.element_size()
    pats = min(patterns, max(1, _CHUNK_BYTES // per_pair))
    rows = max(1, _CHUNK_BYTES // (per_pair * pats))
    vals = torch.empty((n_rows, patterns, states), dtype=cond.dtype, device=cond.device)
    args = torch.empty((n_rows, patterns, states), dtype=torch.int16, device=cond.device)
    for r0 in range(0, n_rows, rows):
        r1 = min(r0 + rows, n_rows)
        cp = p_child[r0:r1, None]                                   # [R, 1, S, S]
        for p0 in range(0, patterns, pats):
            p1 = min(p0 + pats, patterns)
            cc = cond[slots[r0:r1], p0:p1]                          # [R, Pc, S]
            v, a = torch.max(cp * cc[:, :, None, :], dim=-1)        # first maximum
            unresolved = torch.all(cc == 1.0, dim=-1, keepdim=True)
            vals[r0:r1, p0:p1] = torch.where(unresolved, torch.ones((), dtype=v.dtype,
                                                                    device=v.device), v)
            args[r0:r1, p0:p1] = torch.where(unresolved, -1, a).to(torch.int16)
    return vals, args


def joint_reconstruct(
    p_matrices: torch.Tensor,     # [n_nodes(+1), S, S]; row above each node
    leaf_partials: torch.Tensor,  # [n_leaves, patterns, S]
    root_freqs: torch.Tensor,     # [S]
    data: PruningData,
) -> JointReconstruction:
    """Joint ML internal states per pattern, in the leaf partials' dtype
    and device (see the module docstring)."""
    n_nodes, n_leaves = data.n_nodes, data.n_leaves
    patterns, states = leaf_partials.shape[1], leaf_partials.shape[2]
    dtype, device = leaf_partials.dtype, leaf_partials.device
    p_own = p_matrices[:n_nodes].to(dtype)
    eye = torch.eye(states, dtype=dtype, device=device)
    p_all = torch.cat([p_own, eye.expand(n_nodes + 1 - p_own.shape[0], states, states)])

    # CLVs by storage slot: the leaves, each level's nodes, the all-ones
    # scratch row at n_nodes that padded child slots gather
    cond = torch.ones((n_nodes + 1, patterns, states), dtype=dtype, device=device)
    cond[:n_leaves] = leaf_partials
    one = torch.ones((), dtype=dtype, device=device)
    caches: List[torch.Tensor] = []
    log_scale = torch.zeros((patterns,), dtype=torch.float64, device=device)
    for (offset, _, _), plan in zip(data.ulevels, data.plans):
        w, k = plan.child_storage.shape
        vals, args = _max_messages(p_all[plan.child_branch.reshape(-1)], cond,
                                   plan.child_storage.reshape(-1))
        caches.append(args)
        vals = vals.reshape(w, k, patterns, states)
        if k <= _CHUNK:
            prod = torch.prod(vals, dim=1)
        else:
            chunks = torch.prod(vals.reshape(w, k // _CHUNK, _CHUNK, patterns, states), dim=2)
            prod, logs = _chunked_product(chunks, 1)
            log_scale = log_scale + torch.sum(logs, dim=0).to(torch.float64)
        mx = torch.amax(prod, dim=-1, keepdim=True)
        mx = torch.where(mx > 0, mx, one)
        # keep exactly-unresolved nodes at exactly 1.0 (the degeneracy test)
        all_unres = torch.all(prod == 1.0, dim=-1, keepdim=True)
        cond[offset: offset + w] = torch.where(all_unres, prod, prod / mx)
        inc = torch.where(all_unres[..., 0], torch.zeros((), dtype=dtype, device=device),
                          torch.log(mx[..., 0]))
        log_scale = log_scale + torch.sum(inc, dim=0).to(torch.float64)

    root_slot = int(data.node_slots[n_nodes - 1])
    root_cond = cond[root_slot]                                     # [patterns, S]
    weighted = root_cond * root_freqs.to(dtype)[None, :]
    best, root_arg = torch.max(weighted, dim=-1)
    root_state = torch.where(torch.all(root_cond == 1.0, dim=-1), -1, root_arg)
    tiny = torch.tensor(torch.finfo(dtype).tiny, dtype=dtype, device=device)
    root_loglik = torch.log(torch.maximum(best, tiny)).to(torch.float64) + log_scale

    # traceback, top-down over the launches in reverse
    by_slot = torch.full((n_nodes + 1, patterns), -1, dtype=torch.int64, device=device)
    by_slot[root_slot] = root_state
    for (offset, _, _), plan, cache in zip(reversed(data.ulevels), reversed(data.plans),
                                           reversed(caches)):
        w, k = plan.child_storage.shape
        ps = by_slot[offset: offset + w].repeat_interleave(k, dim=0)    # [W*K, patterns]
        cs = torch.gather(cache, -1, ps.clamp_min(0)[..., None])[..., 0].to(torch.int64)
        cs = torch.where(ps < 0, -1, cs)
        slots = plan.child_storage.reshape(-1)
        real = slots != n_nodes                                        # not the scratch row
        by_slot[slots[real]] = cs[real]
    node_slots = torch.as_tensor(data.node_slots[n_leaves:n_nodes], device=device)
    internal = by_slot[node_slots].to(torch.int32)
    return JointReconstruction(internal_states=internal, root_loglik=root_loglik)


def sample_ancestors(
    p_matrices,
    leaf_partials,
    root_freqs,
    data: PruningData,
    children: list,
    n_samples: int,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Sample internal-node states from the joint posterior (reference:
    ``SampleAncestorsBySequence``, ``src/core/tree.cpp:4086``).

    Host NumPy, as in the JAX package, with its node order and its order of
    draws, so that one generator state gives the same samples.  Top-down:
    root ~ pi_s * CLV_root[s]; each child given its sampled parent state q ~
    P_child[q, s] * CLV_child[s].  The inside CLVs renormalise after every
    four children (nodes of at most four children keep the reference's
    product; wider ones would underflow there).  Returns ``[n_samples,
    n_internal, patterns]`` int32.
    """
    rng = rng or np.random.default_rng(0)
    n_nodes = data.n_nodes
    lp = np.asarray(leaf_partials, dtype=np.float64)
    patterns, states = lp.shape[1], lp.shape[2]
    p_all = np.asarray(p_matrices, dtype=np.float64)

    clv = np.ones((n_nodes, patterns, states))
    clv[: data.n_leaves] = lp
    order = []
    done = set(range(data.n_leaves))
    pending = [n for n in range(data.n_leaves, n_nodes)]
    while pending:
        for n in list(pending):
            if all(c in done for c in children[n]):
                order.append(n)
                done.add(n)
                pending.remove(n)
    for n in order:
        acc = np.ones((patterns, states))
        for k, c in enumerate(children[n]):
            if k and k % _CHUNK == 0:
                acc = acc / np.maximum(acc.max(axis=-1, keepdims=True), 1e-300)
            acc = acc * (clv[c] @ p_all[c].T)
        mx = np.maximum(acc.max(axis=-1, keepdims=True), 1e-300)
        clv[n] = acc / mx

    root = n_nodes - 1
    out = np.empty((n_samples, n_nodes - data.n_leaves, patterns), dtype=np.int32)

    def draw(prob):
        """prob [patterns, S] unnormalized -> [patterns] int samples."""
        z = np.maximum(prob.sum(axis=-1, keepdims=True), 1e-300)
        cdf = np.cumsum(prob / z, axis=-1)
        u = rng.uniform(size=(patterns, 1))
        return np.argmax(u < cdf, axis=-1).astype(np.int32)

    for s in range(n_samples):
        state = np.empty((n_nodes, patterns), dtype=np.int32)
        state[root] = draw(clv[root] * np.asarray(root_freqs)[None, :])
        for n in reversed(order):          # preorder: parents before children
            for c in children[n]:
                if c < data.n_leaves:
                    continue
                state[c] = draw(p_all[c][state[n]] * clv[c])
        out[s] = state[data.n_leaves:]
    return out
