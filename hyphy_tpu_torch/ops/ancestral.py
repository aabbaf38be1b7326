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

:func:`branch_flux_vectors` (BUSTED's per-branch class profiles, and
:func:`marginal_posteriors` on top of it) runs an
inside and an outside pass on the same level plans, with the same repair:
the reference multiplies all of a node's children (inside) and all of a
child's siblings (outside) before it renormalises.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from hyphy_tpu_torch.ops.pruning import _CHUNK, PruningData, _chunked_product, _sibling_product

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
    tiny = torch.full((), torch.finfo(dtype).tiny, dtype=dtype, device=device)
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


def _renormalised(x: torch.Tensor):
    """``x`` divided by its max over states (``mx > 0 ? mx : 1``), and the
    fp64 log of that max."""
    mx = torch.amax(x, dim=-1, keepdim=True)
    mx = torch.where(mx > 0, mx, torch.ones((), dtype=x.dtype, device=x.device))
    return x / mx, torch.log(mx[..., 0]).to(torch.float64)


def _sequential_sum(terms: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` one add at a time, in order (the reference's loop)."""
    out = terms.select(dim, 0)
    for k in range(1, terms.shape[dim]):
        out = out + terms.select(dim, k)
    return out


def _exclusive_products(outside: torch.Tensor, msg: torch.Tensor):
    """``outside[w] * prod_{sib != c} msg[w, sib]`` for every child ``c``:
    ``[W, K, patterns, S]`` values and ``[W, K, patterns]`` fp64 logs (the
    value times ``exp(logs)`` is the product).  Nodes of at most ``_CHUNK``
    children multiply in child order, as the reference does (logs 0);
    wider ones combine, renormalising after every step, the products of
    the other members of the child's chunk of four, and prefix and suffix
    products over the other chunks."""
    w, k = msg.shape[:2]
    if k <= _CHUNK:
        vals = []
        for c in range(k):
            acc = outside
            for sib in range(k):
                if sib != c:
                    acc = acc * msg[:, sib]
            vals.append(acc)
        return torch.stack(vals, dim=1), msg.new_zeros(msg.shape[:3], dtype=torch.float64)
    n_chunks = k // _CHUNK
    chunks = msg.reshape(w, n_chunks, _CHUNK, *msg.shape[2:])
    within = _exclusive_products(torch.ones_like(chunks[:, :, 0]).flatten(0, 1),
                                 chunks.flatten(0, 1))[0]          # [W * C, 4, p, S]
    within, within_logs = _renormalised(within.reshape(w, n_chunks, _CHUNK, *msg.shape[2:]))
    totals, total_logs = _renormalised(_sibling_product(chunks, 2))  # [W, C, p, S]
    # prefix[j] = prod_{i < j} totals[i], suffix[j] = prod_{i > j}, renormalised
    prefix, prefix_logs = [torch.ones_like(totals[:, 0])], [total_logs.new_zeros(total_logs[:, 0].shape)]
    for j in range(1, n_chunks):
        v, lg = _renormalised(prefix[-1] * totals[:, j - 1])
        prefix.append(v)
        prefix_logs.append(prefix_logs[-1] + total_logs[:, j - 1] + lg)
    suffix, suffix_logs = [torch.ones_like(totals[:, 0])], [prefix_logs[0]]
    for j in range(n_chunks - 2, -1, -1):
        v, lg = _renormalised(suffix[-1] * totals[:, j + 1])
        suffix.append(v)
        suffix_logs.append(suffix_logs[-1] + total_logs[:, j + 1] + lg)
    others, others_logs = _renormalised(
        torch.stack(prefix, 1) * torch.stack(suffix[::-1], 1) * outside[:, None])
    others_logs = others_logs + torch.stack(prefix_logs, 1) + torch.stack(suffix_logs[::-1], 1)
    vals = others[:, :, None] * within
    logs = others_logs[:, :, None] + within_logs
    return vals.reshape(msg.shape), logs.reshape(msg.shape[:3])


def branch_flux_vectors(
    p_matrices: torch.Tensor,     # [n_nodes(+1), S, S]; row above each node
    leaf_partials: torch.Tensor,  # [n_leaves, patterns, S]
    root_freqs: torch.Tensor,     # [S]
    data: PruningData,
):
    """Inside CLVs and parent-side outside vectors for EVERY branch, with
    fp64 log-scales, so that one branch's model can be swapped without
    re-pruning (counterpart of the JAX package's ``branch_flux_vectors``):

        siteL(P_b -> M) = sum_ij up[b,p,i] M[i,j] clv[b,p,j]
                          * exp(log_clv[b,p] + log_up[b,p])

    This is the engine behind BUSTED's per-branch mixture-class profiles
    (``BUSTED.bf:1060-1092``).  Returns ``(clv [n_nodes, patterns, S],
    log_clv [n_nodes, patterns], up [n_nodes, patterns, S], log_up
    [n_nodes, patterns])`` by node id, in the leaf partials' dtype (the
    logs in fp64); row b describes the branch ABOVE node b (the root's
    ``up`` row is 0).

    Both passes run on the level plans.  Inside: each child's message
    ``clv[c] @ P[c]^T``, their product per node, renormalised by its max
    over states; outside: a node's vector pushed through its branch
    (``up[n] @ P[n]``; the root's is pi) times the messages of a child's
    siblings, renormalised.  Nodes of more than four children renormalise
    every four (see the module docstring and :func:`_exclusive_products`);
    nodes of at most four keep the reference's products and sums in its
    order.  A product whose max is 0 is divided by 1 where the reference
    divides by 1e-300 (which fp32 cannot hold); it stays 0 either way.
    Not differentiable (it writes its buffers in place): BUSTED profiles
    the branches after its fits.
    """
    n_nodes, n_leaves = data.n_nodes, data.n_leaves
    patterns, states = leaf_partials.shape[1], leaf_partials.shape[2]
    dtype, device = leaf_partials.dtype, leaf_partials.device
    p_own = p_matrices[:n_nodes].to(dtype)
    eye = torch.eye(states, dtype=dtype, device=device)
    p_all = torch.cat([p_own, eye.expand(n_nodes + 1 - p_own.shape[0], states, states)])
    f64 = dict(dtype=torch.float64, device=device)

    # by storage slot: the leaves, each level's nodes, the all-ones scratch
    # row at n_nodes that padded children gather (its message is all ones)
    clv = torch.ones((n_nodes + 1, patterns, states), dtype=dtype, device=device)
    clv[:n_leaves] = leaf_partials
    log_clv = torch.zeros((n_nodes + 1, patterns), **f64)
    messages = []
    for (offset, _, _), plan in zip(data.ulevels, data.plans):
        w, k = plan.child_storage.shape
        slots = plan.child_storage.reshape(-1)
        msg = torch.bmm(clv[slots], p_all[plan.child_branch.reshape(-1)].transpose(1, 2))
        msg = msg.reshape(w, k, patterns, states)
        messages.append(msg)
        scale = _sequential_sum(log_clv[slots].reshape(w, k, patterns), 1)
        if k <= _CHUNK:
            prod = _sibling_product(msg, 1)
        else:
            chunks = _sibling_product(msg.reshape(w, k // _CHUNK, _CHUNK, patterns, states), 2)
            prod, logs = _chunked_product(chunks, 1)
            scale = scale + logs.to(torch.float64)
        clv[offset: offset + w], lg = _renormalised(prod)
        log_clv[offset: offset + w] = scale + lg

    slot_node = np.empty(n_nodes + 1, dtype=np.int64)
    slot_node[data.node_slots] = np.arange(n_nodes)
    slot_node[n_nodes] = n_nodes
    root_slot = int(data.node_slots[n_nodes - 1])
    up = torch.zeros((n_nodes + 1, patterns, states), dtype=dtype, device=device)
    log_up = torch.zeros((n_nodes + 1, patterns), **f64)
    up[root_slot] = root_freqs.to(dtype)
    for (offset, _, _), plan, msg in zip(reversed(data.ulevels), reversed(data.plans),
                                         reversed(messages)):
        w, k = plan.child_storage.shape
        nodes = torch.as_tensor(slot_node[offset: offset + w], device=device)
        outside = torch.bmm(up[offset: offset + w], p_all[nodes])    # up[n] @ P[n]
        if offset <= root_slot < offset + w:
            outside[root_slot - offset] = up[root_slot]               # the root's is pi
        slots = plan.child_storage.reshape(-1)
        child_logs = log_clv[slots].reshape(w, k, patterns)
        vals, logs = _exclusive_products(outside, msg)
        if k <= _CHUNK:
            scale = []
            for c in range(k):
                sc = log_up[offset: offset + w]
                for sib in range(k):
                    if sib != c:
                        sc = sc + child_logs[:, sib]
                scale.append(sc)
            scale = torch.stack(scale, 1)
        else:
            total = log_up[offset: offset + w] + child_logs.sum(dim=1)
            scale = total[:, None] - child_logs
        vals, lg = _renormalised(vals)
        real = slots != n_nodes
        up[slots[real]] = vals.reshape(w * k, patterns, states)[real]
        log_up[slots[real]] = (scale + logs + lg).reshape(w * k, patterns)[real]
    up[root_slot] = 0.0
    log_up[root_slot] = 0.0
    node_slots = torch.as_tensor(data.node_slots, device=device)
    return clv[node_slots], log_clv[node_slots], up[node_slots], log_up[node_slots]


def marginal_posteriors(
    p_matrices: torch.Tensor,     # [n_nodes(+1), S, S]; row above each node
    leaf_partials: torch.Tensor,  # [n_leaves, patterns, S]
    root_freqs: torch.Tensor,     # [S]
    data: PruningData,
) -> torch.Tensor:
    """Posterior state probabilities ``P(state_n = s | data)`` of every
    internal node, ``[n_internal, patterns, S]`` in node-id order, as the
    product of the node's inside vector (its CLV) and its outside vector
    (reference: ``RecoverAncestralSequencesMarginal``,
    ``likefunc2.cpp:932``; the JAX package's ``marginal_posteriors``, which
    also takes the tree's children and parents: here the level plans carry
    them).

    Both vectors come from :func:`branch_flux_vectors`: the child-side
    outside vector of node n is its parent-side vector pushed through its
    branch, ``up[n] @ P[n]`` (the root's is pi), and the log-scales of both
    are uniform over states, so they cancel in the normalisation.  The JAX
    package multiplies all of a node's children (inside) and all of a
    child's siblings (outside) before it renormalises, so at a wide
    polytomy its products underflow and the posteriors fall to 0; here
    nodes of more than four children renormalise every four, and nodes of at
    most four keep its products in its order."""
    n_nodes, n_leaves = data.n_nodes, data.n_leaves
    dtype = leaf_partials.dtype
    clv, _, up, _ = branch_flux_vectors(p_matrices, leaf_partials, root_freqs, data)
    internal = slice(n_leaves, n_nodes - 1)                      # the root is the last node
    outside = torch.empty_like(clv[n_leaves:])
    outside[:-1] = torch.bmm(up[internal], p_matrices[internal].to(dtype))
    outside[-1] = root_freqs.to(dtype)
    del up
    joint = clv[n_leaves:] * outside
    del clv, outside
    z = torch.clamp_min(torch.sum(joint, dim=-1, keepdim=True), torch.finfo(dtype).tiny)
    return joint / z
