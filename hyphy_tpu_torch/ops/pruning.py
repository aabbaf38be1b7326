"""Felsenstein pruning, one tree level at a time.

Counterpart of the gene path of ``hyphy_tpu/ops/pruning.py``: the exact-
width unrolled variant (``_site_log_likelihoods_unrolled``), with every
level's sibling product going through the K1 kernel
(:func:`hyphy_tpu_torch.ops.level_products.level_products`), also in a
grid form that prunes many propagator sets over the same leaves at once
(FUBAR's and B-STILL's grids); and the
per-site routes FEL and MEME fit sites with, batched over sites, on the
same schedule: ``single_site_log_likelihood_taylor`` (with its
``mix_weights`` mode), ``single_site_log_likelihood_spectral``,
``single_site_log_likelihood_spectral_mixture`` and
``single_site_log_likelihood_dense`` (materialised propagators).  The
padded ``lax.scan`` variant (``schedule_pad``) is not ported: it pads GARD's
candidates to shared shapes for XLA, and the port compiles nothing;
``mixture_site_log_likelihoods``
(one pruning per rate class) is the grid form over the classes, as
``models/bsrel.py`` and ``likelihood.py``'s class mixture call it.

Numerics kept from the reference, which make fp32 usable on deep trees:
the identity propagator at the scratch index, max-renormalisation per
(node, pattern) with ``mx > 0 ? mx : 1``, the fp64 log-scale accumulator,
and the ``finfo.tiny`` clamp at the root.

Wide nodes.  The reference multiplies all of a node's child messages before
it renormalises, so a node with hundreds of children underflows — in fp64
as in fp32 — and every site's lnL collapses to ``log(tiny)``.  Collapsing
zero-length branches makes such nodes of a tree whose internal branches fit
to zero (a star phylogeny: FEL's uncapped fits on the 1000-taxon bench
workload leave a root of ~1000 children).  Here a node of more than
``_CHUNK`` children multiplies them ``_CHUNK`` at a time, as the reference
does, and combines the chunk products pairwise, renormalising after every
step (:func:`_chunked_product`), as HyPhy scales its partial products.
Nodes of at most ``_CHUNK`` children — every node of a binary tree — keep
the reference's arithmetic exactly.

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

from hyphy_tpu_torch.ops.level_products import _MAX_NODES, level_products
from hyphy_tpu_torch.parallel.mesh import shards as mesh_shards
from hyphy_tpu_torch.parallel.mesh import to_device
from hyphy_tpu_torch.tree.topology import Tree

# source id of the all-ones scratch row gathered by padded child slots
_SCRATCH = -1
# children multiplied before a renormalisation; wider nodes are padded to a
# multiple of it
_CHUNK = 4
# child rows a per-site route multiplies at once, at least: a narrower level
# is padded with the scratch row (identity messages, dropped), because for
# so few rows the card's cuBLAS picks its fp32 kernel by the number of sites
# (on the H100 a 2-child level's rows change in their last bits between 128
# and 4719 sites), and a site's lnL must not depend on the sites that share
# its batch: the chunks of a solve, the fused Nelder-Mead probes
_MIN_ROWS = 20


class LevelPlan(NamedTuple):
    """How one level gathers its children: ``pieces`` is a list of
    ``(source, rows)`` — ``source`` 0 for the leaves, ``l + 1`` for the
    output of level ``l``, ``_SCRATCH`` for the all-ones row — and ``perm``
    (or None when the concatenated pieces are already in order) reorders
    the joined rows into flat ``[W * K]`` child order."""

    pieces: List[Tuple[int, torch.Tensor]]
    perm: "torch.Tensor | None"
    child_branch: torch.Tensor   # [W, K] int64 propagator row per child
    child_storage: torch.Tensor  # [W, K] int64 storage slot per child
    # the per-site routes' flat child rows: storage slots and branches,
    # padded with the scratch row to at least _MIN_ROWS
    site_slots: torch.Tensor
    site_branches: torch.Tensor


class PruningData(NamedTuple):
    """Static (per-topology) arrays driving the pruning loop."""

    n_nodes: int
    n_leaves: int
    # exact-width schedule as in the JAX package: per level
    # (storage_offset, child_storage [W,K], child_branch [W,K]), with
    # internal-node CLVs stored level-contiguously after the leaves; a level
    # whose padding would more than double its child slots is split into
    # arity classes (see :func:`_arity_groups`)
    ulevels: tuple
    plans: Tuple[LevelPlan, ...]   # the same schedule as per-level gathers
    node_slots: np.ndarray         # [n_nodes] storage slot of each node id


def _arity_groups(tree: Tree, lv: np.ndarray) -> List[np.ndarray]:
    """One level's nodes as K1 launches.  The JAX package pads every node to
    the tree's largest arity; here a level is padded to its own largest
    arity, and when that would more than double its child slots — a
    polytomy of hundreds of leaves beside cherries, as collapsing zero-length
    branches makes of a tree whose internal branches fit to zero — the
    level is split into classes of arity ``ceil(log2 K)``, each padded
    within a factor of two.  Padding slots multiply by exact ones, so the
    split changes no value; it bounds the ``[W, K, patterns, S]`` gather."""
    ks = np.array([len(tree.children[nd]) for nd in lv])
    if len(lv) * ks.max() <= 2 * ks.sum():
        return [lv]
    cls = np.ceil(np.log2(ks)).astype(np.int64)
    return [lv[cls == c] for c in np.unique(cls)]


def build_pruning_data(tree: Tree, device) -> PruningData:
    n_nodes, n_leaves = tree.n_nodes, tree.n_leaves
    storage = np.full(n_nodes + 1, n_nodes, dtype=np.int64)
    storage[:n_leaves] = np.arange(n_leaves)
    # storage slot -> (source, row): leaves are source 0, launch l is l + 1
    source_of = np.full(n_nodes + 1, _SCRATCH, dtype=np.int64)
    row_of = np.zeros(n_nodes + 1, dtype=np.int64)
    source_of[:n_leaves] = 0
    row_of[:n_leaves] = np.arange(n_leaves)
    next_slot = n_leaves
    levels, plans = [], []
    for group in (g for lv in tree.levels() for g in _arity_groups(tree, lv)):
        w = len(group)
        arity = max(len(tree.children[nd]) for nd in group)
        if arity > _CHUNK:
            arity = -(-arity // _CHUNK) * _CHUNK
        storage[group] = next_slot + np.arange(w)
        child_storage = np.full((w, arity), n_nodes, dtype=np.int32)
        child_branch = np.full((w, arity), n_nodes, dtype=np.int32)
        for slot, nd in enumerate(group):
            for k, c in enumerate(tree.children[nd]):
                child_storage[slot, k] = storage[c]
                child_branch[slot, k] = c
        levels.append((next_slot, child_storage, child_branch))
        plans.append(_level_plan(child_storage, child_branch, source_of, row_of, n_nodes, device))
        source_of[next_slot : next_slot + w] = len(levels)
        row_of[next_slot : next_slot + w] = np.arange(w)
        next_slot += w
    return PruningData(n_nodes, n_leaves, tuple(levels), tuple(plans), storage[:n_nodes])


def _level_plan(child_storage, child_branch, source_of, row_of, n_nodes, device) -> LevelPlan:
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
    slots = torch.as_tensor(child_storage.astype(np.int64), device=device)
    pad = np.full(max(_MIN_ROWS - len(flat), 0), n_nodes, dtype=np.int64)
    site_slots = torch.as_tensor(np.concatenate([flat, pad]).astype(np.int64), device=device)
    site_branches = torch.as_tensor(
        np.concatenate([child_branch.reshape(-1), pad]).astype(np.int64), device=device)
    return LevelPlan(pieces, perm, branch, slots, site_slots, site_branches)


def _launch_rows(plan: LevelPlan) -> int:
    """K1's node rows for one grid point at this level: the nodes, or for
    nodes wider than ``_CHUNK`` children their chunks."""
    w, k = plan.child_branch.shape
    return w if k <= _CHUNK else w * k // _CHUNK


def max_grid_points(data: PruningData) -> int:
    """The most grid points one call of the grid form of
    :func:`site_log_likelihoods` may fold, so that every level's K1 launch
    stays within ``_MAX_NODES`` rows (``W = G x width``)."""
    return max(1, _MAX_NODES // max(_launch_rows(plan) for plan in data.plans))


def _level_rows(plan: LevelPlan) -> int:
    """Rows of ``[patterns, S]`` that one level of the pruning makes: the
    children gathered from earlier levels, their join (or the copy of the
    shared leaves) and its reordering, K1's product and its renormalised
    copy, and a wide node's chunk products and their pairwise
    combination."""
    w, k = plan.child_branch.shape
    rows = sum(len(r) for src, r in plan.pieces if src > 0)
    shared = len(plan.pieces) == 1 and plan.pieces[0][0] <= 0
    rows += w * k * (int(len(plan.pieces) > 1 or (shared and plan.perm is None))
                     + int(plan.perm is not None))
    chunked = 3 * w * k // _CHUNK if k > _CHUNK else 0
    return rows + 2 * w + chunked


def grid_point_bytes(data: PruningData, patterns: int, states: int, itemsize: int) -> float:
    """One grid point's peak working set in the grid form of
    :func:`site_log_likelihoods`, in bytes: every level's output is kept
    until the root, beside the rows the level makes
    (:func:`_level_rows`)."""
    kept, peak = 0, 0
    for plan in data.plans:
        peak = max(peak, kept + _level_rows(plan))
        kept += plan.child_branch.shape[0]
    return float(peak * patterns * states * itemsize)


def gene_bytes(data: PruningData, patterns: int, states: int, itemsize: int) -> float:
    """The working set of one value and gradient of
    :func:`site_log_likelihoods` (one propagator set), in bytes: autograd
    keeps every level's rows (:func:`_level_rows`) until the backward.  A
    device mesh is engaged on its own only where this passes half a card's
    free memory (``config.Settings.default_mesh``)."""
    return float(sum(_level_rows(plan) for plan in data.plans)
                 * patterns * states * itemsize)


def site_log_likelihoods(
    p_matrices: torch.Tensor,     # [n_nodes(+1), S, S], or [G, n_nodes(+1), S, S]
    leaf_partials: torch.Tensor,  # [n_leaves, patterns, S]
    root_freqs: torch.Tensor,     # [S]
    data: PruningData,
    floor: "bool | None" = None,
) -> torch.Tensor:
    """Per-pattern log-likelihood ``log sum_s pi_s CLV_root[p, s]`` (fp64).

    ``p_matrices`` may have ``n_nodes`` rows (root row unused) or
    ``n_nodes + 1``; the row at the scratch index is the identity, so padded
    child slots are no-ops.

    Grid form: ``p_matrices`` ``[G, n_nodes(+1), S, S]``, one propagator
    set per grid point over the same leaves, gives ``[G, patterns]`` (the
    JAX package ``vmap``s the one-set form, ``fubar.py:122-129``).  Each
    level folds the grid into K1's node axis, ``W = G x width``, so a
    level costs one launch for the whole grid.  Its log-scale sums over a
    level's nodes and its root sum over states go by pairwise halving
    (:func:`_halving_sum`), so that a grid point's values do not depend on
    how many points share the call.  The one-set form keeps its
    reductions.

    The clamp at ``finfo.tiny``.  The grid form does not clamp the root
    likelihood: a pattern that a grid point cannot produce (at alpha or
    beta 0 some codons are unreachable, and the Taylor propagators keep
    those entries exactly 0) gets -inf, HyPhy's conditional likelihood of
    0.  The clamp's floor, log(tiny) = -87 in fp32, lies above every real
    site lnL of a large tree (1000 taxa: hundreds of lnL units below it),
    so such a point would win FUBAR's scaling pass (ROADMAP 3.11).  The
    one-set form keeps the clamp, because the GTR and MG94 fits that
    differentiate it are held to the JAX package's fits, which clamp: where
    a line search probes a rate near 0, patterns of likelihood 0 score the
    floor with a zero gradient there, and an unclamped -inf would end the
    step as non-finite instead, so the two packages' fits would part.
    ``floor`` overrides the default (the one-set form's clamp, the grid
    form's none): the BS-REL mixture fits (``models/bsrel.py``) fold their
    synonymous-rate classes into the grid form and differentiate it, and
    keep the clamp of the JAX package's per-class prunings, which would
    otherwise give a class of likelihood 0 a NaN gradient through its log.
    """
    grid = p_matrices.dim() == 4
    p_grid = p_matrices if grid else p_matrices[None]
    n_nodes = data.n_nodes
    n_grid = p_grid.shape[0]
    patterns, states = leaf_partials.shape[1], leaf_partials.shape[2]
    dtype, device = leaf_partials.dtype, leaf_partials.device

    def node_sum(x):                                       # [G, W, patterns] -> [G, patterns]
        return _halving_sum(x, 1) if grid else torch.sum(x, dim=1)

    p_own = p_grid[:, :n_nodes].to(dtype)
    eye = torch.eye(states, dtype=dtype, device=device)
    pad = eye.expand(n_grid, n_nodes + 1 - p_own.shape[1], states, states)
    p_all = torch.cat([p_own, pad], dim=1)                 # [G, n_nodes + 1, S, S]
    scratch = torch.ones((1, patterns, states), dtype=dtype, device=device)

    def gather(source, rows):                              # -> [G, n, patterns, S]
        if source == _SCRATCH:
            return scratch.index_select(0, rows).expand(n_grid, -1, -1, -1)
        if source == 0:
            return leaf_partials.index_select(0, rows).expand(n_grid, -1, -1, -1)
        return outputs[source].index_select(1, rows)

    outputs = [leaf_partials]
    # the running log-scale sums ~O(tree depth) terms to a large magnitude;
    # accumulate in fp64 (per-level log/sum stay in the compute dtype) so an
    # fp32 CLV path does not quantize site lnL at the accumulator
    log_scale = torch.zeros((n_grid, patterns), dtype=torch.float64, device=device)
    for plan in data.plans:
        w, k = plan.child_branch.shape
        gathered = [gather(s, rows) for s, rows in plan.pieces]
        cc = gathered[0] if len(gathered) == 1 else torch.cat(gathered, dim=1)
        if plan.perm is not None:
            cc = cc.index_select(1, plan.perm)
        # the leaves are shared by every grid point (a stride-0 expand), and
        # a level of one node whose children are all leaves reshapes to a
        # view of that expand: K1 takes contiguous inputs
        cc = cc.reshape(n_grid * w, k, patterns, states).contiguous()
        cp = p_all[:, plan.child_branch].reshape(n_grid * w, k, states, states)
        if k <= _CHUNK:
            prod = level_products(cc, cp).reshape(n_grid, w, patterns, states)
        else:
            # one launch for every chunk of every node, then the chunks combined
            chunks = level_products(cc.reshape(n_grid * w * k // _CHUNK, _CHUNK, patterns, states),
                                    cp.reshape(n_grid * w * k // _CHUNK, _CHUNK, states, states))
            prod, logs = _chunked_product(
                chunks.reshape(n_grid, w, k // _CHUNK, patterns, states), 2)
            log_scale = log_scale + node_sum(logs).to(torch.float64)
        mx = torch.amax(prod, dim=-1, keepdim=True)
        mx = torch.where(mx > 0, mx, torch.ones((), dtype=dtype, device=device))
        outputs.append(prod / mx)
        log_scale = log_scale + node_sum(torch.log(mx[..., 0])).to(torch.float64)
        del gathered, cc, cp, prod, mx     # a level's temporaries die with it

    # the root is the last node of the last level
    root = outputs[-1][:, -1]                              # [G, patterns, S]
    if grid:
        root_like = _halving_sum(root * root_freqs.to(dtype))
    else:
        root_like = root @ root_freqs.to(dtype)            # [G, patterns]
    if (not grid) if floor is None else floor:
        # a fill on the device (torch.tensor of a host scalar is a copy that
        # makes the host wait for the card)
        tiny = torch.full((), torch.finfo(dtype).tiny, dtype=dtype, device=device)
        root_like = torch.maximum(root_like, tiny)
    out = torch.log(root_like.to(torch.float64)) + log_scale
    return out if grid else out[0]


class PatternShards(NamedTuple):
    """A tree's leaf CLVs split on the pattern axis over a device mesh
    (``parallel/mesh.py``): per block, in pattern order, its leaves
    ``[n_leaves, block, S]`` on its device and the tree's
    :class:`PruningData` on that device (the level plans are device
    tensors)."""

    leaves: Tuple[torch.Tensor, ...]
    datas: Tuple[PruningData, ...]


def data_to(data: PruningData, device) -> PruningData:
    """``data`` with its level plans' tensors on ``device``."""
    def move(x):
        return None if x is None else x.to(device)

    plans = tuple(
        LevelPlan([(src, rows.to(device)) for src, rows in plan.pieces], move(plan.perm),
                  *(move(x) for x in plan[2:]))
        for plan in data.plans)
    return data._replace(plans=plans)


def shard_patterns(data: PruningData, leaf_partials, mesh, dtype) -> PatternShards:
    """``leaf_partials`` ``[n_leaves, patterns, S]`` (array or tensor)
    split into the contiguous pattern blocks of ``mesh``, in ``dtype``,
    beside ``data`` on each block's device (copied once per distinct
    device)."""
    lp = torch.as_tensor(leaf_partials)
    plans, leaves, datas = {}, [], []
    for dev, lo, hi in mesh_shards(lp.shape[1], mesh):
        if str(dev) not in plans:
            plans[str(dev)] = data_to(data, dev)
        leaves.append(lp[:, lo:hi].to(dev).to(dtype).contiguous())
        datas.append(plans[str(dev)])
    return PatternShards(tuple(leaves), tuple(datas))


def sharded_site_log_likelihoods(
    p_matrices: torch.Tensor,
    shards: PatternShards,
    root_freqs: torch.Tensor,
    floor: "bool | None" = None,
) -> torch.Tensor:
    """:func:`site_log_likelihoods` with the patterns split over a mesh,
    one-set or grid form: the propagators and root frequencies, built on
    the first device, are copied to each block's device, the block's levels
    run through K1 there, and the blocks' site vectors are joined on the
    first device in pattern order (``[patterns]`` or ``[G, patterns]``).
    Every block is issued before any result is read, so blocks on distinct
    cards overlap."""
    first = shards.leaves[0].device
    outs = []
    for leaves, data in zip(shards.leaves, shards.datas):
        dev = leaves.device
        sll = site_log_likelihoods(to_device(p_matrices, dev), leaves,
                                   to_device(root_freqs, dev), data, floor)
        outs.append(to_device(sll, first))
    return torch.cat(outs, dim=-1)


def total_log_likelihood(site_loglik: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """lnL = sum_patterns freq_p * lnL_p (reference: likefunc.cpp:11123)."""
    return torch.dot(site_loglik, weights)


def _halving_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over axis ``dim`` by pairwise halving (zero-padded to a power of
    two): elementwise adds only, so one site's sum does not depend on how
    many sites share the call.  A reduction kernel's order does on the card
    (a level's log-scale sum over 249 nodes changed in its last bits
    between 997 and 10692 sites on the H100), and a site's lnL must not
    depend on its batch: the chunks of a solve, the fused Nelder-Mead
    probes."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0]


def _sibling_product(terms: torch.Tensor, dim: int) -> torch.Tensor:
    """Product over axis ``dim`` (at most ``_CHUNK`` siblings), one
    elementwise multiply at a time, for the same reason as
    :func:`_halving_sum`."""
    prod = terms.select(dim, 0)
    for k in range(1, terms.shape[dim]):
        prod = prod * terms.select(dim, k)
    return prod


def _chunked_product(terms: torch.Tensor, dim: int):
    """Product over axis ``dim`` of ``terms`` (chunk products of a wide
    node's children, states on the last axis) without underflow: every
    term, then every pairwise product, is divided by its max over states
    (``mx > 0 ? mx : 1``).  Returns ``(product, logs)``: the true product
    is ``product * exp(logs)``, ``logs`` the sum of the log maxima, shaped
    as ``terms`` without ``dim`` (>= 0) and the state axis."""
    one = torch.ones((), dtype=terms.dtype, device=terms.device)
    logs = 0.0
    while True:
        mx = torch.amax(terms, dim=-1, keepdim=True)
        mx = torch.where(mx > 0, mx, one)
        terms = terms / mx
        logs = logs + _halving_sum(torch.log(mx[..., 0]), dim)
        m = terms.shape[dim]
        if m == 1:
            return terms.squeeze(dim), logs
        if m % 2:
            terms = torch.cat([terms, torch.ones_like(terms.narrow(dim, 0, 1))], dim=dim)
        pairs = terms.unflatten(dim, (-1, 2))
        terms = pairs.select(dim + 1, 0) * pairs.select(dim + 1, 1)


# ---------------------------------------------------------------------------
# per-site routes: one lnL per site, every site with its own generators.
# Both keep the buffer layout of the JAX package's unrolled variant (leaves,
# then each level's nodes contiguously, then an all-ones scratch row at
# ``n_nodes``), batched over a leading site axis, and keep the site lnL and
# the log-scale in the compute dtype as the reference does.  Derivative-free
# callers only (FEL's Nelder-Mead): each level writes its slice of the
# buffer in place.


def _site_buffer(leaf_vectors: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """``[N, n_nodes + 1, S]``: the leaves, then room for the internal
    nodes (every level writes its rows before a later level reads them),
    then the all-ones scratch row."""
    n_sites, n_leaves, states = leaf_vectors.shape
    buf = torch.empty((n_sites, n_nodes + 1, states), dtype=leaf_vectors.dtype,
                      device=leaf_vectors.device)
    buf[:, :n_leaves] = leaf_vectors
    buf[:, n_nodes] = 1.0
    return buf


def _per_branch(values: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """``[..., B]`` per-branch values padded with zeros to ``n_nodes + 1``
    columns: the root's row and the scratch row take 0."""
    out = values.new_zeros(values.shape[:-1] + (n_nodes + 1,))
    out[..., : values.shape[-1]] = values
    return out


def _renormalise(msg, w, karity, log_scale):
    """Sibling product of one level, max-renormalised per (site, node);
    nodes wider than ``_CHUNK`` through :func:`_chunked_product`."""
    n_sites, _, states = msg.shape
    if karity <= _CHUNK:
        prod = _sibling_product(msg.reshape(n_sites, w, karity, states), 2)
    else:
        chunks = _sibling_product(msg.reshape(n_sites, w, karity // _CHUNK, _CHUNK, states), 3)
        prod, logs = _chunked_product(chunks, 2)
        log_scale = log_scale + _halving_sum(logs)
    mx = torch.amax(prod, dim=-1, keepdim=True)
    mx = torch.where(mx > 0, mx, 1.0)
    return prod / mx, log_scale + _halving_sum(torch.log(mx[..., 0]))


def _root_log_likelihood(buf, n_nodes, root_freqs, log_scale):
    dtype = buf.dtype
    # not a matrix-vector product: the BLAS's fp32 kernel for that depends
    # on the number of sites (see :func:`_halving_sum`)
    root_like = _halving_sum(buf[:, n_nodes - 1] * root_freqs.to(dtype))
    tiny = torch.full((), torch.finfo(dtype).tiny, dtype=dtype, device=buf.device)
    return torch.log(torch.maximum(root_like, tiny)) + log_scale


class _TaylorAction:
    """One family's Taylor vector action on a level's child vectors, as
    the JAX package's ``action``: squaring-ladder steps by the bits of
    ``j``, then the Horner recurrence, one ``bmm`` (+ one ``addcmul``) per
    step on ``[N, F, S]``."""

    def __init__(self, qn, m2p, n_terms, dtype, device):
        self.qn_t = qn.transpose(-1, -2).contiguous()
        self.m2p_t = m2p.transpose(-1, -2).contiguous()
        self.n_terms, self.n_ladder = n_terms, m2p.shape[2]
        self.ks = torch.arange(n_terms, 0, -1, dtype=dtype, device=device)   # Horner order
        self.shifts = torch.arange(self.n_ladder, device=device)

    def factors(self, r_level, j_level, j_max_level):
        """Horner coefficients ``r_b / k`` ``[N, F, terms]``, the ladder bit
        masks ``[N, F, bits]`` and their count: as many bits as the level's
        largest ``j`` over the whole batch (extra steps are no-ops)."""
        bits = min(self.n_ladder, int(j_max_level.max()).bit_length())
        bit = None
        if bits:
            bit = ((j_level[..., None] >> self.shifts[:bits]) & 1).to(torch.bool)
        return r_level[..., None] / self.ks, bit, bits

    def __call__(self, v, coef, bit, bits, g):
        for k in range(bits):
            v = torch.where(bit[..., k : k + 1], torch.bmm(v, self.m2p_t[:, g, k]), v)
        acc = v
        for i in range(self.n_terms):
            acc = torch.addcmul(v, coef[..., i : i + 1], torch.bmm(acc, self.qn_t[:, g]))
        return acc


def dense_mixture_weights(weights: torch.Tensor, families: torch.Tensor,
                          n_families: int) -> torch.Tensor:
    """``[N, B, M]`` dense family weights from per-item components: branch
    ``b`` of item ``n`` puts ``weights[n, b, c]`` on family ``families[n, b,
    c]`` (the JAX package's ``(comp_index, cw)`` pairs, here one map per
    item: contrast-MEME's permutations give every item its own
    branch-to-set map)."""
    dense = weights.new_zeros(weights.shape[:2] + (n_families,))
    return dense.scatter_add(2, families.to(torch.int64), weights)


def _taylor_mixture(qn, m2p, r, j, n_terms, leaf_vectors, root_freqs, data, mix_weights):
    """The ``mix_weights`` mode of :func:`single_site_log_likelihood_taylor`."""
    n_nodes = data.n_nodes
    n_sites = leaf_vectors.shape[0]
    dtype, device = leaf_vectors.dtype, leaf_vectors.device
    n_fam = m2p.shape[1]
    n_b = mix_weights.shape[1]
    # [N, G, n_nodes + 1]; the root's and the scratch rows mix to the
    # identity: full weight on family 0 with r = 0, j = 0
    r_all = _per_branch(r.to(dtype).transpose(1, 2), n_nodes)
    j_all = _per_branch(j.to(torch.int64).transpose(1, 2), n_nodes)
    w_all = _per_branch(mix_weights.to(dtype).transpose(1, 2), n_nodes)
    w_all[:, 0, n_b:] = 1.0
    j_max = j_all.amax(dim=0).cpu().numpy()                            # [G, n_nodes + 1]
    action = _TaylorAction(qn, m2p, n_terms, dtype, device)
    buf = _site_buffer(leaf_vectors, n_nodes)
    log_scale = torch.zeros((n_sites,), dtype=dtype, device=device)
    for (offset, _, child_branch), plan in zip(data.ulevels, data.plans):
        w, karity = plan.child_storage.shape
        flat_b = plan.site_branches
        v = buf[:, plan.site_slots]                                    # [N, F', S]
        msg = None
        for g in range(n_fam):
            coef, bit, bits = action.factors(r_all[:, g, flat_b], j_all[:, g, flat_b],
                                             j_max[g, child_branch.reshape(-1)])
            term = w_all[:, g, flat_b, None] * action(v, coef, bit, bits, g)
            msg = term if msg is None else msg + term
        msg = torch.clamp_min(msg[:, : w * karity], 0.0)
        prod, log_scale = _renormalise(msg, w, karity, log_scale)
        buf[:, offset : offset + w] = prod
    return _root_log_likelihood(buf, n_nodes, root_freqs, log_scale)


def single_site_log_likelihood_taylor(
    qn: torch.Tensor,              # [N, G, S, S] normalized generators per site, group
    m2p: torch.Tensor,             # [N, G, L, S, S] squaring-ladder matrices
    r: torch.Tensor,               # [N, n_branches] fractional Taylor times
    j: torch.Tensor,               # [N, n_branches] int ladder exponents
    group_of_branch: torch.Tensor, # [n_branches] int in [0, G)
    n_terms: int,
    leaf_vectors: torch.Tensor,    # [N, n_leaves, S] the sites' leaf partials
    root_freqs: torch.Tensor,
    data: PruningData,
    mix_weights: "torch.Tensor | None" = None,  # [N, n_branches, G]
) -> torch.Tensor:
    """Per-site lnL ``[N]`` with each branch's propagator applied as a
    VECTOR action from :func:`ops.expm.taylor_action_factors` (the JAX
    package's select mode): ladder steps ``v <- m2p[g,k] v`` by the bits of
    ``j_b``, then the Horner recurrence ``acc <- v + (r_b/k) qn_g acc``.
    Each branch group's action runs on every child of a level and the result
    is selected per branch, as in the reference.

    Mixture mode (``mix_weights``, MEME's branch-site mixture): branch
    ``b`` of site ``n`` has ``P = sum_g w[n,b,g] expm(t_b Q_{n,g})``; then
    ``r`` and ``j`` are ``[N, n_branches, G]``, one per (branch, family),
    each family walks its own ladder bits, and the message is the weighted
    sum of every family's action (``group_of_branch`` is unused).  Padded
    children act with family 0 at r = 0, j = 0: the identity.  The table
    is per item, so each item may map branches to families its own way
    (:func:`dense_mixture_weights`).

    The ladder walks as many bits as the largest ``j`` of the level's
    branches over the whole batch sets, the trip count of the reference's
    ``while_loop`` under ``vmap``: the extra steps are no-ops for the sites
    whose bits are 0.  The per-branch maxima reach the host once per call.

    Launches per level are kept few, since at a few hundred sites the host
    issues them slower than the card runs them: the ladder's bit masks and
    the Horner coefficients ``r_b / k`` are made once per level, and each
    Horner step is one ``bmm`` and one ``addcmul``.
    """
    n_nodes = data.n_nodes
    n_sites, _, states = leaf_vectors.shape
    dtype, device = leaf_vectors.dtype, leaf_vectors.device
    n_groups, n_ladder = m2p.shape[1], m2p.shape[2]
    if n_sites == 1:
        # a batch of one takes another bmm kernel on the card, which rounds
        # apart from the batched one, and a site's lnL must not depend on
        # its batch (a one-item block or chunk of a solve): the item runs
        # twice and the first copy is kept
        def two(x):
            return None if x is None else torch.cat([x, x])

        return single_site_log_likelihood_taylor(
            two(qn), two(m2p), two(r), two(j), group_of_branch, n_terms, two(leaf_vectors),
            root_freqs, data, two(mix_weights))[:1]
    if mix_weights is not None:
        return _taylor_mixture(qn, m2p, r, j, n_terms, leaf_vectors, root_freqs, data,
                               mix_weights)
    r_all = _per_branch(r.to(dtype), n_nodes)                          # [N, n_nodes + 1]
    j_all = _per_branch(j.to(torch.int64), n_nodes)
    g_all = _per_branch(group_of_branch.to(torch.int64), n_nodes)     # [n_nodes + 1]
    j_max = j_all.amax(dim=0).cpu().numpy()
    action = _TaylorAction(qn, m2p, n_terms, dtype, device)
    buf = _site_buffer(leaf_vectors, n_nodes)
    log_scale = torch.zeros((n_sites,), dtype=buf.dtype, device=buf.device)
    for (offset, _, child_branch), plan in zip(data.ulevels, data.plans):
        w, karity = plan.child_storage.shape
        flat_b = plan.site_branches
        v = buf[:, plan.site_slots]                                    # [N, F', S]
        coef, bit, bits = action.factors(r_all[:, flat_b], j_all[:, flat_b],
                                         j_max[child_branch.reshape(-1)])
        msg = action(v, coef, bit, bits, 0)
        for g in range(1, n_groups):
            msg = torch.where((g_all[flat_b] == g)[:, None], action(v, coef, bit, bits, g), msg)
        msg = torch.clamp_min(msg[:, : w * karity], 0.0)
        prod, log_scale = _renormalise(msg, w, karity, log_scale)
        buf[:, offset : offset + w] = prod
    return _root_log_likelihood(buf, n_nodes, root_freqs, log_scale)


def single_site_log_likelihood_dense(
    p_matrices: torch.Tensor,      # [n_branches(+1), S, S] or [N, n_branches(+1), S, S]
    leaf_vectors: torch.Tensor,    # [N, n_leaves, S] the sites' leaf partials
    root_freqs: torch.Tensor,
    data: PruningData,
) -> torch.Tensor:
    """Per-site lnL ``[N]`` from materialised per-branch transition
    matrices, shared by every site or one set per site: each level gathers
    its children's vectors and applies their branches' P as batched
    matrix-vector products (the JAX package's one-site
    ``single_site_log_likelihood_dense``, ``ops/pruning.py:334``, batched
    over sites like the other per-site routes).  Padded children gather the
    all-ones row through the identity at the scratch index."""
    n_nodes = data.n_nodes
    n_sites, _, states = leaf_vectors.shape
    dtype, device = leaf_vectors.dtype, leaf_vectors.device
    per_site = p_matrices.dim() == 4
    p_sites = p_matrices if per_site else p_matrices[None]
    p_own = p_sites[:, :n_nodes].to(dtype)
    eye = torch.eye(states, dtype=dtype, device=device)
    pad = eye.expand(p_own.shape[0], n_nodes + 1 - p_own.shape[1], states, states)
    p_all = torch.cat([p_own, pad], dim=1)                             # [N or 1, n_nodes + 1, S, S]
    buf = _site_buffer(leaf_vectors, n_nodes)
    log_scale = torch.zeros((n_sites,), dtype=dtype, device=device)
    for (offset, _, _), plan in zip(data.ulevels, data.plans):
        w, karity = plan.child_storage.shape
        cc = buf[:, plan.site_slots]                                   # [N, F', S]
        cp = p_all[:, plan.site_branches]                              # [N or 1, F', S, S]
        if per_site:
            msg = torch.einsum("nfij,nfj->nfi", cp, cc)
        else:                       # one P per child for every site: [F', S, S] x [F', S, N]
            msg = torch.einsum("fij,nfj->nfi", cp[0], cc)
        prod, log_scale = _renormalise(msg[:, : w * karity], w, karity, log_scale)
        buf[:, offset : offset + w] = prod
    return _root_log_likelihood(buf, n_nodes, root_freqs, log_scale)


def single_site_log_likelihood_spectral(
    left: torch.Tensor,            # [N, G, S, S] spectral factors per site, group
    lam: torch.Tensor,             # [N, G, S]
    right: torch.Tensor,           # [N, G, S, S]
    times: torch.Tensor,           # [n_branches] per-branch expm times
    group_of_branch: torch.Tensor, # [n_branches] int in [0, G)
    leaf_vectors: torch.Tensor,    # [N, n_leaves, S]
    root_freqs: torch.Tensor,
    data: PruningData,
) -> torch.Tensor:
    """Per-site lnL ``[N]`` when branch ``b`` of site ``n`` has the
    propagator ``left[n,g] diag(e^{lam[n,g] t_b}) right[n,g]`` with ``g`` its
    group: the spectral factors act on CLV vectors (3 x S^2 flops per
    branch) instead of materializing P_b.

    The reference takes either one factor set (G = 1) or per-branch copies
    ``left[group_of_branch]``; batched over sites the copies would be
    ``[N, branches, S, S]`` (122 GB at 1000 taxa x 2048 sites in fp64), so
    here each group's action runs on every child and the result is selected
    per branch — the same arithmetic per node.  Padded children gather the
    all-ones row at time 0.
    """
    n_nodes = data.n_nodes
    n_sites = leaf_vectors.shape[0]
    n_groups = left.shape[1]
    t_all = _per_branch(times.to(leaf_vectors.dtype), n_nodes)           # [n_nodes + 1]
    g_all = _per_branch(group_of_branch.to(torch.int64), n_nodes)
    left_t, right_t = left.transpose(-1, -2), right.transpose(-1, -2)

    def action(cc, tb, g):
        el = torch.exp(lam[:, g, None, :] * tb[None, :, None])         # [N, F, S]
        return torch.bmm(torch.bmm(cc, right_t[:, g]) * el, left_t[:, g])

    buf = _site_buffer(leaf_vectors, n_nodes)
    log_scale = torch.zeros((n_sites,), dtype=buf.dtype, device=buf.device)
    for (offset, _, _), plan in zip(data.ulevels, data.plans):
        w, karity = plan.child_storage.shape
        flat_b = plan.site_branches
        cc = buf[:, plan.site_slots]                                   # [N, F', S]
        tb = t_all[flat_b]
        msg = action(cc, tb, 0)
        for g in range(1, n_groups):
            msg = torch.where((g_all[flat_b] == g)[:, None], action(cc, tb, g), msg)
        prod, log_scale = _renormalise(msg[:, : w * karity], w, karity, log_scale)
        buf[:, offset : offset + w] = prod
    return _root_log_likelihood(buf, n_nodes, root_freqs, log_scale)


def single_site_log_likelihood_spectral_mixture(
    left: torch.Tensor,            # [N, M, S, S] spectral factors per site, family
    lam: torch.Tensor,             # [N, M, S]
    right: torch.Tensor,           # [N, M, S, S]
    weights: torch.Tensor,         # [N, n_branches, M] mixture weight per family
    times: torch.Tensor,           # [n_branches] per-branch expm times
    leaf_vectors: torch.Tensor,    # [N, n_leaves, S]
    root_freqs: torch.Tensor,
    data: PruningData,
) -> torch.Tensor:
    """Per-site lnL ``[N]`` when each branch's propagator is a mixture of
    exponentials over M generator families, ``P_{n,b} = sum_m w[n,b,m]
    expm(t_b Q_{n,m})`` (MEME's branch-site mixture, reference
    tree.cpp:2999-3008), with the spectral factors acting on CLV vectors.

    The JAX package takes (family index, weight) pairs per branch component
    and makes them the dense ``[branches, M]`` table it works with; here the
    caller passes that table per site (one branch-to-family map per item:
    :func:`dense_mixture_weights`).  Every
    family's message is computed for every child and summed with the
    weights; padded children take family 0 at time 0, the identity.
    """
    n_nodes = data.n_nodes
    n_sites = leaf_vectors.shape[0]
    dtype = leaf_vectors.dtype
    n_fam, n_b = left.shape[1], weights.shape[1]
    t_all = _per_branch(times.to(dtype), n_nodes)                       # [n_nodes + 1]
    w_all = _per_branch(weights.to(dtype).transpose(1, 2), n_nodes)      # [N, M, n_nodes + 1]
    w_all[:, 0, n_b:] = 1.0
    left_t, right_t = left.transpose(-1, -2), right.transpose(-1, -2)

    buf = _site_buffer(leaf_vectors, n_nodes)
    log_scale = torch.zeros((n_sites,), dtype=buf.dtype, device=buf.device)
    for (offset, _, _), plan in zip(data.ulevels, data.plans):
        w, karity = plan.child_storage.shape
        flat_b = plan.site_branches
        cc = buf[:, plan.site_slots]                                   # [N, F', S]
        tb = t_all[flat_b]
        msg = None
        for m in range(n_fam):
            el = torch.exp(lam[:, m, None, :] * tb[None, :, None])     # [N, F, S]
            act = torch.bmm(torch.bmm(cc, right_t[:, m]) * el, left_t[:, m])
            term = w_all[:, m, flat_b, None] * act
            msg = term if msg is None else msg + term
        prod, log_scale = _renormalise(msg[:, : w * karity], w, karity, log_scale)
        buf[:, offset : offset + w] = prod
    return _root_log_likelihood(buf, n_nodes, root_freqs, log_scale)
