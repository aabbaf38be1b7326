"""Sequence simulation from a fitted model — the engine's
``SimulateDataSet`` (reference: ``likefunc.cpp:12584``), used for
parametric-bootstrap null distributions (FEL ``--resample``).

A copy of the numpy-only ``hyphy_tpu/utils/simulate.py`` (the port imports
nothing of the JAX package): for the same generator state and propagators
it draws the same states.

Sampling runs root -> tips over the level schedule with per-branch
transition matrices; rate-class mixtures draw a class per site first
(matching the reference's category-sampling semantics)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from hyphy_tpu_torch.data.genetic_code import AMINO_ACIDS, GeneticCode
from hyphy_tpu_torch.tree.topology import Tree

_NUC = "ACGT"


def simulate_states(
    tree: Tree,
    p_matrices: np.ndarray,          # [n_branches(+), S, S] row above each node
    root_freqs: np.ndarray,
    n_sites: int,
    rng: Optional[np.random.Generator] = None,
    class_weights: Optional[np.ndarray] = None,   # [C] with p [C, B, S, S]
) -> np.ndarray:
    """[n_nodes, n_sites] int states sampled from the model."""
    rng = rng or np.random.default_rng(0)
    p = np.asarray(p_matrices)
    if class_weights is not None:
        classes = rng.choice(len(class_weights), size=n_sites, p=np.asarray(class_weights))
    root_freqs = np.asarray(root_freqs)
    s = root_freqs.shape[0]
    n_nodes = tree.n_nodes
    states = np.empty((n_nodes, n_sites), dtype=np.int32)
    states[tree.root] = rng.choice(s, size=n_sites, p=root_freqs / root_freqs.sum())

    # preorder: parents before children (root = last node id in post-order)
    order = sorted(range(n_nodes), key=lambda nd: -nd)
    u = rng.uniform(size=(n_nodes, n_sites))
    for nd in order:
        if nd == tree.root:
            continue
        par = tree.parent[nd]
        if class_weights is None:
            cdf = np.cumsum(p[nd], axis=1)              # [S, S]
            states[nd] = np.argmax(
                u[nd][:, None] < cdf[states[par]], axis=1
            )
        else:
            cdf = np.cumsum(p[:, nd], axis=2)           # [C, S, S]
            states[nd] = np.argmax(
                u[nd][:, None] < cdf[classes, states[par]], axis=1
            )
    return states


def states_to_alignment(
    states: np.ndarray,
    tree: Tree,
    datatype: str,
    genetic_code: Optional[GeneticCode] = None,
) -> Tuple[List[str], List[str]]:
    """(names, sequences) for the leaf rows of a simulated state matrix."""
    names = tree.names[: tree.n_leaves]
    seqs = []
    if datatype == "codon":
        gc = genetic_code or GeneticCode("Universal")
        sense = np.asarray(gc.sense_codons)
        for t in range(tree.n_leaves):
            cods = sense[states[t]]
            seqs.append(
                "".join(
                    _NUC[c // 16] + _NUC[(c // 4) % 4] + _NUC[c % 4]
                    for c in cods
                )
            )
    elif datatype == "nucleotide":
        for t in range(tree.n_leaves):
            seqs.append("".join(_NUC[x] for x in states[t]))
    elif datatype == "protein":
        for t in range(tree.n_leaves):
            seqs.append("".join(AMINO_ACIDS[x] for x in states[t]))
    else:
        raise ValueError(datatype)
    return list(names), seqs
