"""Synthetic data generation for benchmarks and dry runs.

Copy of ``random_tree_newick`` and ``synthetic_codon_alignment`` from
``hyphy_tpu/utils/synth.py``: for the same seed both give output identical
to the JAX package's, so both packages see the same workload.
"""

from __future__ import annotations

import numpy as np

from hyphy_tpu_torch.data.alignment import Alignment
from hyphy_tpu_torch.data.genetic_code import GeneticCode, codon_string


def random_tree_newick(n_taxa: int, seed: int = 0, mean_branch: float = 0.05) -> str:
    """Random binary tree over t0..t{n-1} with exponential branch lengths."""
    rng = np.random.default_rng(seed)
    nodes = [f"t{i}" for i in range(n_taxa)]
    lengths = {n: rng.exponential(mean_branch) for n in nodes}
    while len(nodes) > 2:
        i, j = sorted(rng.choice(len(nodes), 2, replace=False))
        a, b = nodes[i], nodes[j]
        merged = f"({a}:{lengths[a]:.6f},{b}:{lengths[b]:.6f})"
        lengths[merged] = rng.exponential(mean_branch)
        nodes = [n for k, n in enumerate(nodes) if k not in (i, j)] + [merged]
    a, b = nodes
    return f"({a}:{lengths[a]:.6f},{b}:{lengths[b]:.6f})"


def synthetic_codon_alignment(
    n_taxa: int, n_codons: int, seed: int = 0, mutation_rate: float = 0.15
) -> Alignment:
    """Sense-codon alignment: a random ancestor with per-taxon random
    codon substitutions — produces realistic site-pattern diversity
    without needing a simulator."""
    rng = np.random.default_rng(seed)
    gc = GeneticCode("Universal")
    sense = gc.sense_codons
    ancestor = rng.choice(sense, size=n_codons)
    seqs = []
    for t in range(n_taxa):
        mask = rng.random(n_codons) < mutation_rate
        mutated = np.where(mask, rng.choice(sense, size=n_codons), ancestor)
        seqs.append("".join(codon_string(int(c)) for c in mutated))
    names = [f"t{i}" for i in range(n_taxa)]
    return Alignment(names, seqs)
