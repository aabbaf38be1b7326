"""Synthetic data generation for benchmarks and dry runs.

Copy of ``random_tree_newick``, ``_mg94_generator``,
``simulated_codon_alignment`` and ``synthetic_codon_alignment`` from
``hyphy_tpu/utils/synth.py`` (numpy and scipy): for the same seed each
gives output identical to the JAX package's, so both packages see the same
workload.
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


def _mg94_generator(gc: "GeneticCode", kappa: float, omega: float) -> np.ndarray:
    """Unit-mean-rate MG94-style generator over the sense codons."""
    sense = gc.sense_codons
    s = len(sense)
    trans = gc.translation
    q = np.zeros((s, s))
    for a in range(s):
        ca = int(sense[a])
        na = (ca // 16, (ca // 4) % 4, ca % 4)
        for b in range(s):
            if a == b:
                continue
            cb = int(sense[b])
            nb = (cb // 16, (cb // 4) % 4, cb % 4)
            diff = [p for p in range(3) if na[p] != nb[p]]
            if len(diff) != 1:
                continue
            x, y = na[diff[0]], nb[diff[0]]
            is_transition = {x, y} in ({0, 2}, {1, 3})  # A<->G, C<->T
            rate = kappa if is_transition else 1.0
            if trans[ca] != trans[cb]:
                rate *= omega
            q[a, b] = rate
    pi = np.full(s, 1.0 / s)
    q = q / (pi @ q.sum(axis=1))          # unit expected rate
    np.fill_diagonal(q, 0.0)
    q -= np.diag(q.sum(axis=1))
    return q


def simulated_codon_alignment(
    n_taxa: int,
    n_codons: int,
    seed: int = 0,
    mean_branch: float = 0.05,
    kappa: float = 2.5,
    omega: float = 0.3,
    site_omegas: np.ndarray = None,
):
    """(Alignment, newick): codons simulated ALONG a random tree under an
    MG94-style process (kappa transition bias, omega on nonsynonymous
    steps), so distances are finite and both this framework and the
    reference binary fit the data comfortably — iid-random sequences
    saturate a 1000-taxon tree past the reference's numeric limits.

    ``site_omegas`` ([n_codons]) overrides the shared ``omega`` with a
    per-site value — sites with omega > 1 evolve under positive selection
    (used by the positive-site FEL parity benchmark; reference analogue:
    ``SimulateDataSet`` with per-partition rate multipliers,
    ``likefunc.cpp:12584``).
    """
    import scipy.linalg as sla

    from hyphy_tpu_torch.tree.topology import Tree
    from hyphy_tpu_torch.utils.simulate import simulate_states

    rng = np.random.default_rng(seed)
    gc = GeneticCode("Universal")
    sense = gc.sense_codons
    s = len(sense)
    pi = np.full(s, 1.0 / s)

    newick = random_tree_newick(n_taxa, seed=seed, mean_branch=mean_branch)
    tree = Tree.from_newick(newick)
    lengths = np.maximum(np.asarray(tree.input_lengths[:-1]), 1e-6)

    if site_omegas is None:
        site_omegas = np.full(n_codons, float(omega))
    site_omegas = np.asarray(site_omegas, float)
    assert site_omegas.shape == (n_codons,)

    states = np.zeros((tree.n_nodes, n_codons), dtype=np.int32)
    for w in np.unique(site_omegas):
        cols = np.where(site_omegas == w)[0]
        q = _mg94_generator(gc, kappa, float(w))
        p = np.stack([sla.expm(q * t) for t in lengths])
        states[:, cols] = simulate_states(tree, p, pi, len(cols), rng)
    names = list(tree.names[: tree.n_leaves])
    seqs = [
        "".join(codon_string(int(sense[st])) for st in states[i])
        for i in range(tree.n_leaves)
    ]
    return Alignment(names, seqs), newick


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
