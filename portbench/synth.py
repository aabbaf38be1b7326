"""The benchmark's inputs: a frozen copy of the port's codon simulator.

Copied on 2026-10-19 from ``hyphy_tpu_torch/utils/synth.py``
(``random_tree_newick``, ``_mg94_generator``, ``simulated_codon_alignment``)
and ``hyphy_tpu_torch/utils/simulate.py`` (``simulate_states``), with the
universal genetic code and a newick reader of its own, so that a later change
to the program cannot move the inputs.  NumPy only: nothing here imports the
program.  Two departures from the copied code: the leaves are numbered in
the order t0..t{n-1} (the original numbers them in newick order), and each
branch's propagator comes from the eigendecomposition of the generator,
which uniform codon frequencies make symmetric, in place of
``scipy.linalg.expm`` (the same matrices to round-off, at a fiftieth of the
time).

Tree convention (the one the program and HyPhy use): node ids are the leaves
in the alignment's order, then the internal nodes in post-order of the
newick; every node but the root (the last id) owns the branch above it.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

NUCLEOTIDES = "ACGT"
# the standard code in NCBI's TCAG nesting, remapped below to ACGT nesting
_NCBI_STANDARD = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
_NCBI_ORDER = "TCAG"


def _translation() -> str:
    table = [""] * 64
    for i, aa in enumerate(_NCBI_STANDARD):
        codon = _NCBI_ORDER[i // 16] + _NCBI_ORDER[(i // 4) % 4] + _NCBI_ORDER[i % 4]
        table[codon_index(codon)] = aa
    return "".join(table)


def codon_index(codon: str) -> int:
    return 16 * NUCLEOTIDES.index(codon[0]) + 4 * NUCLEOTIDES.index(codon[1]) + \
        NUCLEOTIDES.index(codon[2])


def codon_string(index: int) -> str:
    return NUCLEOTIDES[index // 16] + NUCLEOTIDES[(index // 4) % 4] + NUCLEOTIDES[index % 4]


TRANSLATION = _translation()
STOP_CODONS = np.array([i for i in range(64) if TRANSLATION[i] == "*"], dtype=np.int64)
SENSE_CODONS = np.array([i for i in range(64) if TRANSLATION[i] != "*"], dtype=np.int64)


@dataclasses.dataclass
class Tree:
    names: List[str]
    parent: np.ndarray        # [nodes] int, -1 at the root
    children: List[List[int]]
    lengths: np.ndarray       # [nodes] branch length above each node (nan at the root)
    n_leaves: int

    @property
    def n_nodes(self) -> int:
        return len(self.names)

    @property
    def root(self) -> int:
        return self.n_nodes - 1

    @property
    def n_branches(self) -> int:
        return self.n_nodes - 1

    def heights(self) -> np.ndarray:
        """[nodes] 0 at the leaves, 1 + the highest child elsewhere."""
        h = np.zeros(self.n_nodes, dtype=np.int64)
        for nd in range(self.n_leaves, self.n_nodes):
            h[nd] = 1 + max(h[c] for c in self.children[nd])
        return h


def parse_newick(text: str, leaf_order=None) -> Tree:
    """A newick string with names and lengths, read into :class:`Tree`."""
    pos = 0
    text = text.strip().rstrip(";")

    def node():
        nonlocal pos
        kids = []
        if text[pos] == "(":
            pos += 1
            kids.append(node())
            while text[pos] == ",":
                pos += 1
                kids.append(node())
            if text[pos] != ")":
                raise ValueError(f"newick: ')' expected at {pos}")
            pos += 1
        start = pos
        while pos < len(text) and text[pos] not in ",():":
            pos += 1
        name = text[start:pos]
        length = np.nan
        if pos < len(text) and text[pos] == ":":
            pos += 1
            start = pos
            while pos < len(text) and text[pos] not in ",()":
                pos += 1
            length = float(text[start:pos])
        return {"name": name, "length": length, "kids": kids}

    root = node()
    leaves, internals = [], []

    def post(nd):
        for c in nd["kids"]:
            post(c)
        (internals if nd["kids"] else leaves).append(nd)

    post(root)
    if leaf_order is not None:
        by_name = {lf["name"]: lf for lf in leaves}
        leaves = [by_name[nm] for nm in leaf_order]
    ordered = leaves + internals
    ids = {id(nd): i for i, nd in enumerate(ordered)}
    parent = np.full(len(ordered), -1, dtype=np.int64)
    children = [[ids[id(c)] for c in nd["kids"]] for nd in ordered]
    for i, kids in enumerate(children):
        parent[kids] = i
    return Tree(names=[nd["name"] for nd in ordered], parent=parent, children=children,
                lengths=np.array([nd["length"] for nd in ordered]), n_leaves=len(leaves))


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


def mg94_generator(kappa: float, omega: float) -> np.ndarray:
    """Unit-mean-rate MG94-style generator over the 61 sense codons."""
    s = len(SENSE_CODONS)
    q = np.zeros((s, s))
    for a in range(s):
        ca = int(SENSE_CODONS[a])
        na = (ca // 16, (ca // 4) % 4, ca % 4)
        for b in range(s):
            if a == b:
                continue
            cb = int(SENSE_CODONS[b])
            nb = (cb // 16, (cb // 4) % 4, cb % 4)
            diff = [p for p in range(3) if na[p] != nb[p]]
            if len(diff) != 1:
                continue
            x, y = na[diff[0]], nb[diff[0]]
            is_transition = {x, y} in ({0, 2}, {1, 3})  # A<->G, C<->T
            rate = kappa if is_transition else 1.0
            if TRANSLATION[ca] != TRANSLATION[cb]:
                rate *= omega
            q[a, b] = rate
    pi = np.full(s, 1.0 / s)
    q = q / (pi @ q.sum(axis=1))
    np.fill_diagonal(q, 0.0)
    q -= np.diag(q.sum(axis=1))
    return q


def simulate_states(tree: Tree, p: np.ndarray, root_freqs: np.ndarray, n_sites: int,
                    rng: np.random.Generator) -> np.ndarray:
    """[nodes, sites] states drawn down the tree from ``p`` [branches, S, S]."""
    s = root_freqs.shape[0]
    states = np.empty((tree.n_nodes, n_sites), dtype=np.int32)
    states[tree.root] = rng.choice(s, size=n_sites, p=root_freqs / root_freqs.sum())
    u = rng.uniform(size=(tree.n_nodes, n_sites))
    for nd in range(tree.n_nodes - 2, -1, -1):     # parents before children
        cdf = np.cumsum(p[nd], axis=1)
        states[nd] = np.argmax(u[nd][:, None] < cdf[states[tree.parent[nd]]], axis=1)
    return states


@dataclasses.dataclass
class CodonData:
    names: List[str]
    states: np.ndarray        # [taxa, codons] sense-codon index
    newick: str
    tree: Tree                # leaves in ``names`` order

    def sequences(self) -> List[str]:
        strings = np.array([codon_string(int(c)) for c in SENSE_CODONS])
        return ["".join(row) for row in strings[self.states]]

    def write_fasta(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("".join(f">{n}\n{s}\n" for n, s in zip(self.names, self.sequences())))


def simulated_codon_alignment(n_taxa: int, n_codons: int, seed: int = 0,
                              mean_branch: float = 0.05, kappa: float = 2.5,
                              omega: float = 0.3, planted_sites=(),
                              planted_omega: float = 5.0, tree_seed=None) -> CodonData:
    """Codons simulated along a random tree under an MG94-style process
    (kappa transition bias, ``omega`` on nonsynonymous steps,
    ``planted_omega`` at the codons ``planted_sites``).  The tree is drawn
    from ``tree_seed`` (by default ``seed``, as in the copied code), the
    codons from ``seed``."""
    rng = np.random.default_rng(seed)
    s = len(SENSE_CODONS)
    pi = np.full(s, 1.0 / s)
    newick = random_tree_newick(n_taxa, seed=seed if tree_seed is None else tree_seed,
                                mean_branch=mean_branch)
    names = [f"t{i}" for i in range(n_taxa)]
    tree = parse_newick(newick, leaf_order=names)
    lengths = np.maximum(tree.lengths[:-1], 1e-6)
    site_omegas = np.full(n_codons, float(omega))
    site_omegas[list(planted_sites)] = planted_omega
    states = np.zeros((tree.n_nodes, n_codons), dtype=np.int32)
    for w in np.unique(site_omegas):
        cols = np.where(site_omegas == w)[0]
        q = mg94_generator(kappa, float(w))
        # symmetric under uniform frequencies: expm(q t) = U e^{lam t} U^T
        lam, u = np.linalg.eigh(0.5 * (q + q.T))
        p = (u[None] * np.exp(lam[None] * lengths[:, None])[:, None, :]) @ u.T[None]
        states[:, cols] = simulate_states(tree, p, pi, len(cols), rng)
    return CodonData(names=names, states=states[:n_taxa], newick=newick, tree=tree)
