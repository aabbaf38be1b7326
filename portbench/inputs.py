"""Inputs of a run, made from ``--seed`` and a configuration file.

The configuration fixes the tree (``tree_seed``: every run has the same
topology, branch lengths and levels); the codons are simulated along it
from ``--seed`` by the frozen :mod:`portbench.synth`; the parameter
points handed to the program (the MG94xREV point of the per-site stage, the
GTR point of the gene fit) come from the generating process itself, so that
no fit of the program moves them.  The simulated alignment is written as
FASTA under ``build/portbench/`` in the checkout, one file per
configuration (named with a digest of its content) and seed, and reused when
it is there.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib

import numpy as np

from portbench import reference, synth

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "portbench"
# theta of each nucleotide pair in the generating process, relative to A<->G:
# the two transitions at 1, the four transversions at 1/kappa
_TRANSITIONS = ("AG", "CT")


@dataclasses.dataclass
class Inputs:
    config: dict
    seed: int
    data: synth.CodonData
    fasta: str
    corners: np.ndarray        # [4, 3] position frequencies (F3x4, one pseudo-count each)
    codon_freqs: np.ndarray    # [61] from ``corners``
    thetas: dict               # pair -> theta of the generating process
    alphas: np.ndarray         # [branches] synonymous rate per branch
    nuc_lengths: np.ndarray    # [branches] nucleotide branch lengths (the GTR point)
    omega: float

    @property
    def n_taxa(self) -> int:
        return self.data.states.shape[0]


def _data_seed(config: dict, seed: int) -> int:
    """One 63-bit seed from the configuration's stream and ``--seed``."""
    ss = np.random.SeedSequence([int(config["seed_stream"]), int(seed) % (1 << 64)])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def make(config: dict, seed: int) -> Inputs:
    data = synth.simulated_codon_alignment(
        config["n_taxa"], config["n_codons"], seed=_data_seed(config, seed),
        mean_branch=config["mean_branch"], kappa=config["kappa"], omega=config["omega"],
        planted_sites=config["planted_sites"], planted_omega=config["planted_omega"],
        tree_seed=config["tree_seed"])
    CACHE.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(json.dumps(config, sort_keys=True).encode()).hexdigest()[:12]
    fasta = CACHE / f"{config['name']}-{digest}-{seed}.fasta"
    if not fasta.exists():
        tmp = fasta.with_suffix(f".{os.getpid()}.tmp")
        data.write_fasta(str(tmp))
        os.replace(tmp, fasta)
    # F3x4 with one pseudo-count per nucleotide and position, so that no codon
    # has frequency 0 (the program's own CF3x4 never gives one); at 1000 x
    # 2048 codons it moves no frequency by more than 2e-6
    n = data.states.size
    corners = (reference.position_frequencies(data.states) * n + 1.0) / (n + 4.0)
    codon_freqs = reference.codon_frequencies(corners)
    kappa = float(config["kappa"])
    thetas = {p: 1.0 if p in _TRANSITIONS else 1.0 / kappa for p in reference._PAIRS}
    omega = float(config["omega"])
    # the synonymous rate that gives each branch its simulated length in
    # expected codon substitutions under (thetas, corners, omega)
    import torch

    q_syn, q_non = reference.mg94_bases({p: torch.tensor(v, dtype=torch.float64)
                                         for p, v in thetas.items()}, corners, "cpu")
    rate = float(torch.as_tensor(codon_freqs) @ (q_syn + omega * q_non).sum(-1))
    lengths = np.maximum(data.tree.lengths[:-1], 1e-6)
    return Inputs(config=config, seed=seed, data=data, fasta=str(fasta), corners=corners,
                  codon_freqs=codon_freqs, thetas=thetas, alphas=lengths / rate,
                  nuc_lengths=lengths / 3.0, omega=omega)
