"""Codon substitution counting: expected/observed synonymous and
non-synonymous sites and substitutions per codon pair.

A copy of the numpy-only ``hyphy_tpu/methods/counting.py`` (the port
imports nothing of the JAX package); it gives the same tables.

Behavioral port of
``genetic_code.ComputePairwiseDifferencesAndExpectedSites``
(``libv3/tasks/genetic_code.bf:262``): per-codon syn/nonsyn site counts
weighted by a position-stratified nucleotide weighting matrix, and per
codon-pair path-averaged expectations over the <=6 orderings of the
differing positions (paths through stop codons excluded).
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence

import numpy as np

from hyphy_tpu_torch.data.genetic_code import NUCLEOTIDES, GeneticCode
from hyphy_tpu_torch.models.dna import GTR_RATES

# nucleotide-pair class for single-step changes (genetic_code.bf ntp_matrix):
# (A,C)=0 (A,G)=1 (A,T)=2 (C,G)=3 (C,T)=4 (G,T)=5
_NTP = np.array(
    [[0, 0, 1, 2], [0, 0, 3, 4], [1, 3, 0, 5], [2, 4, 5, 0]], dtype=np.int32
)


def pairwise_counts(
    gc: GeneticCode,
    weighting_matrices: Optional[Sequence[np.ndarray]] = None,
    count_stop_codons: bool = False,
) -> Dict[str, np.ndarray]:
    """Returns EPS/EPN/OPS/OPN/NTP ([S,S]) and SS/NS ([S]) arrays."""
    if weighting_matrices is None:
        weighting_matrices = [np.ones((4, 4))] * 3
    trans = gc.translation
    stop = "*"

    ss64 = np.zeros(64)
    ns64 = np.zeros(64)
    for codon in range(64):
        if trans[codon] == stop:
            continue
        nucs = [codon // 16, (codon // 4) % 4, codon % 4]
        aa = trans[codon]
        for pos in range(3):
            norm = s_sites = n_sites = 0.0
            for new_nuc in range(4):
                if new_nuc == nucs[pos]:
                    continue
                new = list(nucs)
                new[pos] = new_nuc
                new_codon = 16 * new[0] + 4 * new[1] + new[2]
                w = weighting_matrices[pos][nucs[pos], new_nuc]
                if count_stop_codons or trans[new_codon] != stop:
                    if trans[new_codon] != aa:
                        n_sites += w
                    else:
                        s_sites += w
                norm += w
            if norm > 0:
                ss64[codon] += s_sites / norm
                ns64[codon] += n_sites / norm

    sense = gc.sense_codons
    n = len(sense)
    eps = np.zeros((n, n))
    epn = np.zeros((n, n))
    ops = np.zeros((n, n))
    opn = np.zeros((n, n))
    ntp = np.full((n, n), -1.0)

    for i in range(n):
        c1 = int(sense[i])
        eps[i, i] = ss64[c1]
        epn[i, i] = ns64[c1]
        n1 = [c1 // 16, (c1 // 4) % 4, c1 % 4]
        for j in range(i + 1, n):
            c2 = int(sense[j])
            n2 = [c2 // 16, (c2 // 4) % 4, c2 % 4]
            path_count = 0
            a_eps = a_epn = a_ops = a_opn = 0.0
            pair_ntp = None
            for perm in itertools.permutations(range(3)):
                cur = list(n1)
                cur_aa = trans[c1]
                seq = [c1]
                ps = pn = 0
                ok = True
                for pos in perm:
                    if cur[pos] != n2[pos]:
                        cur[pos] = n2[pos]
                        cc = 16 * cur[0] + 4 * cur[1] + cur[2]
                        next_aa = trans[cc]
                        if next_aa == stop:
                            ok = False
                            break
                        seq.append(cc)
                        if next_aa == cur_aa:
                            ps += 1
                        else:
                            pn += 1
                        cur_aa = next_aa
                if not ok:
                    continue
                path_count += 1
                if len(seq) == 2 and pair_ntp is None:
                    for pos in range(3):
                        if n1[pos] != n2[pos]:
                            pair_ntp = _NTP[n1[pos], n2[pos]]
                            break
                a_eps += sum(ss64[c] for c in seq) / len(seq)
                a_epn += sum(ns64[c] for c in seq) / len(seq)
                a_ops += ps
                a_opn += pn
            if path_count > 0:
                eps[i, j] = eps[j, i] = a_eps / path_count
                epn[i, j] = epn[j, i] = a_epn / path_count
                ops[i, j] = ops[j, i] = a_ops / path_count
                opn[i, j] = opn[j, i] = a_opn / path_count
                if pair_ntp is not None:
                    ntp[i, j] = ntp[j, i] = pair_ntp

    return {
        "EPS": eps, "EPN": epn, "OPS": ops, "OPN": opn, "NTP": ntp,
        "SS": ss64[sense], "NS": ns64[sense],
    }


def slac_weighting_matrix(theta: Dict[str, float], nuc_freqs: np.ndarray) -> np.ndarray:
    """SLAC's counting-bias matrix (SLAC.bf:196-203):
    W[i,j] = theta_ij * pi_j, W[j,i] = theta_ij * pi_i  (i<j, theta_AG=1)."""
    w = np.ones((4, 4))
    for pair in GTR_RATES:
        i, j = NUCLEOTIDES.index(pair[0]), NUCLEOTIDES.index(pair[1])
        rate = 1.0 if pair == "AG" else float(theta[f"theta_{pair}"])
        w[j, i] = rate * nuc_freqs[i]
        w[i, j] = rate * nuc_freqs[j]
    return w


def extended_binomial_tail(n: float, p: float, x: float) -> float:
    """P(X <= x) for the extended (non-integer n) binomial
    (reference: slac.extendedBinTail, SLAC.bf)."""
    if p == 0:
        return 0.0
    r = int(x)
    coeff = (1.0 - p) ** n
    head = 0.0
    for k in range(r + 1):
        head += coeff
        coeff = coeff * (n - k) / (k + 1) * p / (1.0 - p)
    if x <= int(n):
        head += coeff * (x - r)
    else:
        head += (1.0 - head) * (x - r) / (n - int(n))
    return head
