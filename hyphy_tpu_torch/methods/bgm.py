"""BGM: Bayesian-graphical-model detection of co-evolving sites.

Counterpart of ``hyphy_tpu/methods/bgm.py`` (reference:
``res/TemplateBatchFiles/BGM.bf`` and the engine
``src/new/{bgm,bgm2,bayesgraph,bayesgraph2}.cpp``).  Pipeline: nucleotide
GTR -> global MG94xREV (proportional branch lengths) on the device -> joint
ML ancestral states (:func:`ancestral.joint_reconstruct`, in fp64 as in the
reference) -> the binary branch x site map of non-synonymous substitutions
(``BGM.bf:416-424``), sites with >= ``min_subs`` of them (``BGM.bf:426-428``)
-> a Bayesian network over those sites with the tested branches as cases,
learnt by order-MCMC.  The network scores, the order sampler and the
substitution map are the JAX package's host NumPy, copied as they are; the
sampler keeps its order of draws, so one seed gives the same edge table.
The one change is :func:`_logsumexp`, scipy's algorithm for one vector
written out in NumPy: ``scipy.special.logsumexp``'s per-call dispatch took
88% of an order-MCMC step (~400 us of it at 64 sites on the host).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from scipy.special import gammaln

from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.methods import common
from hyphy_tpu_torch.ops import ancestral, pruning


# ---------------------------------------------------------------------------
# scores


def _logsumexp(a: np.ndarray) -> float:
    """``scipy.special.logsumexp`` of a non-empty 1-D vector by scipy's own
    steps (the maxima split out of the sum, ``log1p``), without its array-API
    dispatch."""
    a_max = a.max()
    top = a == a_max
    m = np.count_nonzero(top)
    s = np.sum(np.exp(np.where(top, -np.inf, a) - a_max))
    if s != 0:
        s = s / m
    return float(np.log1p(s) + np.log(m) + a_max)


def k2_local_score(
    data: np.ndarray,      # [cases, nodes] int
    child: int,
    parents: Tuple[int, ...],
    levels: int,
    prior_sample_size: float = 0.0,
) -> float:
    """Local marginal likelihood of ``child`` given ``parents``.

    ``prior_sample_size == 0`` -> K2 metric (Dirichlet(1) pseudocounts,
    Cooper-Herskovits); > 0 -> BDeu with that equivalent sample size —
    matching `_BayesianGraphicalModel::ComputeDiscreteScore`
    (``src/new/bgm.cpp``; BGM.bf passes 0, ``BGM.bf:398``).
    """
    x = data[:, child].astype(np.int64)
    if parents:
        code = np.zeros(len(data), dtype=np.int64)
        for p in parents:
            code = code * levels + data[:, p]
        q = levels ** len(parents)
    else:
        code = np.zeros(len(data), dtype=np.int64)
        q = 1
    joint = np.bincount(code * levels + x, minlength=q * levels).reshape(q, levels)
    nj = joint.sum(axis=1)
    r = levels
    if prior_sample_size > 0:
        a_j = prior_sample_size / q
        a_jk = prior_sample_size / (q * r)
        return float(
            np.sum(gammaln(a_j) - gammaln(nj + a_j))
            + np.sum(gammaln(joint + a_jk) - gammaln(a_jk))
        )
    return float(
        np.sum(gammaln(r) - gammaln(nj + r)) + np.sum(gammaln(joint + 1.0))
    )


class DiscreteBGM:
    """Order-MCMC over Bayesian networks with bounded in-degree
    (reference ``bayesgraph2.cpp`` order sampler).

    Families (child, parent-set) are enumerated up to ``max_parents`` and
    scored once (`_NTupleStorage` role); the chain walks node orderings
    with adjacent transpositions, and edge marginals given an order
    factorize per child.
    """

    def __init__(
        self,
        data: np.ndarray,              # [cases, nodes] int
        levels: int = 2,
        max_parents: int = 1,
        prior_sample_size: float = 0.0,
    ):
        self.data = np.asarray(data, dtype=np.int64)
        self.n = self.data.shape[1]
        self.levels = levels
        self.max_parents = min(max_parents, self.n - 1)
        # per child: scores [F], parent sets as padded index array [F, k]
        self._scores: List[np.ndarray] = []
        self._parents: List[np.ndarray] = []
        others = lambda c: [j for j in range(self.n) if j != c]
        for c in range(self.n):
            fams = [()]
            for k in range(1, self.max_parents + 1):
                fams.extend(itertools.combinations(others(c), k))
            sc = np.array(
                [k2_local_score(self.data, c, f, levels, prior_sample_size)
                 for f in fams]
            )
            pad = np.full((len(fams), self.max_parents), -1, dtype=np.int64)
            for i, f in enumerate(fams):
                pad[i, : len(f)] = f
            self._scores.append(sc)
            self._parents.append(pad)

    def _child_lse(self, c: int, pos: np.ndarray) -> float:
        """log sum over families of child c allowed under ordering
        positions ``pos`` (parents must precede the child)."""
        par = self._parents[c]
        ok = np.all((par < 0) | (pos[np.maximum(par, 0)] < pos[c]), axis=1)
        sc = self._scores[c][ok]
        return _logsumexp(sc) if sc.size else -np.inf

    def _edge_marginals(self, pos: np.ndarray, out: np.ndarray) -> None:
        """Accumulate P(j -> c | order) into out[j, c]."""
        for c in range(self.n):
            par = self._parents[c]
            ok = np.all((par < 0) | (pos[np.maximum(par, 0)] < pos[c]), axis=1)
            sc = self._scores[c][ok]
            if sc.size == 0:
                continue
            w = np.exp(sc - _logsumexp(sc))
            pmat = par[ok]
            for k in range(self.max_parents):
                col = pmat[:, k]
                sel = col >= 0
                np.add.at(out[:, c], col[sel], w[sel])

    def order_mcmc(
        self,
        steps: int = 100000,
        burnin: int = 10000,
        samples: int = 100,
        seed: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (edge_marginals [n, n], score_trace [samples])."""
        rng = np.random.default_rng(
            settings.random_seed if seed is None else seed
        )
        order = rng.permutation(self.n)
        pos = np.empty(self.n, dtype=np.int64)
        pos[order] = np.arange(self.n)
        child_scores = np.array([self._child_lse(c, pos) for c in range(self.n)])
        total = child_scores.sum()

        edge = np.zeros((self.n, self.n))
        trace = []
        sample_every = max(1, (steps - burnin) // max(samples, 1))
        n_sampled = 0

        for step in range(steps):
            i = rng.integers(self.n - 1)  # adjacent transposition
            u, v = order[i], order[i + 1]
            pos[u], pos[v] = pos[v], pos[u]
            order[i], order[i + 1] = v, u
            new_u = self._child_lse(u, pos)
            new_v = self._child_lse(v, pos)
            delta = (new_u + new_v) - (child_scores[u] + child_scores[v])
            if np.log(rng.uniform()) < delta:
                child_scores[u], child_scores[v] = new_u, new_v
                total += delta
            else:  # revert
                pos[u], pos[v] = pos[v], pos[u]
                order[i], order[i + 1] = u, v
            if step >= burnin and (step - burnin) % sample_every == 0 \
                    and n_sampled < samples:
                self._edge_marginals(pos, edge)
                trace.append(total)
                n_sampled += 1

        if n_sampled:
            edge /= n_sampled
        return edge, np.asarray(trace)


# ---------------------------------------------------------------------------
# substitution-map construction (ancestral.ComputeSubstitutionCounts)


def substitution_counts(
    states: np.ndarray,        # [n_nodes, sites] int joint ancestral states
    parent: np.ndarray,        # [n_nodes] int, root = -1
    tested: np.ndarray,        # bool [n_branches]
    amino_of_state: Optional[np.ndarray] = None,   # map state -> aa class
    min_subs: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Binary branch x site substitution indicators
    (``ancestral.ComputeSubstitutionCounts``, ``libv3/tasks/ancestral.bf:522``;
    codon data counts only substitutions that change the amino acid,
    ``BGM.bf:416-424``).  Returns (counts [B, S'], site_indices [S'],
    branch_indices [B])."""
    n_nodes = states.shape[0]
    branch_ids = np.array(
        [b for b in range(n_nodes - 1) if tested[b]], dtype=np.int64
    )
    own = states[branch_ids]
    par = states[parent[branch_ids]]
    valid = (own >= 0) & (par >= 0)
    if amino_of_state is not None:
        diff = amino_of_state[np.maximum(own, 0)] != amino_of_state[np.maximum(par, 0)]
    else:
        diff = own != par
    counts = (diff & valid).astype(np.int64)
    keep = counts.sum(axis=0) >= min_subs
    return counts[:, keep], np.nonzero(keep)[0], branch_ids


# ---------------------------------------------------------------------------
# analysis driver (BGM.bf)

TABLE_HEADERS = [
    ("Site 1", "Index of site 1"),
    ("Site 2", "Index of site 2"),
    ("P [Site 1 –> Site 2]", "Probability that site 2 is conditionally dependent on site 1"),
    ("P [Site 2 –> Site 1]", "Probability that site 1 is conditionally dependent on site 2"),
    ("P [Site 1 <–> Site 2]", "Probability that sites 1 and 2 are not conditionally independent"),
    ("Site 1 subs", "Substitution counts inferred for Site 1"),
    ("Site 2 subs", "Substitution counts inferred for Site 2"),
    ("Shared subs", "Substitutions shared by both sites"),
]


@dataclasses.dataclass
class BGMResult:
    json: Dict
    counts: np.ndarray           # [tested branches, kept sites] 0/1 substitution map
    site_indices: np.ndarray     # [kept sites] 0-based codon index
    branch_indices: np.ndarray   # [tested branches] branch ids
    edge: Optional[np.ndarray]   # [kept, kept] edge marginals (None below three sites)


def run(
    alignment: str,
    tree: Optional[str] = None,
    genetic_code: str = "Universal",
    branches: str = "All",
    steps: int = 100000,
    burnin: int = 10000,
    samples: int = 100,
    max_parents: int = 1,
    min_subs: int = 1,
    seed: Optional[int] = None,
    device=None,
) -> BGMResult:
    """Run the BGM analysis on a codon alignment (``BGM.bf`` codon type:
    MG94xREV fit -> joint ancestors -> nonsynonymous substitution map ->
    order-MCMC network), the fits and the reconstruction on ``device``
    (default ``settings.device``: the card, raising without one)."""
    from hyphy_tpu_torch.io.json_out import analysis_json, model_fit_entry
    from hyphy_tpu_torch.methods.slac import _leaf_state_coding

    data = common.load_codon_data(alignment, genetic_code, tree, branches, device=device)
    common.progress("bgm", "fitting nucleotide GTR")
    gtr = common.fit_gtr(data)
    common.progress("bgm", f"GTR lnL {gtr.loglik:.3f}; fitting global MG94xREV")
    mg = common.fit_partitioned_mg94(data, gtr, refit_lengths=False)
    common.progress("bgm", f"MG94 lnL {mg.loglik:.3f}; reconstructing ancestors")
    filt = data.codon_filter
    with torch.no_grad():
        out = mg.model.build(mg.params, data.tree.n_branches)
        pdata = pruning.build_pruning_data(data.tree, data.device)
        lp = torch.as_tensor(filt.leaf_partials(), dtype=torch.float64, device=data.device)
        joint = ancestral.joint_reconstruct(out.p_matrices, lp, out.root_freqs, pdata)
    leaf_states = _leaf_state_coding(filt)
    all_states = np.concatenate(
        [leaf_states, joint.internal_states.cpu().numpy()], axis=0
    )
    # expand patterns to sites; treat SLAC ambiguity classes (<= -2) as
    # missing for counting, as the reference's -1 check does (BGM.bf:418)
    states = all_states[:, filt.duplicate_map]
    states = np.where(states < 0, -1, states)

    aa_of = data.genetic_code.sense_amino_acids
    counts, site_idx, branch_ids = substitution_counts(
        states, data.tree.parent, data.tested_branches,
        amino_of_state=np.asarray(aa_of), min_subs=min_subs,
    )
    result = analysis_json(
        info="BGM (Bayesian Graphical Model) uses a maximum likelihood "
             "ancestral state reconstruction to map non-synonymous "
             "substitution events to branches in the phylogeny and then "
             "analyzes the joint distribution of the substitution map "
             "using a Bayesian graphical model.",
        version="1.2",
        data=data,
        fits={
            "Nucleotide GTR": model_fit_entry(
                gtr.loglik, gtr.n_parameters, data.sample_size,
                frequencies=gtr.frequencies, display_order=0,
            ),
            "Global MG94xREV": model_fit_entry(
                mg.loglik, mg.n_parameters, data.sample_size,
                frequencies=mg.codon_freqs, display_order=1,
            ),
        },
        extra={
            "settings": {
                "steps": steps, "burn-in": burnin, "samples": samples,
                "max-parents": max_parents, "min-subs": min_subs,
                "type": "codon",
            },
        },
    )
    n_sites = counts.shape[1]
    done = dict(counts=counts, site_indices=site_idx, branch_indices=branch_ids)
    if n_sites <= 2:
        result["MLE"] = {"headers": TABLE_HEADERS, "content": []}
        result["error"] = (
            "BGM requires at least three sites to have accumulated sufficient "
            "substitutions"
        )
        return BGMResult(json=result, edge=None, **done)

    common.progress("bgm", f"{n_sites} sites; scoring families and sampling orders")
    net = DiscreteBGM(counts, levels=2, max_parents=max_parents)
    edge, trace = net.order_mcmc(
        steps=steps, burnin=burnin, samples=samples, seed=seed
    )

    rows = []
    for i in range(n_sites):
        for j in range(i + 1, n_sites):
            rows.append([
                int(site_idx[i]) + 1,
                int(site_idx[j]) + 1,
                float(edge[i, j]),
                float(edge[j, i]),
                float(edge[i, j] + edge[j, i]),
                int(counts[:, i].sum()),
                int(counts[:, j].sum()),
                int((counts[:, i] & counts[:, j]).sum()),
            ])
    result["MLE"] = {"headers": TABLE_HEADERS, "content": {"0": rows}}
    result["trace"] = [float(t) for t in trace]
    return BGMResult(json=result, edge=edge, **done)
