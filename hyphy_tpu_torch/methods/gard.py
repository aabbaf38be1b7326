"""GARD — Genetic Algorithm for Recombination Detection.

Counterpart of ``hyphy_tpu/methods/gard.py`` (reference:
``res/TemplateBatchFiles/GARD.bf``).  A model with N breakpoints splits the
alignment into N+1 contiguous partitions, each with its own NJ topology
(TN93 distances) and branch lengths, the GTR rates shared; its fitness is
small-sample AIC (c-AIC with n = alignment sites).  The search is an
exhaustive single-breakpoint scan (GARD.bf:343-382), then a CHC-style
genetic algorithm over breakpoint vectors for N >= 2 (GARD.bf:415-560).
Breakpoints lie on variable sites only.  ``checkpoint=path`` keeps every
evaluated model and resumes from it (GARD.bf:204-207).

The scan, the genetic algorithm, the c-AIC and the TN93 distances (host
C++, ``native/datapath.cpp``, as in the JAX package; its numpy form kept as
the plain version) are copied as they are, with the same order of draws
from the same generator, so a run resumed from another run's checkpoint
takes the same path.  The one repair, where the JAX package's seeding of a
population would never end, changes no draw of a run that package
finishes.  Each candidate is one joint GTR fit of the multi-partition
:class:`LikelihoodFunction` on the device, every pruning level through K1
at 4 states.  The JAX package pads each candidate's
schedules and patterns to shared shapes (``schedule_pad``,
``pattern_bucket``) so that XLA compiles one program per partition count;
the port compiles nothing, so it fits every candidate at its exact shapes
(zero-weight patterns and identity levels change no lnL).
"""

from __future__ import annotations

import dataclasses
import json as _json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hyphy_tpu_torch import native
from hyphy_tpu_torch.config import resolve_device
from hyphy_tpu_torch.data.alignment import read_alignment
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
from hyphy_tpu_torch.models import frequencies as freq_mod
from hyphy_tpu_torch.models.dna import GTR
from hyphy_tpu_torch.tree.topology import infer_nj_tree


def tn93_distance(filt: DataFilter, use_native: bool = True) -> np.ndarray:
    """Pairwise TN93 distances (the reference's default NJ distance,
    ``tree.infer.NJ`` -> distances) over the sites both sequences resolve;
    a saturated pair, or one with no such site, gets 5.0.  As the JAX
    package does (``gard.py:54``), through the host C++ kernel
    (``native/datapath.cpp``; a failed build raises); ``use_native=False``
    takes its NumPy mirror, the plain version the tests hold it to."""
    masks = filt.char_masks  # [taxa, raw sites] 4-bit nucleotide masks
    # resolved states only (single-bit masks)
    state = np.full(masks.shape, -1, dtype=np.int8)
    for bit, s in zip((1, 2, 4, 8), range(4)):
        state[masks == bit] = s
    if use_native:
        return native.tn93_distances(state, saturation=5.0)
    return _tn93_numpy(state)


def _tn93_numpy(state: np.ndarray) -> np.ndarray:
    """The NumPy TN93 of the JAX package's ``tn93_distance`` on [taxa,
    sites] int8 states (negative = unresolved)."""
    n = state.shape[0]
    d = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            ok = (state[i] >= 0) & (state[j] >= 0)
            tot = ok.sum()
            if tot == 0:
                # zero-overlap pairs get the saturation distance
                d[i, j] = d[j, i] = 5.0
                continue
            si, sj = state[i][ok], state[j][ok]
            freqs = np.bincount(np.concatenate([si, sj]), minlength=4) / (2 * tot)
            gr = freqs[2] + freqs[0]  # purines A,G -> indices 0=A,1=C,2=G,3=T
            gy = freqs[1] + freqs[3]
            diff = si != sj
            purine = ((si == 0) | (si == 2)) & ((sj == 0) | (sj == 2))
            pyrim = ((si == 1) | (si == 3)) & ((sj == 1) | (sj == 3))
            p1 = (diff & purine).sum() / tot    # A<->G transitions
            p2 = (diff & pyrim).sum() / tot     # C<->T transitions
            q = (diff & ~purine & ~pyrim).sum() / tot
            pa, pg, pc, pt = freqs[0], freqs[2], freqs[1], freqs[3]
            k1 = 2 * pa * pg / max(gr, 1e-12)
            k2 = 2 * pc * pt / max(gy, 1e-12)
            k3 = 2 * (gr * gy - pa * pg * gy / max(gr, 1e-12)
                      - pc * pt * gr / max(gy, 1e-12))
            with np.errstate(invalid="ignore", divide="ignore"):
                w1 = 1 - p1 / max(k1, 1e-12) - q / max(2 * gr, 1e-12)
                w2 = 1 - p2 / max(k2, 1e-12) - q / max(2 * gy, 1e-12)
                w3 = 1 - q / max(2 * gr * gy, 1e-12)
                val = -(k1 * np.log(w1) + k2 * np.log(w2) + k3 * np.log(w3))
            if not np.isfinite(val) or val < 0:
                val = 5.0  # saturated
            d[i, j] = d[j, i] = val
    return d


def caic(loglik: float, n_params: int, n_samples: int) -> float:
    """Small-sample AIC (math.GetIC; GARD requires n > p + 1)."""
    return (
        2.0 * n_params
        - 2.0 * loglik
        + 2.0 * n_params * (n_params + 1) / max(n_samples - n_params - 1, 1)
    )


@dataclasses.dataclass
class GARDResult:
    json: Dict
    breakpoints: List[int]
    best_caic: float
    baseline_caic: float
    improvements: Dict[int, Dict]
    site_support: Dict[int, float]


class _Evaluator:
    """Fits a multi-partition GTR model for a breakpoint vector and caches
    c-AIC by model (GARD.bf masterList)."""

    def __init__(self, filt: DataFilter, variable_sites: np.ndarray,
                 precision: float, rate_params: Optional[Dict] = None, device=None):
        self.filt = filt
        self.device = resolve_device(device)
        self.aln_sites = filt.char_masks.shape[1]
        self.variable_sites = variable_sites
        self.precision = precision
        self.rate_params = rate_params  # warm start
        self.cache: Dict[Tuple[int, ...], Tuple[float, float]] = {}
        self.evaluations = 0

    def site_ranges(self, breakpoints: Sequence[int]) -> List[np.ndarray]:
        bps = sorted(breakpoints)
        bounds = [0] + [b + 1 for b in bps] + [self.aln_sites]
        return [
            np.arange(bounds[k], bounds[k + 1]) for k in range(len(bounds) - 1)
        ]

    def evaluate(self, breakpoints: Sequence[int]) -> float:
        """Returns c-AIC; caches; a model with an empty partition is
        infinitely bad."""
        key = tuple(sorted(int(b) for b in breakpoints))
        if key in self.cache:
            return self.cache[key][0]
        parts = []
        ranges = self.site_ranges(key)
        if any(len(r) < 2 for r in ranges):
            self.cache[key] = (np.inf, -np.inf)
            return np.inf
        for rng in ranges:
            sub = self.filt.subset_sites(rng)
            dist = tn93_distance(sub)
            tree = infer_nj_tree(dist, sub.names)
            freqs = freq_mod.empirical_nucleotide(sub)
            parts.append(Partition(sub, tree, GTR(freqs, device=self.device)))
        # at exact shapes: nothing is compiled, so nothing is padded
        lf = LikelihoodFunction(parts, device=self.device)
        init = dict(self.rate_params or {})
        res = lf.fit(init=init, precision=self.precision)
        self.evaluations += 1
        # +3 empirical base frequencies (reference df convention)
        score = caic(res.loglik, res.n_free_parameters + 3, self.aln_sites)
        self.cache[key] = (score, res.loglik)
        return score


def _variable_sites(filt: DataFilter) -> np.ndarray:
    masks = filt.char_masks
    var = []
    for s in range(masks.shape[1]):
        col = masks[:, s]
        resolved = col[(col > 0) & (col & (col - 1) == 0)]  # single-bit
        if len(np.unique(resolved)) > 1:
            var.append(s)
    return np.asarray(var, dtype=np.int64)


def run(
    alignment: str,
    max_breakpoints: int = 10,
    rate_classes: int = 1,
    precision: float = 1e-4,
    population: int = 16,
    mutation_rate: float = 0.15,
    small_shift_rate: float = 0.8,
    stagnant_generations: int = 10,
    improvement_threshold: float = 0.01,
    candidate_stride: int = 1,
    checkpoint: Optional[str] = None,
    seed: int = 0,
    device=None,
) -> GARDResult:
    """GARD on a nucleotide alignment, every candidate fit on ``device``
    (default ``settings.device``: the card, raising without one).
    ``rate_classes`` is accepted and, as in the JAX package, not used."""
    device = resolve_device(device)
    aln = read_alignment(alignment)
    filt = DataFilter.from_alignment(aln, "nucleotide")
    n_sites = filt.char_masks.shape[1]
    n_seqs = filt.n_sequences

    var_sites = _variable_sites(filt)
    if candidate_stride > 1:
        var_sites = var_sites[::candidate_stride]
    rng = np.random.default_rng(seed)

    # baseline: single NJ tree, GTR fit (GARD.bf:286-297)
    dist = tn93_distance(filt)
    base_tree = infer_nj_tree(dist, filt.names)
    base_freqs = freq_mod.empirical_nucleotide(filt)
    lf0 = LikelihoodFunction([Partition(filt, base_tree, GTR(base_freqs, device=device))],
                             device=device)
    res0 = lf0.fit(precision=precision)
    baseline_caic = caic(res0.loglik, res0.n_free_parameters + 3, n_sites)
    warm = {k: v for k, v in res0.params.items() if k.startswith("theta")}

    evaluator = _Evaluator(filt, var_sites, precision, warm, device)
    evaluator.cache[()] = (baseline_caic, res0.loglik)

    # resume from checkpoint (GARD.bf:204-207)
    if checkpoint and os.path.exists(checkpoint):
        with open(checkpoint) as fh:
            saved = _json.load(fh)
        for k, v in saved.get("masterList", {}).items():
            key = tuple(int(x) for x in k.split(",")) if k else ()
            evaluator.cache[key] = (float(v[0]), float(v[1]))

    def save_checkpoint():
        if not checkpoint:
            return
        with open(checkpoint, "w") as fh:
            _json.dump(
                {
                    "masterList": {
                        ",".join(map(str, k)): list(v)
                        for k, v in evaluator.cache.items()
                    },
                },
                fh,
            )

    improvements: Dict[int, Dict] = {}
    best_model: Tuple[int, ...] = ()
    best_caic = baseline_caic

    # single-breakpoint exhaustive scan (GARD.bf:343-382)
    candidates = [int(s) for s in var_sites[:-1]]
    single_scores = {}
    for bp in candidates:
        score = evaluator.evaluate((bp,))
        single_scores[bp] = score
    save_checkpoint()
    if single_scores:
        bp_best = min(single_scores, key=single_scores.get)
        if single_scores[bp_best] < best_caic:
            best_caic = single_scores[bp_best]
            best_model = (bp_best,)
            improvements[1] = {
                "breakpoints": [bp_best],
                "deltaAICc": baseline_caic - best_caic,
            }

    # GA over N >= 2 breakpoints (GARD.bf:415-560, CHC-style)
    n_potential = len(candidates)

    def random_model(n_bp: int) -> Tuple[int, ...]:
        return tuple(sorted(rng.choice(candidates, size=n_bp, replace=False)))

    def mutate(model: Tuple[int, ...]) -> Tuple[int, ...]:
        out = list(model)
        for i in range(len(out)):
            if rng.uniform() < mutation_rate:
                if rng.uniform() < small_shift_rate:
                    # small shift within the variable-site list
                    pos = int(np.searchsorted(var_sites, out[i]))
                    shift = int(rng.integers(-3, 4))
                    pos = int(np.clip(pos + shift, 0, n_potential - 1))
                    out[i] = int(candidates[min(pos, n_potential - 1)])
                else:
                    out[i] = int(rng.choice(candidates))
        return tuple(sorted(set(out))) if len(set(out)) == len(out) else model

    adding_improves = len(best_model) == 1 and n_potential > 2
    n_bp = 1
    while adding_improves and n_bp < max_breakpoints:
        n_bp += 1
        if n_potential < n_bp:
            break
        # seed population with the best (n_bp-1)-model extended
        pop = set()
        if best_model and len(best_model) == n_bp - 1:
            for _ in range(4):
                extra = int(rng.choice(candidates))
                if extra not in best_model:
                    pop.add(tuple(sorted(best_model + (extra,))))
        # at most C(candidates, n_bp) distinct models exist: the JAX package
        # draws for ever when the population asks for more (ROADMAP 3.23);
        # where it ends, the cap changes no draw
        while len(pop) < min(population, math.comb(n_potential, n_bp)):
            pop.add(random_model(n_bp))
        pop = list(pop)

        stagnant = 0
        round_best = np.inf
        round_best_model = None
        while stagnant < stagnant_generations:
            # recombine: uniform crossover of random parent pairs
            children = set()
            for _ in range(population):
                a, b = rng.choice(len(pop), 2, replace=True)
                genes = sorted(set(pop[a]) | set(pop[b]))
                if len(genes) >= n_bp:
                    child = tuple(sorted(rng.choice(genes, n_bp, replace=False)))
                    children.add(mutate(child))
            allm = list(set(pop) | children)
            scored = sorted(allm, key=lambda m: evaluator.evaluate(m))
            pop = scored[:population]
            gen_best = evaluator.evaluate(pop[0])
            if round_best - gen_best < improvement_threshold:
                stagnant += 1
            else:
                stagnant = 0
            if gen_best < round_best:
                round_best, round_best_model = gen_best, pop[0]
        save_checkpoint()

        if round_best < best_caic - improvement_threshold:
            best_caic = round_best
            best_model = round_best_model
            improvements[n_bp] = {
                "breakpoints": list(best_model),
                "deltaAICc": baseline_caic - best_caic,
            }
        else:
            adding_improves = False

    # breakpoint support: Akaike weights over evaluated single-bp models
    # (GARD.bf siteBreakPointSupport)
    site_support: Dict[int, float] = {}
    if single_scores:
        arr = np.array(list(single_scores.values()))
        mn = arr.min()
        wts = np.exp(-0.5 * (arr - mn))
        wts = wts / wts.sum()
        for (bp, _), w in zip(single_scores.items(), wts):
            if w > 1e-6:
                site_support[bp] = float(w)

    out_json = {
        "analysis": {
            "info": "GARD : Genetic Algorithms for Recombination Detection",
            "version": "0.2",
        },
        "input": {
            "file name": alignment,
            "number of sequences": n_seqs,
            "number of sites": n_sites,
        },
        "potentialBreakpoints": n_potential,
        "baselineScore": baseline_caic,
        "bestModelAICc": best_caic,
        # partition spans in the reference's format: breakpointData[p]["bps"]
        # = [first site, last site] (1-based) of partition p (GARD.bf
        # "bps" entries checked by GARD.wbf:16)
        "breakpointData": {
            str(i): {"bps": [int(lo), int(hi)]}
            for i, (lo, hi) in enumerate(
                zip([1] + [int(b) + 1 for b in best_model],
                    [int(b) for b in best_model] + [n_sites])
            )
        },
        "improvements": {str(k): v for k, v in improvements.items()},
        "siteBreakPointSupport": {str(k): v for k, v in site_support.items()},
        "totalModelCount": evaluator.evaluations,
    }
    return GARDResult(
        json=out_json,
        breakpoints=list(best_model),
        best_caic=best_caic,
        baseline_caic=baseline_caic,
        improvements=improvements,
        site_support=site_support,
    )
