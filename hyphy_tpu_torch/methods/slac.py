"""SLAC — Single-Likelihood Ancestor Counting.

Counterpart of ``hyphy_tpu/methods/slac.py`` (reference:
``SelectionAnalyses/SLAC.bf``).  Pipeline: GTR -> global MG94xREV
(proportional branch lengths — SLAC reports the stage-1 fit) -> joint ML
ancestral reconstruction (:func:`ancestral.joint_reconstruct`, on the
device, in fp64 as in the reference) -> per-site counting of
observed/expected syn/nonsyn substitutions with the path-averaged pairwise
tables -> extended binomial test.  The counting (``_leaf_state_coding``,
``compute_counts``) is the JAX package's host NumPy, copied; so is the
ancestral sampling of ``samples`` > 0 (:func:`ancestral.sample_ancestors`),
which keeps the reference's order of draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from hyphy_tpu_torch.io.json_out import analysis_json_parts, model_fit_entry
from hyphy_tpu_torch.methods import common
from hyphy_tpu_torch.methods.counting import (
    extended_binomial_tail,
    pairwise_counts,
    slac_weighting_matrix,
)
from hyphy_tpu_torch.ops import ancestral, pruning

# by-site result columns (SLAC.bf:236-247)
COLUMNS = [
    ("ES", "Expected synonymous sites"),
    ("EN", "Expected non-synonymous sites"),
    ("S", "Inferred synonymous substitutions"),
    ("N", "Inferred non-synonymous substitutions"),
    ("P[S]", "Expected proportion of synonymous sites"),
    ("dS", "Inferred synonymous susbsitution rate"),
    ("dN", "Inferred non-synonymous susbsitution rate"),
    ("dN-dS", "Scaled by the length of the tested branches"),
    ("P [dN/dS > 1]", "Binomial probability that S is no greater than the observed value, with P<sub>s</sub> probability of success"),
    ("P [dN/dS < 1]", "Binomial probability that S is no less than the observed value, with P<sub>s</sub> probability of success"),
    ("Total branch length", "The total length of branches contributing to inference at this site, and used to scale dN-dS"),
]


@dataclasses.dataclass
class SLACResult:
    json: Dict
    by_site: Dict[str, np.ndarray]   # {"RESOLVED": [sites,11], "AVERAGED": ...}
    data: common.LoadedData
    gtr: common.GTRFit
    mg94: common.MG94Fit
    ancestor_states: np.ndarray      # [n_nodes, patterns]


def _leaf_state_coding(filt):
    """Leaf codes -> SLAC state convention: >=0 resolved sense index,
    -1 fully missing, <=-2 ambiguity class (lookup table row)."""
    table = filt.resolution_table
    n_states = filt.n_states
    code_state = np.zeros(table.shape[0], dtype=np.int64)
    for row in range(table.shape[0]):
        s = table[row].sum()
        if s == 1:
            code_state[row] = int(np.argmax(table[row]))
        elif s >= n_states:
            code_state[row] = -1
        else:
            code_state[row] = -(row + 2)
    return code_state[filt.leaf_codes]  # [taxa, patterns]


def compute_counts(
    states: np.ndarray,            # [n_nodes, patterns] SLAC coding
    lookup: np.ndarray,            # resolution table [n_codes, S]
    parent: np.ndarray,            # [n_nodes]
    branch_lengths: np.ndarray,    # [n_branches]
    tested: np.ndarray,            # bool [n_branches]
    counts: Dict[str, np.ndarray],
    duplicate_map: np.ndarray,
    n_leaves: int,
):
    """Port of slac.compute_the_counts (SLAC.bf) on pattern-expanded
    site arrays; returns by-site RESOLVED/AVERAGED [sites, 11]."""
    eps, epn = counts["EPS"], counts["EPN"]
    ops, opn = counts["OPS"], counts["OPN"]
    state_count = eps.shape[0]
    sites = len(duplicate_map)
    sel = np.nonzero(tested)[0]
    lengths = branch_lengths[sel]
    total_len = lengths.sum()
    if total_len <= 0:
        raise ValueError("SLAC: tested branches have zero total length")

    resolved = np.zeros((sites, 11))
    averaged = np.zeros((sites, 11))
    by_site_scaler = np.full(sites, total_len)

    site_states = states[:, duplicate_map]   # [n_nodes, sites]

    # per-site counts of resolved tip states (for 'RESOLVED' ambig handling)
    tip_states = site_states[:n_leaves]      # [n_leaves, sites]
    tip_counts = np.zeros((sites, state_count))
    for t in range(n_leaves):
        ok = tip_states[t] >= 0
        np.add.at(tip_counts, (np.nonzero(ok)[0], tip_states[t][ok]), 1.0)

    for k, b in enumerate(sel):
        bl = lengths[k]
        if bl == 0:
            continue
        rel = bl / total_len
        ps = site_states[parent[b]]
        cs = site_states[b]

        ok = cs >= 0
        if ok.any():
            i_idx, p_idx = cs[ok], ps[ok]
            rows = np.nonzero(ok)[0]
            for mat, col in ((eps, 0), (epn, 1)):
                v = mat[i_idx, p_idx]
                resolved[rows, col] += v * rel
                averaged[rows, col] += v * rel
            for mat, col in ((ops, 2), (opn, 3)):
                v = mat[i_idx, p_idx]
                resolved[rows, col] += v
                averaged[rows, col] += v

        missing = (cs == -1) & (ps != -1)
        by_site_scaler[missing] -= bl

        amb = cs <= -2
        if amb.any():
            rows = np.nonzero(amb)[0]
            for s in rows:
                res = lookup[-cs[s] - 2]          # [S] 0/1 resolution vector
                p_state = ps[s]
                if p_state < 0:
                    continue
                rc = res.sum()
                # AVERAGED: uniform over resolutions
                averaged[s, 0] += (eps[:, p_state] @ res) / rc * rel
                averaged[s, 1] += (epn[:, p_state] @ res) / rc * rel
                averaged[s, 2] += (ops[:, p_state] @ res) / rc
                averaged[s, 3] += (opn[:, p_state] @ res) / rc
                # RESOLVED: restrict to most frequent compatible tip state
                filtered = tip_counts[s] * res
                mf = filtered.max()
                r2 = (filtered == mf) & (res > 0) if mf > 0 else res > 0
                rc2 = r2.sum()
                resolved[s, 0] += (eps[:, p_state] @ r2) / rc2 * rel
                resolved[s, 1] += (epn[:, p_state] @ r2) / rc2 * rel
                resolved[s, 2] += (ops[:, p_state] @ r2) / rc2
                resolved[s, 3] += (opn[:, p_state] @ r2) / rc2

    for mx in (resolved, averaged):
        mx[:, 10] = by_site_scaler
        scale = np.where(by_site_scaler > 0, total_len / np.maximum(by_site_scaler, 1e-300), 1.0)
        mx[:, 0] *= scale
        mx[:, 1] *= scale
        with np.errstate(divide="ignore", invalid="ignore"):
            mx[:, 4] = mx[:, 0] / (mx[:, 0] + mx[:, 1])
            mx[:, 5] = np.where(mx[:, 0] > 0, mx[:, 2] / mx[:, 0], 0.0)
            mx[:, 6] = np.where(mx[:, 1] > 0, mx[:, 3] / mx[:, 1], 0.0)
            mx[:, 7] = np.where(
                by_site_scaler > 0, (mx[:, 6] - mx[:, 5]) / np.maximum(by_site_scaler, 1e-300), 0.0
            )
        for s in range(sites):
            total_subs = mx[s, 2] + mx[s, 3]
            if total_subs > 0:
                p_s = mx[s, 4]
                syn = mx[s, 2]
                mx[s, 8] = extended_binomial_tail(total_subs, p_s, syn)
                if syn == 0:
                    mx[s, 9] = 1.0
                else:
                    mx[s, 9] = 1.0 - extended_binomial_tail(total_subs, p_s, max(0.0, syn - 1.0))
            else:
                mx[s, 8] = 1.0
                mx[s, 9] = 1.0
    return resolved, averaged


def run(
    alignment: str,
    genetic_code: str = "Universal",
    tree: Optional[str] = None,
    branches: str = "All",
    pvalue: float = 0.1,
    precision: float = 1e-5,
    samples: int = 0,
    seed: int = 0,
    device=None,
) -> SLACResult:
    """SLAC on one codon alignment (CHARSET partitions: one table each,
    under one joint MG94 fit), on ``device`` (default ``settings.device``:
    the card, raising without one).  ``pvalue`` is accepted and, as in the
    JAX package, not used.

    ``samples`` > 0 adds ancestral-uncertainty resampling: states are drawn
    from the joint ancestral posterior ``samples`` times (generator
    ``seed + partition``), counts are recomputed per draw, and per-site
    medians / 2.5% / 97.5% quantiles are reported (reference
    ``slac.handle_a_sample``, SLAC.bf:327; JSON keys SLAC.bf:107-109)."""
    md = common.load_codon_data_multi(alignment, genetic_code, tree, branches, device=device)
    common.progress("slac", f"{md.n_partitions} partition(s); fitting nucleotide GTR")
    gtr = common.fit_gtr_multi(md, precision=precision)
    md, gtr = common.kill_zero_branches_multi(md, gtr, branches)
    # SLAC reports the proportional (stage-1) MG94 fit
    common.progress("slac", f"GTR lnL {gtr.loglik:.3f}; fitting global MG94xREV")
    mg = common.fit_partitioned_mg94_multi(md, gtr, precision=precision, refit_lengths=False)
    common.progress("slac", f"MG94 lnL {mg.loglik:.3f}; counting substitutions")

    content = {}
    sample_content = {k: {} for k in ("sample-median", "sample-2.5", "sample-97.5")}
    first = None
    for p_idx, (data, mgp) in enumerate(zip(md.parts, mg.parts)):
        filt = data.codon_filter
        device = data.device
        with torch.no_grad():
            out = mgp.model.build(mgp.params, data.tree.n_branches)
            pdata = pruning.build_pruning_data(data.tree, device)
            lp = torch.as_tensor(filt.leaf_partials(), dtype=torch.float64, device=device)
            joint = ancestral.joint_reconstruct(out.p_matrices, lp, out.root_freqs, pdata)
        leaf_states = _leaf_state_coding(filt)
        all_states = np.concatenate([leaf_states, joint.internal_states.cpu().numpy()], axis=0)

        w = slac_weighting_matrix(
            {k: float(v) for k, v in mgp.params.items() if k.startswith("theta")},
            gtr.parts[p_idx].frequencies,
        )
        counts = pairwise_counts(data.genetic_code, [w, w, w])
        resolved, averaged = compute_counts(
            all_states, filt.resolution_table, data.tree.parent,
            mgp.branch_lengths, data.tested_branches, counts,
            filt.duplicate_map, filt.n_sequences,
        )
        content[str(p_idx)] = {
            "by-site": {"RESOLVED": resolved.tolist(), "AVERAGED": averaged.tolist()}
        }
        if first is None:
            first = (data, resolved, averaged, all_states)

        if samples > 0:
            rng = np.random.default_rng(seed + p_idx)
            drawn = ancestral.sample_ancestors(
                out.p_matrices.cpu().numpy(), filt.leaf_partials(),
                out.root_freqs.cpu().numpy(), pdata, data.tree.children, samples, rng,
            )
            per_sample = []
            for s in range(samples):
                st = np.concatenate([leaf_states, drawn[s]], axis=0)
                res_s, _ = compute_counts(
                    st, filt.resolution_table, data.tree.parent,
                    mgp.branch_lengths, data.tested_branches, counts,
                    filt.duplicate_map, filt.n_sequences,
                )
                per_sample.append(res_s)
            stacked = np.stack(per_sample)      # [samples, sites, cols]
            for key, tbl in (
                ("sample-median", np.median(stacked, axis=0)),
                ("sample-2.5", np.percentile(stacked, 2.5, axis=0)),
                ("sample-97.5", np.percentile(stacked, 97.5, axis=0)),
            ):
                sample_content[key][str(p_idx)] = {"by-site": {"RESOLVED": tbl.tolist()}}

    data0, resolved0, averaged0, states0 = first
    json = analysis_json_parts(
        info="SLAC (Single Likelihood Ancestor Counting) uses a maximum likelihood "
             "ancestral state reconstruction and counting approach",
        version="2.00",
        md=md,
        fits={
            "Nucleotide GTR": model_fit_entry(
                gtr.loglik, gtr.n_parameters, md.sample_size,
                frequencies=gtr.parts[0].frequencies, display_order=0,
            ),
            "Global MG94xREV": model_fit_entry(
                mg.loglik, mg.n_parameters, md.sample_size,
                frequencies=mg.parts[0].codon_freqs, display_order=1,
                rate_distributions={
                    f"non-synonymous/synonymous rate ratio for *{name}*":
                        [[float(mg.omegas[g]), 1.0]]
                    for g, name in enumerate(data0.group_names)
                },
            ),
        },
        extra={
            "MLE": {"headers": [[c[0], c[1]] for c in COLUMNS], "content": content},
            **{key: blk for key, blk in sample_content.items() if blk},
        },
    )
    return SLACResult(
        json=json,
        by_site={"RESOLVED": resolved0, "AVERAGED": averaged0},
        data=data0, gtr=gtr.parts[0], mg94=mg.parts[0],
        ancestor_states=states0,
    )
