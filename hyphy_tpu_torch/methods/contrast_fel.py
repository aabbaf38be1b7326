"""Contrast-FEL — per-site tests for *different* selective pressure
between branch sets.

Counterpart of ``hyphy_tpu/methods/contrast_fel.py`` (reference
``SelectionAnalyses/contrast-fel.bf``).  Pipeline: nucleotide GTR fit ->
global MG94xREV fit (one omega per branch set) -> per-site fits with a
shared synonymous scaler (alpha) and one non-synonymous scaler (beta) per
branch set:

- alternative: all scalers free, seeded from the cartesian {0.1, 1} grid
  over beta scalers (contrast-fel.bf:747-764);
- overall null: all *testable* betas equal (background tied too when only
  one testable set), started from their mean (contrast-fel.bf:824-845);
  LRT df = max(1, n_testable - 1) (contrast-fel.bf:884-886);
- pairwise nulls for >2 testable sets (df=1 each, contrast-fel.bf:855-880);
- Holm-Bonferroni over the per-site test family (contrast-fel.bf:911),
  Benjamini-Hochberg FDR over sites on the overall p-value
  (contrast-fel.bf:508-517).

Per-branch-set substitution counts come from the joint ML ancestral
reconstruction (contrast-fel.bf:786-800), as in SLAC, in fp64.

The per-site route is FEL's (:func:`fel.site_log_likelihood`) with the
branch sets as its group vector, G = testable sets + background: fp64
spectral as the reference, fp32 (the card's default) the Taylor vector
action.  Every site of a stage is fitted at once, as in FEL: the sites
split over the mesh that ``settings.mesh`` names, each block from a host
thread of its own with the objective built on its device, and on each
device in chunks by the block's share of its free memory.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hyphy_tpu_torch.config import resolve_device, settings
from hyphy_tpu_torch.data.alignment import read_alignment
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.data.genetic_code import GeneticCode
from hyphy_tpu_torch.io.json_out import analysis_json, model_fit_entry
from hyphy_tpu_torch.methods import common, fel
from hyphy_tpu_torch.methods.slac import _leaf_state_coding
from hyphy_tpu_torch.models.parameters import ParamSpec
from hyphy_tpu_torch.ops import ancestral, pruning
from hyphy_tpu_torch.optimize.batched import grid_best_starts
from hyphy_tpu_torch.optimize.nelder_mead import vmapped_nelder_mead
from hyphy_tpu_torch.parallel.mesh import per_device, sharded_site_solve
from hyphy_tpu_torch.tree.topology import Tree


def holm_bonferroni(pvals: Dict[str, float]) -> Dict[str, float]:
    """math.HolmBonferroniCorrection (libv3/convenience/math.bf)."""
    items = sorted(pvals.items(), key=lambda kv: kv[1])
    n = len(items)
    out, running = {}, 0.0
    for rank, (k, p) in enumerate(items):
        adj = min(1.0, (n - rank) * p)
        running = max(running, adj)
        out[k] = running
    return out


def benjamini_hochberg(pvals: np.ndarray) -> np.ndarray:
    """math.BenjaminiHochbergFDR: q-value per site."""
    n = len(pvals)
    order = np.argsort(pvals)
    q = np.empty(n)
    prev = 1.0
    for rank in range(n - 1, -1, -1):
        i = order[rank]
        prev = min(prev, pvals[i] * n / (rank + 1))
        q[i] = prev
    return q


@dataclasses.dataclass
class ContrastFELResult:
    json: Dict
    site_table: np.ndarray
    headers: List
    group_names: List[str]
    data: common.LoadedData


def load_multigroup(
    alignment: str,
    genetic_code: str,
    tree_newick: Optional[str],
    test_labels: Optional[Sequence[str]] = None,
    device=None,
) -> common.LoadedData:
    """load_file with one group per tested branch label; unlabeled branches
    form the background set (contrast-fel.bf branch-set selection).  The
    fits that take this data run on ``device``."""
    device = resolve_device(device)
    aln = read_alignment(alignment)
    gc = GeneticCode(genetic_code)
    nuc = DataFilter.from_alignment(aln, "nucleotide")
    cod = DataFilter.from_alignment(aln, "codon", genetic_code=gc)
    if tree_newick is None:
        if not aln.trees:
            raise ValueError("no tree in alignment file; pass tree_newick")
        tree_newick = next(iter(aln.trees.values()))
    tree = Tree.from_newick(tree_newick, leaf_order=nuc.names)

    labels = test_labels or tree.label_set()
    if not labels:
        raise ValueError("contrast-FEL requires >=1 labeled branch set")
    groups = np.full(tree.n_branches, len(labels), dtype=np.int32)  # background id
    for g, lbl in enumerate(labels):
        groups[tree.select_branches(lbl)] = g
    has_background = bool((groups == len(labels)).any())
    group_names = list(labels) + (["background"] if has_background else [])
    return common.LoadedData(
        alignment=aln, nuc_filter=nuc, codon_filter=cod, tree=tree,
        genetic_code=gc, tested_branches=groups < len(labels), branch_groups=groups,
        group_names=group_names, device=device,
    )


def set_counts(data: common.LoadedData):
    """(testable sets, background present, G = all sets)."""
    n_testable = len([g for g in data.group_names if g != "background"])
    has_background = "background" in data.group_names
    return n_testable, has_background, n_testable + int(has_background)


def holm_family(p_overall: np.ndarray, p_pairwise: np.ndarray, pairs) -> np.ndarray:
    """``[patterns, 1 + pairs]``: each site's overall and pairwise p-values
    Holm-Bonferroni corrected as one family (contrast-fel.bf:911)."""
    p_corr = np.empty((p_overall.shape[0], 1 + len(pairs)))
    for s in range(p_overall.shape[0]):
        fam = {"overall": p_overall[s]}
        for j, (g1, g2) in enumerate(pairs):
            fam[f"{g1}|{g2}"] = p_pairwise[s, j]
        adj = holm_bonferroni(fam)
        p_corr[s, 0] = adj["overall"]
        for j, (g1, g2) in enumerate(pairs):
            p_corr[s, 1 + j] = adj[f"{g1}|{g2}"]
    return p_corr


def lrt_pvalues(alt_lnl, null_lnl, pair_lnl, n_testable: int, df_overall: int,
                df_pair: int):
    """Overall and pairwise chi^2 p-values, Holm-corrected per site;
    returns (p_corr, pairs)."""
    lrt_overall = np.maximum(2.0 * (alt_lnl - null_lnl), 0.0)
    p_overall = np.array([common.chi2_sf(x, df_overall) for x in lrt_overall])
    pairs = list(itertools.combinations(range(n_testable), 2)) if n_testable > 2 else []
    p_pairwise = np.ones((alt_lnl.shape[0], len(pairs)))
    for j in range(len(pairs)):
        lrt_j = np.maximum(2.0 * (alt_lnl - pair_lnl[:, j]), 0.0)
        p_pairwise[:, j] = [common.chi2_sf(x, df_pair) for x in lrt_j]
    return holm_family(p_overall, p_pairwise, pairs), pairs


def global_fits(data: common.LoadedData, precision: float):
    gtr = common.fit_gtr(data, precision=precision)
    common.progress("contrast", f"GTR lnL {gtr.loglik:.3f}; fitting global MG94xREV")
    mg = common.fit_partitioned_mg94(data, gtr, precision=precision)
    common.progress("contrast", f"MG94 lnL {mg.loglik:.3f}; per-site fits")
    return gtr, mg


def fit_sites(data: common.LoadedData, mg: common.MG94Fit, srv: bool):
    """The per-site stage: the alternative from the {0.1, 1} start grid, the
    overall null and the pairwise nulls, every pattern at once, split over
    the mesh that ``settings.mesh`` names and in chunks on each device.
    Returns numpy (alpha [n], betas [n, G], alt lnL, null lnL, pairwise lnL
    [n, pairs])."""
    n_testable, has_background, n_groups = set_counts(data)
    model = mg.model
    device = model.device
    dtype = settings.likelihood_dtype(device)
    groups = np.asarray(data.branch_groups)
    beta_names = [f"beta_{g}" for g in range(n_groups)]
    rate = ParamSpec(init=1.0, lower=0.0, upper=10000.0)
    # cartesian {0.1, 1} start grid per beta scaler (contrast-fel.bf:747)
    combos = np.array(list(itertools.product([0.1, 1.0], repeat=n_groups)))
    specs = {name: rate for name in beta_names}
    if srv:
        specs["alpha"] = rate
    tie_background = has_background and n_testable == 1
    pairs = list(itertools.combinations(range(n_testable), 2)) if n_testable > 2 else []

    @per_device
    def make_solver(dev):
        """The objectives and the fit of every item, on ``dev``."""
        loglik = fel.site_log_likelihood(data, mg.to(dev), dtype,
                                         spectral=dtype == torch.float64, groups=groups)
        f64 = dict(dtype=torch.float64, device=dev)
        grid = {name: torch.tensor(combos[:, g], **f64) for g, name in enumerate(beta_names)}
        if srv:
            grid["alpha"] = torch.ones(len(combos), **f64)

        def alpha(idx, p):
            return p["alpha"] if srv else torch.ones(idx.shape[0], **f64)

        def alt_loglik(idx, p):
            return loglik(idx, alpha(idx, p), torch.stack([p[n] for n in beta_names], dim=1))

        def fit(idx):
            starts, _ = grid_best_starts(alt_loglik, grid, idx)
            alt_params, alt_lnl = vmapped_nelder_mead(alt_loglik, specs, starts, idx)
            betas_alt = torch.stack([alt_params[n] for n in beta_names], dim=1)     # [N, G]

            # overall null: all testable betas equal (background tied when only
            # one testable set), contrast-fel.bf:836-845
            null_specs = {"beta_common": rate}
            null_start = {"beta_common": betas_alt[:, :n_testable].mean(dim=1)}
            if has_background and not tie_background:
                null_specs["beta_bg"] = rate
                null_start["beta_bg"] = alt_params[beta_names[-1]]
            if srv:
                null_specs["alpha"] = rate
                denom = n_testable + int(has_background)
                null_start["alpha"] = torch.clamp_max(
                    (alt_params["alpha"] + denom * betas_alt.sum(dim=1)) / denom, 10.0)

            def null_loglik(i, p):
                parts = [p["beta_common"]] * n_testable
                if has_background:
                    parts.append(p["beta_common"] if tie_background else p["beta_bg"])
                return loglik(i, alpha(i, p), torch.stack(parts, dim=1))

            _, null_lnl = vmapped_nelder_mead(null_loglik, null_specs, null_start, idx)

            # pairwise nulls for >2 testable sets: beta_g2 := beta_g1 (df = 1)
            pair_lnls = []
            for g1, g2 in pairs:
                p_specs = {k: v for k, v in specs.items() if k != beta_names[g2]}
                p_start = {k: alt_params[k] for k in p_specs}

                def pair_loglik(i, p, g1=g1, g2=g2):
                    parts = [p[beta_names[g1]] if g == g2 else p[beta_names[g]]
                             for g in range(n_groups)]
                    return loglik(i, alpha(i, p), torch.stack(parts, dim=1))

                pair_lnls.append(vmapped_nelder_mead(pair_loglik, p_specs, p_start, idx)[1])
            pair_lnl = (torch.stack(pair_lnls, dim=1) if pair_lnls
                        else torch.zeros((idx.shape[0], 0), **f64))
            return {"alpha": alpha(idx, alt_params), "betas": betas_alt, "alt_lnl": alt_lnl,
                    "null_lnl": null_lnl, "pair_lnl": pair_lnl}
        return fit

    out = sharded_site_solve(make_solver, data.codon_filter.n_patterns,
                             fel._site_bytes(data, dtype, model.n_states, n_groups), device)
    return tuple(out[k].double().cpu().numpy()
                 for k in ("alpha", "betas", "alt_lnl", "null_lnl", "pair_lnl"))


def substitution_counts(data: common.LoadedData, mg: common.MG94Fit,
                        n_groups: int) -> np.ndarray:
    """``[n_groups, sites]`` substitution counts from the joint ML ancestral
    states (contrast-fel.bf:786-800 via ancestral.ComputeSubstitutionCounts),
    reconstructed in fp64 on the model's device."""
    filt = data.codon_filter
    model = mg.model
    with torch.no_grad():
        out = model.build(mg.params, data.tree.n_branches)
        lp = torch.as_tensor(filt.leaf_partials(), dtype=torch.float64, device=model.device)
        joint = ancestral.joint_reconstruct(out.p_matrices.double(), lp, out.root_freqs,
                                            pruning.build_pruning_data(data.tree, model.device))
    # [nodes, patterns]; < 0: unresolved or ambiguous (not counted)
    states = np.concatenate([_leaf_state_coding(filt), joint.internal_states.cpu().numpy()],
                            axis=0)
    parent = data.tree.parent
    dup = filt.duplicate_map
    counts = np.zeros((n_groups, len(dup)))
    for b in range(data.tree.n_branches):
        child = states[b][dup]
        par = states[parent[b]][dup]
        counts[data.branch_groups[b]] += (child != par) & (child >= 0) & (par >= 0)
    return counts


def global_fit_entries(data: common.LoadedData, gtr, mg) -> Dict:
    return {
        "Nucleotide GTR": model_fit_entry(
            gtr.loglik, gtr.n_parameters, data.sample_size,
            frequencies=gtr.frequencies, display_order=0,
        ),
        "Global MG94xREV": model_fit_entry(
            mg.loglik, mg.n_parameters, data.sample_size,
            frequencies=mg.codon_freqs, display_order=1,
            rate_distributions={
                f"non-synonymous/synonymous rate ratio for *{name}*":
                    [[float(mg.omegas[g]), 1.0]]
                for g, name in enumerate(data.group_names)
            },
        ),
    }


def run(
    alignment: str,
    genetic_code: str = "Universal",
    tree: Optional[str] = None,
    test_labels: Optional[Sequence[str]] = None,
    srv: bool = True,
    pvalue: float = 0.05,
    qvalue: float = 0.20,
    precision: float = 1e-5,
    device=None,
) -> ContrastFELResult:
    """Contrast-FEL on one codon alignment, on ``device`` (default
    ``settings.device``: the card, raising without one).  ``test_labels``:
    the tested branch sets (default: every label of the tree)."""
    data = load_multigroup(alignment, genetic_code, tree, test_labels, device=device)
    gtr, mg = global_fits(data, precision)
    filt = data.codon_filter
    n_testable, _, n_groups = set_counts(data)

    alpha_alt, betas_alt, alt_lnl, null_lnl, pair_lnl = fit_sites(data, mg, srv)
    p_corr, pairs = lrt_pvalues(alt_lnl, null_lnl, pair_lnl, n_testable,
                                max(1, n_testable - 1), 1)
    constant = filt.constant_pattern_mask()
    p_corr[constant] = 1.0
    alpha_alt[constant] = 0.0
    betas_alt[constant] = 0.0

    dup = filt.duplicate_map
    q_overall = benjamini_hochberg(p_corr[dup, 0])
    common.progress("contrast", "substitution counts from the joint ancestral states")
    subs_by_group = substitution_counts(data, mg, n_groups)

    cols = (
        [alpha_alt[dup][:, None], betas_alt[dup]]
        + [subs_by_group.T]
        + [p_corr[dup, 0:1], q_overall[:, None]]
        + ([p_corr[dup, 1:]] if pairs else [])
    )
    site_table = np.concatenate(cols, axis=1)

    headers = [["alpha", "Synonymous substitution rate at a site"]]
    for name in data.group_names:
        headers.append(
            [f"beta ({name})",
             f"Non-synonymous substitution rate at a site for {name} branches"]
        )
    for name in data.group_names:
        headers.append([f"subs ({name})", f"Substitutions mapped to {name} branches"])
    headers.append(["P-value (overall)", "Overall p-value that non-synonymous rates differ between groups (Holm-Bonferroni)"])
    headers.append(["Q-value (overall)", "Benjamini-Hochberg q-value for the overall test"])
    for (g1, g2) in pairs:
        headers.append(
            [f"P-value for {data.group_names[g1]} vs {data.group_names[g2]}",
             "Pairwise difference test (Holm-Bonferroni corrected)"]
        )

    json = analysis_json(
        info="Contrast-FEL (Fixed Effects Likelihood) investigates whether "
             "selective pressures differ between two or more sets of branches "
             "at a site",
        version="0.5",
        data=data,
        fits=global_fit_entries(data, gtr, mg),
        extra={
            "MLE": {"headers": headers, "content": {"0": site_table.tolist()}},
            "test results": {
                "P-value threshold": pvalue,
                "tested": n_testable,
                "significant sites (LRT)": int((p_corr[dup, 0] <= pvalue).sum()),
                "significant sites (FDR)": int((q_overall <= qvalue).sum()),
            },
        },
    )
    return ContrastFELResult(
        json=json, site_table=site_table, headers=headers,
        group_names=data.group_names, data=data,
    )
