"""Contrast-MEME — per-site tests for *different* episodic selective
pressure between branch sets.

Counterpart of ``hyphy_tpu/methods/contrast_meme.py`` (reference
``SelectionAnalyses/contrast-meme.bf``).  Pipeline: nucleotide GTR fit ->
global MG94xREV fit -> per-site fits of a 2-class BS_REL mixture per branch
set: branch b in set g gets

    P_b = prop_g * expm(bl_b * (alpha*Qs + beta1_g*Qn))
        + (1-prop_g) * expm(bl_b * (alpha*Qs + beta2_g*Qn))

with a shared synonymous scaler alpha (free under --srv, else := 1;
contrast-meme.bf:704-722).

- alternative: all (beta1, beta2, prop) free per set, seeded from a
  Latin-hypercube start grid over [0,1] (contrast-meme.bf:771-784);
- overall null: all *testable* sets share (beta1, beta2, prop)
  (background tied too when only one testable set), started from their
  means (contrast-meme.bf:837-864); LRT df = max(3, 3*(n_testable-1))
  (contrast-meme.bf:905);
- pairwise nulls for >2 testable sets (df=3 each,
  contrast-meme.bf:873-899);
- Holm-Bonferroni within each site's test family (contrast-meme.bf:932),
  Benjamini-Hochberg FDR over sites;
- optional permutation test: for sites with min p <= pvalue the branch set
  assignment is shuffled ``permutations`` times and the overall test
  refitted; reported as (1 + #{perm p <= observed}) / (1 + N)
  (contrast-meme.bf:944-958 up to its early stop).

Per-branch-set substitution counts come from the joint ML ancestral
reconstruction, as in contrast-FEL.

The per-site route is MEME's mixture route with 2 families per set: fp64
the spectral mixture, fp32 (the card's default) the Taylor ``mix_weights``
mode.  Each item carries its own branch-to-set map, scattered into the
routes' per-item weight table (``pruning.dense_mixture_weights``): the data's for the site fits, a permuted one for each
permutation job, so every (site, permutation) pair is one item of one
batched solve.  The items split over the mesh that ``settings.mesh`` names,
each block from a host thread of its own with :class:`SetMixture` and its
item tables built on its device (the permutations and the start grid are
drawn on the host first), and on each device in chunks by the block's
share of its free memory.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hyphy_tpu_torch.config import canonical_device, settings
from hyphy_tpu_torch.io.json_out import analysis_json
from hyphy_tpu_torch.methods import common, fel
from hyphy_tpu_torch.methods.contrast_fel import (
    benjamini_hochberg,
    global_fit_entries,
    global_fits,
    load_multigroup,
    lrt_pvalues,
    set_counts,
    substitution_counts,
)
from hyphy_tpu_torch.models.base import fill_diagonal_from_rows
from hyphy_tpu_torch.models.parameters import ParamSpec
from hyphy_tpu_torch.ops import expm as expm_ops
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.optimize.batched import grid_best_starts
from hyphy_tpu_torch.optimize.nelder_mead import vmapped_nelder_mead
from hyphy_tpu_torch.parallel.mesh import per_device, sharded_site_solve, to_device

_PREFIXES = ("b1", "b2", "pr")
_N_LHC = 24


@dataclasses.dataclass
class ContrastMEMEResult:
    json: Dict
    site_table: np.ndarray
    headers: List
    group_names: List[str]
    data: common.LoadedData


@dataclasses.dataclass
class SetMixture:
    """Contrast-MEME's per-site likelihood at the global MG94 fit.

    ``loglik(sites [N], a [N], b1, b2, prop [N, G], groups=None) -> [N]``:
    data pattern ``sites[n]`` under the per-set two-class mixtures, each
    branch on its set's pair of families (2g: beta1_g, 2g+1: beta2_g);
    ``groups`` ``[N, branches]`` gives each item its own branch-to-set map
    (default: the data's).  ``item_bytes``: one item's working set."""

    loglik: object
    n_groups: int
    item_bytes: float


def set_mixture(data: common.LoadedData, mg: common.MG94Fit, dtype: torch.dtype,
                spectral: bool) -> SetMixture:
    model = mg.model
    device = model.device
    _, _, n_groups = set_counts(data)
    q_syn, q_non = fel._site_bases(mg, False)(None, None)              # [1, S, S]
    alpha_hat = torch.as_tensor(mg.alphas, device=device).to(dtype)
    freqs = model.frequencies.to(dtype)
    data_leaves = torch.as_tensor(data.codon_filter.leaf_partials(), device=device)
    data_leaves = data_leaves.to(dtype).transpose(0, 1).contiguous()  # [patterns, taxa, S]
    pdata = pruning.build_pruning_data(data.tree, device)
    n_terms = expm_ops.taylor_action_terms(dtype)
    data_groups = torch.as_tensor(np.asarray(data.branch_groups), dtype=torch.int64,
                                  device=device)

    def loglik(sites, a, b1, b2, prop, groups=None):
        n = sites.shape[0]
        betas = torch.stack([b1, b2], dim=2).reshape(n, 2 * n_groups)   # [N, 2G]
        m = fill_diagonal_from_rows(
            a[:, None, None, None] * q_syn[:, None] + betas[:, :, None, None] * q_non[:, None]
        ).to(dtype)
        if groups is None:
            groups = data_groups.expand(n, -1)
        pw = torch.gather(prop, 1, groups).to(dtype)                    # [N, B]
        weights = pruning.dense_mixture_weights(
            torch.stack([pw, 1.0 - pw], dim=2),
            torch.stack([2 * groups, 2 * groups + 1], dim=2), 2 * n_groups)  # [N, B, 2G]
        leaf_vectors = data_leaves[sites]
        if spectral:
            left, lam, right = expm_ops.reversible_spectral(m, freqs)
            return pruning.single_site_log_likelihood_spectral_mixture(
                left, lam, right, weights, alpha_hat, leaf_vectors, freqs, pdata)
        qn, m2p, r, j = expm_ops.taylor_action_factors(m, alpha_hat)
        return pruning.single_site_log_likelihood_taylor(
            qn, m2p, r.transpose(1, 2), j.transpose(1, 2), None, n_terms, leaf_vectors,
            freqs, pdata, mix_weights=weights)

    # MEME's item rule (meme.mixture_sites) with 2G families
    itemsize = torch.finfo(dtype).bits // 8
    s, n_fam = model.n_states, 2 * n_groups
    item_bytes = itemsize * (s * (8 * (data.tree.n_nodes + 1) + n_fam * 14 * s)
                             + n_fam * data.tree.n_branches)
    return SetMixture(loglik=loglik, n_groups=n_groups, item_bytes=item_bytes)


def _names(n_groups: int):
    return {pre: [f"{pre}_{g}" for g in range(n_groups)] for pre in _PREFIXES}


def _specs(n_groups: int, srv: bool):
    specs = {}
    names = _names(n_groups)
    for n in names["b1"] + names["b2"]:
        specs[n] = ParamSpec(init=0.5, lower=0.0, upper=10000.0)
    for n in names["pr"]:
        # terms.range_almost_01 (contrast-meme.bf:389)
        specs[n] = ParamSpec(init=0.7, lower=1e-6, upper=1.0 - 1e-6)
    if srv:
        specs["alpha"] = ParamSpec(init=1.0, lower=0.0, upper=10000.0)
    return specs


def _start_grid(n_groups: int, srv: bool, device) -> Dict[str, torch.Tensor]:
    """The Latin-hypercube start grid over [0, 1] per scaler
    (contrast-meme.bf:771-784), drawn from ``default_rng(7)`` in the JAX
    package's order."""
    rng = np.random.default_rng(7)
    names = _names(n_groups)
    grid = {}
    for n in names["b1"] + names["b2"] + names["pr"]:
        strata = (np.arange(_N_LHC) + rng.random(_N_LHC)) / _N_LHC
        grid[n] = torch.as_tensor(rng.permutation(strata), dtype=torch.float64, device=device)
    if srv:
        grid["alpha"] = torch.ones(_N_LHC, dtype=torch.float64, device=device)
    return grid


class _Model:
    """The alternative, null and pairwise objectives over items that map
    to data patterns ``sites[i]`` with branch-to-set maps ``groups[i]``
    (None: the data's)."""

    def __init__(self, mix: SetMixture, data: common.LoadedData, srv: bool, sites, groups):
        self.mix, self.srv, self.sites, self.groups = mix, srv, sites, groups
        n_testable, has_background, n_groups = set_counts(data)
        self.n_testable, self.has_background, self.n_groups = n_testable, has_background, n_groups
        self.tie_background = has_background and n_testable == 1
        self.n_tied = n_testable + int(self.tie_background)
        self.names = _names(n_groups)

    def _call(self, idx, p, b1, b2, prop):
        a = p["alpha"] if self.srv else torch.ones(idx.shape[0], dtype=torch.float64,
                                                    device=idx.device)
        groups = None if self.groups is None else self.groups[idx]
        return self.mix.loglik(self.sites[idx], a, b1, b2, prop, groups)

    def alternative(self, idx, p):
        b1, b2, pr = (torch.stack([p[n] for n in self.names[pre]], dim=1) for pre in _PREFIXES)
        return self._call(idx, p, b1, b2, pr)

    def null(self, idx, p):
        def reps(pre):
            parts = [p[f"{pre}_c"]] * self.n_tied
            if self.n_tied < self.n_groups:
                parts.append(p[f"{pre}_bg"])
            return torch.stack(parts, dim=1)

        return self._call(idx, p, reps("b1"), reps("b2"), torch.clamp(reps("pr"), 1e-6, 1 - 1e-6))

    def pair(self, g1: int, g2: int):
        def objective(idx, p):
            vecs = [torch.stack([p[names[g1]] if g == g2 else p[names[g]]
                                 for g in range(self.n_groups)], dim=1)
                    for names in (self.names[pre] for pre in _PREFIXES)]
            return self._call(idx, p, *vecs)
        return objective

    def null_specs(self, specs):
        out = {f"{pre}_c": specs[self.names[pre][0]] for pre in _PREFIXES}
        if self.has_background and not self.tie_background:
            for pre in _PREFIXES:
                out[f"{pre}_bg"] = specs[self.names[pre][-1]]
        if self.srv:
            out["alpha"] = specs["alpha"]
        return out


def alternative_stage(model: _Model, specs, grid, idx):
    """The alternative fits from the best Latin-hypercube start."""
    starts, _ = grid_best_starts(model.alternative, grid, idx)
    return vmapped_nelder_mead(model.alternative, specs, starts, idx)


def null_stage(model: _Model, specs, idx, alt_params):
    """The overall null, started from the alternative's means over the tied
    sets (contrast-meme.bf:837-864)."""
    def mean_over_tied(names):
        return sum(alt_params[n] for n in names[: model.n_tied]) / model.n_tied

    start = {"b1_c": mean_over_tied(model.names["b1"]),
             "b2_c": mean_over_tied(model.names["b2"]),
             "pr_c": torch.clamp(mean_over_tied(model.names["pr"]), 1e-6, 1 - 1e-6)}
    if model.has_background and not model.tie_background:
        for pre in _PREFIXES:
            start[f"{pre}_bg"] = alt_params[model.names[pre][-1]]
    if model.srv:
        start["alpha"] = alt_params["alpha"]
    return vmapped_nelder_mead(model.null, model.null_specs(specs), start, idx)


def pairwise_stage(model: _Model, specs, idx, alt_params):
    """``[N, pairs]`` lnL of the pairwise nulls (set g2 := set g1) for more
    than two testable sets."""
    lnls = []
    if model.n_testable > 2:
        for g1, g2 in itertools.combinations(range(model.n_testable), 2):
            dropped = {model.names[pre][g2] for pre in _PREFIXES}
            p_specs = {k: v for k, v in specs.items() if k not in dropped}
            p_start = {k: alt_params[k] for k in p_specs}
            lnls.append(vmapped_nelder_mead(model.pair(g1, g2), p_specs, p_start, idx)[1])
    if not lnls:
        return torch.zeros((idx.shape[0], 0), dtype=torch.float64, device=idx.device)
    return torch.stack(lnls, dim=1)


def permutation_stage(model: _Model, specs, grid, idx):
    """One permutation job per item: the alternative from the start grid and
    the overall null from fixed starts, under the item's permuted map.
    Returns (alternative lnL, null lnL)."""
    _, alt_lnl = alternative_stage(model, specs, grid, idx)
    null_specs = model.null_specs(specs)
    n, f64 = idx.shape[0], dict(dtype=torch.float64, device=idx.device)
    start = {"b1_c": torch.full((n,), 0.5, **f64), "b2_c": torch.full((n,), 0.5, **f64),
             "pr_c": torch.full((n,), 0.7, **f64)}
    for pre in _PREFIXES:
        if f"{pre}_bg" in null_specs:
            start[f"{pre}_bg"] = start[f"{pre}_c"]
    if model.srv:
        start["alpha"] = torch.ones(n, **f64)
    _, null_lnl = vmapped_nelder_mead(model.null, null_specs, start, idx)
    return alt_lnl, null_lnl


def _site_solve(data: common.LoadedData, mg: common.MG94Fit, srv: bool, sites: np.ndarray,
                groups: Optional[np.ndarray], stage) -> Dict[str, torch.Tensor]:
    """``stage(model, specs, grid, idx) -> {k: [n, ...]}`` over the items
    that map to data patterns ``sites`` with branch-to-set maps ``groups``
    (``[items, branches]``; None: the data's), split over the mesh that
    ``settings.mesh`` names: on each block's device its :class:`SetMixture`,
    its item tables and a copy of the start grid, drawn once here."""
    dev = canonical_device(mg.model.device)
    dtype = settings.likelihood_dtype(dev)
    _, _, n_groups = set_counts(data)
    specs = _specs(n_groups, srv)
    grid = _start_grid(n_groups, srv, dev)
    mix = set_mixture(data, mg, dtype, spectral=dtype == torch.float64)

    @per_device
    def make_solver(d):
        mix_d = mix if d == dev else set_mixture(data, mg.to(d), dtype,
                                                 spectral=dtype == torch.float64)
        model = _Model(mix_d, data, srv, torch.as_tensor(sites, device=d),
                       None if groups is None
                       else torch.as_tensor(groups, dtype=torch.int64, device=d))
        grid_d = {k: to_device(v, d) for k, v in grid.items()}
        return lambda idx: stage(model, specs, grid_d, idx)

    return sharded_site_solve(make_solver, len(sites), mix.item_bytes, dev)


def fit_sites(data: common.LoadedData, mg: common.MG94Fit, srv: bool) -> Dict[str, np.ndarray]:
    """The per-site stage: every pattern's alternative from the best
    Latin-hypercube start, its overall null and its pairwise nulls.
    Returns numpy {alpha, b1, b2, pr (each [n, G] but alpha), alt_lnl,
    null_lnl, pair_lnl [n, pairs]}."""
    names = _names(set_counts(data)[2])

    def fit(model, specs, grid, idx):
        alt_params, alt_lnl = alternative_stage(model, specs, grid, idx)
        _, null_lnl = null_stage(model, specs, idx, alt_params)
        out = {"alt_lnl": alt_lnl, "null_lnl": null_lnl,
               "pair_lnl": pairwise_stage(model, specs, idx, alt_params),
               "alpha": (alt_params["alpha"] if srv else
                         torch.ones(idx.shape[0], dtype=torch.float64, device=idx.device))}
        for pre in _PREFIXES:
            out[pre] = torch.stack([alt_params[n] for n in names[pre]], dim=1)
        return out

    fitted = _site_solve(data, mg, srv, np.arange(data.codon_filter.n_patterns), None, fit)
    return {k: v.double().cpu().numpy() for k, v in fitted.items()}


def permutation_lrts(data: common.LoadedData, mg: common.MG94Fit, srv: bool,
                     job_sites: np.ndarray, job_groups: np.ndarray) -> np.ndarray:
    """``[jobs]`` overall LRTs of the permutation jobs: pattern
    ``job_sites[j]`` under the branch-to-set map ``job_groups[j]``, both
    drawn by the caller."""
    def fit(model, specs, grid, idx):
        alt, null = permutation_stage(model, specs, grid, idx)
        return {"alt_lnl": alt, "null_lnl": null}

    perm = _site_solve(data, mg, srv, job_sites, job_groups, fit)
    return np.maximum(2.0 * (perm["alt_lnl"].double().cpu().numpy()
                             - perm["null_lnl"].double().cpu().numpy()), 0.0)


def run(
    alignment: str,
    genetic_code: str = "Universal",
    tree: Optional[str] = None,
    test_labels: Optional[Sequence[str]] = None,
    srv: bool = True,
    pvalue: float = 0.05,
    qvalue: float = 0.20,
    permutations: int = 0,
    permutation_seed: int = 0,
    precision: float = 1e-5,
    device=None,
) -> ContrastMEMEResult:
    """Contrast-MEME on one codon alignment, on ``device`` (default
    ``settings.device``: the card, raising without one)."""
    data = load_multigroup(alignment, genetic_code, tree, test_labels, device=device)
    gtr, mg = global_fits(data, precision)
    filt = data.codon_filter
    n_patterns = filt.n_patterns
    n_testable, _, n_groups = set_counts(data)
    groups = np.asarray(data.branch_groups)

    common.progress("contrast-meme", "per-site alternative, null and pairwise fits")
    fitted = fit_sites(data, mg, srv)
    alpha_alt, b1_alt, b2_alt, pr_alt, alt_lnl, null_lnl, pair_lnl = (
        fitted[k] for k in ("alpha", "b1", "b2", "pr", "alt_lnl", "null_lnl", "pair_lnl"))

    df_overall = max(3, 3 * (n_testable - 1))
    p_corr, pairs = lrt_pvalues(alt_lnl, null_lnl, pair_lnl, n_testable, df_overall, 3)
    constant = filt.constant_pattern_mask()
    p_corr[constant] = 1.0
    alpha_alt[constant] = 0.0
    b1_alt[constant] = 0.0
    b2_alt[constant] = 0.0

    # -- permutation test on significant sites ---------------------------------
    perm_p = np.full(n_patterns, -1.0)
    min_p = p_corr.min(axis=1)
    sig_sites = np.nonzero((min_p <= pvalue) & ~constant)[0]
    if permutations > 0 and sig_sites.size:
        rng_p = np.random.default_rng(permutation_seed)
        job_sites, job_groups = [], []
        for s in sig_sites:
            for _ in range(permutations):
                job_sites.append(s)
                job_groups.append(rng_p.permutation(groups))
        common.progress("contrast-meme", f"{len(job_sites)} permutation jobs")
        lrt_perm = permutation_lrts(data, mg, srv, np.array(job_sites),
                                    np.stack(job_groups)).reshape(sig_sites.size, permutations)
        p_perm_overall = np.vectorize(lambda x: common.chi2_sf(x, df_overall))(lrt_perm)
        for r, s in enumerate(sig_sites):
            hits = (p_perm_overall[r] <= min_p[s] + 1e-12).sum()
            perm_p[s] = (1.0 + hits) / (1.0 + permutations)

    dup = filt.duplicate_map
    q_overall = benjamini_hochberg(p_corr[dup, 0])
    common.progress("contrast-meme", "substitution counts from the joint ancestral states")
    subs_by_group = substitution_counts(data, mg, n_groups)

    # alt-fit total tree length (reference: last column, store_results)
    with torch.no_grad():
        q_syn, q_non = mg.model.combined_basis_matrices(mg.params)
        freqs = mg.model.frequencies
        rate_syn = float(q_syn.sum(-1) @ freqs)
        rate_non = float(q_non.sum(-1) @ freqs)
    mean_beta = (pr_alt * b1_alt + (1.0 - pr_alt) * b2_alt)[:, groups]      # [n, B]
    a_col = np.where(constant, 0.0, alpha_alt)
    bl = (a_col[:, None] * rate_syn + mean_beta * rate_non) * np.asarray(mg.alphas)[None, :] / 3.0
    total_bl = bl.sum(axis=1)
    total_bl[constant] = 0.0

    cols = [alpha_alt[dup][:, None]]
    headers = [["alpha", "Synonymous substitution rate at a site"]]
    for g, name in enumerate(data.group_names):
        cols += [b1_alt[dup, g:g + 1], b2_alt[dup, g:g + 1], pr_alt[dup, g:g + 1]]
        headers += [
            [f"beta1 ({name})", f"Non-synonymous rate 1 at a site for {name} branches"],
            [f"beta2 ({name})", f"Non-synonymous rate 2 at a site for {name} branches"],
            [f"prop ({name})", f"Mixture weight on rate 1 for {name} branches"],
        ]
    testable_names = [g for g in data.group_names if g != "background"]
    for g, name in enumerate(testable_names):
        cols.append(subs_by_group[g][:, None])
        headers.append([f"subs ({name})", f"Substitutions mapped to {name} branches"])
    cols += [p_corr[dup, 0:1], q_overall[:, None]]
    headers += [
        ["P-value (overall)", "Overall p-value that selective profiles differ between groups (Holm-Bonferroni)"],
        ["Q-value (overall)", "Benjamini-Hochberg q-value for the overall test"],
    ]
    for j, (g1, g2) in enumerate(pairs):
        cols.append(p_corr[dup, 1 + j:2 + j])
        headers.append(
            [f"P-value for {data.group_names[g1]} vs {data.group_names[g2]}",
             "Pairwise difference test (Holm-Bonferroni corrected)"]
        )
    cols += [perm_p[dup][:, None], total_bl[dup][:, None]]
    headers += [
        ["Permutation p-value", "Permutation significance for sites passing the LRT screen (-1 = not tested)"],
        ["Total branch length", "Total tree length at the alternative fit"],
    ]
    site_table = np.concatenate(cols, axis=1)

    json = analysis_json(
        info="Contrast-MEME (Mixed Effects Model of Evolution) investigates "
             "whether or not selective pressures differ between two or more "
             "sets of branches at a site",
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
    return ContrastMEMEResult(
        json=json, site_table=site_table, headers=headers,
        group_names=data.group_names, data=data,
    )
