"""FEL — Fixed Effects Likelihood site-level selection analysis.

Counterpart of ``hyphy_tpu/methods/fel.py`` (reference
``res/TemplateBatchFiles/SelectionAnalyses/FEL.bf``).  Pipeline: nucleotide
GTR fit -> global MG94xREV fit -> per-site 2-parameter (alpha, beta) fits
against the alpha=beta null, LRT ~ chi^2_1.

Site recipe (parity-critical, FEL.bf:565-820): per branch
``alpha_b := alpha_scaler * synRate_hat_b`` and
``beta_b := beta_scaler_{test|nuisance} * synRate_hat_b`` where
``synRate_hat_b`` are the MG94 MLE branch synonymous rates; without
``--srv`` the alpha scaler is pinned to 1.  The alternative fit is seeded
from a fixed start grid; the null starts from
``alpha <- (min(alpha_hat,100) + 3 min(beta_hat,100))/4``.

Every site is fitted at once: one batched Nelder-Mead over all patterns on
one device (the JAX package shards the same batch over a device mesh).  The
per-site route follows the compute dtype, as in the reference: fp64 takes
the spectral route, fp32 (the card's default) the Taylor vector action.

Not ported yet, and raising ``NotImplementedError`` (ROADMAP.md, 'Left by
the FEL slice'): ``resample > 0``, ``multiple_hits`` other than "None",
``ci=True``, and alignments with CHARSET partitions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.io.json_out import analysis_json, model_fit_entry
from hyphy_tpu_torch.methods import common
from hyphy_tpu_torch.models.base import fill_diagonal_from_rows
from hyphy_tpu_torch.models.parameters import ParamSpec
from hyphy_tpu_torch.ops import expm as expm_ops
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.optimize.batched import grid_best_starts
from hyphy_tpu_torch.optimize.nelder_mead import vmapped_nelder_mead

# FEL.bf:609-734 start grids
_SRV_GRID = np.array(
    [
        # (alpha, beta_test/nuisance)
        (0.01, 0.1), (1.0, 0.1), (1.0, 0.5), (1.0, 1.0), (1.0, 5.0),
        (10.0, 0.1), (0.01, 0.5), (0.01, 5.0), (10.0, 0.5), (10.0, 1.0),
        (10.0, 50.0), (100.0, 1.0),
    ]
)
_NOSRV_GRID = np.array([0.01, 0.1, 0.25, 0.5, 1.0, 5.0])

_LEFT = "is not ported yet (ROADMAP.md, 'Left by the FEL slice', item {})"

_HEADERS = [
    ["alpha", "Synonymous substitution rate at a site"],
    ["beta", "Non-synonymous substitution rate at a site"],
    ["alpha=beta", "The rate estimate under the neutral model"],
    ["LRT", "Likelihood ratio test statistic for beta = alpha, versus beta &neq; alpha"],
    ["p-value", "Likelihood ratio test statistic for beta = alpha, versus beta &neq; alpha"],
    ["Total branch length", "The total length of branches contributing to inference at this site, and used to scale dN-dS"],
]


@dataclasses.dataclass
class FELResult:
    json: Dict
    site_table: np.ndarray          # [sites, 6]
    headers: list
    data: common.LoadedData
    gtr: common.GTRFit
    mg94: common.MG94Fit


def site_log_likelihood(
    data: common.LoadedData,
    mgp: common.MG94Fit,
    dtype: torch.dtype,
    spectral: bool,
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """FEL's per-site likelihood at the global MG94 fit ``mgp``.

    Returns ``loglik(idx [N], a [N], betas [N, G]) -> [N]``: site ``idx[n]``
    under branch generators ``alpha_hat_b * (a_n Q_syn + beta_{n,g(b)}
    Q_nonsyn)``, with ``g(b)`` 0 on tested branches and 1 on background
    ones (G = 2 only when there are background branches).  Generators are
    built in fp64 and cast to ``dtype``; ``spectral`` picks the route
    (fp64 eigendecomposition, else the Taylor vector action).
    """
    model = mgp.model
    device = model.device
    tested = data.tested_branches
    q_syn, q_non = model.basis_matrices(mgp.params)                 # fp64 [S, S]
    alpha_hat = torch.as_tensor(mgp.alphas, device=device).to(dtype)   # [B]
    freqs = model.frequencies.to(dtype)
    group_of_branch = torch.as_tensor(np.where(tested, 0, 1), device=device)
    has_background = bool((~tested).any())
    rows = torch.arange(alpha_hat.shape[0], device=device)
    # [patterns, taxa, S]: the tree's leaves are in the filter's order
    leaves = torch.as_tensor(data.codon_filter.leaf_partials(), device=device)
    leaves = leaves.to(dtype).transpose(0, 1).contiguous()
    pdata = pruning.build_pruning_data(data.tree, device)
    n_terms = expm_ops.taylor_action_terms(dtype)

    def loglik(idx, a, betas):
        m = fill_diagonal_from_rows(
            a[:, None, None, None] * q_syn + betas[:, :, None, None] * q_non
        ).to(dtype)                                                  # [N, G, S, S]
        leaf_vectors = leaves[idx]
        if spectral:
            left, lam, right = expm_ops.reversible_spectral(m, freqs)
            return pruning.single_site_log_likelihood_spectral(
                left, lam, right, alpha_hat, group_of_branch, leaf_vectors, freqs, pdata)
        qn, m2p, r, j = expm_ops.taylor_action_factors(m, alpha_hat)
        if has_background:
            r, j = r[:, group_of_branch, rows], j[:, group_of_branch, rows]
        else:
            r, j = r[:, 0], j[:, 0]
        return pruning.single_site_log_likelihood_taylor(
            qn, m2p, r, j, group_of_branch, n_terms, leaf_vectors, freqs, pdata)

    return loglik


def solve_partition(data: common.LoadedData, mgp: common.MG94Fit, srv: bool = True):
    """The per-site stage of one partition: grid starts, alternative and
    null Nelder-Mead fits of every pattern at once, LRT, and the site table
    expanded from patterns to sites.  Returns (site_table, headers)."""
    filt = data.codon_filter
    tested = data.tested_branches
    has_background = bool((~tested).any())
    n_patterns = filt.n_patterns
    model = mgp.model
    device = model.device
    dtype = settings.likelihood_dtype(device)
    loglik = site_log_likelihood(data, mgp, dtype, spectral=dtype == torch.float64)
    f64 = dict(dtype=torch.float64, device=device)

    def site_loglik(idx, scalers):
        a = scalers["alpha"] if srv else torch.ones(idx.shape[0], **f64)
        betas = [scalers["beta_test"]]
        if has_background:
            betas.append(scalers["beta_nuisance"])
        return loglik(idx, a, torch.stack(betas, dim=1))

    def null_loglik(idx, scalers):
        betas = [scalers["alpha"]]
        if has_background:
            betas.append(scalers["beta_nuisance"])
        return loglik(idx, scalers["alpha"], torch.stack(betas, dim=1))

    # -- alternative fits -------------------------------------------------------
    rate = ParamSpec(init=1.0, lower=0.0, upper=10000.0)
    if srv:
        specs = {"alpha": rate, "beta_test": rate}
        grid = {"alpha": torch.tensor(_SRV_GRID[:, 0], **f64),
                "beta_test": torch.tensor(_SRV_GRID[:, 1], **f64)}
        if has_background:
            grid["beta_nuisance"] = torch.tensor(_SRV_GRID[:, 1], **f64)
    else:
        specs = {"beta_test": rate}
        grid = {"beta_test": torch.tensor(_NOSRV_GRID, **f64)}
        if has_background:
            grid["beta_nuisance"] = torch.tensor(_NOSRV_GRID, **f64)
    if has_background:
        specs["beta_nuisance"] = rate

    idx = torch.arange(n_patterns, device=device)
    starts, _ = grid_best_starts(site_loglik, grid, idx)
    alt_params, alt_lnl = vmapped_nelder_mead(site_loglik, specs, starts, idx)
    alt_alpha = alt_params["alpha"] if srv else torch.ones(n_patterns, **f64)
    alt_beta = alt_params["beta_test"]

    # null: beta_test := alpha (a free common scaler even without SRV — the
    # reference's `=` assignment clears the alpha := 1 constraint), started
    # from the reference's blend (FEL.bf:777-785)
    null_specs = {"alpha": rate}
    null_start = {"alpha": (torch.clamp_max(alt_alpha, 100.0)
                            + 3.0 * torch.clamp_max(alt_beta, 100.0)) / 4.0}
    if has_background:
        null_specs["beta_nuisance"] = rate
        null_start["beta_nuisance"] = alt_params["beta_nuisance"]
    null_params, null_lnl = vmapped_nelder_mead(null_loglik, null_specs, null_start, idx)
    null_common = null_params["alpha"]

    # per-site total tested branch length at the null fit (reference:
    # BranchLength(tree,-1) . selected_branches, FEL.bf:800); /3: codon
    # branch lengths are per nucleotide site
    q_syn, q_non = model.basis_matrices(mgp.params)
    rate_syn = q_syn.sum(-1) @ model.frequencies
    rate_non = q_non.sum(-1) @ model.frequencies
    alpha_hat = torch.as_tensor(mgp.alphas, device=device).to(dtype)
    rate_b = null_common[:, None] * alpha_hat[None, :]
    bl = (rate_b * rate_syn + rate_b * rate_non) / 3.0
    total_bl = bl @ torch.as_tensor(tested.astype(np.float64), device=device)
    common.progress("fel", "per-site fits done")

    alt_alpha, alt_beta, alt_lnl, null_common, null_lnl, total_bl = (
        x.detach().cpu().numpy()
        for x in (alt_alpha, alt_beta, alt_lnl, null_common, null_lnl, total_bl))
    lrt = np.maximum(2.0 * (alt_lnl - null_lnl), 0.0)
    pvals = np.array([common.chi2_sf(x, 1) for x in lrt])

    # constant patterns are not fit (FEL.bf: is_constant -> zero row)
    constant = filt.constant_pattern_mask()
    for arr, val in ((alt_alpha, 0.0), (alt_beta, 0.0), (null_common, 0.0),
                     (lrt, 0.0), (pvals, 1.0), (total_bl, 0.0)):
        arr[constant] = val

    dup = filt.duplicate_map
    columns = [alt_alpha, alt_beta, null_common, lrt, pvals, total_bl]
    site_table = np.stack([c[dup] for c in columns], axis=1)
    return site_table, [list(h) for h in _HEADERS]


def run(
    alignment: str,
    genetic_code: str = "Universal",
    tree: Optional[str] = None,
    branches: str = "All",
    srv: bool = True,
    pvalue: float = 0.1,
    precision: float = 1e-5,
    site_precision: float = 1e-4,
    resample: int = 0,
    resample_seed: int = 0,
    multiple_hits: str = "None",
    site_multihit: str = "Estimate",
    ci: bool = False,
    device=None,
) -> FELResult:
    """FEL on one codon alignment, on ``device`` (default
    ``settings.device``: the card, raising without one).  The signature is
    the JAX package's; ``pvalue``, ``site_precision``, ``resample_seed`` and
    ``site_multihit`` are accepted and, as there, not used by the fit."""
    if resample > 0:
        raise NotImplementedError("FEL --resample " + _LEFT.format(1))
    if multiple_hits not in (None, "None", ""):
        raise NotImplementedError("FEL --multiple-hits " + _LEFT.format(2))
    if ci:
        raise NotImplementedError("FEL --ci " + _LEFT.format(3))
    md = common.load_codon_data_multi(alignment, genetic_code, tree, branches, device=device)
    common.progress("fel", f"{md.n_partitions} partition(s); fitting nucleotide GTR")
    gtr = common.fit_gtr_multi(md, precision=precision)
    md, gtr = common.kill_zero_branches_multi(md, gtr, branches)
    common.progress("fel", f"GTR lnL {gtr.loglik:.3f}; fitting global MG94xREV")
    mg = common.fit_partitioned_mg94_multi(md, gtr, precision=precision)
    common.progress("fel", f"MG94 lnL {mg.loglik:.3f}; per-site fits")

    data = md.parts[0]
    site_table, headers = solve_partition(data, mg.parts[0], srv)
    fits = {
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
                for g, name in enumerate(data.group_names)
            },
        ),
    }
    info = ("FEL (Fixed Effects Likelihood) estimates site-wise synonymous "
            "(&alpha;) and non-synonymous (&beta;) rates")
    extra = {"MLE": {"headers": headers, "content": {"0": site_table.tolist()}}}
    json = analysis_json(info=info, version="2.1", data=data, fits=fits, extra=extra)
    return FELResult(json=json, site_table=site_table, headers=headers,
                     data=data, gtr=gtr.parts[0], mg94=mg.parts[0])
