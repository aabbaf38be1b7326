"""B-STILL — Bayesian Significance Test of Invariant Low Likelihoods.

Reference: ``SelectionAnalyses/B-STILL.bf`` (a FUBAR-family analysis).
Detects effectively-invariant sites (alpha = beta = 0, and "proximal"
sites whose expected substitution rate is within a radius of 0) and
reports posterior probabilities plus Empirical Bayes Factors for each
invariance event.

Pipeline (B-STILL.bf): GTR fit -> (alpha, beta) grid that is DENSER near
zero than FUBAR's (quadratic spacing on [0, 1] for the first 70% of the
1-D points, cubic to 50 above; ``fubar.DefineAlphaBetaGrid``,
``B-STILL.bf:812-852``) -> per-grid-point site log-likelihood vectors ->
Dirichlet-prior posterior over grid weights (VB0 / collapsed Gibbs /
MCMC) -> per-site posterior masses over invariance stencils
(``B-STILL.bf:413-445``):

  * ``Prob[alpha=beta=0]``  — grid points with alpha == 0 and beta == 0
  * ``Prob[alpha=0]`` / ``Prob[beta=0]``
  * ``Prob[alpha,beta~0]``  — "proximal": grid points whose expected
    substitutions/codon ``3*(alpha*rate_syn + beta*rate_non)`` (the
    model's branch-length expression at the gene MLEs,
    ``B-STILL.bf:339``) is <= the radius threshold (default 0.5)
  * ``Prob[alpha<beta]``    — positive selection, as in FUBAR

plus ``EBF[...]`` for each, where EBF(p, prior) = (p/(1-p)) /
(prior/(1-prior)) (``B-STILL.bf:18-24``).  Reference quirk reproduced
deliberately: the per-site proximal posterior uses the substitution-
scale radius (``check_radius``, ``B-STILL.bf:425-441``) while the
proximal EBF *prior* uses a plain Euclidean ball alpha^2 + beta^2 < r^2
(``B-STILL.bf:564``) — two different definitions; both are mirrored so
outputs compare directly, and the JSON records the divergence under
``settings["prior note"]``.

Counterpart of ``hyphy_tpu/methods/bstill.py``: the grid's
site-likelihood vectors come from FUBAR's two grid passes
(:func:`fubar.grid_site_loglik_matrix`, the grid folded into the K1
kernel's node axis); the posterior and stencil algebra are host numpy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

from hyphy_tpu_torch.io.json_out import analysis_json, model_fit_entry
from hyphy_tpu_torch.methods import common
from hyphy_tpu_torch.methods.fubar import conditionals, grid_site_loglik_matrix
from hyphy_tpu_torch.methods.grid_bayes import posterior_over_grid


def bstill_grid(points: int = 20, non_zero: bool = False) -> np.ndarray:
    """(alpha, beta) grid with quadratic (denser-near-zero) spacing on the
    negative-selection segment (``fubar.DefineAlphaBetaGrid``,
    ``B-STILL.bf:812-852``; FUBAR's own grid is linear there)."""
    points = max(points, 5)
    neg = int(points * 0.7 + 0.5)
    pos = points - neg
    one_d = np.zeros(points)
    one_d[:neg] = (np.arange(neg) / (neg - 1)) ** 2
    step = 49.0 ** (1.0 / 3.0) / pos
    for k in range(1, pos + 1):
        one_d[neg + k - 1] = 1.0 + (step * k) ** 3
    grid = np.array([(a, b) for a in one_d for b in one_d])
    if non_zero:
        mn = max(1e-3, one_d[0])
        grid[:, 0] = np.maximum(grid[:, 0], mn)
    return grid


def _ebf(p: np.ndarray, prior: float) -> np.ndarray:
    """Empirical Bayes factor (``fubar.compute_ebf``, B-STILL.bf:18-24)."""
    if not (0.0 < prior < 1.0):
        return np.zeros_like(np.asarray(p, float))
    p = np.asarray(p, float)
    out = np.where(p >= 1.0, 1e10, (p / np.maximum(1.0 - p, 1e-300))
                   / (prior / (1.0 - prior)))
    return out


@dataclasses.dataclass
class BSTILLResult:
    json: Dict
    site_table: np.ndarray        # [sites, 14]
    grid: np.ndarray              # [G, 2]
    posterior_weights: np.ndarray  # [G]
    proximal_sites: np.ndarray     # indices with EBF[prox] >= threshold
    data: common.LoadedData
    gtr: common.GTRFit


def run(
    alignment: str,
    genetic_code: str = "Universal",
    tree: Optional[str] = None,
    branches: str = "All",
    grid_points: int = 20,
    method: str = "Variational-Bayes",
    concentration: float = 0.5,
    chain_length: int = 2_000_000,
    burn_in: int = 1_000_000,
    samples: int = 100,
    non_zero: bool = False,
    ebf_threshold: float = 10.0,
    radius_threshold: float = 0.5,
    precision: float = 1e-5,
    seed: int = 0,
    cache: Optional[str] = None,
    device=None,
) -> BSTILLResult:
    """B-STILL on one codon alignment, on ``device`` (default
    ``settings.device``: the card, raising without one)."""
    common.progress("bstill", f"loading {os.path.basename(alignment)}")
    data = common.load_codon_data(alignment, genetic_code, tree, branches, device=device)
    filt = data.codon_filter

    grid = bstill_grid(grid_points, non_zero=non_zero)
    common.progress(
        "bstill", f"site log-likelihoods on the {grid_points}x{grid_points} grid"
    )
    sll, gtr, rate_syn, rate_non = grid_site_loglik_matrix(
        data, grid, precision=precision, cache=cache,
        fingerprint_extra="|".join(
            [os.path.basename(alignment), branches, "bstill", str(non_zero)]
        ),
    )

    # expand patterns -> sites; normalize per site (ConvertToConditionals)
    cond = conditionals(sll, filt)
    n_sites = cond.shape[1]

    common.progress("bstill", f"posterior over grid weights ({method})")
    posterior_mean, _ = posterior_over_grid(
        method, cond, concentration, chain_length, burn_in, samples,
        rng=np.random.default_rng(seed),
    )

    # stencils (B-STILL.bf:413-445)
    a, b = grid[:, 0], grid[:, 1]
    sub_scale = 3.0 * (a * rate_syn + b * rate_non)      # subs/codon at (a,b)
    stencils = {
        "inv": (a == 0) & (b == 0),
        "a0": a == 0,
        "b0": b == 0,
        "prox": sub_scale <= radius_threshold,
        "pos": a < b,
    }
    p_ks = posterior_mean @ cond                         # [sites]
    alpha_col = (posterior_mean * a) @ cond / p_ks
    beta_col = (posterior_mean * b) @ cond / p_ks
    probs = {
        k: (posterior_mean * s.astype(float)) @ cond / p_ks
        for k, s in stencils.items()
    }
    # EBF priors: inv/a0/b0 use their own stencils; prox deliberately uses
    # the reference's Euclidean ball (B-STILL.bf:564), NOT sub_scale
    priors = {
        k: float(posterior_mean[stencils[k]].sum()) for k in ("inv", "a0", "b0")
    }
    priors["prox"] = float(
        posterior_mean[a ** 2 + b ** 2 < radius_threshold ** 2].sum()
    )
    ebfs = {k: _ebf(probs[k], priors[k]) for k in ("inv", "a0", "b0", "prox")}

    # column layout mirrors B-STILL.bf partition_results {sites, 14}
    site_table = np.zeros((n_sites, 14))
    site_table[:, 0] = alpha_col
    site_table[:, 1] = beta_col
    site_table[:, 2] = probs["inv"]
    site_table[:, 3] = probs["a0"]
    site_table[:, 4] = probs["b0"]
    site_table[:, 5] = probs["prox"]
    site_table[:, 6] = probs["pos"]
    # cols 7-8 (PSRF / Neff) stay 0 outside the MH method, as in the
    # reference's VB0/CG paths
    site_table[:, 9] = ebfs["inv"]
    site_table[:, 10] = ebfs["a0"]
    site_table[:, 11] = ebfs["b0"]
    site_table[:, 12] = ebfs["prox"]

    proximal_sites = np.where(site_table[:, 12] >= ebf_threshold)[0]
    common.progress(
        "bstill",
        f"{len(proximal_sites)} sites under proximal constraint at "
        f"EBF >= {ebf_threshold}",
    )

    headers = [
        ["alpha", "Mean posterior synonymous substitution rate at a site"],
        ["beta", "Mean posterior non-synonymous substitution rate at a site"],
        ["Prob[alpha=beta=0]", "Posterior probability of alpha=beta=0"],
        ["Prob[alpha=0]", "Posterior probability of alpha=0"],
        ["Prob[beta=0]", "Posterior probability of beta=0"],
        ["Prob[alpha,beta~0]",
         "Posterior probability of alpha and beta within a radius of "
         f"{radius_threshold} of 0"],
        ["Prob[alpha<beta]", "Posterior probability of positive selection at a site"],
        ["PSRF", "Potential scale reduction factor - an MCMC mixing measure"],
        ["Neff", "Estimated effective sample site for Prob [alpha<beta]"],
        ["EBF[alpha=beta=0]", "Empirical Bayes Factor for alpha=beta=0"],
        ["EBF[alpha=0]", "Empirical Bayes Factor for alpha=0"],
        ["EBF[beta=0]", "Empirical Bayes Factor for beta=0"],
        ["EBF[alpha,beta~0]",
         "Empirical Bayes Factor for alpha and beta within a radius of "
         f"{radius_threshold} of 0"],
    ]

    # per-site normalized grid posteriors (report.posteriors)
    pp = posterior_mean[:, None] * cond
    pp /= pp.sum(axis=0, keepdims=True)

    json = analysis_json(
        info="Perform a B-STILL (Bayesian Significance Test of Invariant Low "
             "Likelihoods) analysis to detect invariant sites (alpha=beta=0) "
             "and quantify their posterior probabilities and Empirical Bayes "
             "Factors. This is a modified version of the standard FUBAR "
             "analysis that uses a denser grid around zero and reports the "
             "probability of a site being effectively invariant.",
        version="1.0 (B-STILL)",
        data=data,
        fits={
            "Nucleotide GTR": model_fit_entry(
                gtr.loglik, gtr.n_parameters, data.sample_size,
                frequencies=gtr.frequencies, display_order=0,
            ),
        },
        extra={
            "MLE": {"headers": headers, "content": {"0": site_table.tolist()}},
            "grid": np.column_stack([grid, posterior_mean]).tolist(),
            "posterior": {"0": pp.T.tolist()},
            "settings": {
                "grid size": grid_points, "method": method,
                "concentration": concentration, "non-zero": non_zero,
                "ebf": ebf_threshold, "radius-threshold": radius_threshold,
                "prior note": (
                    "EBF[alpha,beta~0] prior uses the Euclidean ball "
                    "alpha^2+beta^2 < r^2 (B-STILL.bf:564) while the "
                    "posterior uses the substitution-scale radius "
                    "(B-STILL.bf:425-441), mirroring the reference"
                ),
            },
        },
    )
    return BSTILLResult(
        json=json, site_table=site_table, grid=grid,
        posterior_weights=posterior_mean, proximal_sites=proximal_sites,
        data=data, gtr=gtr,
    )
