"""PRIME — PRoperty Informed Model of Evolution.

Counterpart of ``hyphy_tpu/methods/prime.py`` (reference
``res/TemplateBatchFiles/SelectionAnalyses/PRIME.bf`` with the property
model ``libv3/models/codon/MG_REV_PROPERTIES.bf``).  Per site, the
non-synonymous rate from amino acid X to Y is

    beta(X, Y) = beta * Exp(-sum_p lambda_p * |prop_p(X) - prop_p(Y)|)

(local-form rate entry, ``MG_REV_PROPERTIES.bf:857-871``) with properties
from the Atchley et al. 2005 factor analysis (five factors,
``MG_REV_PROPERTIES.bf:30-141``; PNAS 102(18):6395).  Each property's
importance lambda_p in [-10, 10] is LRT-tested against the lambda_p := 0
null (chi^2_1).

The per-site fits are FEL's: grid starts, then one batched Nelder-Mead
over every pattern for the full model (400 iterations) and one per
property's null, warm-started from the full fit (250 iterations each)
(:func:`fit_sites`), the patterns split over the mesh that
``settings.mesh`` names, each block from a host thread of its own with the
objective built on its device, and on each device in as many chunks as the
block's share of its free memory asks.  The per-site route follows
the compute dtype as FEL's does: fp64 takes the spectral route (the JAX
package's only route), fp32 (the card's default) the Taylor vector action,
because the card's fp32 ``eigh`` loses ~1e-2 on 61-state generators.  At
|lambda| near 10 the rate modifier reaches e^9.2 and ``||Q t||`` passes the
Taylor ladder's default range, so each evaluation takes the ladder as deep
as its largest ``||Q t||`` needs (:func:`expm.ladder_depth`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.data.genetic_code import AMINO_ACIDS
from hyphy_tpu_torch.io.json_out import analysis_json, model_fit_entry
from hyphy_tpu_torch.methods import common
from hyphy_tpu_torch.methods.fel import _site_bytes, leaf_rows
from hyphy_tpu_torch.models.base import fill_diagonal_from_rows
from hyphy_tpu_torch.models.parameters import ParamSpec
from hyphy_tpu_torch.ops import expm as expm_ops
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.optimize.batched import grid_best_starts
from hyphy_tpu_torch.optimize.nelder_mead import vmapped_nelder_mead
from hyphy_tpu_torch.parallel.mesh import per_device, sharded_site_solve, to_device

# Atchley et al. 2005 five-factor amino-acid property scores
# (MG_REV_PROPERTIES.bf:30-141; PNAS 102(18):6395, Table 2), keyed by the
# one-letter code in AMINO_ACIDS order below.
ATCHLEY = {
    "Factor I bipolar": {
        "A": -0.591, "C": -1.343, "D": 1.05, "E": 1.357, "F": -1.006,
        "G": -0.384, "H": 0.336, "I": -1.239, "K": 1.831, "L": -1.019,
        "M": -0.663, "N": 0.945, "P": 0.189, "Q": 0.931, "R": 1.538,
        "S": -0.228, "T": -0.032, "V": -1.337, "W": -0.595, "Y": 0.26,
    },
    "Factor II secondary structure": {
        "A": -1.302, "C": 0.465, "D": 0.302, "E": -1.453, "F": -0.59,
        "G": 1.652, "H": -0.417, "I": -0.547, "K": -0.561, "L": -0.987,
        "M": -1.524, "N": 0.828, "P": 2.081, "Q": -0.179, "R": -0.055,
        "S": 1.399, "T": 0.326, "V": -0.279, "W": 0.009, "Y": 0.83,
    },
    "Factor III volume": {
        "A": -0.733, "C": -0.862, "D": -3.656, "E": 1.477, "F": 1.891,
        "G": 1.33, "H": -1.673, "I": 2.131, "K": 0.533, "L": -1.505,
        "M": 2.219, "N": 1.299, "P": -1.628, "Q": -3.005, "R": 1.502,
        "S": -4.76, "T": 2.213, "V": -0.544, "W": 0.672, "Y": 3.097,
    },
    "Factor IV composition": {
        "A": 1.57, "C": -1.02, "D": -0.259, "E": 0.113, "F": -0.397,
        "G": 1.045, "H": -1.474, "I": 0.393, "K": -0.277, "L": 1.266,
        "M": -1.005, "N": -0.169, "P": 0.421, "Q": -0.503, "R": 0.44,
        "S": 0.67, "T": 0.908, "V": 1.242, "W": -2.128, "Y": -0.838,
    },
    "Factor V charge": {
        "A": -0.146, "C": -0.255, "D": -3.242, "E": -0.837, "F": 0.412,
        "G": 2.064, "H": -0.078, "I": 0.816, "K": 1.648, "L": -0.912,
        "M": 1.212, "N": 0.933, "P": -1.392, "Q": -1.853, "R": 2.897,
        "S": -2.647, "T": 1.313, "V": -1.262, "W": -0.184, "Y": 1.512,
    },
}


def property_distance_tensors(gc, properties=None) -> List[np.ndarray]:
    """[P] dense [S, S] |prop(X) - prop(Y)| tables over sense codons."""
    aa_idx = gc.sense_amino_acids                      # [S] index into AMINO_ACIDS
    out = []
    for values in (properties or ATCHLEY).values():
        v = np.array([values[AMINO_ACIDS[i]] for i in aa_idx])
        out.append(np.abs(v[:, None] - v[None, :]))
    return out


def site_log_likelihood(
    data: common.LoadedData,
    mgp: common.MG94Fit,
    dists: torch.Tensor,
    dtype: torch.dtype,
    spectral: bool,
) -> Callable[..., torch.Tensor]:
    """PRIME's per-site likelihood at the global MG94 fit ``mgp``.

    Returns ``loglik(idx [N], p, zero_mask [P]) -> [N]``: site ``idx[n]``
    under the tested branches' generator ``alpha_hat_b * (a Q_syn + beta
    (Q_nonsyn o exp(clip(-sum_p lambda_p zero_mask_p |d_p|, -23, 9.2))))``
    (``prime.py:128-156``); with background branches their generator is
    ``a Q_syn + beta_bg Q_nonsyn`` (G = 2).  ``p``: ``alpha``, ``beta``,
    ``lambda_0..P-1`` (and ``beta_bg``), each ``[N]``; ``dists``: the
    ``[P, S, S]`` property distances.  Generators are built in fp64 and
    cast to ``dtype``; ``spectral`` picks the route."""
    model = mgp.model
    device = model.device
    q_syn, q_non = model.basis_matrices(mgp.params)
    alpha_hat = torch.as_tensor(mgp.alphas, device=device).to(dtype)
    freqs = model.frequencies.to(dtype)
    tested = data.tested_branches
    has_background = bool((~tested).any())
    groups = np.where(tested, 0, 1)
    group_of_branch = torch.as_tensor(groups, device=device)
    rows = torch.arange(alpha_hat.shape[0], device=device)
    data_leaves = torch.as_tensor(data.codon_filter.leaf_partials(), device=device)
    data_leaves = data_leaves.to(dtype).transpose(0, 1).contiguous()
    pdata = pruning.build_pruning_data(data.tree, device)
    n_terms = expm_ops.taylor_action_terms(dtype)
    codons = torch.arange(model.n_states, device=device)
    n_props = dists.shape[0]
    dists = dists.to(torch.float64)

    def loglik(idx, p, zero_mask):
        lam = torch.stack([p[f"lambda_{k}"] for k in range(n_props)], dim=1) * zero_mask
        # exponent clamped like the reference's Min(10000, ...) rate cap
        mod = torch.exp(torch.clamp(-torch.einsum("np,pij->nij", lam, dists), -23.0, 9.2))
        q_t = fill_diagonal_from_rows(
            p["alpha"][:, None, None] * q_syn + p["beta"][:, None, None] * q_non * mod)
        if has_background:
            q_bg = fill_diagonal_from_rows(
                p["alpha"][:, None, None] * q_syn + p["beta_bg"][:, None, None] * q_non)
            m = torch.stack([q_t, q_bg], dim=1)
        else:
            m = q_t[:, None]
        m = m.to(dtype)                                              # [N, G, S, S]
        leaf_vectors = leaf_rows(data_leaves, None, idx, codons)
        if spectral:
            left, lam_e, right = expm_ops.reversible_spectral(m, freqs)
            return pruning.single_site_log_likelihood_spectral(
                left, lam_e, right, alpha_hat, group_of_branch, leaf_vectors, freqs, pdata)
        qn_, m2p, r, j = expm_ops.taylor_action_factors(
            m, alpha_hat, max_squarings=expm_ops.ladder_depth(m, alpha_hat, 12, maximum=31))
        if has_background:
            r, j = r[:, group_of_branch, rows], j[:, group_of_branch, rows]
        else:
            r, j = r[:, 0], j[:, 0]
        return pruning.single_site_log_likelihood_taylor(
            qn_, m2p, r, j, group_of_branch, n_terms, leaf_vectors, freqs, pdata)

    return loglik


def fit_sites(data: common.LoadedData, mg: common.MG94Fit,
              dists: torch.Tensor) -> Dict[str, np.ndarray]:
    """The per-site stage: every pattern's full property model from the
    best of four (alpha, beta) starts, then each property's null (lambda_k
    := 0) warm-started from it; the patterns split over the mesh that
    ``settings.mesh`` names.  ``dists``: the ``[P, S, S]`` property
    distances.  Returns numpy {full_lnl, alpha, beta, lambda_k, null_k}."""
    device = mg.model.device
    has_background = bool((~data.tested_branches).any())
    dtype = settings.likelihood_dtype(device)
    n_props = dists.shape[0]
    specs = {
        "alpha": ParamSpec(init=1.0, lower=0.0, upper=10000.0),
        "beta": ParamSpec(init=1.0, lower=0.0, upper=10000.0),
    }
    for k in range(n_props):
        specs[f"lambda_{k}"] = ParamSpec(init=0.1, lower=-10.0, upper=10.0)
    if has_background:
        specs["beta_bg"] = ParamSpec(init=1.0, lower=0.0, upper=10000.0)
    start_ab = np.array([(1.0, 0.5), (1.0, 1.0), (0.5, 2.0), (2.0, 0.25)])

    @per_device
    def make_solver(dev):
        """The objectives and the fit of every item, on ``dev``."""
        f64 = dict(dtype=torch.float64, device=dev)
        loglik = site_log_likelihood(data, mg.to(dev), to_device(dists, dev), dtype,
                                     spectral=dtype == torch.float64)
        grid = {"alpha": torch.as_tensor(start_ab[:, 0], **f64),
                "beta": torch.as_tensor(start_ab[:, 1], **f64)}
        for k in range(n_props):
            grid[f"lambda_{k}"] = torch.full((len(start_ab),), 0.1, **f64)
        if has_background:
            grid["beta_bg"] = torch.as_tensor(start_ab[:, 1], **f64)
        ones_mask = torch.ones(n_props, **f64)

        def fit_all_sites(idx):
            def full_obj(i, p):
                return loglik(i, p, ones_mask)

            starts, _ = grid_best_starts(full_obj, grid, idx)
            full_params, full_lnl = vmapped_nelder_mead(full_obj, specs, starts, idx,
                                                        max_iterations=400)
            out = {"full_lnl": full_lnl, "alpha": full_params["alpha"],
                   "beta": full_params["beta"]}
            for k in range(n_props):
                out[f"lambda_{k}"] = full_params[f"lambda_{k}"]
            # per-property nulls: lambda_k := 0, warm-started from the full fit
            for k in range(n_props):
                mask = ones_mask.clone()
                mask[k] = 0.0

                def null_obj(i, p, mask=mask):
                    return loglik(i, p, mask)

                _, out[f"null_{k}"] = vmapped_nelder_mead(null_obj, specs, full_params, idx,
                                                          max_iterations=250)
            return out
        return fit_all_sites

    n_groups = 2 if has_background else 1
    # the property modifier and a deeper ladder on top of FEL's working set
    site_bytes = _site_bytes(data, dtype, mg.model.n_states, 3 * n_groups)
    fits = sharded_site_solve(make_solver, data.codon_filter.n_patterns, site_bytes, device)
    return {k: v.detach().cpu().numpy().astype(np.float64) for k, v in fits.items()}


@dataclasses.dataclass
class PRIMEResult:
    json: Dict
    site_table: np.ndarray
    headers: list
    data: common.LoadedData


def run(
    alignment: str,
    genetic_code: str = "Universal",
    tree: Optional[str] = None,
    branches: str = "All",
    pvalue: float = 0.1,
    precision: float = 1e-5,
    properties: Optional[Dict[str, Dict[str, float]]] = None,
    device=None,
) -> PRIMEResult:
    """PRIME on one codon alignment, on ``device`` (default
    ``settings.device``: the card, raising without one).  ``properties``:
    optional custom property set (name -> one-letter-code -> value), the
    reference's "Custom" option (MG_REV_PROPERTIES.bf:693); default
    Atchley.  ``pvalue`` is accepted and, as in the JAX package, not used
    by the fit."""
    properties = properties or ATCHLEY
    data = common.load_codon_data(alignment, genetic_code, tree, branches, device=device)
    device = data.device
    common.progress("prime", "fitting nucleotide GTR")
    gtr = common.fit_gtr(data, precision=precision)
    common.progress("prime", f"GTR lnL {gtr.loglik:.3f}; fitting global MG94xREV")
    mg = common.fit_partitioned_mg94(data, gtr, precision=precision)
    common.progress("prime", f"MG94 lnL {mg.loglik:.3f}; per-site property fits")

    filt = data.codon_filter
    dists = torch.as_tensor(
        np.stack(property_distance_tensors(data.genetic_code, properties)),
        dtype=torch.float64, device=device)
    prop_names = list(properties)
    n_props = len(prop_names)
    fits = fit_sites(data, mg, dists)
    common.progress("prime", "per-site fits done")
    full_lnl = fits["full_lnl"]
    lambdas = np.stack([fits[f"lambda_{k}"] for k in range(n_props)], axis=1)   # [N, P]
    alpha, beta = fits["alpha"], fits["beta"]
    null_lnls = np.stack([fits[f"null_{k}"] for k in range(n_props)], axis=1)   # [N, P]

    lrt = np.maximum(2.0 * (full_lnl[:, None] - null_lnls), 0.0)
    pvals = np.vectorize(lambda x: common.chi2_sf(x, 1))(lrt)

    constant = filt.constant_pattern_mask()
    alpha[constant] = 0.0
    beta[constant] = 0.0
    lambdas[constant] = 0.0
    lrt[constant] = 0.0
    pvals[constant] = 1.0

    dup = filt.duplicate_map
    cols = [alpha[dup], beta[dup], full_lnl[dup]]
    headers = [
        ["alpha;", "Synonymous substitution rate at a site"],
        ["&beta;", "Non-synonymous substitution rate at a site"],
        ["log L", "Site log likelihood under the full property model"],
    ]
    for k, name in enumerate(prop_names):
        cols.extend([lambdas[dup, k], lrt[dup, k], pvals[dup, k]])
        headers.extend([
            [f"lambda{k + 1}", f"Importance of {name}"],
            [f"LRT{k + 1}", f"LRT statistic for lambda ({name}) = 0"],
            [f"p{k + 1}", f"p-value for non-zero importance of {name}"],
        ])
    site_table = np.stack(cols, axis=1)

    json = analysis_json(
        info="PRIME (PRoperty Informed Model of Evolution): tests whether "
             "non-synonymous substitution rates at a site depend on five "
             "amino-acid properties (Atchley factors)",
        version="0.1",
        data=data,
        fits={
            "Nucleotide GTR": model_fit_entry(
                gtr.loglik, gtr.n_parameters, data.sample_size,
                frequencies=gtr.frequencies, display_order=0),
            "Global MG94xREV": model_fit_entry(
                mg.loglik, mg.n_parameters, data.sample_size,
                frequencies=mg.codon_freqs, display_order=1),
        },
        extra={
            "MLE": {"headers": headers, "content": {"0": site_table.tolist()}},
            "analysis properties": prop_names,
        },
    )
    return PRIMEResult(json=json, site_table=site_table, headers=headers, data=data)
