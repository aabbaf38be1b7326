"""FEL — Fixed Effects Likelihood site-level selection analysis.

Counterpart of ``hyphy_tpu/methods/fel.py`` (reference
``res/TemplateBatchFiles/SelectionAnalyses/FEL.bf``).  Pipeline: nucleotide
GTR fit -> global MG94xREV fit -> per-site 2-parameter (alpha, beta) fits
against the alpha=beta null, LRT ~ chi^2_1; one site table per CHARSET
partition.

Site recipe (parity-critical, FEL.bf:565-820): per branch
``alpha_b := alpha_scaler * synRate_hat_b`` and
``beta_b := beta_scaler_{test|nuisance} * synRate_hat_b`` where
``synRate_hat_b`` are the MG94 MLE branch synonymous rates; without
``--srv`` the alpha scaler is pinned to 1.  The alternative fit is seeded
from a fixed start grid; the null starts from
``alpha <- (min(alpha_hat,100) + 3 min(beta_hat,100))/4``.

Options: ``multiple_hits`` adds 2- and 3-hit rates to the global fit and
the site models (per-site estimates or the global values,
``site_multihit``); ``ci`` adds 95% profile-likelihood intervals on site
dN/dS; ``resample`` replaces the chi^2 p-values by parametric-bootstrap
ones and keeps the asymptotic ones in a "p-asmp" column.

Every site of a partition is fitted at once: one batched Nelder-Mead over
all patterns, split over the device mesh that ``settings.mesh`` names
(:func:`parallel.mesh.sharded_site_solve`: each block of contiguous
patterns is fitted from a host thread of its own with an objective built
on its device) and, on each device, in time when the block's share of its
free memory asks.  The per-site route follows
the compute dtype, as in the reference: fp64 takes the spectral route,
fp32 (the card's default) the Taylor vector action.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Callable, Dict, Optional

import numpy as np
import torch

from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.io.json_out import analysis_json, analysis_json_parts, model_fit_entry
from hyphy_tpu_torch.methods import common
from hyphy_tpu_torch.models.base import fill_diagonal_from_rows
from hyphy_tpu_torch.models.parameters import ParamSpec
from hyphy_tpu_torch.ops import expm as expm_ops
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.optimize.batched import grid_best_starts
from hyphy_tpu_torch.optimize.nelder_mead import vmapped_nelder_mead
from hyphy_tpu_torch.parallel.mesh import per_device, sharded_site_solve, to_device
from hyphy_tpu_torch.utils import simulate as sim_mod

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

_HEADERS = [
    ["alpha", "Synonymous substitution rate at a site"],
    ["beta", "Non-synonymous substitution rate at a site"],
    ["alpha=beta", "The rate estimate under the neutral model"],
    ["LRT", "Likelihood ratio test statistic for beta = alpha, versus beta &neq; alpha"],
    ["p-value", "Likelihood ratio test statistic for beta = alpha, versus beta &neq; alpha"],
    ["Total branch length", "The total length of branches contributing to inference at this site, and used to scale dN-dS"],
]
_CI_HEADERS = [
    ["dN/dS LB", "95% profile likelihood CI lower bound for dN/dS (if available)"],
    ["dN/dS MLE", "Point estimate for site dN/dS"],
    ["dN/dS UB", "95% profile likelihood CI upper bound for dN/dS (if available)"],
]
_PASMP_HEADER = ["p-asmp", "p-value derived from the asymptotic test statistic"]
_2H_HEADER = ["2H rate", "Site-level rate for 2-nucleotide substitutions"]
_3H_HEADER = ["3H rate", "Site-level rate for 3-nucleotide substitutions"]

_CHI2_95_HALF = 1.9207294  # qchisq(0.95, df=1) / 2 — the 95% profile drop
_OMEGA_CAP = 10000.0       # omega_ratio_for_ci :< 10000 (FEL.bf:746)
# sites whose null propagators ([branches, S, S] fp64 each) one host copy
# of the bootstrap carries
_SIMULATION_CHUNK = 64


@dataclasses.dataclass
class FELResult:
    json: Dict
    site_table: np.ndarray          # [sites, columns] of the first partition
    headers: list
    data: common.LoadedData
    gtr: common.GTRFit
    mg94: common.MG94Fit


def _site_bases(mgp: common.MG94Fit, per_site_multihit: bool):
    """``bases(delta, psi) -> (Q_syn, Q_nonsyn)``, each ``[1 or N, S, S]``
    in the fit's dtype: the fit's folded bases (with its global delta/psi
    under multiple hits), or with ``per_site_multihit`` ``Q1 + delta_n Q2
    (+ psi_n Q3)`` from the ``[N]`` rates ``delta`` (and ``psi``)."""
    model = mgp.model
    if not per_site_multihit:
        q_syn, q_non = model.combined_basis_matrices(mgp.params)
        return lambda delta, psi: (q_syn[None], q_non[None])
    q1 = model.basis_matrices(mgp.params)
    q2 = model.multihit_basis_matrices(mgp.params, 2)
    q3 = (model.multihit_basis_matrices(mgp.params, 3)
          if model.multiple_hits == "Double+Triple" else None)

    def bases(delta, psi):
        qs = q1[0] + delta[:, None, None] * q2[0]
        qn = q1[1] + delta[:, None, None] * q2[1]
        if q3 is not None:
            qs = qs + psi[:, None, None] * q3[0]
            qn = qn + psi[:, None, None] * q3[1]
        return qs, qn

    return bases


def site_log_likelihood(
    data: common.LoadedData,
    mgp: common.MG94Fit,
    dtype: torch.dtype,
    spectral: bool,
    per_site_multihit: bool = False,
    groups: Optional[np.ndarray] = None,
) -> Callable[..., torch.Tensor]:
    """FEL's per-site likelihood at the global MG94 fit ``mgp``.

    Returns ``loglik(idx [N], a [N], betas [N, G], delta=None, psi=None,
    states=None) -> [N]``: site ``idx[n]`` under branch generators
    ``alpha_hat_b * (a_n Q_syn + beta_{n,g(b)} Q_nonsyn)``.  ``groups``: the
    ``[branches]`` group vector ``g`` in ``[0, G)`` (contrast-FEL's branch
    sets); by default FEL's, 0 on tested branches and 1 on background ones
    (G = 2 only when there are background branches).  The bases are
    :func:`_site_bases`'.  ``states``:
    an ``[items, taxa]`` int table of codon states (-1: missing) indexed by
    ``idx`` in place of the data's leaf partials (the bootstrap's simulated
    columns); only the evaluated rows are made one-hot.  Generators are
    built in fp64 as ``[N, G, S, S]`` and cast to ``dtype``; ``spectral``
    picks the route (fp64 eigendecomposition, else the Taylor vector
    action).
    """
    model = mgp.model
    device = model.device
    bases = _site_bases(mgp, per_site_multihit)
    alpha_hat = torch.as_tensor(mgp.alphas, device=device).to(dtype)   # [B]
    freqs = model.frequencies.to(dtype)
    groups = _branch_groups(data) if groups is None else np.asarray(groups)
    group_of_branch = torch.as_tensor(groups, device=device)
    n_groups = int(groups.max()) + 1
    rows = torch.arange(alpha_hat.shape[0], device=device)
    # [patterns, taxa, S]: the tree's leaves are in the filter's order
    data_leaves = torch.as_tensor(data.codon_filter.leaf_partials(), device=device)
    data_leaves = data_leaves.to(dtype).transpose(0, 1).contiguous()
    pdata = pruning.build_pruning_data(data.tree, device)
    n_terms = expm_ops.taylor_action_terms(dtype)
    codons = torch.arange(model.n_states, device=device)

    def loglik(idx, a, betas, delta=None, psi=None, states=None):
        qs, qn = bases(delta, psi)
        m = fill_diagonal_from_rows(
            a[:, None, None, None] * qs[:, None] + betas[:, :, None, None] * qn[:, None]
        ).to(dtype)                                                  # [N, G, S, S]
        leaf_vectors = leaf_rows(data_leaves, states, idx, codons)
        if spectral:
            left, lam, right = expm_ops.reversible_spectral(m, freqs)
            return pruning.single_site_log_likelihood_spectral(
                left, lam, right, alpha_hat, group_of_branch, leaf_vectors, freqs, pdata)
        qn_, m2p, r, j = expm_ops.taylor_action_factors(m, alpha_hat)
        if n_groups > 1:
            r, j = r[:, group_of_branch, rows], j[:, group_of_branch, rows]
        else:
            r, j = r[:, 0], j[:, 0]
        return pruning.single_site_log_likelihood_taylor(
            qn_, m2p, r, j, group_of_branch, n_terms, leaf_vectors, freqs, pdata)

    return loglik


def leaf_rows(data_leaves: torch.Tensor, states, idx: torch.Tensor,
              codons: torch.Tensor) -> torch.Tensor:
    """``[N, taxa, S]`` leaf vectors of items ``idx``: the data's patterns
    (``data_leaves`` ``[patterns, taxa, S]``), or with ``states`` (an
    ``[items, taxa]`` int table, -1 missing) those rows made one-hot."""
    if states is None:
        return data_leaves[idx]
    st = states[idx][..., None]                                      # [N, taxa, 1]
    return ((st == codons) | (st < 0)).to(data_leaves.dtype)


def _branch_groups(data: common.LoadedData) -> np.ndarray:
    """FEL's group vector: 0 on tested branches, 1 on background ones."""
    return np.where(data.tested_branches, 0, 1)


def _site_bytes(data: common.LoadedData, dtype: torch.dtype, n_states: int,
                n_groups: Optional[int] = None) -> float:
    """Working set of one site in a batched per-site evaluation: the
    ``[nodes, S]`` CLV buffer and a level's child messages and temporaries
    (~8 buffers of it), plus each of the ``n_groups`` groups' Taylor factors
    (ladder and powers, ~14 ``[S, S]`` matrices; by default FEL's count).
    The card measured 3.3 MB per site at 1000 taxa in fp32 (PERF.md); this
    gives 4.1 MB."""
    itemsize = torch.finfo(dtype).bits // 8
    if n_groups is None:
        n_groups = int(_branch_groups(data).max()) + 1
    return itemsize * n_states * (8 * (data.tree.n_nodes + 1) + n_groups * 14 * n_states)


def _simulate_null_states(
    data: common.LoadedData,
    mgp: common.MG94Fit,
    null: Dict[str, np.ndarray],
    n_reps: int,
    seed: int,
) -> np.ndarray:
    """``[patterns * n_reps, taxa]`` int16 states simulated under each
    site's null fit (FEL.bf:805-820) by :func:`draw_site_columns`.
    ``null``: the per-pattern null rates ``alpha`` (common) and
    ``beta_nuisance``, and under per-site multiple hits ``delta`` (and
    ``psi``).  Each non-constant site's propagators ``expm(t_b (c Q_syn +
    beta_g(b) Q_nonsyn))``, over the site's own bases (:func:`_site_bases`),
    are built on the model's device in fp64 (shared-power Taylor, one
    generator per branch group)."""
    model = mgp.model
    device = model.device
    f64 = dict(dtype=torch.float64, device=device)
    groups = _branch_groups(data)
    branch_sets = [torch.as_tensor(np.nonzero(groups == g)[0], device=device)
                   for g in range(int(groups.max()) + 1)]
    mh_keys = [key for key in ("delta", "psi") if key in null]
    bases = _site_bases(mgp, per_site_multihit=bool(mh_keys))
    times = torch.as_tensor(mgp.alphas, **f64)

    def propagators(s):
        rates = (float(null["alpha"][s]), float(null["beta_nuisance"][s]))
        site = {key: torch.as_tensor(null[key][s: s + 1], **f64) for key in mh_keys}
        q_syn, q_non = (q[0].double() for q in bases(site.get("delta"), site.get("psi")))
        p = torch.empty((times.shape[0],) + q_syn.shape, **f64)
        for g, branches in enumerate(branch_sets):
            q = fill_diagonal_from_rows(rates[0] * q_syn + rates[g] * q_non)
            p[branches] = expm_ops.shared_taylor_propagators(q, times[branches])
        return p

    return draw_site_columns(data, mgp, propagators, n_reps, seed)


def draw_site_columns(data: common.LoadedData, mgp: common.MG94Fit, propagators,
                      n_reps: int, seed: int) -> np.ndarray:
    """``[patterns * n_reps, taxa]`` int16 states: ``n_reps`` columns per
    non-constant site drawn along the tree from ``propagators(s)`` (``[branches,
    S, S]`` fp64 on the model's device) at the model's root frequencies, -1
    where a site is constant (not simulated: its columns stay missing).  The
    propagators reach the host ``_SIMULATION_CHUNK`` sites per copy, where
    :func:`simulate_states` draws them in the JAX package's order: one
    generator from ``seed``, one call per site in site order."""
    rng = np.random.default_rng(seed)
    filt = data.codon_filter
    n_taxa = filt.n_sequences
    root_freqs = mgp.model.frequencies.cpu().numpy()
    states = np.full((filt.n_patterns * n_reps, n_taxa), -1, dtype=np.int16)
    sites = np.nonzero(~filt.constant_pattern_mask())[0]
    for lo in range(0, len(sites), _SIMULATION_CHUNK):
        chunk = sites[lo: lo + _SIMULATION_CHUNK]
        with torch.no_grad():
            host = torch.stack([propagators(s) for s in chunk]).cpu().numpy()
        for s, p in zip(chunk, host):
            st = sim_mod.simulate_states(data.tree, p, root_freqs, n_reps, rng)
            states[s * n_reps: (s + 1) * n_reps] = st[:n_taxa].T
    return states


def _profile_ci(solve, stage, specs, srv, init, alt_alpha, alt_beta, alt_lnl,
                n_patterns, n_expand: int = 8, n_bisect: int = 25):
    """95% profile-likelihood CI on site dN/dS (FEL.bf:738-756).

    The profile reoptimizes the nuisance parameters (alpha, background
    beta, site delta/psi) at every trial ratio — the engine's
    COVARIANCE_PARAMETER machinery (likefunc.cpp:6565) — with the batched
    Nelder-Mead (at most 80 iterations).  All sites are profiled at once:
    each bisection step is one batched fit over every pattern, each device
    of the mesh fitting its block with ``stage(device).site_loglik``."""
    nuis_specs = {k: v for k, v in specs.items() if k != "beta_test"}

    def profile(r: np.ndarray) -> np.ndarray:
        """max over the nuisance of site lnL with beta_test := r * alpha."""

        def make_solver(dev):
            f64 = dict(dtype=torch.float64, device=dev)
            r_t = torch.as_tensor(r, **f64)
            site_loglik = stage(dev).site_loglik
            start_all = {k: to_device(v, dev) for k, v in init.items()}

            def obj(i, p):
                q = dict(p)
                a = q["alpha"] if srv else torch.ones(i.shape[0], **f64)
                q["beta_test"] = r_t[i] * a
                return site_loglik(i, q)

            def solver(idx):
                if not nuis_specs:
                    return {"lnl": obj(idx, {})}
                start = {k: v[idx] for k, v in start_all.items()}
                _, lnl = vmapped_nelder_mead(obj, nuis_specs, start, idx, max_iterations=80)
                return {"lnl": lnl}

            return solver

        return solve(make_solver, n_patterns)["lnl"].cpu().numpy()

    r_mle = np.clip(alt_beta / np.maximum(alt_alpha if srv else 1.0, 1e-8), 1e-10, _OMEGA_CAP)
    target = alt_lnl - _CHI2_95_HALF

    # lower bound: bisect g(r) = profile(r) - target on [0, r_mle]
    lo = np.zeros(n_patterns)
    hi = r_mle.copy()
    at_zero = profile(lo) - target >= 0.0   # profile at omega=0 still within the band
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        take_hi = profile(mid) - target >= 0.0   # mid still inside the CI -> move down
        hi = np.where(take_hi, mid, hi)
        lo = np.where(take_hi, lo, mid)
    lb = np.where(at_zero, 0.0, 0.5 * (lo + hi))

    # upper bound: geometric expansion then log-space bisection
    lo_u = r_mle.copy()
    hi_u = np.minimum(np.maximum(r_mle * 4.0, 1e-4), _OMEGA_CAP)
    for _ in range(n_expand):
        inside = (profile(hi_u) - target >= 0.0) & (hi_u < _OMEGA_CAP)
        lo_u = np.where(inside, hi_u, lo_u)
        hi_u = np.where(inside, np.minimum(hi_u * 4.0, _OMEGA_CAP), hi_u)
    at_cap = profile(hi_u) - target >= 0.0
    llo, lhi = np.log(np.maximum(lo_u, 1e-10)), np.log(hi_u)
    for _ in range(n_bisect):
        lmid = 0.5 * (llo + lhi)
        inside = profile(np.exp(lmid)) - target >= 0.0
        llo = np.where(inside, lmid, llo)
        lhi = np.where(inside, lhi, lmid)
    ub = np.where(at_cap, _OMEGA_CAP, np.exp(0.5 * (llo + lhi)))
    return lb, r_mle.copy(), ub


def _bootstrap_pvalues(solve, stage, n_reps, states, lrt_obs):
    """Parametric-bootstrap per-site p-values (FEL.bf:805-820): refit the
    alternative and the null on each of the ``n_reps`` columns simulated per
    site (``states``, from :func:`_simulate_null_states`) as one batch of
    ``patterns * n_reps`` items, in the solver's blocks and chunks
    (``stage(device).fit`` on each device of the mesh), and count the
    replicates whose LRT reaches the observed one.  The states stay an int
    table on each device; each evaluation makes its chunk's rows one-hot.
    Returns (p [patterns], LRT [patterns, n_reps])."""
    def make_solver(dev):
        st = torch.as_tensor(states, device=dev)
        fit = stage(dev).fit
        return lambda idx: fit(idx, st)

    out = solve(make_solver, states.shape[0])
    alt_lnl, null_lnl = (out[k].cpu().numpy() for k in ("alt_lnl", "null_lnl"))
    lrt_sim = np.maximum(2.0 * (alt_lnl - null_lnl), 0.0).reshape(-1, n_reps)
    hits = (lrt_sim >= lrt_obs[:, None] - 1e-10).sum(axis=1)
    return (hits + 1.0) / (n_reps + 1.0), lrt_sim


def solve_partition(
    data: common.LoadedData,
    mgp: common.MG94Fit,
    srv: bool = True,
    site_multihit: str = "Estimate",
    resample: int = 0,
    resample_seed: int = 0,
    ci: bool = False,
):
    """The per-site stage of one partition: grid starts, alternative and
    null Nelder-Mead fits of every pattern (split over the mesh that
    ``settings.mesh`` names, the objective built once on each of its
    devices, and on each device in as many chunks as its free memory
    asks), LRT, then the options' columns (CI, bootstrap p-values, 2H/3H
    rates), and the site table expanded from patterns to sites.  Returns (site_table, headers)."""
    filt = data.codon_filter
    tested = data.tested_branches
    has_background = bool((~tested).any())
    n_patterns = filt.n_patterns
    model = mgp.model
    device = model.device
    mh = model.multiple_hits != "None"
    mh_triple = model.multiple_hits == "Double+Triple"
    mh_est = mh and site_multihit == "Estimate"
    mh_keys = ("delta", "psi")[: 2 if mh_triple else 1] if mh_est else ()
    delta_hat = float(mgp.params["delta"]) if mh else 0.0
    psi_hat = float(mgp.params["psi"]) if mh_triple else 0.0
    dtype = settings.likelihood_dtype(device)
    f64 = dict(dtype=torch.float64, device=device)
    site_bytes = _site_bytes(data, dtype, model.n_states)
    rate = ParamSpec(init=1.0, lower=0.0, upper=10000.0)
    if srv:
        specs = {"alpha": rate, "beta_test": rate}
        grid_np = {"alpha": _SRV_GRID[:, 0], "beta_test": _SRV_GRID[:, 1]}
        if has_background:
            grid_np["beta_nuisance"] = _SRV_GRID[:, 1]
    else:
        specs = {"beta_test": rate}
        grid_np = {"beta_test": _NOSRV_GRID}
        if has_background:
            grid_np["beta_nuisance"] = _NOSRV_GRID
    if has_background:
        specs["beta_nuisance"] = rate
    n_grid = next(iter(grid_np.values())).shape[0]
    for key, hat in zip(mh_keys, (delta_hat, psi_hat)):
        specs[key] = ParamSpec(init=max(hat, 1e-3), lower=0.0, upper=100.0)
        grid_np[key] = np.full(n_grid, hat)

    def solve(make_solver, n_items):
        return sharded_site_solve(make_solver, n_items, site_bytes, device)

    @per_device
    def stage(dev):
        """The per-site objectives and the fit of every item, on ``dev``."""
        loglik = site_log_likelihood(data, mgp.to(dev), dtype,
                                     spectral=dtype == torch.float64,
                                     per_site_multihit=mh_est)
        f64 = dict(dtype=torch.float64, device=dev)
        grid = {k: torch.tensor(v, **f64) for k, v in grid_np.items()}

        def evaluate(idx, a, betas, scalers, states):
            if has_background:
                betas = betas + [scalers["beta_nuisance"]]
            return loglik(idx, a, torch.stack(betas, dim=1), scalers.get("delta"),
                          scalers.get("psi"), states)

        def site_loglik(idx, scalers, states=None):
            a = scalers["alpha"] if srv else torch.ones(idx.shape[0], **f64)
            return evaluate(idx, a, [scalers["beta_test"]], scalers, states)

        def null_loglik(idx, scalers, states=None):
            return evaluate(idx, scalers["alpha"], [scalers["alpha"]], scalers, states)

        def fit(idx, states=None):
            def alt(i, p):
                return site_loglik(i, p, states)

            def null(i, p):
                return null_loglik(i, p, states)

            starts, _ = grid_best_starts(alt, grid, idx)
            alt_params, alt_lnl = vmapped_nelder_mead(alt, specs, starts, idx)
            alt_alpha = alt_params["alpha"] if srv else torch.ones(idx.shape[0], **f64)
            alt_beta = alt_params["beta_test"]
            # null: beta_test := alpha (a free common scaler even without SRV —
            # the reference's `=` assignment clears the alpha := 1 constraint),
            # started from the reference's blend (FEL.bf:777-785)
            null_specs = {"alpha": rate}
            null_start = {"alpha": (torch.clamp_max(alt_alpha, 100.0)
                                    + 3.0 * torch.clamp_max(alt_beta, 100.0)) / 4.0}
            for key in (("beta_nuisance",) if has_background else ()) + mh_keys:
                null_specs[key] = specs[key]
                null_start[key] = alt_params[key]
            null_params, null_lnl = vmapped_nelder_mead(null, null_specs, null_start, idx)
            ones = torch.ones(idx.shape[0], **f64)
            out = {"alt_alpha": alt_alpha, "alt_beta": alt_beta, "alt_lnl": alt_lnl,
                   "null_common": null_params["alpha"], "null_lnl": null_lnl,
                   "null_bg": null_params.get("beta_nuisance", ones),
                   "alt_bg": alt_params.get("beta_nuisance", ones)}
            out.update({key: alt_params[key] for key in mh_keys})
            out.update({f"null_{key}": null_params[key] for key in mh_keys})
            return out

        return SimpleNamespace(fit=fit, site_loglik=site_loglik)

    fitted = solve(lambda dev: stage(dev).fit, n_patterns)
    common.progress("fel", "per-site fits done")
    fits = {k: v.detach().cpu().numpy() for k, v in fitted.items()}
    alt_alpha, alt_beta, alt_lnl = fits["alt_alpha"], fits["alt_beta"], fits["alt_lnl"]
    null_common, null_lnl = fits["null_common"], fits["null_lnl"]

    # per-site total tested branch length at the null fit (reference:
    # BranchLength(tree,-1) . selected_branches, FEL.bf:800); /3: codon
    # branch lengths are per nucleotide site
    alpha_hat = torch.as_tensor(mgp.alphas, device=device).to(dtype)
    rate_b = fitted["null_common"][:, None] * alpha_hat[None, :]
    bl = model.rate_per_branch(model.combined_basis_matrices(mgp.params), rate_b, rate_b)
    total_bl = (bl @ torch.as_tensor(tested.astype(np.float64), device=device)).cpu().numpy()

    lrt = np.maximum(2.0 * (alt_lnl - null_lnl), 0.0)
    p_asymptotic = np.array([common.chi2_sf(x, 1) for x in lrt])
    pvals = p_asymptotic.copy()
    if resample > 0:
        common.progress("fel", f"parametric bootstrap: {resample} replicates/site")
        null = {"alpha": null_common, "beta_nuisance": fits["null_bg"]}
        null.update({key: fits[f"null_{key}"] for key in mh_keys})
        states = _simulate_null_states(data, mgp, null, resample, resample_seed)
        pvals, _ = _bootstrap_pvalues(solve, stage, resample, states, lrt)

    ci_cols = None
    if ci:
        common.progress("fel", "profile-likelihood CIs on site dN/dS")
        init = {}
        if srv:
            init["alpha"] = torch.as_tensor(np.maximum(alt_alpha, 1e-8), **f64)
        if has_background:
            init["beta_nuisance"] = fitted["alt_bg"]
        init.update({key: fitted[key] for key in mh_keys})
        ci_cols = _profile_ci(solve, stage, specs, srv, init, alt_alpha, alt_beta,
                              alt_lnl, n_patterns)

    # constant patterns are not fit (FEL.bf: is_constant -> zero row)
    constant = filt.constant_pattern_mask()
    site_rates = [fits[key] for key in mh_keys]
    for arr, val in ((alt_alpha, 0.0), (alt_beta, 0.0), (null_common, 0.0),
                     (lrt, 0.0), (pvals, 1.0), (total_bl, 0.0)):
        arr[constant] = val
    for arr in list(ci_cols or ()) + site_rates:
        arr[constant] = 0.0

    # column order mirrors FEL.bf:174-270: base, [ci x3], [p-asmp], [2H], [3H]
    columns = [alt_alpha, alt_beta, null_common, lrt, pvals, total_bl]
    headers = [list(h) for h in _HEADERS]
    if ci:
        columns += list(ci_cols)
        headers += [list(h) for h in _CI_HEADERS]
    if resample > 0:
        columns.append(p_asymptotic)
        headers.append(list(_PASMP_HEADER))
    if mh:
        columns.append(site_rates[0] if mh_est else np.full(n_patterns, delta_hat))
        headers.append(list(_2H_HEADER))
        if mh_triple:
            columns.append(site_rates[1] if mh_est else np.full(n_patterns, psi_hat))
            headers.append(list(_3H_HEADER))
    dup = filt.duplicate_map
    site_table = np.stack([c[dup] for c in columns], axis=1)
    return site_table, headers


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
    """FEL on one codon alignment (CHARSET partitions: one site table
    each), on ``device`` (default ``settings.device``: the card, raising
    without one).  The signature is the JAX package's; ``pvalue`` and
    ``site_precision`` are accepted and, as there, not used by the fit.

    ``resample`` > 0: per-site parametric-bootstrap p-values, ``p = (1 +
    #{LRT_sim >= LRT_obs}) / (N + 1)`` over that many columns simulated
    under each site's null fit from ``resample_seed`` (FEL.bf:805-820).
    ``multiple_hits`` "Double" / "Double+Triple": 2-hit (delta) and 3-hit
    (psi) rates in the global fit and the site models (FEL.bf:102-137);
    ``site_multihit`` "Estimate" fits them per site, "Global" plugs in the
    global values (FEL.bf:163-172).  ``ci``: 95% profile-likelihood
    intervals on site dN/dS (FEL.bf:738-756)."""
    md = common.load_codon_data_multi(alignment, genetic_code, tree, branches, device=device)
    common.progress("fel", f"{md.n_partitions} partition(s); fitting nucleotide GTR")
    gtr = common.fit_gtr_multi(md, precision=precision)
    md, gtr = common.kill_zero_branches_multi(md, gtr, branches)
    common.progress("fel", f"GTR lnL {gtr.loglik:.3f}; fitting global MG94xREV")
    mg = common.fit_partitioned_mg94_multi(md, gtr, precision=precision,
                                           multiple_hits=multiple_hits)
    common.progress("fel", f"MG94 lnL {mg.loglik:.3f}; per-site fits")

    content = {}
    tables = []
    for k, (pdat, mgp) in enumerate(zip(md.parts, mg.parts)):
        tables.append(solve_partition(pdat, mgp, srv, site_multihit, resample,
                                      resample_seed, ci))
        content[str(k)] = tables[-1][0].tolist()
    site_table, headers = tables[0]

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
                for g, name in enumerate(md.parts[0].group_names)
            },
        ),
    }
    info = ("FEL (Fixed Effects Likelihood) estimates site-wise synonymous "
            "(&alpha;) and non-synonymous (&beta;) rates")
    extra = {"MLE": {"headers": headers, "content": content}}
    if md.n_partitions > 1:
        json = analysis_json_parts(info=info, version="2.1", md=md, fits=fits, extra=extra)
    else:
        json = analysis_json(info=info, version="2.1", data=md.parts[0], fits=fits, extra=extra)
    return FELResult(json=json, site_table=site_table, headers=headers,
                     data=md.parts[0], gtr=gtr.parts[0], mg94=mg.parts[0])
