"""MEME — Mixed Effects Model of Evolution.

Counterpart of ``hyphy_tpu/methods/meme.py`` (reference
``SelectionAnalyses/MEME.bf``).  Per site: a K-class branch-site mixture on
tested branches (K = ``rate_classes``, MEME.bf:134) — classes 1..K-1:
(alpha, beta_i = omega_i * alpha, omega_i in [0,1]) with stick-breaking
weights (MEME.bf:498-513); class K: beta+ free; background branches get a
FEL-style (alpha, beta_bg).  The null constrains beta+ := alpha; the LRT
p-value uses the 2/3 - 2/3(0.45 chi2_1 + 0.55 chi2_2) mixture
(``MEME.bf:1656``).  A FEL fit per site seeds the MEME fit and is
reported alongside (``meme.handle_a_site``).

Per-branch empirical Bayes factors for the positive class come from
forcing each tested branch into each non-positive class and comparing to
the mixture likelihood (``meme.compute_branch_EBF``, MEME.bf:886); the
"# branches under selection" column counts tested branches with
EBF >= 100.  Each (site, tested branch, class) is one item of a batched
mixture evaluation.

``multiple_hits``: "Double"/"Double+Triple" adds 2- (delta) and 3-hit
(psi) rates (MEME.bf:140-155); ``site_multihit`` = "Estimate" frees them
per site, "Global" plugs in the global-fit MLEs (MEME.bf:478-481).

Every stage fits all sites at once (batched grid, candidates and
Nelder-Mead), the items split over the mesh that ``settings.mesh`` names,
each block from a host thread of its own and with :class:`MixtureSites`
built on its device, and on each device in chunks by its share of the
free memory (:func:`parallel.mesh.sharded_site_solve`).  The per-site
route follows the dtype, as in the reference: fp64 the spectral mixture,
fp32 (the card's default) the Taylor vector action in its ``mix_weights``
mode.

``resample`` > 0 replaces the mixture p-values by parametric-bootstrap ones
(MEME.bf:1445-1470): ``resample`` columns are drawn under each non-constant
site's null fit and the whole site pipeline (FEL, candidates, alternative,
null) is refitted on them as one batch of ``patterns x resample`` items;
p = (1 + #{LRT_sim >= LRT}) / (1 + N).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from hyphy_tpu_torch.config import canonical_device, settings
from hyphy_tpu_torch.io.json_out import analysis_json, analysis_json_parts, model_fit_entry
from hyphy_tpu_torch.methods import common, fel
from hyphy_tpu_torch.models.base import fill_diagonal_from_rows
from hyphy_tpu_torch.models.parameters import ParamSpec
from hyphy_tpu_torch.ops import expm as expm_ops
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.optimize.batched import grid_best_starts
from hyphy_tpu_torch.optimize.nelder_mead import vmapped_nelder_mead
from hyphy_tpu_torch.parallel.mesh import per_device, sharded_site_solve, to_device

# FEL-style start grid for the per-site FEL pre-fit
_FEL_GRID = np.array(
    [(0.01, 0.1), (1.0, 0.1), (1.0, 0.5), (1.0, 1.0), (1.0, 5.0), (10.0, 0.1)]
)
# candidate rows (MEME.bf initial_guess_grid) relative to the FEL estimates:
# (beta+ multiplier, omega_1 override, w_1 override)
_CAND = [(1.0, None, None), (2.0, 0.5, 0.5), (4.0, 0.25, 0.25),
         (1.0, 0.5, 0.5), (1.0, 0.75, 0.8), (8.0, 0.5, 0.8),
         (1.0, 0.0, 0.01), (1.0, 0.0, 0.7)]


@dataclasses.dataclass
class MEMEResult:
    json: Dict
    site_table: np.ndarray          # [sites, columns] of the first partition
    headers: list
    data: common.LoadedData
    gtr: common.GTRFit
    mg94: common.MG94Fit


def _stick_weights(ws: torch.Tensor) -> torch.Tensor:
    """``[..., K-1]`` stick-breaking aux -> ``[..., K]`` class weights
    (BS_REL.bf:313-351)."""
    k1 = ws.shape[-1]
    remaining = torch.cat([torch.ones_like(ws[..., :1]), torch.cumprod(1.0 - ws, dim=-1)], dim=-1)
    return torch.cat([ws * remaining[..., :k1], remaining[..., k1:]], dim=-1)


@dataclasses.dataclass
class MixtureSites:
    """One partition's per-site MEME likelihoods at the global MG94 fit.

    ``loglik(idx [N], p {k: [N]}, weights=None) -> [N]``: the mixture site
    lnL; families 0..K-2 are the negative/neutral classes (beta = omega_i
    alpha), K-1 the positive class (beta+), K the background (beta_bg, or
    0 without background branches); ``weights`` ``[N, branches, K+1]``
    overrides :meth:`class_weights` (the forced EBF evaluations).
    ``fel(idx, p) -> [N]``: the FEL model, tested (alpha, beta_fg),
    background (alpha, beta_bg).  :meth:`on` gives the same likelihoods
    built on another device (a block of a sharded solve)."""

    loglik: Callable
    fel: Callable
    rate_classes: int
    tested: torch.Tensor           # [branches] bool
    item_bytes: float              # working set of one mixture evaluation item
    fel_bytes: float               # ... of one FEL evaluation item
    device: torch.device
    rebuild: Callable              # device -> MixtureSites there, memoised

    def class_weights(self, p) -> torch.Tensor:
        return _class_weights(p, self.rate_classes, self.tested)

    def on(self, device) -> "MixtureSites":
        if canonical_device(device) == canonical_device(self.device):
            return self
        return self.rebuild(device)


def _class_weights(p, k: int, tested: torch.Tensor) -> torch.Tensor:
    """``[N, branches, K+1]`` family weights per branch: the stick weights
    of ``p``'s ``w_i`` on tested branches, weight 1 on the background
    family elsewhere."""
    w = _stick_weights(torch.stack([p[f"w_{i}"] for i in range(1, k)], dim=-1))
    tested_w = torch.cat([w, torch.zeros_like(w[:, :1])], dim=1)           # [N, K+1]
    background = torch.zeros(k + 1, dtype=w.dtype, device=w.device)
    background[k] = 1.0
    return torch.where(tested[None, :, None], tested_w[:, None, :], background)


def mixture_sites(
    data: common.LoadedData,
    mgp: common.MG94Fit,
    dtype: torch.dtype,
    spectral: bool,
    rate_classes: int,
    per_site_multihit: bool = False,
    states: Optional[torch.Tensor] = None,
) -> MixtureSites:
    """MEME's per-site likelihoods for one partition (see
    :class:`MixtureSites`), with the bases of :func:`fel._site_bases`.
    Generators are built in fp64 and cast to ``dtype``; ``spectral`` picks
    the route (fp64 spectral mixture, else the Taylor mixture).
    ``states``: an ``[items, taxa]`` int table of codon states (-1:
    missing) whose rows the items index in place of the data's patterns
    (the bootstrap's simulated columns), as in
    :func:`fel.site_log_likelihood`."""
    model = mgp.model
    device = model.device
    k = rate_classes
    tested = data.tested_branches
    has_background = bool((~tested).any())
    bases = fel._site_bases(mgp, per_site_multihit)
    alpha_hat = torch.as_tensor(mgp.alphas, device=device).to(dtype)
    freqs = model.frequencies.to(dtype)
    data_leaves = torch.as_tensor(data.codon_filter.leaf_partials(), device=device)
    data_leaves = data_leaves.to(dtype).transpose(0, 1).contiguous()     # [patterns, taxa, S]
    pdata = pruning.build_pruning_data(data.tree, device)
    n_terms = expm_ops.taylor_action_terms(dtype)
    fel_loglik = fel.site_log_likelihood(data, mgp, dtype, spectral, per_site_multihit)
    tested_t = torch.as_tensor(tested, device=device)
    codons = torch.arange(model.n_states, device=device)

    def generators(p):
        qs, qn = bases(p.get("delta"), p.get("psi"))
        a = p["alpha"]
        bb = p["beta_bg"] if has_background else torch.zeros_like(a)
        betas = torch.stack([p[f"omega_{i}"] * a for i in range(1, k)] + [p["beta_plus"], bb],
                            dim=1)                                          # [N, K+1]
        return fill_diagonal_from_rows(
            a[:, None, None, None] * qs[:, None] + betas[:, :, None, None] * qn[:, None]
        ).to(dtype)

    def loglik(idx, p, weights=None):
        m = generators(p)
        w = _class_weights(p, k, tested_t) if weights is None else weights
        leaf_vectors = fel.leaf_rows(data_leaves, states, idx, codons)
        if spectral:
            left, lam, right = expm_ops.reversible_spectral(m, freqs)
            return pruning.single_site_log_likelihood_spectral_mixture(
                left, lam, right, w, alpha_hat, leaf_vectors, freqs, pdata)
        qn_, m2p, r, j = expm_ops.taylor_action_factors(m, alpha_hat)
        return pruning.single_site_log_likelihood_taylor(
            qn_, m2p, r.transpose(1, 2), j.transpose(1, 2), None, n_terms, leaf_vectors,
            freqs, pdata, mix_weights=w)

    def fel_obj(idx, p):
        betas = [p["beta_fg"]] + ([p["beta_bg"]] if has_background else [])
        return fel_loglik(idx, p["alpha"], torch.stack(betas, dim=1), p.get("delta"),
                          p.get("psi"), states)

    # one evaluation item: the [nodes, S] CLV buffer and a level's messages
    # and temporaries (~8 buffers of it), plus each family's Taylor factors
    # (~14 [S, S] matrices) and its weights per branch (fel._site_bytes'
    # rule, with K+1 families)
    itemsize = torch.finfo(dtype).bits // 8
    s = model.n_states
    item_bytes = itemsize * (s * (8 * (data.tree.n_nodes + 1) + (k + 1) * 14 * s)
                             + (k + 1) * data.tree.n_branches)
    @per_device
    def rebuild(dev):
        return mixture_sites(data, mgp.to(dev), dtype, spectral, k, per_site_multihit,
                             None if states is None else to_device(states, dev))

    return MixtureSites(loglik=loglik, fel=fel_obj, rate_classes=k, tested=tested_t,
                        item_bytes=item_bytes, fel_bytes=fel._site_bytes(data, dtype, s),
                        device=device, rebuild=rebuild)


def _specs(k: int, has_background: bool, mh_rates: Dict[str, float]):
    """(FEL, MEME alternative, MEME null) parameter spaces."""
    rate = ParamSpec(init=1.0, lower=0.0, upper=10000.0)
    fel_specs = {"alpha": rate, "beta_fg": rate}
    meme_specs = {"alpha": rate, "beta_plus": rate}
    for i in range(1, k):
        meme_specs[f"omega_{i}"] = ParamSpec(init=min(0.25 * i, 1.0), lower=0.0, upper=1.0)
        # stick-breaking aux weights (MEME.bf:500 bounds 1e-8..1)
        meme_specs[f"w_{i}"] = ParamSpec(init=1.0 / (k - i + 1), lower=0.0, upper=1.0)
    if has_background:
        fel_specs["beta_bg"] = rate
        meme_specs["beta_bg"] = rate
    for key, val in mh_rates.items():
        fel_specs[key] = meme_specs[key] = ParamSpec(init=max(val, 1e-3), lower=0.0, upper=100.0)
    null_specs = {key: v for key, v in meme_specs.items() if key != "beta_plus"}
    return fel_specs, meme_specs, null_specs


def _fel_stage(sites: MixtureSites, specs, grid, idx) -> Dict[str, torch.Tensor]:
    """Stage 1: per-site FEL fits from the start grid."""
    starts, _ = grid_best_starts(sites.fel, grid, idx)
    params, lnl = vmapped_nelder_mead(sites.fel, specs, starts, idx)
    return {"alpha": params["alpha"], "beta": params["beta_fg"],
            "beta_bg": params.get("beta_bg", params["alpha"]), "lnl": lnl}


def _candidate_starts(sites: MixtureSites, idx, base, fel_beta) -> Dict[str, torch.Tensor]:
    """The best of the 8 candidate rows per site (the first maximum)."""
    n = idx.shape[0]
    cands, values = [], []
    for mult, om, wt in _CAND:
        c = dict(base)
        c["beta_plus"] = torch.clamp_min(fel_beta * mult, 1e-4)
        if om is not None:
            c["omega_1"] = torch.full_like(fel_beta, om)
            c["w_1"] = torch.full_like(fel_beta, wt)
        cands.append(c)
        values.append(sites.loglik(idx, c))
    best = torch.argmax(torch.stack(values), dim=0)
    rows = torch.arange(n, device=best.device)
    return {key: torch.stack([c[key] for c in cands])[best, rows] for key in base}


def _alternative_stage(sites: MixtureSites, specs, idx, starts) -> Dict[str, torch.Tensor]:
    """Stage 2: two Nelder-Mead passes of the mixture, the second from the
    first's optimum with a fresh simplex (the rank-1 shrink can collapse a
    simplex early on hard 4-parameter sites); the better one per site."""
    params, lnl = vmapped_nelder_mead(sites.loglik, specs, starts, idx)
    params2, lnl2 = vmapped_nelder_mead(sites.loglik, specs, params, idx)
    better = lnl2 > lnl
    out = {key: torch.where(better, params2[key], params[key]) for key in params}
    out["lnl"] = torch.maximum(lnl, lnl2)
    return out


def _null_stage(sites: MixtureSites, specs, idx, init) -> Dict[str, torch.Tensor]:
    """Stage 3: the null, beta+ := alpha."""
    def null_loglik(i, p):
        merged = dict(p)
        merged["beta_plus"] = torch.clamp_min(p["alpha"], 1e-4)
        return sites.loglik(i, merged)

    params, lnl = vmapped_nelder_mead(null_loglik, specs, init, idx)
    return dict(params, lnl=lnl)


def branch_ebfs(
    sites: MixtureSites,
    alt: Dict[str, torch.Tensor],
    tested_idx: np.ndarray,
    sites_idx: Optional[torch.Tensor] = None,
    chunk: Optional[int] = None,
) -> np.ndarray:
    """Per-branch EBFs of the positive class (meme.compute_branch_EBF):
    force each tested branch into each non-positive class c at the
    alternative fit ``alt`` ({parameter: [n], "lnl": [n]}, indexed by site
    row); posterior_+ = 1 - sum_c w_c L_c / L_mix.  Each (site, branch,
    class) is one item of a batched forced evaluation, the items split over
    the mesh that ``settings.mesh`` names and chunked by each block's share
    of its device's free memory (``chunk`` forces the items per chunk).
    ``sites_idx``: the data patterns of ``alt``'s rows (default: all, in
    order).  Returns ``[n, tested]`` (fp64)."""
    k = sites.rate_classes
    n = alt["lnl"].shape[0]
    device = alt["lnl"].device
    if sites_idx is None:
        sites_idx = torch.arange(n, device=device)
    per_site = len(tested_idx) * (k - 1)

    @per_device
    def make_solver(dev):
        sites_d, sites_idx_d = sites.on(dev), to_device(sites_idx, dev)
        tested_t = torch.as_tensor(tested_idx, device=dev)
        params = {key: to_device(v, dev) for key, v in alt.items() if key != "lnl"}

        def solver(items):
            row = items // per_site
            rest = items % per_site
            branch, cls = tested_t[rest // (k - 1)], rest % (k - 1)
            p = {key: v[row] for key, v in params.items()}
            weights = sites_d.class_weights(p)
            weights[torch.arange(items.shape[0], device=dev), branch] = \
                torch.nn.functional.one_hot(cls, k + 1).to(weights.dtype)
            return {"lnl": sites_d.loglik(sites_idx_d[row], p, weights=weights)}
        return solver

    forced = sharded_site_solve(make_solver, n * per_site, sites.item_bytes, device, chunk=chunk)
    forced = forced["lnl"].double().cpu().numpy().reshape(n, len(tested_idx), k - 1)
    w_all = _stick_weights(torch.stack([alt[f"w_{i}"] for i in range(1, k)], dim=-1))
    w_all = w_all.double().cpu().numpy()                                    # [n, K]
    w_neg = w_all[:, : k - 1]
    lnl = alt["lnl"].double().cpu().numpy()
    post_neg = (w_neg[:, None, :] * np.exp(forced - lnl[:, None, None])).sum(-1)
    post_pos = np.clip(1.0 - post_neg, 0.0, 1.0)
    prior_pos = w_all[:, k - 1]
    # degenerate weights: EBF := 1 (zero prior odds, meme.compute_branch_EBF)
    degenerate = (prior_pos <= 1e-12) | (prior_pos >= 1.0 - 1e-12)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        ebf = (post_pos / np.maximum(1.0 - post_pos, 1e-300)) * (
            (1.0 - prior_pos) / np.maximum(prior_pos, 1e-300))[:, None]
    return np.where(degenerate[:, None], 1.0, ebf)


def site_pipeline(sites: MixtureSites, specs, mh_rates: Dict[str, float],
                  has_background: bool, n_items: int, device):
    """Stages 1-3 over ``n_items`` items (the data's patterns, or the
    bootstrap's simulated columns): per-site FEL fits from the start grid,
    the alternative mixture fits seeded from them per
    meme.handle_a_site, then the null.  Returns (FEL fit, alternative,
    null), each {parameter: [n], "lnl": [n]}."""
    k = sites.rate_classes
    fel_specs, meme_specs, null_specs = specs
    f64 = dict(dtype=torch.float64, device=device)

    def solve(stage, item_bytes, inputs):
        """``stage(sites, inputs, idx)`` over the items, split over the mesh,
        with ``sites`` and ``inputs`` (a dict of tensors) on each block's
        device."""
        @per_device
        def make_solver(dev):
            sites_d = sites.on(dev)
            inputs_d = {key: to_device(v, dev) for key, v in inputs.items()}
            return lambda idx: stage(sites_d, inputs_d, idx)

        return sharded_site_solve(make_solver, n_items, item_bytes, device)

    # -- stage 1: FEL ----------------------------------------------------------
    grid = {"alpha": torch.tensor(_FEL_GRID[:, 0], **f64),
            "beta_fg": torch.tensor(_FEL_GRID[:, 1], **f64)}
    if has_background:
        grid["beta_bg"] = torch.tensor(_FEL_GRID[:, 1], **f64)
    for key, val in mh_rates.items():
        grid[key] = torch.full((_FEL_GRID.shape[0],), val, **f64)
    common.progress("meme", "stage 1: per-site FEL fits")
    fel_fit = solve(lambda sites_d, g, idx: _fel_stage(sites_d, fel_specs, g, idx),
                    sites.fel_bytes, grid)
    fa, fb, fbg = (fel_fit[key].double() for key in ("alpha", "beta", "beta_bg"))

    # -- stage 2: the alternative, seeded per meme.handle_a_site ---------------
    common.progress("meme", "stage 2: per-site MEME alternative fits")
    pos_case = fa < fb
    omega_rate = torch.where(fa > 1e-5, fb / torch.clamp_min(fa, 1e-5), torch.ones_like(fa))
    init = {"alpha": torch.clamp_max(fa, 100.0),
            "omega_1": torch.clamp(torch.where(pos_case, 0.0, omega_rate), 0.0, 1.0),
            "w_1": torch.where(pos_case, torch.full_like(fa, 0.25), torch.full_like(fa, 0.75)),
            "beta_plus": torch.where(pos_case, fb, torch.clamp_min(1.5 * fa, 0.1))}
    for i in range(2, k):
        init[f"omega_{i}"] = torch.full_like(fa, min(0.25 * i, 1.0))
        init[f"w_{i}"] = torch.full_like(fa, 1.0 / (k - i + 1))
    if has_background:
        init["beta_bg"] = fbg
    for key, val in mh_rates.items():
        init[key] = torch.full_like(fa, val)

    def alternative(sites_d, inputs, idx):
        starts = _candidate_starts(sites_d, idx,
                                   {key: inputs[key][idx] for key in init}, inputs["_fb"][idx])
        return _alternative_stage(sites_d, meme_specs, idx, starts)

    alt = solve(alternative, sites.item_bytes, dict(init, _fb=fb))

    # -- stage 3: the null -----------------------------------------------------
    common.progress("meme", "stage 3: per-site null fits")
    null_init = {key: alt[key] for key in null_specs}
    # alpha = 0 is a logit-space trap (vanishing steps at the bound); start
    # the null from the FEL-style blend of alternative alpha and beta+
    null_init["alpha"] = (torch.clamp_max(alt["alpha"], 100.0)
                          + 3.0 * torch.clamp_max(alt["beta_plus"], 100.0)) / 4.0
    null = solve(lambda sites_d, inputs, idx: _null_stage(
        sites_d, null_specs, idx, {key: v[idx] for key, v in inputs.items()}),
        sites.item_bytes, null_init)
    return fel_fit, alt, null


def simulate_null_states(
    data: common.LoadedData,
    mgp: common.MG94Fit,
    null: Dict[str, np.ndarray],
    rate_classes: int,
    n_reps: int,
    seed: int,
    per_site_multihit: bool = False,
) -> np.ndarray:
    """``[patterns * n_reps, taxa]`` int16 states drawn under each
    non-constant site's null fit (MEME.bf:1445-1470) by
    :func:`fel.draw_site_columns`.  ``null``: the per-pattern null
    parameters (``alpha``, ``omega_i``, ``w_i``, ``beta_bg`` with background
    branches, ``delta``/``psi`` with per-site multiple hits).  Each site's
    branch propagators are built on the model's device in fp64: one
    shared-power Taylor series per family (the K classes with beta+ :=
    alpha on the tested branches, the background family elsewhere), mixed
    with the stick weights on the tested branches.  The JAX package builds
    the same propagators with host ``scipy.linalg.expm``."""
    k = rate_classes
    model = mgp.model
    device = model.device
    f64 = dict(dtype=torch.float64, device=device)
    tested = data.tested_branches
    has_background = bool((~tested).any())
    tested_idx = torch.as_tensor(np.nonzero(tested)[0], device=device)
    background_idx = torch.as_tensor(np.nonzero(~tested)[0], device=device)
    bases = fel._site_bases(mgp, per_site_multihit)
    times = torch.as_tensor(mgp.alphas, **f64)

    def propagators(s):
        site = {key: torch.as_tensor(null[key][s: s + 1], **f64)
                for key in ("delta", "psi") if per_site_multihit and key in null}
        q_syn, q_non = (q[0].double() for q in bases(site.get("delta"), site.get("psi")))
        a = float(null["alpha"][s])
        betas = [float(null[f"omega_{i}"][s]) * a for i in range(1, k)] + [a]
        w = _stick_weights(torch.as_tensor([float(null[f"w_{i}"][s]) for i in range(1, k)],
                                           **f64))
        p = torch.empty((times.shape[0],) + q_syn.shape, **f64)
        mix = None
        for c, beta in enumerate(betas):
            term = w[c] * expm_ops.shared_taylor_propagators(
                fill_diagonal_from_rows(a * q_syn + beta * q_non), times[tested_idx])
            mix = term if mix is None else mix + term
        p[tested_idx] = mix
        if has_background:
            bg = float(null["beta_bg"][s])
            p[background_idx] = expm_ops.shared_taylor_propagators(
                fill_diagonal_from_rows(a * q_syn + bg * q_non), times[background_idx])
        return p

    return fel.draw_site_columns(data, mgp, propagators, n_reps, seed)


def bootstrap_lrts(data, mgp, sites: MixtureSites, specs, mh_rates, null, n_reps: int,
                   seed: int, dtype, spectral: bool) -> np.ndarray:
    """``[patterns, n_reps]`` LRTs of the whole site pipeline refitted on
    ``n_reps`` columns simulated per site under its null fit ``null``
    (:func:`simulate_null_states`); the states stay an int table on the
    device, each evaluation making its chunk's rows one-hot."""
    k = sites.rate_classes
    device = mgp.model.device
    common.progress("meme", f"parametric bootstrap: {n_reps} replicates/site")
    null_np = {key: v.double().cpu().numpy() for key, v in null.items()}
    states = simulate_null_states(data, mgp, null_np, k, n_reps, seed,
                                  per_site_multihit=bool(mh_rates))
    sim_sites = mixture_sites(data, mgp, dtype, spectral, k, per_site_multihit=bool(mh_rates),
                              states=torch.as_tensor(states, device=device))
    _, alt, sim_null = site_pipeline(sim_sites, specs, mh_rates,
                                     bool((~data.tested_branches).any()), states.shape[0],
                                     device)
    lrt = 2.0 * (alt["lnl"].double() - sim_null["lnl"].double())
    return np.maximum(lrt.cpu().numpy(), 0.0).reshape(-1, n_reps)


def solve_partition(
    data: common.LoadedData,
    mgp: common.MG94Fit,
    rate_classes: int = 2,
    site_multihit: str = "Estimate",
    resample: int = 0,
    resample_seed: int = 0,
):
    """The per-site stages of one partition: FEL fits, the alternative
    mixture fits from the best of 8 candidate starts, the null fits, the
    branch EBFs, the mixture (or, with ``resample``, bootstrap) p-values
    and the site table expanded from patterns to sites.  Returns
    (site_table, headers)."""
    k = rate_classes
    filt = data.codon_filter
    tested = data.tested_branches
    has_background = bool((~tested).any())
    n_patterns = filt.n_patterns
    model = mgp.model
    device = model.device
    mh = model.multiple_hits != "None"
    mh_triple = model.multiple_hits == "Double+Triple"
    mh_est = mh and site_multihit == "Estimate"
    delta_hat = float(mgp.params["delta"]) if mh else 0.0
    psi_hat = float(mgp.params["psi"]) if mh_triple else 0.0
    mh_rates = {}
    if mh_est:
        mh_rates["delta"] = delta_hat
        if mh_triple:
            mh_rates["psi"] = psi_hat
    dtype = settings.likelihood_dtype(device)
    spectral = dtype == torch.float64
    sites = mixture_sites(data, mgp, dtype, spectral=spectral, rate_classes=k,
                          per_site_multihit=mh_est)
    specs = _specs(k, has_background, mh_rates)
    fel_fit, alt, null = site_pipeline(sites, specs, mh_rates, has_background, n_patterns,
                                       device)

    # -- stage 4: branch EBFs --------------------------------------------------
    common.progress("meme", "stage 4: branch EBFs")
    ebf = branch_ebfs(sites, alt, np.nonzero(tested)[0])

    fits = {f"alt_{key}": v.double().cpu().numpy() for key, v in alt.items()}
    alpha, beta_plus, alt_lnl = fits["alt_alpha"], fits["alt_beta_plus"], fits["alt_lnl"]
    null_lnl = null["lnl"].double().cpu().numpy()
    fel_lnl = fel_fit["lnl"].double().cpu().numpy()
    fa, fb = (fel_fit[key].double().cpu().numpy() for key in ("alpha", "beta"))
    omegas = [fits[f"alt_omega_{i}"] for i in range(1, k)]
    weights = _stick_weights(torch.stack([alt[f"w_{i}"] for i in range(1, k)], dim=-1))
    weights = weights.double().cpu().numpy().T                              # [K, n]

    # LRT + p-values; sites failing the positive-evidence condition get
    # Null = alternative (MEME.bf else-branch)
    w_plus = weights[k - 1]
    condition = (beta_plus > alpha) & (w_plus > 1e-6)
    lrt = np.where(condition, np.maximum(2.0 * (alt_lnl - null_lnl), 0.0), 0.0)
    pvals = np.array([
        2.0 / 3.0 - 2.0 / 3.0 * (
            0.45 * (1.0 - common.chi2_sf(x, 1)) + 0.55 * (1.0 - common.chi2_sf(x, 2)))
        for x in lrt
    ])
    if resample > 0:
        # MEME.bf:1662: p = (1 + #{LRT_sim >= LRT}) / (1 + N) over columns
        # simulated under each site's null
        lrt_sim = bootstrap_lrts(data, mgp, sites, specs, mh_rates, null, resample,
                                 resample_seed, dtype, spectral)
        hits = (lrt_sim >= lrt[:, None] - 1e-10).sum(axis=1)
        pvals = np.where(condition, (hits + 1.0) / (resample + 1.0), 1.0)
    n_branches_sel = np.where(condition, (ebf >= 100.0).sum(axis=1).astype(float), 0.0)

    # total tested branch length at the alternative fit
    with torch.no_grad():
        q_syn, q_non = model.combined_basis_matrices(mgp.params)
        rate_syn = float(q_syn.sum(-1) @ model.frequencies)
        rate_non = float(q_non.sum(-1) @ model.frequencies)
    mean_beta = sum(weights[i - 1] * omegas[i - 1] * alpha for i in range(1, k))
    mean_beta = mean_beta + w_plus * beta_plus
    bl = (alpha[:, None] * rate_syn + mean_beta[:, None] * rate_non) * np.asarray(
        mgp.alphas)[None, :] / 3.0
    total_bl = bl @ tested.astype(np.float64)

    cols = [alpha]
    col_consts = [0.0]
    headers = [["&alpha;", "Synonymous substitution rate at a site"]]
    for i in range(1, k):
        cols += [omegas[i - 1] * alpha, weights[i - 1]]
        col_consts += [0.0, 1.0 if i == 1 else 0.0]
        headers += [
            [f"&beta;<sup>{i}</sup>",
             f"Non-synonymous substitution rate at a site for the negative/neutral evolution component {i}"],
            [f"p<sup>{i}</sup>",
             f"Mixture distribution weight allocated to negative/neutral evolution component {i}"],
        ]
    cols += [beta_plus, w_plus, lrt, pvals, n_branches_sel, total_bl,
             alt_lnl, fel_lnl, np.maximum(2.0 * (alt_lnl - fel_lnl), 0.0), fa, fb]
    col_consts += [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    headers += [
        ["&beta;<sup>+</sup>", "Non-synonymous substitution rate at a site for the positive selection component"],
        ["p<sup>+</sup>", "Mixture distribution weight allocated to the positive selection component"],
        ["LRT", "Likelihood ratio test statistic for episodic diversification"],
        ["p-value", "Asymptotic p-value for episodic diversification"],
        ["# branches under selection", "Number of tested branches with EBF >= 100 for the positive class"],
        ["Total branch length", "The total length of branches contributing to inference at this site"],
        ["MEME LogL", "Site Log-likelihood under the MEME model"],
        ["FEL LogL", "Site Log-likelihood under the FEL model"],
        ["LRT MEME vs FEL", "Likelihood ratio test statistic for MEME vs FEL"],
        ["FEL &alpha;", "Synonymous substitution rate under the FEL model"],
        ["FEL &beta;", "Non-synonymous substitution rate under the FEL model"],
    ]
    if mh:
        cols.append(fits["alt_delta"] if mh_est else np.full(n_patterns, delta_hat))
        col_consts.append(0.0)
        headers.append(["2H rate", "Site-level rate for 2-nucleotide substitutions"])
        if mh_triple:
            cols.append(fits["alt_psi"] if mh_est else np.full(n_patterns, psi_hat))
            col_consts.append(0.0)
            headers.append(["3H rate", "Site-level rate for 3-nucleotide substitutions"])

    constant = filt.constant_pattern_mask()
    cols = [np.array(c, dtype=float, copy=True) for c in cols]
    for arr, cval in zip(cols, col_consts):
        arr[constant] = cval
    site_table = np.stack([c[filt.duplicate_map] for c in cols], axis=1)
    return site_table, headers


def run(
    alignment: str,
    genetic_code: str = "Universal",
    tree: Optional[str] = None,
    branches: str = "All",
    pvalue: float = 0.1,
    precision: float = 1e-5,
    rate_classes: int = 2,
    resample: int = 0,
    resample_seed: int = 0,
    multiple_hits: str = "None",
    site_multihit: str = "Estimate",
    device=None,
) -> MEMEResult:
    """MEME on one codon alignment (CHARSET partitions: one site table
    each), on ``device`` (default ``settings.device``: the card, raising
    without one).  The signature is the JAX package's; ``pvalue`` is
    accepted and, as there, not used by the fit.  ``resample`` > 0:
    per-site parametric-bootstrap p-values over that many columns simulated
    under each site's null fit from ``resample_seed``
    (MEME.bf:1445-1470)."""
    if not (2 <= rate_classes <= 4):
        raise ValueError("rate_classes must be in [2, 4] (MEME.bf:135)")
    md = common.load_codon_data_multi(alignment, genetic_code, tree, branches, device=device)
    common.progress("meme", f"{md.n_partitions} partition(s); fitting nucleotide GTR")
    gtr = common.fit_gtr_multi(md, precision=precision)
    md, gtr = common.kill_zero_branches_multi(md, gtr, branches)
    common.progress("meme", f"GTR lnL {gtr.loglik:.3f}; fitting global MG94xREV")
    mg = common.fit_partitioned_mg94_multi(md, gtr, precision=precision,
                                           multiple_hits=multiple_hits)
    common.progress("meme", f"MG94 lnL {mg.loglik:.3f}")

    content = {}
    tables = []
    for p_idx, (pdat, mgp) in enumerate(zip(md.parts, mg.parts)):
        tables.append(solve_partition(pdat, mgp, rate_classes, site_multihit, resample,
                                      resample_seed))
        content[str(p_idx)] = tables[-1][0].tolist()
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
    info = ("MEME (Mixed Effects Model of Evolution) estimates a site-wise "
            "synonymous rate and a mixture of omega classes on tested branches")
    extra = {
        "MLE": {"headers": headers, "content": content},
        "analysis settings": {"rates": rate_classes, "multihit": multiple_hits,
                              "resample": resample},
    }
    if md.n_partitions > 1:
        json = analysis_json_parts(info=info, version="3.0", md=md, fits=fits, extra=extra)
    else:
        json = analysis_json(info=info, version="3.0", data=md.parts[0], fits=fits, extra=extra)
    return MEMEResult(json=json, site_table=site_table, headers=headers,
                      data=md.parts[0], gtr=gtr.parts[0], mg94=mg.parts[0])
