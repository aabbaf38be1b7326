"""LEISR — per-site relative evolutionary rate inference
(Rate4Site-like; Spielman & Kosakovsky Pond 2018).

Counterpart of ``hyphy_tpu/methods/leisr.py`` (reference
``res/TemplateBatchFiles/LEISR.bf``).  Pipeline:

1. fit a baseline model with free branch lengths — GTR/HKY85/JC69
   (nucleotide) or LG/WAG/JTT/... "+F" (protein) (LEISR.bf:104-135);
2. per site, a single global scaler ``r`` multiplies every branch length
   (estimators.ApplyExistingEstimates proportional-scaler mode,
   LEISR.bf:268-271); fit r per site (LEISR.bf:393-449) by the batched
   Nelder-Mead over all patterns;
3. 95% profile-likelihood CI per site (``parameters.GetProfileCI``,
   LEISR.bf:449): lnL(r) = lnL_max - chi^2_1(0.95)/2, by the fixed-trip
   bisection of :func:`vmapped_profile_ci`, batched over patterns.

Output columns (LEISR.bf:202-206): MLE, Lower, Upper, LogL global (site
lnL at r = 1), LogL local (site lnL at the MLE).  Constant patterns get
r = 0 and a lower bound of 0.

The per-site route.  One generator ``Q`` serves every site; site ``n``'s
branch ``b`` has ``expm(r_n t_b Q)``.  In fp64 (the CPU's default) that is
the JAX package's route: one fp64 ``eigh`` of ``Q`` per run (per device of
the mesh that ``settings.mesh`` names, which splits the sites), each site's
eigenvalues scaled by its ``r``.  In fp32 (the card's default) it is
FEL's Taylor vector action on the generators ``r_n Q``: the profile's lower
root probes ``r`` down to 1e-8, where the spectral propagator's off-diagonal
entries are cancellations of O(1) terms (ROADMAP 3.5), which fp32 cannot
hold; the Taylor series of ``r Q t`` keeps them at fp32 round-off.  A
residue absent from the data (+F frequency 0) also takes the Taylor route,
in fp64 too: the spectral route's symmetrisation divides by the square root
of that frequency (ROADMAP 3.21).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from hyphy_tpu_torch.config import resolve_device, settings
from hyphy_tpu_torch.data.alignment import read_alignment
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.io.json_out import model_fit_entry
from hyphy_tpu_torch.likelihood import FitResult, LikelihoodFunction, Partition
from hyphy_tpu_torch.methods import common
from hyphy_tpu_torch.models import frequencies as freq_mod
from hyphy_tpu_torch.models.dna import GTR, HKY85, JC69
from hyphy_tpu_torch.models.parameters import ParamSpec
from hyphy_tpu_torch.models.protein import EmpiricalProtein
from hyphy_tpu_torch.ops import expm as expm_ops
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.parallel.mesh import per_device, sharded_site_solve
from hyphy_tpu_torch.optimize.nelder_mead import vmapped_nelder_mead
from hyphy_tpu_torch.tree.topology import Tree

_CHI2_95_HALF = 1.9207294  # chi^2_1 0.95 quantile / 2

_HEADERS = [
    ["MLE", "Relative rate estimate at a site"],
    ["Lower", "Lower bound of 95% profile likelihood CI"],
    ["Upper", "Upper bound of 95% profile likelihood CI"],
    ["LogL global", "Site log likelihood under the global (average rate) model fit"],
    ["LogL local", "Site log likelihood under the local (site-specific rate) model fit"],
]


@dataclasses.dataclass
class LEISRResult:
    json: Dict
    site_table: np.ndarray      # [sites, 5]
    headers: List
    rates: np.ndarray           # per-site MLE rate
    baseline_loglik: float


def _nucleotide_model(name: str, filt: DataFilter, device):
    freqs = freq_mod.empirical_nucleotide(filt)
    if name.upper() == "GTR":
        return GTR(freqs, device=device)
    if name.upper() in ("HKY85", "HKY"):
        return HKY85(freqs, device=device)
    if name.upper() in ("JC69", "JC"):
        return JC69(device=device)
    raise ValueError(f"unknown nucleotide model {name!r}")


def vmapped_profile_ci(
    loglik: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    idx: torch.Tensor,
    r_mle: torch.Tensor,
    lnl_mle: torch.Tensor,
    level_drop: float = _CHI2_95_HALF,
    lower_floor: float = 1e-8,
    upper_cap: float = 1e26,
    iters: int = 60,
):
    """Batched profile-likelihood CI (parameters.GetProfileCI semantics):
    per item, bisect for the two roots of lnL(r) = lnL_mle - level_drop on
    either side of the MLE, in log space.  Fixed trips, as the JAX
    package's: 10 expansions of the far end by 3 in log r, one test of the
    bound, then ``iters`` halvings per side, each one batched evaluation of
    ``loglik(idx [N], r [N]) -> [N]`` (the JAX package ``vmap``s a per-item
    function).  Returns (lower ``[N]``, upper ``[N]``) fp64."""
    target = lnl_mle.to(torch.float64) - level_drop
    log_mle = torch.log(torch.clamp_min(r_mle.to(torch.float64), lower_floor))
    log_lo, log_hi = np.log(lower_floor), np.log(upper_cap)

    def above(log_r):
        return loglik(idx, torch.exp(log_r)).to(torch.float64) > target

    def bisect(side):
        bound = log_hi if side > 0 else log_lo
        far = log_mle + side * 2.0
        # expand the far end until lnL(far) < target (or the bound is hit)
        for _ in range(10):
            need = above(far)
            far = torch.where(need, torch.clamp(far + side * 3.0, log_lo, log_hi), far)
            far = torch.where(need & (torch.abs(far - bound) < 1e-12),
                              torch.full_like(far, bound), far)
        hit_bound = above(far)                  # no root within bounds
        near = log_mle
        for _ in range(iters):
            mid = 0.5 * (near + far)
            up = above(mid)
            near, far = torch.where(up, mid, near), torch.where(up, far, mid)
        root = 0.5 * (near + far)
        return torch.exp(torch.where(hit_bound, torch.full_like(root, bound), root))

    return bisect(-1), bisect(+1)


def fit_baseline(lf: LikelihoodFunction, tree: Tree, precision: float) -> FitResult:
    """The baseline fit with free branch lengths, started at the tree's
    input lengths where it has them."""
    init = {}
    if np.isfinite(tree.input_lengths[:-1]).all():
        init["t"] = torch.as_tensor(np.maximum(tree.input_lengths[:-1], 1e-6))
    return lf.fit(init=init, precision=precision)


def site_log_likelihood(model, params, filt: DataFilter, tree: Tree, dtype: torch.dtype,
                        spectral: bool):
    """The per-site objective ``loglik(idx [N], r [N]) -> [N]``: pattern
    ``idx[n]`` with every branch time of the baseline fit ``params["t"]``
    scaled by ``r[n]``.  ``spectral``: one fp64 eigendecomposition of the
    fitted generator, the eigenvalues scaled per site (the JAX package's
    route); else the Taylor vector action of the fp64 generators ``r_n Q``
    cast to ``dtype`` (FEL's fp32 route)."""
    device = model.device
    with torch.no_grad():
        q = model.q_matrix({k: v.to(torch.float64) for k, v in params.items()})
    freqs = model.frequencies.to(dtype)
    t_hat = params["t"].detach().to(device=device, dtype=dtype)
    leaves = torch.as_tensor(filt.leaf_partials(), device=device).to(dtype)
    leaves = leaves.transpose(0, 1).contiguous()                      # [patterns, taxa, S]
    pdata = pruning.build_pruning_data(tree, device)
    groups = torch.zeros(t_hat.shape[0], dtype=torch.int64, device=device)
    # a residue the data lack has frequency 0 (+F), and the symmetrised
    # generator of the spectral route divides by its square root: its
    # propagators come back as garbage (ROADMAP 3.21); the Taylor route
    # needs no symmetrisation
    spectral = spectral and bool((model.frequencies > 0).all())
    if spectral:
        left, lam, right = (x.to(dtype) for x in expm_ops.reversible_spectral(
            q[None], model.frequencies))
    n_terms = expm_ops.taylor_action_terms(dtype)

    def loglik(idx, r):
        n = idx.shape[0]
        r = r.to(torch.float64)
        if spectral:
            lam_n = (r[:, None] * lam.to(torch.float64)).to(dtype)[:, None]   # [N, 1, S]
            return pruning.single_site_log_likelihood_spectral(
                left[None].repeat(n, 1, 1, 1), lam_n, right[None].repeat(n, 1, 1, 1),
                t_hat, groups, leaves[idx], freqs, pdata)
        m = (r[:, None, None, None] * q[None, None]).to(dtype)            # [N, 1, S, S]
        qn, m2p, rr, j = expm_ops.taylor_action_factors(m, t_hat)
        return pruning.single_site_log_likelihood_taylor(
            qn, m2p, rr[:, 0], j[:, 0], groups, n_terms, leaves[idx], freqs, pdata)

    return loglik


def site_log_likelihood_on(model, params, filt: DataFilter, tree: Tree, dtype: torch.dtype,
                           spectral: bool):
    """``dev -> loglik``: :func:`site_log_likelihood` with the model and the
    baseline fit ``params`` copied to ``dev``, built once per device (the
    blocks of a sharded :func:`fit_sites`)."""
    return per_device(lambda dev: site_log_likelihood(
        model.to(dev), {k: v.to(dev) for k, v in params.items()}, filt, tree, dtype, spectral))


def _site_bytes(tree: Tree, dtype: torch.dtype, n_states: int) -> float:
    """One site's working set in a batched evaluation, FEL's rule
    (``fel._site_bytes``) at one generator."""
    itemsize = torch.finfo(dtype).bits // 8
    return itemsize * n_states * (8 * (tree.n_nodes + 1) + 14 * n_states)


def fit_sites(loglik_on, n_patterns: int, bytes_per_item: float, device):
    """Every pattern's rate: lnL at r = 1, the Nelder-Mead fit of r from 1,
    the profile CI; the patterns split over the mesh that ``settings.mesh``
    names, in chunks of each block's share of its device's free memory.
    ``loglik_on(dev)``: the objective of :func:`site_log_likelihood` built
    on ``dev`` (:func:`site_log_likelihood_on`).  Returns numpy (r, lower,
    upper, lnl_global, lnl_local)."""
    def make_solver(dev):
        loglik = loglik_on(dev)

        def solver(idx):
            with torch.no_grad():
                ones = torch.ones(idx.shape[0], dtype=torch.float64, device=dev)
                lnl_global = loglik(idx, ones)
                specs = {"r": ParamSpec(init=1.0, lower=0.0, upper=1e26)}
                params, lnl_local = vmapped_nelder_mead(
                    lambda i, p: loglik(i, p["r"]), specs, {"r": ones}, idx)
                lo, hi = vmapped_profile_ci(loglik, idx, params["r"], lnl_local)
            return {"r": params["r"], "lo": lo, "hi": hi, "global": lnl_global,
                    "local": lnl_local}
        return solver

    out = sharded_site_solve(make_solver, n_patterns, bytes_per_item, device)
    return tuple(out[k].to(torch.float64).cpu().numpy().copy()
                 for k in ("r", "lo", "hi", "global", "local"))


def run(
    alignment: str,
    datatype: str = "nucleotide",
    model: str = "GTR",
    tree: Optional[str] = None,
    precision: float = 1e-5,
    device=None,
) -> LEISRResult:
    device = resolve_device(device)
    aln = read_alignment(alignment)
    if datatype not in ("nucleotide", "protein"):
        raise ValueError(datatype)
    filt = DataFilter.from_alignment(aln, datatype)
    if tree is None:
        if not aln.trees:
            raise ValueError("no tree in alignment file; pass tree")
        tree = next(iter(aln.trees.values()))
    tr = Tree.from_newick(tree, leaf_order=filt.names)

    if datatype == "nucleotide":
        mdl = _nucleotide_model(model, filt, device)
    else:
        # the reference appends +F: empirical frequencies from the data
        mdl = EmpiricalProtein(model, frequencies=freq_mod.empirical_character(filt),
                               device=device)

    lf = LikelihoodFunction([Partition(filt, tr, mdl)], device=device)
    res = fit_baseline(lf, tr, precision)
    common.progress("leisr", f"baseline {model} fit: lnL {res.loglik:.4f}")

    dtype = settings.likelihood_dtype(device)
    loglik_on = site_log_likelihood_on(mdl, res.params, filt, tr, dtype,
                                       spectral=dtype == torch.float64)
    r_mle, lo, hi, lnl_global, lnl_local = fit_sites(
        loglik_on, filt.n_patterns, _site_bytes(tr, dtype, mdl.n_states), device)
    common.progress("leisr", "per-site rates and profile CIs done")

    constant = filt.constant_pattern_mask()
    r_mle[constant] = 0.0
    lo[constant] = 0.0

    dup = filt.duplicate_map
    site_table = np.stack(
        [r_mle[dup], lo[dup], hi[dup], lnl_global[dup], lnl_local[dup]], axis=1
    )
    n_sites = len(dup)
    json = {
        "analysis": {
            "info": "LEISR (Likelihood Estimation of Individual Site Rates) "
                    "infers relative amino-acid or nucleotide rates",
            "version": "0.5",
        },
        "input": {
            "file name": alignment,
            "number of sequences": filt.n_sequences,
            "number of sites": n_sites,
            "partition count": 1,
        },
        "fits": {
            f"{model}": model_fit_entry(
                res.loglik, res.n_free_parameters, n_sites * filt.n_sequences,
                frequencies=mdl.frequencies.cpu().numpy(), display_order=0,
            ),
        },
        "MLE": {"headers": _HEADERS, "content": {"0": site_table.tolist()}},
    }
    return LEISRResult(
        json=json, site_table=site_table, headers=_HEADERS,
        rates=site_table[:, 0], baseline_loglik=res.loglik,
    )
