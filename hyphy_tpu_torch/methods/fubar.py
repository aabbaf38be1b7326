"""FUBAR — Fast Unconstrained Bayesian AppRoximation.

Counterpart of ``hyphy_tpu/methods/fubar.py`` (reference
``SelectionAnalyses/FUBAR.bf`` + ``modules/grid_compute.ibf``).  Pipeline:
GTR fit -> 20x20 (alpha, beta) rate grid (70% of points linear in [0,1],
the rest cubic to 50) -> per-grid-point site log-likelihood vectors (theta
fixed at the GTR MLEs, CF3x4 frequencies, branch rates proportional to the
GTR branch lengths) -> Dirichlet-prior posterior over grid weights by
0th-order variational Bayes (default), collapsed Gibbs or MCMC
(:mod:`grid_bayes`) -> per-site P(beta > alpha) and empirical Bayes
factors.

Each grid point is one whole gene pruning (``ops/pruning.py::
site_log_likelihoods``, every level through the K1 kernel), and the grid is
pruned twice (pass 1 picks the best overall scaling, pass 2 runs on the
rebased tree).  The JAX package ``vmap``s the pruning over grid points and
shards them over its mesh; here the grid points are split over the mesh
that ``settings.mesh`` names (``parallel/mesh.py::sharded_site_solve``,
each block from a host thread of its own), and on each device the grid
form of the pruning folds a chunk of grid points into K1's node axis, one
launch per level for the chunk, the chunks sized by the block's share of
the card's free memory and capped so that every level's launch stays
within K1's node limit (:func:`pruning.max_grid_points`).
Propagators per grid point follow the port's MG94 rule: fp64 spectral,
fp32 (the card's default) shared-power Taylor.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.io.json_out import analysis_json, model_fit_entry
from hyphy_tpu_torch.methods import common
from hyphy_tpu_torch.methods.grid_bayes import posterior_over_grid
from hyphy_tpu_torch.models import frequencies as freq_mod
from hyphy_tpu_torch.models.base import fill_diagonal_from_rows
from hyphy_tpu_torch.models.codon import MG94Base
from hyphy_tpu_torch.ops import expm as expm_ops
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.parallel.mesh import per_device, sharded_site_solve, to_device


def alpha_beta_grid(points: int = 20, non_zero: bool = False) -> np.ndarray:
    """(alpha, beta) grid (fubar.DefineAlphaBetaGrid, FUBAR.bf:799)."""
    points = max(points, 5)
    neg = int(points * 0.7 + 0.5)
    pos = int((points - 1) * 0.3)
    if neg + pos != points:
        pos = points - neg
    one_d = np.zeros(points)
    one_d[:neg] = np.arange(neg) / neg
    one_d[neg - 1] = 1.0
    step = 49.0 ** (1.0 / 3.0) / pos
    for k in range(1, pos + 1):
        one_d[neg + k - 1] = 1.0 + (step * k) ** 3
    grid = np.array([(a, b) for a in one_d for b in one_d])
    if non_zero:
        mn = max(1e-3, one_d[0])
        grid[:, 0] = np.maximum(grid[:, 0], mn)
    return grid


@dataclasses.dataclass
class GridPruning:
    """One pass's inputs: the bases at the GTR thetas, the leaves and the
    schedule, in the compute dtype; ``point_bytes`` is one grid point's
    working set: its peak in the grid form of the pruning
    (:func:`pruning.grid_point_bytes`) and its propagators, built in fp64
    and cast, then joined with the identity row."""

    q_syn: torch.Tensor
    q_non: torch.Tensor
    freqs: torch.Tensor
    leaves: torch.Tensor
    schedule: pruning.PruningData
    dtype: torch.dtype
    point_bytes: float

    def propagators(self, grid: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
        """``[n, branches, S, S]``: ``expm(t_b (a Q_syn + b Q_nonsyn))`` for
        each (a, b) row of ``grid`` (fp64 ``[n, 2]``), built in fp64 and
        cast: one batched eigendecomposition in fp64, one shared-power
        Taylor series per point otherwise."""
        m = fill_diagonal_from_rows(grid[:, 0, None, None] * self.q_syn
                                    + grid[:, 1, None, None] * self.q_non)
        if self.dtype == torch.float64:
            left, lam, right = expm_ops.reversible_spectral(m, self.freqs)
            return expm_ops.spectral_propagators(left[:, None], lam[:, None], right[:, None],
                                                 times[None, :])
        return torch.stack([expm_ops.shared_taylor_propagators(q, times.to(self.dtype))
                            for q in m.to(self.dtype)])


def grid_pruning(data: common.LoadedData, model: MG94Base, theta) -> GridPruning:
    filt = data.codon_filter
    device = model.device
    dtype = settings.likelihood_dtype(device)
    q_syn, q_non = model.basis_matrices(theta)
    s = model.n_states
    itemsize = torch.finfo(dtype).bits // 8
    schedule = pruning.build_pruning_data(data.tree, device)
    # the propagators: the cast set and its join, and in fp64 the spectral
    # build's three [branches, S, S] temporaries
    build = 3 * 8 if dtype == torch.float64 else 0
    prop_bytes = (data.tree.n_nodes + 1) * s * s * (2 * itemsize + build)
    return GridPruning(
        q_syn=q_syn.double(), q_non=q_non.double(), freqs=model.frequencies,
        leaves=torch.as_tensor(filt.leaf_partials(), device=device).to(dtype),
        schedule=schedule, dtype=dtype,
        point_bytes=pruning.grid_point_bytes(schedule, filt.n_patterns, s, itemsize)
        + prop_bytes)


def grid_pruning_to(gp, device):
    """``gp`` (this module's :class:`GridPruning` or FADE's) with its
    tensors and its schedule on ``device``: the inputs of one block of a
    sharded grid pass."""
    moved = {f.name: to_device(getattr(gp, f.name), device) for f in dataclasses.fields(gp)
             if isinstance(getattr(gp, f.name), torch.Tensor)}
    return dataclasses.replace(gp, schedule=pruning.data_to(gp.schedule, device), **moved)


def grid_pass(gp: GridPruning, grid: torch.Tensor, times,
              chunk: Optional[int] = None) -> torch.Tensor:
    """``[G, patterns]`` site lnL at every grid point with branch scales
    ``times``: the grid points split over the mesh that ``settings.mesh``
    names (:func:`parallel.mesh.sharded_site_solve`, each block's inputs
    copied to its device), on each device in chunks of ``chunk`` points or
    as many as the block's share of its card's free memory holds (every
    point on the CPU), and never more than keep each level's K1 launch
    within its node limit (:func:`pruning.max_grid_points`); each chunk is
    one call of the grid form of the pruning.  ``gp``
    is any grid pruning whose ``propagators(points, times)`` gives the
    chunk's ``[n, branches, S, S]`` (FADE's takes its target residue in
    place of ``times``)."""
    @per_device
    def make_solver(dev):
        gp_d, grid_d = grid_pruning_to(gp, dev), to_device(grid, dev)
        times_d = to_device(times, dev) if isinstance(times, torch.Tensor) else times

        def solver(idx):
            with torch.no_grad():
                p = gp_d.propagators(grid_d[idx], times_d)
                return {"sll": pruning.site_log_likelihoods(
                    p, gp_d.leaves, gp_d.freqs.to(gp_d.dtype), gp_d.schedule)}
        return solver

    return sharded_site_solve(make_solver, grid.shape[0], gp.point_bytes, grid.device,
                              chunk=chunk, max_chunk=pruning.max_grid_points(gp.schedule))["sll"]


def grid_site_loglik_matrix(
    data: common.LoadedData,
    grid: np.ndarray,
    precision: float = 1e-5,
    cache: Optional[str] = None,
    fingerprint_extra: str = "",
):
    """``[G, patterns]`` site log-likelihood vectors over an (alpha, beta)
    grid, the phases 1-2 shared by FUBAR and B-STILL: GTR fit -> branch
    scaling -> pass 1 (the best overall scaling) -> pass 2 on the rebased
    scales (reference: ``ComputeOnGrid``, ``modules/grid_compute.ibf:3-52``).
    ``cache``: an ``.npz`` of the matrix, the grid and a fingerprint of the
    data, read when it matches and written after pass 2.

    Returns ``(sll [G, patterns] fp64 numpy, gtr, rate_syn, rate_non)``
    where blexpr(alpha, beta) = alpha * rate_syn + beta * rate_non at the
    GTR thetas."""
    gc = data.genetic_code
    filt = data.codon_filter
    device = data.device

    if cache is not None and not cache.endswith(".npz"):
        cache = cache + ".npz"
    fingerprint = "|".join([
        str(filt.n_patterns), str(data.tree.n_leaves), gc.name, fingerprint_extra,
    ])
    grid_key = np.asarray(grid, np.float64)
    cached = None
    if cache is not None and os.path.exists(cache):
        loaded = np.load(cache)
        if (
            "fingerprint" in loaded.files
            and str(loaded["fingerprint"]) == fingerprint
            and "grid" in loaded.files
            and loaded["grid"].shape == grid_key.shape
            and np.allclose(loaded["grid"], grid_key)
        ):
            cached = loaded

    gtr = common.fit_gtr(data, precision=precision)
    corners, codon_freqs = freq_mod.cf3x4(filt, gc, device=device)
    model = MG94Base(gc, corners, codon_freqs, device=device)
    theta = {k: v.to(device) for k, v in gtr.params.items() if k.startswith("theta")}
    with torch.no_grad():
        rate_syn, rate_non = (float(r) for r in model.syn_nonsyn_unit_rates(theta))
    if cached is not None:
        return np.asarray(cached["sll"]), gtr, rate_syn, rate_non

    gp = grid_pruning(data, model, theta)
    grid_t = torch.as_tensor(grid_key, device=device)
    # branch scale solving BL(alpha=beta=c) = 3 * gtr_bl against the raw
    # branch length expression (fubar.scalers.SetBranchLength: FindRoot):
    # c = 3 * bl / (rate_syn + rate_non)
    c_b = torch.as_tensor(3.0 * gtr.branch_lengths / (rate_syn + rate_non), device=device)

    # pass 1: the best overall scaling on the grid (FUBAR.bf:280-292)
    sll = grid_pass(gp, grid_t, c_b).cpu().numpy()
    best = int(np.argmax(sll @ np.asarray(filt.pattern_weights)))
    a_hat, b_hat = grid[best]
    # rebase the branch scales at the best grid point
    c_b = c_b * float((a_hat * rate_syn + b_hat * rate_non) / (rate_syn + rate_non))

    # pass 2: the conditional site likelihood vectors on the rebased tree
    sll = grid_pass(gp, grid_t, c_b).cpu().numpy()
    if cache is not None:
        np.savez(cache, sll=sll, grid=grid_key, fingerprint=fingerprint)
    return sll, gtr, rate_syn, rate_non


def conditionals(sll: np.ndarray, filt) -> np.ndarray:
    """Patterns -> sites, normalized per site (ConvertToConditionals):
    ``cond [G, sites]`` with columns summing to 1."""
    sll_sites = sll[:, filt.duplicate_map]
    cond = np.exp(sll_sites - sll_sites.max(axis=0, keepdims=True))
    return cond / cond.sum(axis=0, keepdims=True)


@dataclasses.dataclass
class FUBARResult:
    json: Dict
    site_table: np.ndarray       # [sites, 6] (VB0)
    grid: np.ndarray             # [G, 2]
    posterior_weights: np.ndarray  # [G]
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
    posterior: float = 0.9,
    precision: float = 1e-5,
    seed: int = 0,
    cache: Optional[str] = None,
    device=None,
) -> FUBARResult:
    """FUBAR on one codon alignment, on ``device`` (default
    ``settings.device``: the card, raising without one).  ``cache``: a
    resumable checkpoint of the grid's likelihood vectors (reference
    fubar.cache, FUBAR.bf:160-236); phases 1-2 are skipped when it exists
    and matches."""
    data = common.load_codon_data(alignment, genetic_code, tree, branches, device=device)
    filt = data.codon_filter
    common.progress("fubar", f"site log-likelihoods on the {grid_points}x{grid_points} grid")
    grid = alpha_beta_grid(grid_points)
    sll, gtr, _, _ = grid_site_loglik_matrix(
        data, grid, precision=precision, cache=cache,
        fingerprint_extra="|".join([os.path.basename(alignment), branches, "fubar"]),
    )
    cond = conditionals(sll, filt)
    n_sites = cond.shape[1]

    common.progress("fubar", f"posterior over grid weights ({method})")
    posterior_mean, _ = posterior_over_grid(
        method, cond, concentration, chain_length, burn_in, samples,
        rng=np.random.default_rng(seed),
    )

    # per-site statistics (FUBAR.bf phase 4)
    p_ks = posterior_mean @ cond                         # [sites]
    alpha_col = (posterior_mean * grid[:, 0]) @ cond / p_ks
    beta_col = (posterior_mean * grid[:, 1]) @ cond / p_ks
    pos_stencil = (grid[:, 0] < grid[:, 1]).astype(float)
    neg_stencil = (grid[:, 0] > grid[:, 1]).astype(float)
    p_pos = (posterior_mean * pos_stencil) @ cond / p_ks
    p_neg = (posterior_mean * neg_stencil) @ cond / p_ks
    weight_non_positive = posterior_mean[grid[:, 0] >= grid[:, 1]].sum()
    with np.errstate(divide="ignore", invalid="ignore"):
        if 0 < weight_non_positive < 1:
            bf = p_pos / (1 - p_pos) / (1 - weight_non_positive) * weight_non_positive
        else:
            bf = np.ones(n_sites)

    site_table = np.stack(
        [alpha_col, beta_col, beta_col - alpha_col, p_neg, p_pos, bf], axis=1
    )
    headers = [
        ["alpha", "Mean posterior synonymous substitution rate at a site"],
        ["beta", "Mean posterior non-synonymous substitution rate at a site"],
        ["beta-alpha", "Mean posterior beta-alpha"],
        ["Prob[alpha>beta]", "Posterior probability of negative selection at a site"],
        ["Prob[alpha<beta]", "Posterior probability of positive selection at a site"],
        ["BayesFactor[alpha<beta]", "Empiricial Bayes Factor for positive selection at a site"],
    ]
    json = analysis_json(
        info="FUBAR (Fast Unconstrained Bayesian AppRoximation) estimates site "
             "rates using a flexible random effects prior on a rate grid",
        version="2.2",
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
            "settings": {
                "grid size": grid_points, "method": method,
                "concentration": concentration, "posterior": posterior,
            },
        },
    )
    return FUBARResult(
        json=json, site_table=site_table, grid=grid,
        posterior_weights=posterior_mean, data=data, gtr=gtr,
    )
