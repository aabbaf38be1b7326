"""FADE — FUBAR Approach to Directional Evolution (protein alignments).

Counterpart of ``hyphy_tpu/methods/fade.py`` (reference
``res/TemplateBatchFiles/SelectionAnalyses/FADE.bf``).  Tests whether sites
evolve *toward* a particular residue along test branches at accelerated
rates.  Requires a **rooted** tree (FADE.bf:191): the biased process is
non-stationary, so the root placement matters.

Model (fade.rate.modifier, FADE.bf:359-377): on test branches,

    q_xy = rate * q_xy^base * bias/(1 - e^-bias)   if y == target
    q_xy = rate * q_xy^base * bias/(e^bias - 1)    if x == target
    q_xy = rate * q_xy^base                        otherwise

Background branches keep the baseline model; root frequencies stay at the
baseline pi.

Per target residue: site likelihood vectors on a 20x20 (rate, bias) grid
(fade.DefineGrid, FADE.bf:891-938; the bias-0 column holds the no-bias
cells), then a Dirichlet-prior posterior over grid weights (VB0 /
collapsed Gibbs / MH, the shared ``grid_bayes``), per-site Prob[bias>0] and
Bayes factors (FADE.bf:426-447).

Each grid point is one gene pruning, through FUBAR's grid pass
(``fubar.grid_pass``): the grid points split over the mesh that
``settings.mesh`` names (this module's :class:`GridPruning` copied to each
block's device), and the grid form of :func:`pruning.site_log_likelihoods`
folds a chunk of grid points into K1's node axis, one launch per level for
the chunk; the chunk is sized by the block's share of the device's free memory
(:func:`pruning.grid_point_bytes` plus the propagators) and capped by
:func:`pruning.max_grid_points`.

The biased propagators.  The JAX package takes them from the spectral route
of the generator's tilted stationary frequencies (``pi'_x ~ pi_x
e^{bias [x = target]}``).  At the grid's highest bias, 50, the symmetrised
matrix couples the target through entries ~e^-25 below the others and the
back-transform multiplies them by ~e^25, so the eigensolver's round-off
comes back as errors of up to 0.5 in ``P[x, target]`` in fp64 (ROADMAP
3.19).  Here they take the Taylor route, which needs no symmetrisation:
every grid point's generator at every tested branch's time in one batched
fp64 call (:func:`expm.taylor_propagators_batched`), cast to the compute
dtype for the pruning.  At rate 0 the tested branches are exactly the
identity, so a pattern that varies inside the tested clade gets -inf there
(HyPhy's likelihood of 0), where the JAX package's pruning scores its
``finfo.tiny`` floor (ROADMAP 3.11, 3.20).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from hyphy_tpu_torch.config import resolve_device, settings
from hyphy_tpu_torch.data.alignment import read_alignment
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.data.genetic_code import AMINO_ACIDS
from hyphy_tpu_torch.io.json_out import model_fit_entry
from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
from hyphy_tpu_torch.methods import common
from hyphy_tpu_torch.methods.fubar import grid_pass
from hyphy_tpu_torch.methods.grid_bayes import posterior_over_grid
from hyphy_tpu_torch.methods.leisr import fit_baseline
from hyphy_tpu_torch.models import frequencies as freq_mod
from hyphy_tpu_torch.models.base import fill_diagonal_from_rows
from hyphy_tpu_torch.models.protein import EmpiricalProtein
from hyphy_tpu_torch.ops import expm as expm_ops
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.tree.topology import Tree

_HEADERS = [
    ["rate", "Mean posterior relative rate at a site"],
    ["bias", "Mean posterior bias parameter at a site"],
    ["Prob[bias>0]", "Posterior probability of substitution bias"],
    ["BayesFactor[bias>0]", "Empiricial Bayes Factor for substitution bias"],
]


def define_grid(points: int = 20) -> np.ndarray:
    """(rate, bias) grid (fade.DefineGrid, FADE.bf:891-938)."""
    points = max(points, 5)
    below1 = int(points * 0.7 + 0.5)
    above1 = points - below1
    rate_1d = np.zeros(points)
    bias_1d = np.zeros(points)
    for k in range(below1):
        bias_1d[k] = k / below1
        rate_1d[k] = (k + 1) / (below1 + 1)
    rate_1d[below1 - 1] = 1.0
    bias_1d[below1 - 1] = 1.0
    step = 49.0 ** (1.0 / 3.0) / above1
    for k in range(1, above1 + 1):
        bias_1d[below1 + k - 1] = 1.0 + (step * k) ** 3
        rate_1d[below1 + k - 1] = 1.0 + (step * k) ** 3
    grid = np.array([(r, b) for r in rate_1d for b in bias_1d])
    grid[0] = (0.0, 0.0)
    grid[1, 1] = 0.0
    return grid


@dataclasses.dataclass
class FADEResult:
    json: Dict
    site_tables: Dict[str, np.ndarray]   # per residue [sites, 4]
    headers: List
    grid: np.ndarray
    baseline_loglik: float


def _bias_factors(bias: torch.Tensor):
    """(toward, away) multipliers; both -> 1 as bias -> 0."""
    b = torch.clamp_min(bias, 1e-10)
    toward = b / -torch.expm1(-b)       # bias/(1 - e^-bias)
    away = b / torch.expm1(b)           # bias/(e^bias - 1)
    return toward, away


def biased_generators(s_pi: torch.Tensor, grid: torch.Tensor, target: int) -> torch.Tensor:
    """``[n, 20, 20]`` fp64 generators of the test branches at the ``[n,
    2]`` (rate, bias) rows of ``grid`` toward residue ``target``;
    ``s_pi`` is the baseline's off-diagonal ``r_xy pi_y``."""
    rate, bias = grid[:, 0], grid[:, 1]
    toward, away = _bias_factors(bias)
    onehot = torch.zeros(20, dtype=s_pi.dtype, device=s_pi.device)
    onehot[target] = 1.0
    mult = (1.0 + (toward - 1.0)[:, None, None] * onehot[None, None, :]
            + (away - 1.0)[:, None, None] * onehot[None, :, None])
    return fill_diagonal_from_rows(rate[:, None, None] * s_pi[None] * mult)


@dataclasses.dataclass
class GridPruning:
    """The inputs of FADE's grid passes, shared by every target: the
    baseline's off-diagonal generator and propagators (fp64), the fitted
    times of the tested branches, the leaves and the schedule in the
    compute dtype; ``point_bytes`` is one grid point's working set (its
    peak in the grid form of the pruning and its propagators, with the
    batched Taylor build's temporaries in fp64)."""

    s_pi: torch.Tensor
    freqs: torch.Tensor
    base_p: torch.Tensor          # [n_nodes, S, S] fp64
    tested_rows: torch.Tensor     # [Bt] branch index
    tested_t: torch.Tensor        # [Bt] fp64
    leaves: torch.Tensor
    schedule: pruning.PruningData
    dtype: torch.dtype
    point_bytes: float

    def propagators(self, grid: torch.Tensor, target: int) -> torch.Tensor:
        """``[n, n_nodes, S, S]`` in the compute dtype: the baseline's on
        every branch, the biased generators' on the tested ones."""
        q = biased_generators(self.s_pi, grid, target)
        times = self.tested_t[:, None].expand(-1, grid.shape[0])        # [Bt, n]
        # row renormalisation puts the rows' round-off on the diagonal, which
        # at rate 50 toward a target holds ~0 and can come out at -4e-15;
        # the grid form has no floor, so a negative entry would make a root
        # likelihood negative and its log NaN
        biased = expm_ops.taylor_propagators_batched(q, times).clamp_min(0.0)   # [Bt, n, S, S]
        p = self.base_p.to(self.dtype)[None].repeat(grid.shape[0], 1, 1, 1)
        p[:, self.tested_rows] = biased.transpose(0, 1).to(self.dtype)
        return p


def grid_pruning(model: EmpiricalProtein, filt: DataFilter, tree: Tree, t_hat: torch.Tensor,
                 tested: np.ndarray) -> GridPruning:
    device = model.device
    dtype = settings.likelihood_dtype(device)
    s = model.n_states
    itemsize = torch.finfo(dtype).bits // 8
    pi = model.frequencies
    s_pi = torch.as_tensor(model.exchangeabilities, device=device) * pi[None, :]
    t64 = t_hat.detach().to(torch.float64)
    base_p = expm_ops.shared_taylor_propagators(fill_diagonal_from_rows(s_pi), t64)
    schedule = pruning.build_pruning_data(tree, device)
    rows = np.nonzero(tested)[0]
    # the propagators: the joined set and its cast, and the batched fp64
    # Taylor build's ~6 [S, S] temporaries per tested branch
    prop_bytes = (tree.n_nodes + 1) * s * s * 2 * itemsize + len(rows) * s * s * 6 * 8
    return GridPruning(
        s_pi=s_pi, freqs=pi, base_p=base_p,
        tested_rows=torch.as_tensor(rows, device=device), tested_t=t64[rows],
        leaves=torch.as_tensor(filt.leaf_partials(), device=device).to(dtype),
        schedule=schedule, dtype=dtype,
        point_bytes=pruning.grid_point_bytes(schedule, filt.n_patterns, s, itemsize)
        + prop_bytes)


def run(
    alignment: str,
    model: str = "WAG",
    tree: Optional[str] = None,
    branches: str = "All",
    grid_points: int = 20,
    method: str = "Variational-Bayes",
    concentration: float = 0.5,
    chain_length: int = 2_000_000,
    burn_in: int = 1_000_000,
    samples: int = 100,
    posterior_threshold: float = 0.9,
    precision: float = 1e-5,
    seed: int = 0,
    residues: Optional[str] = None,
    device=None,
) -> FADEResult:
    device = resolve_device(device)
    aln = read_alignment(alignment)
    filt = DataFilter.from_alignment(aln, "protein")
    if tree is None:
        if not aln.trees:
            raise ValueError("no tree in alignment file; pass tree")
        tree = next(iter(aln.trees.values()))
    tr = Tree.from_newick(tree, leaf_order=filt.names)
    tested = tr.select_branches(branches)

    # baseline fit (+F frequencies), free branch lengths (FADE.bf:246)
    mdl = EmpiricalProtein(model, frequencies=freq_mod.empirical_character(filt),
                           device=device)
    lf = LikelihoodFunction([Partition(filt, tr, mdl)], device=device)
    res = fit_baseline(lf, tr, precision)
    common.progress("fade", f"baseline {model}+F fit: lnL {res.loglik:.4f}")
    gp = grid_pruning(mdl, filt, tr, res.params["t"], tested)

    grid = define_grid(grid_points)
    grid_t = torch.as_tensor(grid, device=device)
    dup = filt.duplicate_map
    n_sites = len(dup)
    bias_positive = grid[:, 1] > 0

    site_tables: Dict[str, np.ndarray] = {}
    site_annotations = {}
    rng = np.random.default_rng(seed)
    targets = [AMINO_ACIDS.index(r) for r in residues] if residues else range(20)
    for target in targets:
        residue = AMINO_ACIDS[target]
        sll = grid_pass(gp, grid_t, target).cpu().numpy()
        sll_sites = sll[:, dup]
        mx = sll_sites.max(axis=0, keepdims=True)
        cond = np.exp(sll_sites - mx)
        cond /= cond.sum(axis=0, keepdims=True)

        post_mean, _ = posterior_over_grid(
            method, cond, concentration, chain_length, burn_in, samples,
            site_weights=np.ones(n_sites), rng=rng,
        )

        p_ks = post_mean @ cond
        rate_col = (post_mean * grid[:, 0]) @ cond / p_ks
        bias_col = (post_mean * grid[:, 1]) @ cond / p_ks
        p_pos = (post_mean * bias_positive) @ cond / p_ks
        prior_mass = post_mean[bias_positive].sum()
        with np.errstate(divide="ignore", invalid="ignore"):
            if 0 < prior_mass < 1:
                bf = (p_pos / np.maximum(1 - p_pos, 1e-12)) * (1 - prior_mass) / prior_mass
            else:
                bf = np.ones(n_sites)
        site_tables[residue] = np.stack([rate_col, bias_col, p_pos, bf], axis=1)
        site_annotations[residue] = int((p_pos >= posterior_threshold).sum())
        common.progress("fade", f"residue {residue}: {site_annotations[residue]} sites")

    json = {
        "analysis": {
            "info": "FADE (FUBAR Approach to Directional Evolution) tests "
                    "whether sites evolve towards a particular residue along "
                    "a subset of branches",
            "version": "0.2",
        },
        "input": {
            "file name": alignment,
            "number of sequences": filt.n_sequences,
            "number of sites": n_sites,
            "partition count": 1,
        },
        "fits": {
            f"{model}+F": model_fit_entry(
                res.loglik, res.n_free_parameters,
                n_sites * filt.n_sequences,
                frequencies=mdl.frequencies.cpu().numpy(), display_order=0,
            ),
        },
        "MLE": {
            "headers": _HEADERS,
            "content": {
                residue: {"0": tbl.tolist()} for residue, tbl in site_tables.items()
            },
        },
        "site annotations": site_annotations,
        "settings": {
            "grid size": grid_points, "method": method,
            "concentration": concentration,
            "posterior": posterior_threshold,
        },
    }
    return FADEResult(
        json=json, site_tables=site_tables, headers=_HEADERS,
        grid=grid, baseline_loglik=res.loglik,
    )
