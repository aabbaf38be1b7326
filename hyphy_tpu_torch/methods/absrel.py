"""aBSREL — adaptive Branch-Site Random Effects Likelihood.

Counterpart of ``hyphy_tpu/methods/absrel.py`` (reference
``SelectionAnalyses/aBSREL.bf``).  Pipeline: GTR -> MG94 -> per-branch
one-omega baseline -> step-up complexity selection (branches by descending
MG94 length; add omega classes while AIC-c improves, at most 5;
``aBSREL.bf:385-460``) -> polish -> per-branch LRTs (the branch's largest
omega := 1) with p = 0.5 * (1 - 0.4 chi2_1 - 0.6 chi2_2)
(``aBSREL.bf:935-939``) and Holm-Bonferroni correction over the tested
branches.

Ragged per-branch class counts are padded to KMAX classes: omega 1 and
stick-breaking fractions forced to 1 at the branch's last active class, so
weight 0 beyond it, as in the JAX package; the padded classes are built and
mixed like the others.  Every branch is its own BS-REL group, so the
engine takes its per-branch route (all B*KMAX families in one batched
pass).  Where a branch's null ends above the full model, which holds it,
the full model is refit from that null's MLE (ROADMAP 3.16) and every LRT
is taken against the final full model.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from hyphy_tpu_torch.io.json_out import aic_c, analysis_json, model_fit_entry
from hyphy_tpu_torch.methods import common
from hyphy_tpu_torch.models.bsrel import BSRELEngine, srv_distribution
from hyphy_tpu_torch.models.codon import MG94Base
from hyphy_tpu_torch.models.parameters import ParamSpec, Specs
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.optimize.core import maximize_jax as maximize

KMAX = 5  # reference: at most 5 rate classes per branch (aBSREL.bf:29)
# the step-up's capped candidate fits (absrel.py:266-267)
STEP_UP_PRECISION, STEP_UP_ITERATIONS = 0.01, 250


def holm_bonferroni(p_values: Dict[str, float]) -> Dict[str, float]:
    """Holm-Bonferroni correction (reference: math.HolmBonferroniCorrection)."""
    items = sorted(p_values.items(), key=lambda kv: kv[1])
    m = len(items)
    corrected = {}
    running = 0.0
    for rank, (name, p) in enumerate(items):
        adj = min(1.0, p * (m - rank))
        running = max(running, adj)
        corrected[name] = running
    return corrected


def mixed_chi2_p(lrt: float) -> float:
    """p = 0.5 * (1 - 0.4 chi2_1 cdf - 0.6 chi2_2 cdf) (aBSREL.bf:935-939)."""
    return 0.5 * (1.0 - 0.4 * (1.0 - common.chi2_sf(lrt, 1))
                  - 0.6 * (1.0 - common.chi2_sf(lrt, 2)))


def branch_distributions(params, n_classes):
    """(omegas ``[B, KMAX]``, weights ``[B, KMAX]``) for the per-branch
    class counts ``n_classes`` ``[B]`` (an integer tensor): classes before
    the last active one take ``omega_raw``, the last ``omega_last``, the
    padding omega 1; the stick-breaking fractions are 1 from the last
    active class on, so the padding has weight 0 (absrel.py:182-198)."""
    raw, last, fracs = params["omega_raw"], params["omega_last"], params["fracs"]
    n = n_classes[:, None]
    idx = torch.arange(KMAX, device=raw.device)[None, :]
    padded = torch.cat([raw, torch.ones_like(raw[:, :1])], dim=1)
    omegas = torch.where(idx < n - 1, padded,
                         torch.where(idx == n - 1, last[:, None], torch.ones_like(padded)))
    fr = torch.where(idx[:, : KMAX - 1] >= n - 1, torch.ones_like(fracs), fracs)
    ones = torch.ones_like(fr[:, :1])
    rem = torch.cat([ones, torch.cumprod(1.0 - fr, dim=1)], dim=1)
    weights = torch.cat([fr, ones], dim=1) * rem
    return omegas, weights


@dataclasses.dataclass
class ABSRELResult:
    json: Dict
    full_lnl: float
    baseline_lnl: float
    n_classes: np.ndarray
    branch_lrt: Dict[str, float]
    branch_p: Dict[str, float]
    branch_p_corrected: Dict[str, float]
    positive_branches: list
    data: common.LoadedData
    gtr: common.GTRFit
    mg94: common.MG94Fit


class ABSRELModel:
    """The adaptive BS-REL likelihood of one alignment: the engine (one
    group per branch), the parameter space, the objective at a class-count
    vector, capped fits and the parameter count."""

    def __init__(self, mg94, data, multiple_hits="None", srv=False, srv_classes=3):
        self.mh = multiple_hits not in (None, "None", "")
        self.triple = multiple_hits == "Double+Triple"
        self.srv = srv
        self.c_srv = srv_classes if srv else 1
        self.mg94 = mg94
        self.device = device = data.device
        n_branches = data.tree.n_branches
        self.n_branches = n_branches
        basis_fn = self.basis if self.mh else None
        filt = data.codon_filter
        self.engine = BSRELEngine(
            mg94, pruning.build_pruning_data(data.tree, device), filt.leaf_partials(),
            filt.pattern_weights, np.arange(n_branches, dtype=np.int32),
            srv_classes=self.c_srv, basis_fn=basis_fn)
        specs: Specs = dict(MG94Base.theta_specs())
        specs["t"] = ParamSpec(init=0.05, lower=0.0, upper=10000.0, shape=(n_branches,))
        specs["omega_last"] = ParamSpec(init=0.3, lower=0.0, upper=10000.0, shape=(n_branches,))
        specs["omega_raw"] = ParamSpec(init=0.2, lower=0.0, upper=1.0,
                                       shape=(n_branches, KMAX - 1))
        specs["fracs"] = ParamSpec(init=0.5, lower=0.0, upper=1.0, shape=(n_branches, KMAX - 1))
        if self.mh:
            specs["delta"] = ParamSpec(init=0.05, lower=0.0, upper=100.0, shape=(n_branches,))
            if self.triple:
                specs["psi"] = ParamSpec(init=0.05, lower=0.0, upper=100.0, shape=(n_branches,))
        if srv:
            for i in range(1, self.c_srv + 1):
                specs[f"srv_rate_{i}"] = ParamSpec(init=0.3 * i, lower=0.0, upper=10000.0)
            for i in range(1, self.c_srv):
                specs[f"srv_w_{i}"] = ParamSpec(init=1.0 / self.c_srv, lower=0.0, upper=1.0)
        self.specs = specs

    def basis(self, params):
        """Per-branch delta / psi folded into that branch's bases ``[B, S,
        S]``: Q_{b,k} = t_b [(Q1s + d_b Q2s + p_b Q3s) + omega_{b,k} (Q1n +
        d_b Q2n + p_b Q3n)] (absrel.py:140-155)."""
        mg94 = self.mg94
        q1s, q1n = mg94.basis_matrices(params)
        q2s, q2n = mg94.multihit_basis_matrices(params, 2)
        d = params["delta"][:, None, None]
        qs = q1s[None] + d * q2s[None]
        qn = q1n[None] + d * q2n[None]
        if self.triple:
            q3s, q3n = mg94.multihit_basis_matrices(params, 3)
            p = params["psi"][:, None, None]
            qs = qs + p * q3s[None]
            qn = qn + p * q3n[None]
        return qs, qn

    def srv_dist(self, params):
        if not self.srv:
            one = torch.ones((1,), dtype=torch.float64, device=self.device)
            return one, one
        return srv_distribution(params, self.c_srv)

    def classes(self, n_classes) -> torch.Tensor:
        return torch.as_tensor(np.asarray(n_classes, dtype=np.int64), device=self.device)

    def loglik(self, params, n_classes):
        omegas, weights = branch_distributions(params, n_classes)
        rates, wsrv = self.srv_dist(params)
        return self.engine.loglik(params, omegas, weights, params["t"], rates, wsrv)

    def fit(self, init, n_classes, precision=1e-4, max_iterations=None):
        """A fit of every parameter at the class counts ``n_classes``.
        Returns (params, lnL)."""
        counts = self.classes(n_classes)
        p, v, _ = maximize(lambda free: self.loglik(free, counts), self.specs,
                           {k: v for k, v in init.items() if k in self.specs},
                           precision=precision, max_iterations=max_iterations)
        return p, float(v)

    def fit_branch_null(self, params, n_classes, b, precision):
        """The full model with branch b's last active omega := 1, every
        parameter free otherwise (absrel.py:296-310).  Returns (params,
        lnL)."""
        mask = torch.zeros(self.n_branches, dtype=torch.bool, device=self.device)
        mask[b] = True
        counts = self.classes(n_classes)

        def pinned(p):
            ol = p["omega_last"]
            return dict(p, omega_last=torch.where(mask, torch.ones_like(ol), ol))

        def objective(free):
            return self.loglik(pinned(free), counts)

        init = pinned({k: v for k, v in params.items() if k in self.specs})
        p, v, _ = maximize(objective, self.specs, init, precision=precision)
        return pinned(p), float(v)

    def n_params(self, n_classes):
        """Per branch: t + n omegas + (n-1) weights [+ delta / psi]; 5
        thetas + 9 empirical frequencies [+ the shared SRV]."""
        per_branch_mh = (1 if self.mh else 0) + (1 if self.triple else 0)
        shared_srv = (2 * self.c_srv - 1) if self.srv else 0
        return int(5 + 9 + shared_srv + sum(2 * int(c) + per_branch_mh for c in n_classes))


def step_up(model, params, lnl, n_classes, order, sample_size, names):
    """Add classes to each branch in ``order`` while AIC-c improves, each
    candidate a capped fit (precision 0.01, 250 iterations) from the current
    point (absrel.py:254-278).  Returns (params, lnL, class counts,
    candidate fits)."""
    best_aicc = aic_c(lnl, model.n_params(n_classes), sample_size)
    n_fits = 0
    for b in order:
        while n_classes[b] < KMAX:
            trial = n_classes.copy()
            trial[b] += 1
            cand_params, cand_lnl = model.fit(params, trial, precision=STEP_UP_PRECISION,
                                              max_iterations=STEP_UP_ITERATIONS)
            n_fits += 1
            cand_aicc = aic_c(cand_lnl, model.n_params(trial), sample_size)
            if cand_aicc < best_aicc:
                n_classes = trial
                params, lnl, best_aicc = cand_params, cand_lnl, cand_aicc
                common.progress("absrel", f"branch {names[b]} -> {n_classes[b]} classes "
                                          f"(lnL {cand_lnl:.3f}, AIC-c {cand_aicc:.2f})")
            else:
                break
    return params, lnl, n_classes, n_fits


def test_branches(model, params, full_lnl, n_classes, tested, names, precision):
    """Per tested branch whose last active omega exceeds 1 at the full MLE:
    the null with it := 1.  A null above the full model refits the full
    model from the null's MLE (ROADMAP 3.16).  Returns (params, full lnL,
    {name: null lnL}) — the first two the refit's where it climbed higher;
    a branch whose omega is at most 1 has no null (LRT 0, p 1)."""
    last = params["omega_last"].detach().cpu().numpy()
    nulls = {}
    for b in range(model.n_branches):
        if not tested[b] or last[b] <= 1.0:
            continue
        p_null, v_null = model.fit_branch_null(params, n_classes, b, precision)
        nulls[names[b]] = v_null
        if v_null > full_lnl:
            common.progress("absrel", f"null of {names[b]} lnL {v_null:.6f} above the full "
                                      f"model's {full_lnl:.6f}; full refit from its MLE")
            refit, refit_lnl = model.fit(p_null, n_classes, precision=precision)
            if refit_lnl > full_lnl:
                params, full_lnl = refit, refit_lnl
    return params, full_lnl, nulls


def _srv_json(model, params, n_classes, filt):
    """The fitted synonymous-rate GDD and the per-site class posteriors
    (aBSREL.bf:1371-1390 _report_srv, "Synonymous site-posteriors",
    aBSREL.bf:44)."""
    with torch.no_grad():
        rates, wsrv = model.srv_dist(params)
        omegas, weights = branch_distributions(params, model.classes(n_classes))
        class_sll = model.engine.class_site_log_likelihoods(
            params, omegas, weights, params["t"], rates).cpu().numpy()    # [C, patterns]
    rates, wsrv = rates.cpu().numpy(), wsrv.cpu().numpy()
    lp = class_sll + np.log(np.maximum(wsrv, 1e-300))[:, None]
    lp -= lp.max(axis=0, keepdims=True)
    post = np.exp(lp) / np.exp(lp).sum(axis=0, keepdims=True)
    return {
        "Synonymous site-posteriors": post[:, filt.duplicate_map].tolist(),
        "Synonymous site-to-site rates": [[float(r), float(w)] for r, w in zip(rates, wsrv)],
    }


def run(
    alignment: str,
    genetic_code: str = "Universal",
    tree: Optional[str] = None,
    branches: str = "All",
    pvalue: float = 0.05,
    precision: float = 1e-4,
    multiple_hits: str = "None",
    srv: bool = False,
    srv_classes: int = 3,
    device=None,
) -> ABSRELResult:
    """aBSREL on one codon alignment, on ``device`` (default
    ``settings.device``: the card, raising without one); the JAX package's
    signature.  ``multiple_hits`` "Double" / "Double+Triple": branch-specific
    2-hit (delta) and 3-hit (psi) rates in every branch's mixture
    (aBSREL.bf:124-133).  ``srv``: a shared ``srv_classes``-bin unit-mean GDD
    synonymous rate distribution over every model (aBSREL.bf:135-157), with
    the per-site class posteriors in the JSON."""
    data = common.load_codon_data(alignment, genetic_code, tree, branches, device=device)
    device = data.device
    common.progress("absrel", "fitting nucleotide GTR")
    gtr = common.fit_gtr(data, precision=1e-5)
    common.progress("absrel", f"GTR lnL {gtr.loglik:.3f}; fitting global MG94xREV")
    mg = common.fit_partitioned_mg94(data, gtr, precision=1e-5, multiple_hits=multiple_hits)
    common.progress("absrel", f"MG94 lnL {mg.loglik:.3f}")

    filt = data.codon_filter
    tree_obj = data.tree
    n_branches = tree_obj.n_branches
    names = tree_obj.names
    tested = data.tested_branches
    sample_size = data.sample_size
    mg94 = MG94Base(data.genetic_code, mg.corner_freqs, mg.codon_freqs, device=device)
    model = ABSRELModel(mg94, data, multiple_hits, srv, srv_classes)

    # -- baseline: one omega per branch ----------------------------------------
    n_classes = np.ones(n_branches, dtype=np.int64)
    init = {k: s.initial(device) for k, s in model.specs.items()}
    init.update({k: v for k, v in mg.params.items() if k.startswith("theta")})
    init["t"] = torch.as_tensor(np.maximum(mg.alphas, 1e-6), dtype=torch.float64, device=device)
    init["omega_last"] = torch.full((n_branches,), float(np.mean(mg.omegas)),
                                    dtype=torch.float64, device=device)
    for name in ("delta", "psi"):
        if name in model.specs:
            init[name] = torch.full((n_branches,), float(mg.params.get(name, 0.05)),
                                    dtype=torch.float64, device=device)
    common.progress("absrel", "fitting baseline (one omega per branch)")
    base_params, base_lnl = model.fit(init, n_classes, precision=precision)
    common.progress("absrel", f"baseline lnL {base_lnl:.3f}")

    # -- step-up, then the polish ----------------------------------------------
    base_bl = mg.branch_lengths
    order = np.argsort(-base_bl)
    params, _, n_classes, _ = step_up(model, base_params, base_lnl, n_classes, order,
                                      sample_size, names)
    params, full_lnl = model.fit(params, n_classes, precision=precision)
    common.progress("absrel", f"full adaptive model lnL {full_lnl:.3f}")

    # -- per-branch tests ------------------------------------------------------
    params, full_lnl, nulls = test_branches(model, params, full_lnl, n_classes, tested, names,
                                            precision)
    branch_lrt, branch_p = {}, {}
    for b in range(n_branches):
        if not tested[b]:
            continue
        name = names[b]
        lrt = max(2.0 * (full_lnl - nulls[name]), 0.0) if name in nulls else 0.0
        branch_lrt[name] = lrt
        branch_p[name] = mixed_chi2_p(lrt) if name in nulls else 1.0
    corrected = holm_bonferroni(branch_p) if branch_p else {}
    positives = [n for n, p in corrected.items() if p <= pvalue]
    common.progress("absrel", f"{len(positives)} of {int(tested.sum())} tested branches at "
                              f"corrected p <= {pvalue}")

    # -- JSON -------------------------------------------------------------------
    with torch.no_grad():
        omegas_mle, weights_mle = (x.cpu().numpy() for x in branch_distributions(
            params, model.classes(n_classes)))
        t_mle = params["t"].cpu().numpy()
        mean_omega_b = (omegas_mle * weights_mle).sum(axis=1)
        if model.mh:
            qs_b, qn_b = (x.cpu().numpy() for x in model.basis(params))    # [B, S, S]
            freqs = mg94.frequencies.cpu().numpy()
            rs_b, rn_b = qs_b.sum(-1) @ freqs, qn_b.sum(-1) @ freqs
            full_bl = t_mle * (rs_b + mean_omega_b * rn_b) / 3.0
        else:
            rate_syn, rate_non = (float(x) for x in mg94.syn_nonsyn_unit_rates(params))
            full_bl = t_mle * (rate_syn + mean_omega_b * rate_non) / 3.0

    branch_attributes = {"0": {}}
    for b in range(n_branches):
        name = names[b]
        entry = {
            "Rate classes": int(n_classes[b]),
            "Rate Distributions": [[float(omegas_mle[b, i]), float(weights_mle[b, i])]
                                   for i in range(n_classes[b])],
            "Full adaptive model": float(full_bl[b]),
            "Baseline MG94xREV": float(base_bl[b]),
        }
        if model.mh:
            # all-terms.bf:490-491 vocabulary, as in the reference JSON
            entry["rate at which 2 nucleotides are changed instantly within a single codon"] = \
                float(params["delta"][b])
            if model.triple:
                entry["rate at which 3 nucleotides are changed instantly within a single "
                      "codon"] = float(params["psi"][b])
        if name in branch_lrt:
            entry["LRT"] = branch_lrt[name]
            entry["Uncorrected P-value"] = branch_p[name]
            entry["Corrected P-value"] = corrected[name]
        branch_attributes["0"][name] = entry

    extra = {
        "test results": {"positive test results": len(positives), "tested": int(tested.sum()),
                         "P-value threshold": pvalue},
        "branch attributes": branch_attributes,
    }
    if srv:
        extra.update(_srv_json(model, params, n_classes, filt))
    json = analysis_json(
        info="aBSREL (Adaptive branch-site random effects likelihood) uses an "
             "adaptive random effects branch-site model framework",
        version="2.3",
        data=data,
        fits={
            "Nucleotide GTR": model_fit_entry(
                gtr.loglik, gtr.n_parameters, sample_size, frequencies=gtr.frequencies,
                display_order=0),
            "Baseline MG94xREV": model_fit_entry(
                base_lnl, model.n_params(np.ones(n_branches)), sample_size, display_order=1),
            "Full adaptive model": model_fit_entry(
                full_lnl, model.n_params(n_classes), sample_size, display_order=2),
        },
        extra=extra,
    )
    return ABSRELResult(
        json=json, full_lnl=full_lnl, baseline_lnl=base_lnl, n_classes=n_classes,
        branch_lrt=branch_lrt, branch_p=branch_p, branch_p_corrected=corrected,
        positive_branches=positives, data=data, gtr=gtr, mg94=mg,
    )
