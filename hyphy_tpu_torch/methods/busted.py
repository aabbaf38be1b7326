"""BUSTED — Branch-Site Unrestricted Statistical Test for Episodic
Diversification.

Counterpart of ``hyphy_tpu/methods/busted.py`` (reference
``SelectionAnalyses/BUSTED.bf``).  Pipeline: GTR -> global MG94xREV ->
unconstrained 3-class BS_REL fit on the tested branches (a separate
3-class distribution on background branches; optional 3-class GDD
synonymous rate variation shared by all) -> constrained (omega_3 := 1)
refit -> LRT with p = 0.5 * (chi^2_0 + chi^2_2) (BUSTED.bf:1427) and
per-site evidence ratios exp(siteL_alt - siteL_null).

The mixture fits run :func:`optimize.core.maximize_jax` (logit-remapped
L-BFGS, as in the JAX package: the bounded omegas and weights sit at
vertices of their boxes, where raw-space L-BFGS-B stalls on projected
corner steps).  Every evaluation prunes the C synonymous-rate classes in
one grid-form pass through K1 (``models/bsrel.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from hyphy_tpu_torch.data.genetic_code import codon_string
from hyphy_tpu_torch.io import serialize
from hyphy_tpu_torch.io.json_out import analysis_json, model_fit_entry
from hyphy_tpu_torch.methods import common
from hyphy_tpu_torch.models.bsrel import BSRELEngine, omega_distribution, srv_distribution
from hyphy_tpu_torch.models.codon import MG94Base
from hyphy_tpu_torch.models.parameters import ParamSpec, Specs, count_parameters
from hyphy_tpu_torch.ops import ancestral, hmm, pruning
from hyphy_tpu_torch.optimize.core import maximize_jax as maximize


@dataclasses.dataclass
class BUSTEDResult:
    json: Dict
    unconstrained_lnl: float
    null_lnl: float
    lrt: float
    p_value: float
    evidence_ratios: np.ndarray
    alt_params: Dict
    data: common.LoadedData
    gtr: common.GTRFit
    mg94: common.MG94Fit
    # fit context for derived analyses (BUSTED-PH refits under extra
    # constraints): {"loglik", "specs", "unpack", "k", "error_sink",
    # "has_background", "precision"}
    context: Optional[Dict] = None


def _distribution_specs(
    prefix: str,
    k: int,
    error_sink: bool = False,
    error_sink_bound: float = 100.0,
    error_sink_weight: float = 0.01,
) -> Specs:
    """BS_REL omega distribution: omega_1..k-1 in [0,1], omega_k >= 1.

    ``error_sink`` adds class 0 — high dN/dS (>= ``error_sink_bound``),
    tiny weight (<= ``error_sink_weight``) — that absorbs misalignment
    artifacts; the positive class is then capped at the error bound
    (reference ``BUSTED.bf:196-226``)."""
    specs = {}
    pos_upper = 10000.0
    if error_sink:
        specs[f"{prefix}_omega_0"] = ParamSpec(
            init=2.0 * error_sink_bound, lower=error_sink_bound, upper=1e6)
        specs[f"{prefix}_w_0"] = ParamSpec(
            init=min(1e-4, error_sink_weight), lower=0.0, upper=error_sink_weight)
        pos_upper = error_sink_bound
    for i in range(1, k):
        specs[f"{prefix}_omega_{i}"] = ParamSpec(init=0.1 * i, lower=0.0, upper=1.0)
    specs[f"{prefix}_omega_{k}"] = ParamSpec(init=1.5, lower=1.0, upper=pos_upper)
    for i in range(1, k):
        specs[f"{prefix}_w_{i}"] = ParamSpec(init=0.7 if i == 1 else 0.75, lower=0.0, upper=1.0)
    return specs


def _srv_specs(k: int) -> Specs:
    specs = {}
    for i in range(1, k + 1):
        specs[f"srv_rate_{i}"] = ParamSpec(init=0.3 * i, lower=0.0, upper=10000.0)
    for i in range(1, k):
        specs[f"srv_w_{i}"] = ParamSpec(init=1.0 / k, lower=0.0, upper=1.0)
    return specs


def _candidates(specs, base_init, k, mean_omega, starting_points, seed,
                error_sink_bound, error_sink_weight, device):
    """Random starting points: the numpy draws of the JAX package, in its
    order (``busted.py:276-297``), so that one seed gives both packages the
    same candidates."""
    rng = np.random.default_rng(seed)

    def scalar(x):
        return torch.tensor(float(x), dtype=torch.float64, device=device)

    candidates = []
    for _ in range(max(4 * starting_points, 8)):
        cand = dict(base_init)
        for name, spec in specs.items():
            if name in cand:
                continue
            if name.endswith("_omega_0"):  # error-sink class
                cand[name] = scalar(rng.uniform(error_sink_bound, 10 * error_sink_bound))
            elif name.endswith("_w_0"):
                cand[name] = scalar(rng.uniform(0.0, 0.5 * error_sink_weight))
            elif name.endswith("_omega_" + str(k)):
                hi = 1.0 + rng.exponential(max(mean_omega, 0.5))
                cand[name] = scalar(min(hi, spec.upper - 1e-6))
            elif "_omega_" in name:
                cand[name] = scalar(rng.uniform(0.0, min(1.0, max(mean_omega, 0.2))))
            elif "_w_" in name or name.startswith("srv_w"):
                cand[name] = scalar(rng.uniform(0.05, 0.95))
            elif name.startswith("srv_rate"):
                cand[name] = scalar(rng.uniform(0.2, 2.0))
            elif name in ("delta", "psi"):
                cand[name] = scalar(rng.uniform(0.01, 0.5))
            else:
                cand[name] = spec.initial(device)
        candidates.append(cand)
    return candidates


def fit_unconstrained(loglik, specs, candidates, starting_points, precision):
    """Score every candidate, coarse fits (precision 0.05, at most 400
    iterations) from the best ``max(starting_points, 2)``, then polish the
    two best coarse fits at ``precision`` (the reference's grid + passes +
    restarts, BUSTED.bf:835-909).  Returns (params, lnL)."""
    with torch.no_grad():
        scored = sorted(((float(loglik(c)), i) for i, c in enumerate(candidates)), reverse=True)
    coarse = []
    for _, idx in scored[: max(starting_points, 2)]:
        p0, v0, _ = maximize(loglik, specs, candidates[idx], precision=0.05,
                             max_iterations=400)
        coarse.append((float(v0), p0))
    coarse.sort(key=lambda x: -x[0])
    alt_params, alt_lnl = None, -np.inf
    for _, p0 in coarse[:2]:
        p1, v1, _ = maximize(loglik, specs, p0, precision=precision)
        if float(v1) > alt_lnl:
            alt_lnl, alt_params = float(v1), p1
    return alt_params, alt_lnl


def fit_constrained(loglik, specs, alt_params, fixed, precision):
    """Refit with the parameters in ``fixed`` held at their values, from the
    unconstrained MLE.  Returns (params with ``fixed`` merged in, lnL)."""
    free_specs = {k: v for k, v in specs.items() if k not in fixed}
    init = {k: v for k, v in alt_params.items() if k not in fixed}

    def constrained(free):
        merged = dict(free)
        merged.update(fixed)
        return loglik(merged)

    params, lnl, _ = maximize(constrained, free_specs, init, precision=precision)
    params = dict(params)
    params.update(fixed)
    return params, float(lnl)


def substitution_map(data: common.LoadedData, internal_states: np.ndarray) -> Dict:
    """The joint ancestral substitution map of the error-sink JSON block:
    per site, the root's codon and every node whose codon differs from its
    parent's (leaves: the resolved codon, '---' for a gap or a fully
    ambiguous code, 'NNN' for a partly ambiguous one; internal nodes:
    '---' where the reconstruction left the state unresolved).
    ``internal_states`` ``[n_internal, sites]``."""
    filt = data.codon_filter
    sense = data.genetic_code.sense_codons
    n_states = len(sense)
    labels = [codon_string(int(c)) for c in sense] + ["---", "NNN"]
    resolved = filt.resolution_table != 0
    count = resolved.sum(axis=1)
    code_label = np.where(count == 1, np.argmax(resolved, axis=1),
                          np.where((count == 0) | (count == resolved.shape[1]),
                                   n_states, n_states + 1))
    dup = filt.duplicate_map
    label = np.concatenate([code_label[filt.leaf_codes[:, dup]],
                            np.where(internal_states >= 0, internal_states, n_states)])
    tree = data.tree
    root = tree.n_nodes - 1
    changed = label[:root] != label[tree.parent[:root]]              # [n_nodes - 1, sites]
    out = {}
    for site in range(filt.n_units):
        entry = {"root": labels[label[root, site]]}
        for node in np.nonzero(changed[:, site])[0]:
            entry[tree.names[node]] = labels[label[node, site]]
        out[str(site)] = entry
    return out


def error_sink_blocks(data, mg, engine, unpack, params):
    """The error-sink support blocks (consumed by error-filter; reference
    BUSTED.bf:1040-1140): per tested branch, the class posteriors over the
    whole alignment and per site, from the branch-pinned site lnLs; and the
    joint ancestral substitution map under the class-mixed propagators.
    Returns (branch attributes, substitutions)."""
    filt = data.codon_filter
    omegas, weights, rates, wsrv = unpack(params)
    tested_ids = np.nonzero(data.tested_branches)[0]
    sll_bk = engine.branch_class_site_logliks(
        params, omegas, weights, params["t"], rates, wsrv, tested_ids)   # [n_sel, K+1, pat]
    post = BSRELEngine.class_posteriors(sll_bk, weights[0]).cpu().numpy()[:, :, filt.duplicate_map]
    # branch-level class posterior from the pattern-weighted totals
    tot = (sll_bk @ engine.pattern_weights).cpu().numpy()              # [n_sel, K+1]
    logw = np.log(np.maximum(weights[0].detach().cpu().numpy(), 1e-300))
    lp = tot + logw[None, :]
    lp -= lp.max(axis=1, keepdims=True)
    branch_post = np.exp(lp) / np.exp(lp).sum(axis=1, keepdims=True)
    branch_attr = {"0": {}}
    bl = np.asarray(mg.branch_lengths)
    for row, b in enumerate(tested_ids):
        branch_attr["0"][data.tree.names[b]] = {
            "Posterior prob omega class": [[float(x)] for x in branch_post[row]],
            "Posterior prob omega class by site": post[row].tolist(),
            # per-branch length under the MG94 fit (clade_support reads
            # this key for its annotated tree, clade_support.bf:74)
            "MG94xREV with separate rates for branch sets": float(bl[b]),
        }
    with torch.no_grad():
        times = rates[:, None] * params["t"][None, :]
        p_cls = engine.mixture_propagators(params, omegas, weights, times)   # [C, B, S, S]
        p_bar = torch.einsum("c,cbij->bij", wsrv.to(engine.dtype), p_cls)
        joint = ancestral.joint_reconstruct(p_bar, engine.leaf_partials, engine.freqs,
                                            engine.pdata)
    internal = joint.internal_states.cpu().numpy()[:, filt.duplicate_map]
    return branch_attr, {"0": substitution_map(data, internal)}


def _viterbi_path(engine, unpack, params, c_srv, filt):
    """Most probable synonymous-rate class per site (RunViterbi,
    likefunc2.cpp:1284)."""
    with torch.no_grad():
        omegas, weights, rates, wsrv = unpack(params)
        class_sll = engine.class_site_log_likelihoods(params, omegas, weights, params["t"], rates)
        trans = hmm.uniform_switching_matrix(c_srv, params["srv_lambda"])
        path, _ = hmm.viterbi_path(class_sll, filt.duplicate_map, trans, wsrv)
    return [int(x) for x in path]


def run(
    alignment: str,
    genetic_code: str = "Universal",
    tree: Optional[str] = None,
    branches: str = "All",
    srv: bool = True,
    rate_classes: int = 3,
    srv_classes: int = 3,
    starting_points: int = 5,
    precision: float = 1e-4,
    seed: int = 1,
    save_fit: Optional[str] = None,
    srv_hmm: bool = False,
    srv_branchsite: bool = False,
    multiple_hits: str = "None",
    error_sink: bool = False,
    error_sink_bound: float = 100.0,
    error_sink_weight: float = 0.01,
    branch_site_posteriors: bool = False,
    device=None,
) -> BUSTEDResult:
    """BUSTED on one codon alignment, on ``device`` (default
    ``settings.device``: the card, raising without one); the JAX package's
    signature and options.

    ``save_fit``: path for a full-model snapshot — written after the
    unconstrained fit and reused (skipping that fit) on reruns against the
    same data (reference --save-fit, BUSTED.bf:680-733).  ``srv_hmm``: the
    synonymous rate classes follow a hidden Markov chain along the
    alignment (switching rate ``srv_lambda``; BUSTED.bf:137-158), and the
    fitted Viterbi path is reported.  ``srv_branchsite``: the omega class
    and the synonymous rate class are drawn per branch-site, so the K x C
    mixture folds into each branch's matrix (BUSTED.bf:137-141).
    ``multiple_hits``: "Double" / "Double+Triple" adds global delta (psi)
    rates to every mixture component (BUSTED.bf:160-166,329-352).
    ``error_sink``: adds the BUSTED-E misalignment-absorbing class
    (BUSTED.bf:196-226), and with ``branch_site_posteriors`` the
    per-branch class posteriors and the ancestral substitution map."""
    if srv_hmm or srv_branchsite:
        srv = True
    mh = multiple_hits not in (None, "None", "")
    triple = multiple_hits == "Double+Triple"
    if srv_branchsite and (mh or error_sink or srv_hmm):
        # reference asserts the same incompatibilities (BUSTED.bf:393-394)
        raise ValueError(
            "branch-site SRV cannot combine with multiple-hits, error-sink, or HMM SRV")
    data = common.load_codon_data(alignment, genetic_code, tree, branches, device=device)
    device = data.device
    common.progress("busted", "fitting nucleotide GTR")
    gtr = common.fit_gtr(data, precision=1e-5)
    common.progress("busted", f"GTR lnL {gtr.loglik:.3f}; fitting global MG94xREV")
    mg = common.fit_partitioned_mg94(data, gtr, precision=1e-5)
    common.progress("busted", f"MG94 lnL {mg.loglik:.3f}; unconstrained BS-REL fit")

    filt = data.codon_filter
    has_background = bool((~data.tested_branches).any())
    group_of_branch = np.where(data.tested_branches, 0, 1).astype(np.int64)
    k = rate_classes
    c_srv = srv_classes if srv else 1
    mg94 = MG94Base(data.genetic_code, mg.corner_freqs, mg.codon_freqs, device=device)

    if mh:
        def basis_fn(params):
            q1s, q1n = mg94.basis_matrices(params)
            q2s, q2n = mg94.multihit_basis_matrices(params, 2)
            qs = q1s + params["delta"] * q2s
            qn = q1n + params["delta"] * q2n
            if triple:
                q3s, q3n = mg94.multihit_basis_matrices(params, 3)
                qs = qs + params["psi"] * q3s
                qn = qn + params["psi"] * q3n
            return qs, qn
    else:
        basis_fn = None

    engine = BSRELEngine(
        mg94, pruning.build_pruning_data(data.tree, device), filt.leaf_partials(),
        filt.pattern_weights, group_of_branch, c_srv, basis_fn=basis_fn)

    # -- parameter space ------------------------------------------------------
    specs: Specs = dict(MG94Base.theta_specs())
    specs.update(_distribution_specs("test", k, error_sink, error_sink_bound, error_sink_weight))
    if has_background:
        specs.update(_distribution_specs("bkg", k, error_sink, error_sink_bound,
                                         error_sink_weight))
    if srv:
        specs.update(_srv_specs(c_srv))
    if srv_hmm:
        specs["srv_lambda"] = ParamSpec(init=0.2, lower=1e-4, upper=1.0 - 1e-4)
    if mh:
        # reference rate bounds: delta/psi in [0, 100] (MG_REV_MH.bf)
        specs["delta"] = ParamSpec(init=0.05, lower=0.0, upper=100.0)
        if triple:
            specs["psi"] = ParamSpec(init=0.05, lower=0.0, upper=100.0)
    specs["t"] = ParamSpec(init=0.1, lower=0.0, upper=10000.0, shape=(data.tree.n_branches,))
    ones = torch.ones((1,), dtype=torch.float64, device=device)

    def unpack(params):
        om_t, w_t = omega_distribution(params, "test", k, error_sink)
        if has_background:
            om_b, w_b = omega_distribution(params, "bkg", k, error_sink)
            omegas, weights = torch.stack([om_t, om_b]), torch.stack([w_t, w_b])
        else:
            omegas, weights = om_t[None], w_t[None]
        if srv:
            rates, wsrv = srv_distribution(params, c_srv)
        else:
            rates, wsrv = ones, ones
        return omegas, weights, rates, wsrv

    if srv_hmm:
        def loglik(params):
            omegas, weights, rates, wsrv = unpack(params)
            class_sll = engine.class_site_log_likelihoods(params, omegas, weights, params["t"],
                                                          rates)
            trans = hmm.uniform_switching_matrix(c_srv, params["srv_lambda"])
            return hmm.forward_log_likelihood(class_sll, filt.duplicate_map, trans, wsrv)
    elif srv_branchsite:
        def loglik(params):
            return torch.dot(site_logliks(params), engine.pattern_weights)
    else:
        def loglik(params):
            omegas, weights, rates, wsrv = unpack(params)
            return engine.loglik(params, omegas, weights, params["t"], rates, wsrv)

    if srv_branchsite:
        def site_logliks(params):
            omegas, weights, rates, wsrv = unpack(params)
            return engine.branchsite_srv_site_log_likelihoods(
                params, omegas, weights, params["t"], rates, wsrv)
    else:
        def site_logliks(params):
            omegas, weights, rates, wsrv = unpack(params)
            return engine.site_log_likelihoods(params, omegas, weights, params["t"], rates, wsrv)

    # -- starting points ------------------------------------------------------
    base_init = {key: v for key, v in mg.params.items() if key.startswith("theta")}
    base_init["t"] = torch.as_tensor(mg.alphas, dtype=torch.float64, device=device)
    candidates = _candidates(specs, base_init, k, float(mg.omegas[0]), starting_points, seed,
                             error_sink_bound, error_sink_weight, device)

    # cached full-model fit (reference --save-fit, BUSTED.bf:680-733)
    fingerprint, cached = "", None
    if save_fit:
        fingerprint = serialize.data_fingerprint(data.alignment.names,
                                                 data.alignment.sequences)
        cached = serialize.load_snapshot(save_fit, expect_fingerprint=fingerprint,
                                         expect_model="BUSTED")
    if cached is not None and set(cached["parameters"]) == set(specs):
        common.progress("busted", f"unconstrained fit loaded from {save_fit}")
        alt_params = {key: torch.as_tensor(v, dtype=torch.float64, device=device)
                      for key, v in cached["parameters"].items()}
        alt_lnl = float(cached["log_likelihood"])
    else:
        alt_params, alt_lnl = fit_unconstrained(loglik, specs, candidates, starting_points,
                                                precision)
        if save_fit:
            serialize.save_snapshot(
                save_fit, {key: v.detach().cpu().numpy() for key, v in alt_params.items()},
                alt_lnl, model="BUSTED",
                model_config={"rate_classes": k, "srv_classes": c_srv, "srv": srv,
                              "branches": branches},
                tree=data.tree.newick_string, fingerprint=fingerprint)

    # -- null: omega_k := 1 ---------------------------------------------------
    common.progress("busted", f"unconstrained lnL {alt_lnl:.3f}; constrained fit")
    one = torch.tensor(1.0, dtype=torch.float64, device=device)
    null_params, null_lnl = fit_constrained(loglik, specs, alt_params,
                                            {f"test_omega_{k}": one}, precision)
    if null_lnl > alt_lnl:
        # the alternative holds the null (omega_k = 1 is its lower bound), so
        # its fit stopped short: refit it from the null's MLE (the JAX package
        # keeps the lower alternative and clamps the LRT at 0, ROADMAP 3.16)
        common.progress("busted", f"constrained lnL {null_lnl:.6f} above the unconstrained "
                                  f"{alt_lnl:.6f}; unconstrained refit from the constrained MLE")
        refit, refit_lnl, _ = maximize(loglik, specs, null_params, precision=precision)
        if float(refit_lnl) > alt_lnl:
            alt_params, alt_lnl = refit, float(refit_lnl)
    lrt = max(2.0 * (alt_lnl - null_lnl), 0.0)
    p_value = 0.5 * common.chi2_sf(lrt, 2)

    # -- site log likelihoods + evidence ratios -------------------------------
    dup = filt.duplicate_map
    constrained = dict(alt_params)
    constrained[f"test_omega_{k}"] = one
    with torch.no_grad():
        sll_alt, sll_null, sll_con = (site_logliks(p).cpu().numpy()[dup]
                                      for p in (alt_params, null_params, constrained))
    er_optimized = np.exp(sll_alt - sll_null)
    # 'constrained': omega_k clamped at 1 without refitting
    er_constrained = np.exp(sll_alt - sll_con)

    branch_attr = substitutions = None
    if (error_sink or branch_site_posteriors) and not (srv_hmm or srv_branchsite):
        common.progress("busted", "branch-site class posteriors + ancestors")
        branch_attr, substitutions = error_sink_blocks(data, mg, engine, unpack, alt_params)

    omegas, weights, rates, wsrv = (x.detach().cpu().numpy() for x in unpack(alt_params))
    n_classes = omegas.shape[1]  # k, or k+1 with the error sink
    # reference schema: class-index-keyed dicts with omega/proportion
    # (BUSTED.bf selection.io.report_dnds)
    rate_dists = {
        "Test": {str(i): {"omega": float(omegas[0, i]), "proportion": float(weights[0, i])}
                 for i in range(n_classes)},
    }
    if has_background:
        rate_dists["Background"] = {
            str(i): {"omega": float(omegas[1, i]), "proportion": float(weights[1, i])}
            for i in range(n_classes)}
    if mh:
        mh_rates = {"rate at which 2 nucleotides are changed instantly within a single codon":
                    float(alt_params["delta"])}
        if triple:
            mh_rates["rate at which 3 nucleotides are changed instantly within a single codon"] \
                = float(alt_params["psi"])
        rate_dists["Multiple hit rates"] = mh_rates
    if srv:
        rate_dists["Synonymous site-to-site rates"] = [
            [float(rates[i]), float(wsrv[i])] for i in range(c_srv)]

    n_free = count_parameters(specs)
    extra = {
        "test results": {"LRT": lrt, "p-value": p_value},
        "Evidence Ratios": {"optimized null": [er_optimized.tolist()],
                            "constrained": [er_constrained.tolist()]},
        "Site Log Likelihood": {"unconstrained": [sll_alt.tolist()],
                                "optimized null": [sll_null.tolist()]},
    }
    if branch_attr:
        extra["branch attributes"] = branch_attr
    if substitutions:
        extra["substitutions"] = substitutions
    if srv_hmm:
        extra["Synonymous rate HMM"] = {
            "switching rate": float(alt_params["srv_lambda"]),
            "Viterbi path": _viterbi_path(engine, unpack, alt_params, c_srv, filt),
        }
    json = analysis_json(
        info="BUSTED (branch-site unrestricted statistical test of episodic "
             "diversification) uses a random effects branch-site model",
        version="4.5",
        data=data,
        fits={
            "Nucleotide GTR": model_fit_entry(
                gtr.loglik, gtr.n_parameters, data.sample_size,
                frequencies=gtr.frequencies, display_order=0),
            "MG94xREV with separate rates for branch sets": model_fit_entry(
                mg.loglik, mg.n_parameters, data.sample_size,
                frequencies=mg.codon_freqs, display_order=1),
            "Unconstrained model": model_fit_entry(
                alt_lnl, n_free + 9, data.sample_size,
                rate_distributions=rate_dists, display_order=2),
            "Constrained model": model_fit_entry(
                null_lnl, n_free + 8, data.sample_size, display_order=3),
        },
        extra=extra,
    )
    if error_sink:
        json.setdefault("analysis", {}).setdefault("settings", {})["error-sink"] = 1
    return BUSTEDResult(
        json=json, unconstrained_lnl=alt_lnl, null_lnl=null_lnl,
        lrt=lrt, p_value=p_value, evidence_ratios=er_optimized,
        alt_params=alt_params, data=data, gtr=gtr, mg94=mg,
        context={
            "loglik": loglik, "specs": specs, "unpack": unpack, "k": k,
            "error_sink": error_sink, "has_background": has_background,
            "precision": precision,
        },
    )
