"""RELAX — test for relaxation or intensification of selection.

Counterpart of ``hyphy_tpu/methods/relax.py`` (reference
``SelectionAnalyses/RELAX.bf``).  Classic mode: a test and a reference
branch set (unclassified branches get their own nuisance distribution).
Models (``--models All``):

  * general descriptive: a shared K-class omega distribution with a
    per-branch exponent k_b (omega_i ^ k_b), one BS-REL group per branch —
    the engine's per-branch route builds all B*K families in one batched
    pass;
  * RELAX alternative: reference {omega_i, w_i}, test {omega_i ^ K}, shared
    weights, K free in (0, 50];
  * RELAX null: K := 1 (LRT ~ chi^2_1);
  * partitioned descriptive: independent distributions per branch set.

``--models Minimal`` fits the alternative and the null only.  Group mode
(``groups``): three or more labelled sets, a K per set against the
reference's K := 1, null all K := 1 with df = N - 1.

Every fit is :func:`optimize.core.maximize_jax` (logit-remapped L-BFGS, as
in the JAX package).  Where the null ends above the alternative, which holds
it at K = 1, the alternative is refit from the null's MLE (the JAX package
keeps the lower alternative and clamps the LRT at 0, ROADMAP 3.16).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from hyphy_tpu_torch.io.json_out import analysis_json, model_fit_entry
from hyphy_tpu_torch.methods import common
from hyphy_tpu_torch.models.bsrel import BSRELEngine
from hyphy_tpu_torch.models.codon import MG94Base
from hyphy_tpu_torch.models.parameters import ParamSpec, Specs, count_parameters
from hyphy_tpu_torch.models.parameters import stick_breaking_weights
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.optimize.core import maximize_jax as maximize

# the floor under omega in omega ^ K: keeps log(omega) in the exponent's
# gradient finite (relax.py:154-155, :198)
OMEGA_FLOOR = 1e-10
# the alternative's starts for K (relax.py:241)
K_STARTS = (1.0, 0.3, 3.0)


@dataclasses.dataclass
class RELAXResult:
    json: Dict
    k: float
    lrt: float
    p_value: float
    fits: Dict[str, float]
    distributions: Dict
    data: common.LoadedData
    gtr: common.GTRFit
    mg94: common.MG94Fit
    # {"alternative": (loglik, specs, params), "null": (loglik, specs,
    # params with the K pinned)}
    models: Optional[Dict] = None


def _omega_specs(prefix: str, k: int) -> Specs:
    """omega_1..k-1 in [0,1), omega_k >= 1 (RELAX ge ranges)."""
    specs = {}
    for i in range(1, k):
        specs[f"{prefix}_omega_{i}"] = ParamSpec(init=0.2 * i, lower=0.0, upper=1.0)
    specs[f"{prefix}_omega_{k}"] = ParamSpec(init=1.5, lower=1.0, upper=10000.0)
    return specs


def _weight_specs(prefix: str, k: int) -> Specs:
    return {
        f"{prefix}_w_{i}": ParamSpec(init=0.6 if i == 1 else 0.5, lower=0.0, upper=1.0)
        for i in range(1, k)
    }


def _get_omegas(params, prefix, k):
    return torch.stack([params[f"{prefix}_omega_{i}"] for i in range(1, k + 1)])


def _get_weights(params, prefix, k):
    if k == 1:
        return torch.ones_like(params[f"{prefix}_omega_1"])[None]
    fracs = torch.stack([params[f"{prefix}_w_{i}"] for i in range(1, k)])
    return stick_breaking_weights(fracs)


def _floored(omegas):
    # torch.maximum splits the gradient at ties as jnp.maximum does
    return torch.maximum(omegas, torch.full_like(omegas, OMEGA_FLOOR))


def _dist_json(params, prefix, k):
    om = _get_omegas(params, prefix, k).detach().cpu().numpy()
    w = _get_weights(params, prefix, k).detach().cpu().numpy()
    return {str(i): {"omega": float(om[i]), "proportion": float(w[i])} for i in range(k)}


def general_descriptive_distribution(params, k, n_branches):
    """(omegas ``[B, K]``, weights ``[B, K]``): the shared ``ge``
    distribution with branch b's omegas at the power ``k_branch[b]``
    (relax.py:152-157)."""
    om = _get_omegas(params, "ge", k)
    w = _get_weights(params, "ge", k)
    omegas = torch.pow(_floored(om)[None, :], params["k_branch"][:, None])
    return omegas, w[None].expand(n_branches, k)


def group_distribution(params, k, n_groups, has_unc):
    """(omegas, weights) of group mode: the reference set's distribution,
    set g's omegas at the power ``K_g``, and the nuisance set's own
    distribution (relax.py:438-448)."""
    om_ref = _floored(_get_omegas(params, "ref", k))
    w = _get_weights(params, "ref", k)
    rows = [om_ref] + [torch.pow(om_ref, params[f"K_{gi}"]) for gi in range(1, n_groups)]
    w_rows = [w] * n_groups
    if has_unc:
        rows.append(_floored(_get_omegas(params, "unc", k)))
        w_rows.append(_get_weights(params, "unc", k))
    return torch.stack(rows), torch.stack(w_rows)


def _objective(engine, distribution):
    """lnL of ``engine`` at the (omegas, weights) ``distribution(params)``
    gives, without synonymous rate variation; the engine stays reachable as
    ``loglik.engine``."""
    def loglik(params):
        omegas, weights = distribution(params)
        ones = torch.ones_like(omegas[:1, 0])
        return engine.loglik(params, omegas, weights, params["t"], ones, ones)

    loglik.engine = engine
    return loglik


def general_descriptive_objective(engine, k):
    """The general-descriptive lnL (relax.py:151-160); ``engine`` has one
    group per branch."""
    n_branches = engine.group_of_branch.shape[0]
    return _objective(engine, lambda p: general_descriptive_distribution(p, k, n_branches))


def alternative_objective(engine, k, has_unclassified):
    """The classic alternative's lnL: groups test (``ref`` omegas at the
    power K), reference, and the unclassified set's own omegas with the
    reference's weights (relax.py:197-211)."""
    n_groups = 3 if has_unclassified else 2

    def distribution(params):
        om_ref = _floored(_get_omegas(params, "ref", k))
        w = _get_weights(params, "ref", k)
        rows = [torch.pow(om_ref, params["K"]), om_ref]
        if has_unclassified:
            rows.append(_get_omegas(params, "unc", k))
        return torch.stack(rows), w[None].expand(n_groups, k)

    return _objective(engine, distribution)


def partitioned_objective(engine, k, prefixes):
    """The partitioned descriptive lnL: one free distribution per branch
    set (relax.py:278-283)."""
    return _objective(engine, lambda p: (
        torch.stack([_get_omegas(p, prefix, k) for prefix in prefixes]),
        torch.stack([_get_weights(p, prefix, k) for prefix in prefixes])))


def group_objective(engine, k, n_groups, has_unc):
    """Group mode's lnL (relax.py:450-455)."""
    return _objective(engine, lambda p: group_distribution(p, k, n_groups, has_unc))


def fit_general_descriptive(loglik, specs, starts, precision):
    """Coarse fits from every start (precision 0.1, at most 500
    iterations), then the best two polished at ``precision``
    (relax.py:167-184).  Returns (params, lnL)."""
    coarse = []
    for init in starts:
        p0, v0, _ = maximize(loglik, specs, init, precision=0.1, max_iterations=500)
        coarse.append((float(v0), p0))
    coarse.sort(key=lambda x: -x[0])
    best, best_lnl = None, -np.inf
    for _, p0 in coarse[:2]:
        p1, v1, _ = maximize(loglik, specs, p0, precision=precision)
        if float(v1) > best_lnl:
            best_lnl, best = float(v1), p1
    return best, best_lnl


def fit_alternative(loglik, specs, init, k_names, precision):
    """From each of the three K starts (every K in ``k_names`` set to it): a
    coarse fit (precision 0.1, at most 400 iterations), then a polish at
    ``precision``; the best polished fit (relax.py:239-247, :476-486).
    Returns (params, lnL)."""
    best, best_lnl = None, -np.inf
    for k_start in K_STARTS:
        start = dict(init)
        for name in k_names:
            start[name] = torch.full_like(init[name], k_start)
        p0, _, _ = maximize(loglik, specs, start, precision=0.1, max_iterations=400)
        p1, v1, _ = maximize(loglik, specs, p0, precision=precision)
        if float(v1) > best_lnl:
            best_lnl, best = float(v1), p1
    return best, best_lnl


def fit_null(loglik, specs, alt_params, alt_lnl, fixed, precision):
    """The alternative with ``fixed`` held, from the alternative's MLE
    (``alt_params``, lnL ``alt_lnl``); where it ends above the alternative,
    the alternative is refit from its MLE (ROADMAP 3.16).  Returns (null
    params with ``fixed`` merged, null lnL, alternative params, alternative
    lnL) — the last two the refit's where it climbed higher."""
    free_specs = {k: v for k, v in specs.items() if k not in fixed}
    init = {k: v for k, v in alt_params.items() if k not in fixed}

    def constrained(free):
        merged = dict(free)
        merged.update(fixed)
        return loglik(merged)

    null_params, null_lnl, _ = maximize(constrained, free_specs, init, precision=precision)
    null_params = dict(null_params)
    null_params.update(fixed)
    null_lnl = float(null_lnl)
    if null_lnl > alt_lnl:
        common.progress("relax", f"null lnL {null_lnl:.6f} above the alternative's "
                                 f"{alt_lnl:.6f}; alternative refit from the null's MLE")
        refit, refit_lnl, _ = maximize(loglik, specs, null_params, precision=precision)
        if float(refit_lnl) > alt_lnl:
            alt_params, alt_lnl = refit, float(refit_lnl)
    return null_params, null_lnl, alt_params, alt_lnl


def fit_partitioned_descriptive(loglik, specs, init, precision):
    """A coarse fit (precision 0.1, at most 400 iterations), then a polish
    (relax.py:301-302).  Returns (params, lnL)."""
    p0, _, _ = maximize(loglik, specs, init, precision=0.1, max_iterations=400)
    params, lnl, _ = maximize(loglik, specs, p0, precision=precision)
    return params, float(lnl)


def _general_descriptive_starts(theta_init, t_init, k, n_branches, mean_omega, rng, scalar,
                                device):
    """The five starts, with the JAX package's draws in its order
    (relax.py:168-177): start 0 is fixed, the others random."""
    starts = []
    for trial in range(5):
        init = dict(theta_init)
        init["t"] = t_init
        init["k_branch"] = torch.ones(n_branches, dtype=torch.float64, device=device)
        for i in range(1, k):
            init[f"ge_omega_{i}"] = scalar(
                min(0.95, rng.uniform(0.1, 0.8) * max(mean_omega, 0.3)) if trial
                else 0.25 * i * min(mean_omega * 2, 1.0) + 1e-3)
            init[f"ge_w_{i}"] = scalar(rng.uniform(0.4, 0.8) if trial else 0.6)
        init[f"ge_omega_{k}"] = scalar(
            1.0 + rng.exponential(1.0) if trial else max(1.1, mean_omega * 2))
        starts.append(init)
    return starts


def _mg94_stages(data, precision):
    common.progress("relax", "fitting nucleotide GTR")
    gtr = common.fit_gtr(data, precision=precision)
    common.progress("relax", f"GTR lnL {gtr.loglik:.3f}; fitting global MG94xREV")
    mg = common.fit_partitioned_mg94(data, gtr, precision=precision)
    common.progress("relax", f"MG94 lnL {mg.loglik:.3f}")
    return gtr, mg


def _fit_entries(data, gtr, mg):
    return {
        "Nucleotide GTR": model_fit_entry(
            gtr.loglik, gtr.n_parameters, data.sample_size,
            frequencies=gtr.frequencies, display_order=0),
        "MG94xREV with separate rates for branch sets": model_fit_entry(
            mg.loglik, mg.n_parameters, data.sample_size, display_order=1),
    }


def run(
    alignment: str,
    genetic_code: str = "Universal",
    tree: Optional[str] = None,
    test: str = "Group1",
    reference: Optional[str] = "Group2",
    rate_classes: int = 3,
    models: str = "All",
    precision: float = 1e-5,
    seed: int = 3,
    groups: Optional[list] = None,
    device=None,
) -> RELAXResult:
    """RELAX on one codon alignment, on ``device`` (default
    ``settings.device``: the card, raising without one); the JAX package's
    signature.  ``groups``: group mode (>= 3 labelled branch sets;
    ``RELAX.bf:91-94``), ``reference`` naming the set with K := 1; it runs
    the alternative and the null only."""
    if groups is not None:
        return _run_groups(alignment, genetic_code, tree, groups, reference, rate_classes,
                           precision, device)
    data = common.load_codon_data(alignment, genetic_code, tree, branches=test, device=device)
    device = data.device
    tree_obj = data.tree
    n_branches = tree_obj.n_branches
    # branch sets: 0 = test, 1 = reference, 2 = unclassified
    test_mask = tree_obj.select_branches(test)
    ref_mask = tree_obj.select_branches(reference) if reference else ~test_mask
    group = np.full(n_branches, 2, dtype=np.int32)
    group[ref_mask] = 1
    group[test_mask] = 0
    has_unclassified = bool((group == 2).any())
    n_groups = 3 if has_unclassified else 2
    data.tested_branches = test_mask
    data.branch_groups = group

    gtr, mg = _mg94_stages(data, precision)
    filt = data.codon_filter
    k = rate_classes
    mg94 = MG94Base(data.genetic_code, mg.corner_freqs, mg.codon_freqs, device=device)
    pdata = pruning.build_pruning_data(tree_obj, device)
    lp = filt.leaf_partials()

    def scalar(x):
        return torch.tensor(float(x), dtype=torch.float64, device=device)

    theta_init = {key: v for key, v in mg.params.items() if key.startswith("theta")}
    t_init = torch.as_tensor(mg.alphas, dtype=torch.float64, device=device)
    mean_omega = float(np.mean(mg.omegas))
    rng = np.random.default_rng(seed)
    t_spec = ParamSpec(init=0.1, lower=0.0, upper=10000.0, shape=(n_branches,))

    # -- general descriptive: a per-branch exponent k_b ------------------------
    ge_engine = BSRELEngine(mg94, pdata, lp, filt.pattern_weights,
                            np.arange(n_branches, dtype=np.int32))
    ge_specs: Specs = dict(MG94Base.theta_specs())
    ge_specs.update(_omega_specs("ge", k))
    ge_specs.update(_weight_specs("ge", k))
    ge_specs["k_branch"] = ParamSpec(init=1.0, lower=0.0, upper=50.0, shape=(n_branches,))
    ge_specs["t"] = t_spec

    ge_loglik = general_descriptive_objective(ge_engine, k)

    ge_params, ge_lnl = None, -np.inf
    if models == "All":
        # the general-descriptive fit belongs to All mode only
        # (RELAX.bf --models: Minimal = alternative + null)
        common.progress("relax", "fitting general descriptive model")
        starts = _general_descriptive_starts(theta_init, t_init, k, n_branches, mean_omega, rng,
                                             scalar, device)
        ge_params, ge_lnl = fit_general_descriptive(ge_loglik, ge_specs, starts, precision)
        common.progress("relax", f"general descriptive lnL {ge_lnl:.3f}")

    # -- alternative: test = reference ^ K ------------------------------------
    alt_engine = BSRELEngine(mg94, pdata, lp, filt.pattern_weights, group)
    alt_specs: Specs = dict(MG94Base.theta_specs())
    alt_specs.update(_omega_specs("ref", k))
    alt_specs.update(_weight_specs("ref", k))
    if has_unclassified:
        alt_specs.update(_omega_specs("unc", k))
    alt_specs["K"] = ParamSpec(init=1.0, lower=0.0, upper=50.0)
    alt_specs["t"] = t_spec

    alt_loglik = alternative_objective(alt_engine, k, has_unclassified)

    # from the GD fit where there is one (All mode), else from MG94
    alt_init = {}
    if ge_params is not None:
        alt_init.update({key: v for key, v in ge_params.items() if key.startswith("theta")})
        alt_init["t"] = ge_params["t"]
        for i in range(1, k + 1):
            alt_init[f"ref_omega_{i}"] = ge_params[f"ge_omega_{i}"]
            if has_unclassified:
                alt_init[f"unc_omega_{i}"] = ge_params[f"ge_omega_{i}"]
        for i in range(1, k):
            alt_init[f"ref_w_{i}"] = ge_params[f"ge_w_{i}"]
    else:
        alt_init.update(theta_init)
        alt_init["t"] = t_init
        for i in range(1, k + 1):
            val = (min(0.25 * i * max(mean_omega * 2, 0.2), 0.95)
                   if i < k else max(1.1, mean_omega * 2))
            alt_init[f"ref_omega_{i}"] = scalar(val)
            if has_unclassified:
                alt_init[f"unc_omega_{i}"] = scalar(val)
        for i in range(1, k):
            alt_init[f"ref_w_{i}"] = scalar(0.6)
    alt_init["K"] = scalar(1.0)

    common.progress("relax", "fitting RELAX alternative model")
    alt_params, alt_lnl = fit_alternative(alt_loglik, alt_specs, alt_init, ["K"], precision)
    common.progress("relax", f"alternative lnL {alt_lnl:.3f}, K = {float(alt_params['K']):.3f}")

    # -- null: K := 1 ---------------------------------------------------------
    common.progress("relax", "fitting RELAX null model")
    null_params, null_lnl, alt_params, alt_lnl = fit_null(
        alt_loglik, alt_specs, alt_params, alt_lnl, {"K": scalar(1.0)}, precision)
    k_mle = float(alt_params["K"])
    null_specs = {key: v for key, v in alt_specs.items() if key != "K"}
    lrt = max(2.0 * (alt_lnl - null_lnl), 0.0)
    p_value = common.chi2_sf(lrt, 1)
    common.progress("relax", f"null lnL {null_lnl:.3f}; LRT {lrt:.3f}, p {p_value:.4f}")

    # -- partitioned descriptive ----------------------------------------------
    pd_lnl, pd_dists = None, None
    if models == "All":
        pd_specs: Specs = dict(MG94Base.theta_specs())
        prefixes = ["pd_test", "pd_ref"] + (["pd_unc"] if has_unclassified else [])
        for pref in prefixes:
            pd_specs.update(_omega_specs(pref, k))
            pd_specs.update(_weight_specs(pref, k))
        pd_specs["t"] = t_spec

        pd_loglik = partitioned_objective(alt_engine, k, prefixes)

        pd_init = {key: v for key, v in alt_params.items() if key.startswith("theta")}
        pd_init["t"] = alt_params["t"]
        k_clip = min(max(k_mle, 1e-3), 50.0)
        for i in range(1, k + 1):
            ref_om = float(alt_params[f"ref_omega_{i}"])
            pd_init[f"pd_ref_omega_{i}"] = scalar(ref_om)
            pd_init[f"pd_test_omega_{i}"] = scalar(
                min(max(ref_om ** k_clip, 1.0 if i == k else 0.0),
                    1.0 - 1e-6 if i < k else 10000.0))
            if has_unclassified:
                pd_init[f"pd_unc_omega_{i}"] = alt_params[f"unc_omega_{i}"]
        for i in range(1, k):
            for pref in prefixes:
                pd_init[f"{pref}_w_{i}"] = alt_params[f"ref_w_{i}"]

        common.progress("relax", "fitting partitioned descriptive model")
        pd_params, pd_lnl = fit_partitioned_descriptive(pd_loglik, pd_specs, pd_init, precision)
        pd_dists = {"Test": _dist_json(pd_params, "pd_test", k),
                    "Reference": _dist_json(pd_params, "pd_ref", k)}
        common.progress("relax", f"partitioned descriptive lnL {pd_lnl:.3f}")

    # -- results ---------------------------------------------------------------
    om_ref = _get_omegas(alt_params, "ref", k).detach().cpu().numpy()
    w_ref = _get_weights(alt_params, "ref", k).detach().cpu().numpy()
    alt_dists = {
        "Test": {str(i): {"omega": float(om_ref[i] ** k_mle), "proportion": float(w_ref[i])}
                 for i in range(k)},
        "Reference": {str(i): {"omega": float(om_ref[i]), "proportion": float(w_ref[i])}
                      for i in range(k)},
    }
    fits = _fit_entries(data, gtr, mg)
    if ge_params is not None:
        fits["General descriptive"] = model_fit_entry(
            ge_lnl, count_parameters(ge_specs) + 9, data.sample_size, display_order=4,
            rate_distributions={"Shared": _dist_json(ge_params, "ge", k)})
    fits["RELAX alternative"] = model_fit_entry(
        alt_lnl, count_parameters(alt_specs) + 9, data.sample_size, display_order=2,
        rate_distributions=alt_dists)
    fits["RELAX null"] = model_fit_entry(
        null_lnl, count_parameters(null_specs) + 9, data.sample_size, display_order=3)
    if pd_lnl is not None:
        fits["RELAX partitioned descriptive"] = model_fit_entry(
            pd_lnl, count_parameters(pd_specs) + 9, data.sample_size, display_order=5,
            rate_distributions=pd_dists)

    json = analysis_json(
        info="RELAX (a random effects test of selection relaxation) uses a "
             "random effects branch-site model framework",
        version="4.1",
        data=data,
        fits=fits,
        extra={"test results": {"LRT": lrt, "p-value": p_value,
                                "relaxation or intensification parameter": k_mle}},
    )
    return RELAXResult(
        json=json, k=k_mle, lrt=lrt, p_value=p_value,
        fits={name: entry["Log Likelihood"] for name, entry in fits.items()},
        distributions={"alternative": alt_dists, "partitioned descriptive": pd_dists},
        data=data, gtr=gtr, mg94=mg,
        models={"alternative": (alt_loglik, alt_specs, alt_params),
                "null": (alt_loglik, alt_specs, null_params)},
    )


def _run_groups(alignment, genetic_code, tree, groups, reference, rate_classes, precision,
                device):
    """RELAX group mode: N >= 3 labelled sets, a K per set against an all
    K := 1 null (``RELAX.bf`` kGroupMode, ``RELAX-Groups.bf``)."""
    if reference is None or reference not in groups:
        raise ValueError("group mode needs reference to be one of groups")
    if len(groups) < 3:
        raise ValueError("group mode needs >= 3 branch sets; use test/"
                         "reference for the classic 2-set analysis")
    k = rate_classes
    # the reference first (K = 1 identically)
    ordered = [reference] + [g for g in groups if g != reference]
    data = common.load_codon_data(alignment, genetic_code, tree, branches=ordered[1],
                                  device=device)
    device = data.device
    tree_obj = data.tree
    n_branches = tree_obj.n_branches
    group = np.full(n_branches, -1, dtype=np.int32)
    for gi, label in enumerate(ordered):
        group[tree_obj.select_branches(label)] = gi
    n_groups = len(ordered)
    # unlabelled branches form the reference's unclassified (nuisance) set
    # (RELAX.bf:264-267, :952-982): their own distribution, the same in the
    # alternative and the null
    has_unc = bool((group < 0).any())
    if has_unc:
        group[group < 0] = n_groups
    data.tested_branches = group == 1
    data.branch_groups = group

    gtr, mg = _mg94_stages(data, precision)
    filt = data.codon_filter
    mg94 = MG94Base(data.genetic_code, mg.corner_freqs, mg.codon_freqs, device=device)
    engine = BSRELEngine(mg94, pruning.build_pruning_data(tree_obj, device),
                         filt.leaf_partials(), filt.pattern_weights, group)

    def scalar(x):
        return torch.tensor(float(x), dtype=torch.float64, device=device)

    specs: Specs = dict(MG94Base.theta_specs())
    specs.update(_omega_specs("ref", k))
    specs.update(_weight_specs("ref", k))
    if has_unc:
        specs.update(_omega_specs("unc", k))
        specs.update(_weight_specs("unc", k))
    k_names = [f"K_{gi}" for gi in range(1, n_groups)]
    for name in k_names:
        specs[name] = ParamSpec(init=1.0, lower=0.0, upper=50.0)
    specs["t"] = ParamSpec(init=0.1, lower=0.0, upper=10000.0, shape=(n_branches,))

    alt_loglik = group_objective(engine, k, n_groups, has_unc)

    mean_omega = float(np.mean(mg.omegas))
    init = {key: v for key, v in mg.params.items() if key.startswith("theta")}
    init["t"] = torch.as_tensor(mg.alphas, dtype=torch.float64, device=device)
    for i in range(1, k + 1):
        init[f"ref_omega_{i}"] = scalar(min(0.25 * i * max(mean_omega * 2, 0.2), 0.95)
                                        if i < k else max(1.1, mean_omega * 2))
    for i in range(1, k):
        init[f"ref_w_{i}"] = scalar(0.6)
    if has_unc:
        for i in range(1, k + 1):
            init[f"unc_omega_{i}"] = init[f"ref_omega_{i}"]
        for i in range(1, k):
            init[f"unc_w_{i}"] = scalar(0.6)
    for name in k_names:
        init[name] = scalar(1.0)

    common.progress("relax", f"fitting group-mode alternative ({n_groups} sets)")
    alt_params, alt_lnl = fit_alternative(alt_loglik, specs, init, k_names, precision)
    common.progress("relax", "fitting group-mode null (all K := 1)")
    null_fixed = {name: scalar(1.0) for name in k_names}
    null_params, null_lnl, alt_params, alt_lnl = fit_null(alt_loglik, specs, alt_params,
                                                          alt_lnl, null_fixed, precision)
    null_specs = {key: v for key, v in specs.items() if key not in null_fixed}
    k_mles = {ordered[gi]: float(alt_params[f"K_{gi}"]) for gi in range(1, n_groups)}
    df = n_groups - 1
    lrt = max(2.0 * (alt_lnl - null_lnl), 0.0)
    p_value = common.chi2_sf(lrt, df)
    common.progress("relax", f"alternative lnL {alt_lnl:.3f}, K = {k_mles}; null lnL "
                             f"{null_lnl:.3f}; LRT {lrt:.3f} (df {df}), p {p_value:.4f}")

    om_ref = _get_omegas(alt_params, "ref", k).detach().cpu().numpy()
    w_ref = _get_weights(alt_params, "ref", k).detach().cpu().numpy()
    alt_dists = {ordered[0]: {str(i): {"omega": float(om_ref[i]), "proportion": float(w_ref[i])}
                              for i in range(k)}}
    for gi in range(1, n_groups):
        kg = float(alt_params[f"K_{gi}"])
        alt_dists[ordered[gi]] = {
            str(i): {"omega": float(om_ref[i] ** kg), "proportion": float(w_ref[i])}
            for i in range(k)}
    if has_unc:
        alt_dists["Unclassified"] = _dist_json(alt_params, "unc", k)

    fits = _fit_entries(data, gtr, mg)
    fits["RELAX alternative"] = model_fit_entry(
        alt_lnl, count_parameters(specs) + 9, data.sample_size, display_order=2,
        rate_distributions=alt_dists)
    fits["RELAX null"] = model_fit_entry(
        null_lnl, count_parameters(null_specs) + 9, data.sample_size, display_order=3)
    json = analysis_json(
        info="RELAX (group mode): tests for differences of selective "
             "pressures among 3 or more branch groups",
        version="4.1",
        data=data,
        fits=fits,
        extra={"test results": {"LRT": lrt, "p-value": p_value,
                                "relaxation or intensification parameter": k_mles,
                                "degrees of freedom": df}},
    )
    return RELAXResult(
        json=json, k=k_mles.get(ordered[1], 1.0), lrt=lrt, p_value=p_value,
        fits={name: entry["Log Likelihood"] for name, entry in fits.items()},
        distributions={"alternative": alt_dists, "partitioned descriptive": None},
        data=data, gtr=gtr, mg94=mg,
        models={"alternative": (alt_loglik, specs, alt_params),
                "null": (alt_loglik, specs, null_params)},
    )
