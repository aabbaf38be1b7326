"""FitMultiModel (FMM) — compare codon models with double / triple
instantaneous substitutions.

Counterpart of ``hyphy_tpu/methods/fmm.py`` (reference
``res/TemplateBatchFiles/SelectionAnalyses/FitMultiModel.bf``).  Pipeline:
nucleotide GTR fit -> partitioned MG94 hand-off -> three global fits, each
(by default) with a 3-class general-discrete site-level omega distribution
(``FitMultiModel.bf:25`` rate_classes = 3, GDD factory ``:210``):

  * Standard MG94 (single-hit),
  * MG94 + double-hit rate delta (``MG_REV_MH.bf``),
  * MG94 + double & triple hits (delta, psi, ``MG_REV_TRIP.bf``;
    ``triple_islands`` adds a separate synonymous 3-hit rate).

LRTs between nested pairs (chi^2 with 1 / 1 / 2 df) and per-site evidence
ratios exp(site lnL_MH - site lnL_standard) flag the sites that drive
multi-hit support.  Each fit is a gradient fit of the gene likelihood with
the K omega classes folded into K1's node axis (one launch per level for
all classes, ``LikelihoodFunction``'s class mixture).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from hyphy_tpu_torch.io.json_out import analysis_json, model_fit_entry
from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
from hyphy_tpu_torch.methods import common
from hyphy_tpu_torch.models.codon import MG94xREVMultiHitGDD


@dataclasses.dataclass
class FMMResult:
    json: Dict
    loglik_standard: float
    loglik_double: float
    loglik_triple: float
    delta: float
    psi: float
    data: common.LoadedData


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def _fit_one(data, mg, hits: str, rate_classes: int, triple_islands: bool,
             precision: float, prev=None, delta_starts=(0.05,)):
    """One GDD fit.  ``delta_starts``: multi-start values for the 2-hit
    rate — the GDD x multi-hit surface is multimodal and a single warm start
    can under-fit the 2H model by ~1.5 lnL (enough to corrupt the 2H:1H
    LRT); each start gets a coarse fit (precision 0.05) and the two best
    are polished.  Returns (fit, model, site lnL numpy)."""
    device = data.device
    model = MG94xREVMultiHitGDD(
        data.genetic_code, mg.corner_freqs, mg.codon_freqs,
        branch_groups=data.branch_groups, n_groups=int(data.branch_groups.max()) + 1,
        hits=hits, rate_classes=rate_classes, triple_islands=triple_islands,
        device=device,
    )
    lf = LikelihoodFunction([Partition(data.codon_filter, data.tree, model)], device=device)
    init = {k: v for k, v in mg.params.items() if k.startswith("theta")}
    init["alpha"] = _f64(mg.alphas, device)
    if rate_classes > 1:
        omega0 = float(np.mean(mg.omegas))
        init["omega_c"] = _f64([omega0 * f for f in np.linspace(0.35, 2.2, rate_classes)],
                               device)
        init["omega_w"] = _f64(np.full((rate_classes - 1,), 0.55), device)
    else:
        init["omega"] = _f64(mg.omegas, device)
    if hits != "None":
        init["delta"] = _f64(0.05, device)
    if hits == "Double+Triple":
        init["psi"] = _f64(0.05, device)
        if triple_islands:
            init["psi_syn"] = _f64(0.05, device)
    if prev is not None:  # warm-start from the nested fit
        init.update({k: v for k, v in prev.params.items() if k in lf.specs})
    if hits == "None" or len(delta_starts) <= 1:
        res = lf.fit(init=init, precision=precision)
    else:
        coarse = []
        for d0 in delta_starts:
            start = dict(init)
            start["delta"] = _f64(d0, device)
            if hits == "Double+Triple":
                start["psi"] = _f64(max(d0 / 2, 1e-3), device)
            coarse.append(lf.fit(init=start, precision=max(precision, 0.05)))
        coarse.sort(key=lambda r: -r.loglik)
        res = None
        for cand in coarse[:2]:
            polished = lf.fit(init=cand.params, precision=precision)
            if res is None or polished.loglik > res.loglik:
                res = polished
    with torch.no_grad():
        site_lnl = lf.site_log_likelihoods(res.params)[0].cpu().numpy()
    return res, model, site_lnl


def run(
    alignment: str,
    genetic_code: str = "Universal",
    tree: Optional[str] = None,
    rate_classes: int = 3,
    triple_islands: bool = False,
    precision: float = 1e-5,
    device=None,
) -> FMMResult:
    data = common.load_codon_data(alignment, genetic_code, tree, "All", device=device)
    gtr = common.fit_gtr(data, precision=precision)
    mg = common.fit_partitioned_mg94(data, gtr, precision=precision, refit_lengths=False)
    common.progress("fmm", f"GTR lnL {gtr.loglik:.4f}, MG94 lnL {mg.loglik:.4f}")

    res1, model1, site1 = _fit_one(data, mg, "None", rate_classes, False, precision)
    res2, model2, site2 = _fit_one(
        data, mg, "Double", rate_classes, False, precision, prev=res1,
        delta_starts=(0.02, 0.1, 0.4),
    )
    res3, model3, site3 = _fit_one(
        data, mg, "Double+Triple", rate_classes, triple_islands, precision,
        prev=res2, delta_starts=(0.02, 0.1, 0.4),
    )
    common.progress("fmm", f"1H {res1.loglik:.4f}, 2H {res2.loglik:.4f}, "
                           f"3H {res3.loglik:.4f}")

    lrt21, p21 = common.lrt(res2.loglik, res1.loglik, 1)
    lrt32, p32 = common.lrt(res3.loglik, res2.loglik, 1 + int(triple_islands))
    lrt31, p31 = common.lrt(res3.loglik, res1.loglik, 2 + int(triple_islands))

    dup = data.codon_filter.duplicate_map
    er_double = np.exp(np.clip(site2[dup] - site1[dup], -700, 700))
    er_triple = np.exp(np.clip(site3[dup] - site2[dup], -700, 700))

    delta2 = float(res2.params["delta"])
    delta3 = float(res3.params["delta"])
    psi3 = float(res3.params["psi"])

    def dist_entry(res, model, mh_params):
        # FMM.wbf reads ["Rate Distributions"]["parameters"][<rate term>]
        rd = {"parameters": mh_params}
        if rate_classes > 1:
            with torch.no_grad():
                omegas, weights = (x.cpu().numpy() for x in model.class_distribution(res.params))
            order = np.argsort(omegas)
            rd["non-synonymous/synonymous rate ratio"] = [
                [float(omegas[i]), float(weights[i])] for i in order
            ]
        return rd

    _2h = "rate at which 2 nucleotides are changed instantly within a single codon"
    _3h = "rate at which 3 nucleotides are changed instantly within a single codon"
    _3hs = _3h + " between synonymous codon islands"

    json = analysis_json(
        info="FitMultiModel fits MG94xREV models allowing double and triple "
             "instantaneous nucleotide substitutions within a codon and "
             "compares them to the standard single-hit model",
        version="0.3",
        data=data,
        fits={
            "Nucleotide GTR": model_fit_entry(
                gtr.loglik, gtr.n_parameters, data.sample_size,
                frequencies=gtr.frequencies, display_order=0,
            ),
            "Standard MG94": model_fit_entry(
                res1.loglik, res1.n_free_parameters + 9, data.sample_size,
                frequencies=mg.codon_freqs, display_order=1,
                rate_distributions=dist_entry(res1, model1, {}),
            ),
            "MG94 with double instantaneous substitutions": model_fit_entry(
                res2.loglik, res2.n_free_parameters + 9, data.sample_size,
                frequencies=mg.codon_freqs, display_order=2,
                rate_distributions=dist_entry(res2, model2, {_2h: delta2}),
            ),
            "MG94 with double and triple instantaneous substitutions": model_fit_entry(
                res3.loglik, res3.n_free_parameters + 9, data.sample_size,
                frequencies=mg.codon_freqs, display_order=3,
                rate_distributions=dist_entry(
                    res3, model3,
                    {_2h: delta3, _3h: psi3,
                     **({_3hs: float(res3.params["psi_syn"])}
                        if triple_islands else {})},
                ),
            ),
        },
        extra={
            "test results": {
                "Double-hit vs single-hit": {"LRT": lrt21, "p-value": p21},
                "Triple-hit vs double-hit": {"LRT": lrt32, "p-value": p32},
                "Triple-hit vs single-hit": {"LRT": lrt31, "p-value": p31},
            },
            "Evidence Ratios": {
                "Two-hit": [er_double.tolist()],
                "Three-hit": [er_triple.tolist()],
            },
            "Site Log Likelihood": {
                "Standard": [site1[dup].tolist()],
                "Double-hit": [site2[dup].tolist()],
                "Triple-hit": [site3[dup].tolist()],
            },
        },
    )
    return FMMResult(
        json=json,
        loglik_standard=res1.loglik,
        loglik_double=res2.loglik,
        loglik_triple=res3.loglik,
        delta=delta3,
        psi=psi3,
        data=data,
    )
