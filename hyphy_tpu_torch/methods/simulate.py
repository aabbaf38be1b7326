"""``python -m hyphy_tpu_torch simulate`` — parametric simulation of alignments from a
fitted model (the user surface over the engine's ``SimulateDataSet``,
reference ``likefunc.cpp:12584``; HBL exposes it as the ``SimulateDataSet
(lf)`` statement after ``Optimize``).

Pipeline: load alignment + tree -> nucleotide GTR fit -> global MG94xREV
fit (the same staged hand-off every selection method uses) -> sample
``replicates`` alignments root-to-tips under the MLE transition matrices
-> write FASTA replicates + a JSON manifest of the generating
parameters.  ``--omega`` / ``--site-omegas`` override the fitted omega
so power studies can plant positive sites with everything else (tree,
branch lengths, nucleotide biases, frequencies) taken from the real
data's fit.

Counterpart of ``hyphy_tpu/methods/simulate.py``: the fits run on the
device; the MLE propagators (fp64) come to the host, where
:func:`simulate_states` draws the replicates with the JAX package's order
of draws.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from hyphy_tpu_torch.io.json_out import analysis_json, model_fit_entry
from hyphy_tpu_torch.methods import common
from hyphy_tpu_torch.utils.simulate import simulate_states, states_to_alignment


@dataclasses.dataclass
class SimulateResult:
    json: Dict
    files: List[str]


def run(
    alignment: str,
    genetic_code: str = "Universal",
    tree: Optional[str] = None,
    branches: str = "All",
    replicates: int = 1,
    sites: Optional[int] = None,
    omega: Optional[float] = None,
    seed: int = 0,
    output: Optional[str] = None,
    precision: float = 1e-4,
    device=None,
) -> SimulateResult:
    """``sites``: number of codons per replicate (default: the input's
    length).  ``omega``: override the fitted global omega (all branch
    groups).  The fits run on ``device`` (default ``settings.device``: the
    card, raising without one)."""
    common.progress("simulate", f"loading {os.path.basename(alignment)}")
    data = common.load_codon_data(alignment, genetic_code, tree, branches, device=device)
    gtr = common.fit_gtr(data, precision=precision)
    common.progress("simulate", f"GTR lnL {gtr.loglik:.3f}; fitting MG94xREV")
    mg = common.fit_partitioned_mg94(data, gtr, precision=precision)
    common.progress("simulate", f"MG94 lnL {mg.loglik:.3f}; simulating")

    params = dict(mg.params)
    if omega is not None:
        params["omega"] = torch.full_like(params["omega"], omega)
    with torch.no_grad():
        out = mg.model.build(params, data.tree.n_branches)
    p = out.p_matrices.cpu().numpy().astype(np.float64)
    # guard against fp round-off in the sampler's cumulative sums
    p = np.maximum(p, 0.0)
    p /= p.sum(axis=-1, keepdims=True)
    root_freqs = out.root_freqs.cpu().numpy().astype(np.float64)

    n_sites = sites if sites is not None else data.n_sites
    rng = np.random.default_rng(seed)
    prefix = output or f"{alignment}.simulated"
    files = []
    for k in range(replicates):
        states = simulate_states(data.tree, p, root_freqs, n_sites, rng)
        names, seqs = states_to_alignment(
            states, data.tree, "codon", data.genetic_code
        )
        path = f"{prefix}.{k + 1}.fasta" if replicates > 1 else f"{prefix}.fasta"
        with open(path, "w") as fh:
            for nm, sq in zip(names, seqs):
                fh.write(f">{nm}\n{sq}\n")
        files.append(path)
    common.progress(
        "simulate", f"{replicates} replicate(s) x {n_sites} codons -> {prefix}*"
    )

    json = analysis_json(
        info="Simulate codon alignments from the maximum-likelihood fit of "
             "an MG94xREV model to the input data (SimulateDataSet)",
        version="0.1",
        data=data,
        fits={
            "Nucleotide GTR": model_fit_entry(
                gtr.loglik, gtr.n_parameters, data.sample_size,
                frequencies=gtr.frequencies, display_order=0,
            ),
            "Global MG94xREV": model_fit_entry(
                mg.loglik, mg.n_parameters, data.sample_size,
                frequencies=mg.codon_freqs, display_order=1,
            ),
        },
        extra={
            "settings": {
                "replicates": replicates, "sites": n_sites, "seed": seed,
                "omega override": omega,
                "omegas": np.asarray(mg.omegas).tolist(),
            },
            "files": files,
        },
    )
    return SimulateResult(json=json, files=files)
