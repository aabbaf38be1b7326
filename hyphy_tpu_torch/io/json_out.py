"""HyPhy-schema JSON result construction.

A copy of the numpy-only ``hyphy_tpu/io/json_out.py`` (the port imports
nothing of the JAX package).

The key vocabulary mirrors ``libv3/all-terms.bf`` (``terms.json``
namespace) so goldens and downstream consumers (e.g. hyphy-vision)
compare directly: top-level ``analysis/input/fits/MLE/test results/
branch attributes/data partitions/timers``; per-model ``Log Likelihood /
AIC-c / estimated parameters / Equilibrium frequencies /
Rate Distributions / display order``.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

import numpy as np


def aic_c(loglik: float, n_params: int, sample_size: int) -> float:
    """AIC-c = 2p - 2lnL + 2p(p+1)/(n-p-1) (reference: math.GetIC)."""
    p, n = n_params, sample_size
    return 2.0 * p - 2.0 * loglik + 2.0 * p * (p + 1) / max(n - p - 1, 1)


def model_fit_entry(
    loglik: float,
    n_params: int,
    sample_size: int,
    frequencies: Optional[np.ndarray] = None,
    rate_distributions: Optional[Dict] = None,
    display_order: int = 0,
) -> Dict:
    entry = {
        "Log Likelihood": float(loglik),
        "estimated parameters": int(n_params),
        "AIC-c": aic_c(loglik, n_params, sample_size),
        "display order": display_order,
    }
    if frequencies is not None:
        entry["Equilibrium frequencies"] = [
            [float(x)] for x in np.asarray(frequencies).ravel()
        ]
    if rate_distributions is not None:
        entry["Rate Distributions"] = rate_distributions
    return entry


def analysis_json(
    info: str,
    version: str,
    data,                      # common.LoadedData
    fits: Dict,
    extra: Optional[Dict] = None,
    tested_map: Optional[Dict] = None,
) -> Dict:
    """Assemble the shared scaffold (selection.io json_store machinery)."""
    tree = data.tree
    branch_names = tree.branch_names()
    if tested_map is None:
        tested_map = {
            "0": {
                branch_names[b]: ("test" if data.tested_branches[b] else "background")
                for b in range(tree.n_branches)
            }
        }
    out = {
        "analysis": {
            "info": info,
            "version": version,
            "citation": "hyphy_tpu_torch (PyTorch/CUDA reimplementation of HyPhy analyses)",
        },
        "input": {
            "file name": data.alignment.file_name or "",
            "number of sequences": data.n_sequences,
            "number of sites": data.n_sites,
            "partition count": 1,
            "trees": {"0": tree.newick_string},
        },
        "fits": fits,
        "data partitions": {
            "0": {
                "name": "default",
                "coverage": [list(range(data.n_sites))],
            }
        },
        "tested": tested_map,
        "timers": {"Total time": {"timer": int(time.time()), "order": 0}},
    }
    if extra:
        out.update(extra)
    return out


def analysis_json_parts(
    info: str,
    version: str,
    md,                        # common.MultiLoadedData
    fits: Dict,
    extra: Optional[Dict] = None,
) -> Dict:
    """Multi-partition scaffold: one tested map / tree / coverage block
    per partition (reference: selection.io json machinery keyed by
    partition index)."""
    tested_map = {}
    trees = {}
    partitions = {}
    offset = 0
    for i, part in enumerate(md.parts):
        tree = part.tree
        names = tree.branch_names()
        tested_map[str(i)] = {
            names[b]: ("test" if part.tested_branches[b] else "background")
            for b in range(tree.n_branches)
        }
        trees[str(i)] = tree.newick_string
        partitions[str(i)] = {
            "name": md.partition_names[i],
            "coverage": [list(range(offset, offset + part.n_sites))],
        }
        offset += part.n_sites
    out = {
        "analysis": {
            "info": info,
            "version": version,
            "citation": "hyphy_tpu_torch (PyTorch/CUDA reimplementation of HyPhy analyses)",
        },
        "input": {
            "file name": md.alignment.file_name or "",
            "number of sequences": md.n_sequences,
            "number of sites": md.n_sites,
            "partition count": md.n_partitions,
            "trees": trees,
        },
        "fits": fits,
        "data partitions": partitions,
        "tested": tested_map,
        "timers": {"Total time": {"timer": int(time.time()), "order": 0}},
    }
    if extra:
        out.update(extra)
    return out


def write_json(obj: Dict, path: str):
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1, sort_keys=True, default=_np_default)


def _np_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")
