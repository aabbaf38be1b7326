"""clade_support — Effective Clade Breadth (ECB) for a BUSTED-PH result.

A numpy copy of ``hyphy_tpu/methods/clade_support.py`` (the port imports nothing of
the JAX package).

Reference: ``res/TemplateBatchFiles/SelectionAnalyses/clade_support.bf``.
Quantifies how many independent phenotypic origins contribute to the
selection signal: for each maximal foreground clade, the average expected
number of positively-selected (branch, site) events per branch (from the
empirical-Bayes class posteriors BUSTED-PH stores under
"Posterior prob omega class by site"); the normalized clade weights feed
an information-theoretic perplexity ``exp(-sum w log w)`` — 1 means one
dominant lineage, higher values a signal replicated across independent
transitions.
"""

from __future__ import annotations

import dataclasses
import json as json_mod
from typing import Dict, Optional

import numpy as np

from hyphy_tpu_torch.methods import common
from hyphy_tpu_torch.tree.topology import Tree


@dataclasses.dataclass
class CladeSupportResult:
    json: Dict
    perplexity: Dict[str, float]        # per partition


def run(
    json_path: str,
    output_json: Optional[str] = None,
) -> CladeSupportResult:
    with open(json_path) as fh:
        j = json_mod.load(fh)
    has_sink = bool(j.get("analysis", {}).get("settings", {}).get("error-sink"))
    rates = common.rate_distribution(
        j["fits"]["Unconstrained model"]["Rate Distributions"]["Test"]
    )
    # positive classes: omega > 1, excluding the error-sink class 0
    # (clade_support.bf:40-49)
    positive = np.array([
        1.0 if (omega > 1.0 and not (has_sink and i == 0)) else 0.0
        for i, (omega, _w) in enumerate(rates)
    ])

    results: Dict = {}
    perplexities: Dict[str, float] = {}
    for part, info in j.get("branch attributes", {}).items():
        if part == "attributes":
            continue
        tree = Tree.from_newick(j["input"]["trees"][part])
        names = tree.names
        n_leaves = tree.n_leaves

        branch_post: Dict[str, float] = {}
        for b, binfo in info.items():
            bp = binfo.get("Posterior prob omega class by site")
            if bp is not None:
                branch_post[b] = float(positive @ np.asarray(bp).sum(axis=1))

        # maximal foreground clades: a foreground (posterior-bearing)
        # branch whose parent branch is not foreground roots a clade
        # (clade_support.bf:84-110)
        name_to_id = {names[i]: i for i in range(tree.n_nodes)}
        clades: Dict[str, float] = {}
        clade_stats: Dict[str, Dict] = {}
        for b in branch_post:
            node = name_to_id[b]
            par = int(tree.parent[node])
            par_fg = par >= 0 and par != tree.n_nodes - 1 and (
                names[par] in branch_post
            )
            if par_fg:
                continue
            # accumulate over the subtree rooted at this branch, mirroring
            # the reference's arithmetic EXACTLY (clade_support.bf:110-127),
            # quirks included — verified against the reference binary's
            # JSON on CD2 (tests/data/ref_goldens/CD2.CLADESUP.json):
            #   * the clade ROOT's posterior is counted TWICE (once before
            #     the subtree loop at :113, once when the subtree
            #     iteration visits the root itself);
            #   * "branches" counts the subtree INCLUDING the root;
            #   * "tips" counts subtree members at depth 1 — the root's
            #     DIRECT children, not the clade's actual tip count
            #     (CD2's clades are shallow enough that they coincide).
            total = 2.0 * branch_post.get(b, 0.0)
            if node < n_leaves:
                n_branches, n_tips = 1, 1
            else:
                n_branches, n_tips = 1, len(tree.children[node])
                stack = list(tree.children[node])
                while stack:
                    x = stack.pop()
                    n_branches += 1
                    total += branch_post.get(names[x], 0.0)
                    stack.extend(tree.children[x])
            clades[b] = total / max(n_branches, 1)
            clade_stats[b] = {"branches": n_branches, "tips": n_tips}

        total_w = sum(clades.values()) or 1.0
        weights = {c: v / total_w for c, v in clades.items()}
        entropy = sum(
            w * np.log(w) for w in weights.values() if w > 0
        )
        perplexity = float(np.exp(-entropy))
        results[part] = {
            "expected_sites": clades,
            "clade_stats": clade_stats,
            "weights": weights,
            "perplexity": perplexity,
            "branch_support": branch_post,
        }
        perplexities[part] = perplexity
        common.progress(
            "clade-support",
            f"partition {part}: {len(clades)} foreground clades, "
            f"ECB (perplexity) = {perplexity:.4f}",
        )

    if output_json:
        with open(output_json, "w") as fh:
            json_mod.dump(results, fh, indent=1)
    return CladeSupportResult(json=results, perplexity=perplexities)
