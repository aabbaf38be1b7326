"""error-filter — mask alignment segments flagged by the BUSTED error-sink
class (the "BUSTED-E" workflow).

A numpy copy of ``hyphy_tpu/methods/error_filter.py`` (the port imports nothing of
the JAX package).

Reference: ``res/TemplateBatchFiles/SelectionAnalyses/error-filter.bf``.
Consumes the JSON written by ``busted.run(..., error_sink=True)`` (which
carries, per tested branch, the per-site posterior probability of each
omega class — the error sink is class 0 — plus the joint-ancestral
substitution map), and masks codon sites whose empirical Bayes factors
say "this is probably alignment error":

  * per (branch, site): ``BF = p_sink / (1 - p_sink) / prior_odds`` with
    ``prior_odds = w_sink / (1 - w_sink)`` and
    ``BF2 = p_sink / p_fastest / min(1e25, w_sink / w_fastest)``
    (``error-filter.bf:95-105,171-180``);
  * a site x branch combination is masked when ``BF >= threshold`` AND
    ``BF2 >= ratio`` (defaults 100 / 20);
  * a flagged terminal branch masks that sequence's codon; a flagged
    internal branch masks the smaller leaf-side of its split, and if that
    side covers >= ``site_threshold`` (default 40%) of all sequences the
    whole column is masked (``error-filter.bf:196-225``).

Output: a masked FASTA (+ the tree when single-partition) and a JSON
report of masked sites per sequence.
"""

from __future__ import annotations

import dataclasses
import json as json_mod
from typing import Dict, Optional

from hyphy_tpu_torch.methods import common
from hyphy_tpu_torch.tree.topology import Tree


@dataclasses.dataclass
class ErrorFilterResult:
    json: Dict
    masked_sites: Dict[str, list]     # sequence name -> masked site indices
    sequences: Dict[str, str]         # masked sequences (codon strings)
    total_masked: int


def run(
    json_path: str,
    output: Optional[str] = None,
    output_json: Optional[str] = None,
    threshold: float = 100.0,
    ratio: float = 20.0,
    site_threshold: float = 0.4,
) -> ErrorFilterResult:
    with open(json_path) as fh:
        j = json_mod.load(fh)
    settings = j.get("analysis", {}).get("settings", {})
    if not settings.get("error-sink"):
        raise ValueError("no error-sink data in the JSON (run BUSTED with "
                         "error_sink=True first)")
    dist = common.rate_distribution(
        j["fits"]["Unconstrained model"]["Rate Distributions"]["Test"]
    )
    w_sink = float(dist[0][1])
    w_fast = float(dist[-1][1])
    # w_sink == 0: the fit put NO mass on the error class, so every
    # by-site sink posterior is exactly 0 and nothing can be masked (the
    # reference's BF arithmetic degenerates to 0/0 -> never passes the
    # threshold; verified against the binary on CD2, which masks nothing)
    prior_odds = 1e100 if w_sink == 0 else w_sink / (1.0 - w_sink)
    prior_ratio = min(1e25, w_sink / max(w_fast, 1e-100))
    prior_ratio = max(prior_ratio, 1e-100)

    n_seq = j["input"]["number of sequences"]
    out_json = {
        "analysis": {
            "info": "The error filter analysis reads a BUSTED-E JSON result "
                    "file, identifies sites which may be due to alignment or "
                    "other error, and masks them.",
            "version": "0.1",
        },
        "settings": {
            "Empirical Bayes Factor": threshold,
            "BF ratio": ratio,
            "site threshold": site_threshold,
        },
        "input": j["input"],
    }

    sequences: Dict[str, list] = {}
    masked_sites: Dict[str, list] = {}
    site_offset = 0
    tree = None
    n_parts = j["input"].get("partition count", 1)
    for p in range(n_parts):
        pk = str(p)
        branch_data = j["branch attributes"][pk]
        subs = j["substitutions"][pk]
        tree = Tree.from_newick(j["input"]["trees"][pk])
        n_sites_p = len(subs)
        names = tree.names
        n_leaves = tree.n_leaves
        leaves = set(names[:n_leaves])
        if p == 0:
            for s in leaves:
                sequences[s] = []
                masked_sites[s] = []

        # smaller leaf-side of each internal branch's split
        leaf_desc = {}
        for node in range(n_leaves, tree.n_nodes - 1):
            stack, acc = [node], set()
            while stack:
                x = stack.pop()
                for c in tree.children[x]:
                    if c < n_leaves:
                        acc.add(names[c])
                    else:
                        stack.append(c)
            if 2 * len(acc) > n_leaves:
                acc = leaves - acc
            leaf_desc[names[node]] = acc

        # preorder over nodes (parents before children)
        preorder = _preorder(tree)

        for site in range(n_sites_p):
            entry = subs[str(site)]
            states = {}
            masked = set()
            write_out = {}
            mask_all = False
            for node in preorder:
                nm = names[node]
                if node == tree.n_nodes - 1:
                    states[nm] = entry.get("root", "---")
                else:
                    pnm = names[tree.parent[node]]
                    states[nm] = entry.get(nm, states[pnm])
                bd = branch_data.get(nm)
                # background branches carry no by-site posteriors (the
                # reference's BUSTED-E json stores them only for the
                # tested set; error-filter.bf:165 indexes them directly)
                if bd is not None and "Posterior prob omega class by site" \
                        not in bd:
                    bd = None
                if bd is not None and nm not in masked:
                    post = bd["Posterior prob omega class by site"]
                    p_sink = float(post[0][site])
                    p_fast = float(post[-1][site])
                    bf = (p_sink / (1 - p_sink) / prior_odds
                          if p_sink < 1 else 1e25)
                    # reference: BF2 computed only while p_fast < 1, else
                    # saturates (error-filter.bf:176-180); p_fast == 1
                    # implies p_sink == 0 so BF fails the threshold anyway
                    bf2 = (p_sink / max(p_fast, 1e-300) / prior_ratio
                           if p_fast < 1 else 1e25)
                    if bf >= threshold and bf2 >= ratio:
                        if nm in leaves:
                            masked_sites[nm].append(site + site_offset)
                            write_out[nm] = "---"
                            masked.add(nm)
                        else:
                            side = leaf_desc.get(nm, set())
                            if len(side) / max(len(leaves), 1) >= site_threshold:
                                for ntm in leaves:
                                    write_out[ntm] = "---"
                                    if ntm not in masked:
                                        masked_sites[ntm].append(site + site_offset)
                                mask_all = True
                                break
                            for ntm in side:
                                write_out[ntm] = "---"
                                if ntm not in masked:
                                    masked_sites[ntm].append(site + site_offset)
                                masked.add(ntm)
                if nm in leaves and nm not in masked and not mask_all:
                    write_out[nm] = states[nm]
            for s in leaves:
                sequences[s].append(write_out.get(s, "---"))
        site_offset += n_sites_p

    seq_strings = {s: "".join(v) for s, v in sequences.items()}
    total = sum(len(v) for v in masked_sites.values())
    out_json["filter"] = masked_sites

    if output:
        with open(output, "w") as fh:
            for s in tree.names[: tree.n_leaves]:
                fh.write(f">{s}\n{seq_strings[s]}\n")
            if n_parts == 1:
                fh.write("\n" + tree.newick_string + "\n")
    if output_json:
        with open(output_json, "w") as fh:
            json_mod.dump(out_json, fh, indent=1)
    common.progress(
        "error-filter",
        f"masked {total} site x sequence cells "
        f"({100.0 * total / max(n_seq * site_offset, 1):.3f}%)",
    )
    return ErrorFilterResult(
        json=out_json, masked_sites=masked_sites,
        sequences=seq_strings, total_masked=total,
    )


def _preorder(tree: Tree):
    order = []
    stack = [tree.n_nodes - 1]
    while stack:
        n = stack.pop()
        order.append(n)
        stack.extend(reversed(tree.children[n]))
    return order
