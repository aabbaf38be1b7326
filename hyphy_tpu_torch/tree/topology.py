"""Tree topology: flattened arrays and the level schedule for batched
pruning.

Replaces the reference's ``_TheTree`` flat representation
(``flatLeaves/flatNodes/flatParents``, ``src/core/tree.h:336``) with a
TPU-friendly *level schedule*: internal nodes are grouped into levels such
that every child of a level-L node lives in a level < L.  Pruning is then a
``lax.scan`` over levels of batched gathers + matmuls — the reference's
post-order branch loop (``tree_evaluator.cpp:3556``) without sequential
per-branch dependencies inside a level.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from hyphy_tpu_torch.tree.newick import ParseNode, parse_newick


@dataclasses.dataclass
class Tree:
    """A rooted (possibly multifurcating) phylogenetic tree.

    Node ids: leaves ``0..n_leaves-1`` (ordered to match the data filter's
    taxa), internal nodes in post-order after that; the root is the last id.
    Every non-root node owns the branch to its parent, so "branch b" ==
    "node b" throughout the engine.
    """

    names: List[str]                 # per node id
    parent: np.ndarray               # [n_nodes] int32, root = -1
    children: List[List[int]]        # per node id
    n_leaves: int
    input_lengths: np.ndarray        # [n_nodes] f64, NaN if absent
    labels: List[Optional[str]]      # {annotation} per node
    newick_string: str = ""

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_newick(text: str, leaf_order: Optional[Sequence[str]] = None) -> "Tree":
        root = parse_newick(text)
        return Tree.from_parse(root, leaf_order, newick=text)

    @staticmethod
    def from_parse(
        root: ParseNode, leaf_order: Optional[Sequence[str]] = None, newick: str = ""
    ) -> "Tree":
        leaves: List[ParseNode] = []
        internals: List[ParseNode] = []

        def post(nd: ParseNode):
            for c in nd.children:
                post(c)
            (leaves if nd.is_leaf else internals).append(nd)

        post(root)

        if leaf_order is not None:
            by_name = {lf.name: lf for lf in leaves}
            missing = [nm for nm in leaf_order if nm not in by_name]
            if missing:
                # retry against HyPhy-normalized tip names (non-alphanumeric
                # -> '_', the same mapping applied to sequence names;
                # reference: alignments.bf name normalization)
                import re as _re

                for lf in leaves:
                    norm = _re.sub(r"[^a-zA-Z0-9]", "_", lf.name)
                    if norm not in by_name:
                        by_name[norm] = lf
                        lf.name = norm
                missing = [nm for nm in leaf_order if nm not in by_name]
            if missing:
                raise ValueError(f"tree is missing taxa: {missing[:5]}")
            extra = {lf.name for lf in leaves} - set(leaf_order)
            if extra:
                raise ValueError(f"tree has extra taxa: {sorted(extra)[:5]}")
            leaves = [by_name[nm] for nm in leaf_order]

        ordered = leaves + internals
        ids = {id(nd): i for i, nd in enumerate(ordered)}
        n = len(ordered)
        parent = np.full(n, -1, dtype=np.int32)
        children: List[List[int]] = [[] for _ in range(n)]
        for nd in ordered:
            me = ids[id(nd)]
            if nd.parent is not None:
                parent[me] = ids[id(nd.parent)]
            # preserve the input child order (matters for newick round-trip
            # and reference-matching output ordering)
            children[me] = [ids[id(c)] for c in nd.children]
        return Tree(
            names=[nd.name for nd in ordered],
            parent=parent,
            children=children,
            n_leaves=len(leaves),
            input_lengths=np.array(
                [nd.length if nd.length is not None else np.nan for nd in ordered]
            ),
            labels=[nd.label for nd in ordered],
            newick_string=newick,
        )

    # -- basic properties ---------------------------------------------------

    @property
    def n_nodes(self) -> int:
        return len(self.names)

    @property
    def n_internal(self) -> int:
        return self.n_nodes - self.n_leaves

    @property
    def root(self) -> int:
        return self.n_nodes - 1

    @property
    def n_branches(self) -> int:
        """Every node but the root owns a branch."""
        return self.n_nodes - 1

    def is_leaf(self, node: int) -> bool:
        return node < self.n_leaves

    def branch_names(self) -> List[str]:
        return self.names[: self.n_branches]

    # -- level schedule -----------------------------------------------------

    def levels(self) -> List[np.ndarray]:
        """Internal-node ids grouped by height above the leaves."""
        height = np.zeros(self.n_nodes, dtype=np.int64)
        for node in range(self.n_leaves, self.n_nodes):  # post-order
            height[node] = 1 + max(height[c] for c in self.children[node])
        out = []
        for h in range(1, int(height.max()) + 1):
            ids = np.nonzero(height == h)[0]
            ids = ids[ids >= self.n_leaves]
            if len(ids):
                out.append(ids.astype(np.int32))
        return out

    # -- branch selections (reference: trees.bf branch-set machinery) -------

    def select_branches(self, which: str) -> np.ndarray:
        """Branch-id mask for 'All' / 'Internal' / 'Leaves' / a {label} /
        a comma-separated branch-name list / a regular expression over
        branch names (reference: ``libv3/tasks/trees.bf`` selectors —
        named sets, and regex matching via ``regexp.find``)."""
        import re as _re

        n = self.n_branches
        mask = np.zeros(n, dtype=bool)
        key = which.strip().lower()
        if key == "all":
            mask[:] = True
        elif key == "internal":
            mask[self.n_leaves :] = True
        elif key == "leaves":
            mask[: self.n_leaves] = True
        elif key in ("unlabeled", "unlabeled branches"):
            # branches with no {label} annotation — a selectable set in the
            # reference's branch-selection menus (e.g. BUSTED-PH.bf:331)
            for b in range(n):
                if self.labels[b] is None:
                    mask[b] = True
        else:
            for b in range(n):
                lbl = self.labels[b]
                if lbl is not None and lbl.lower() == key:
                    mask[b] = True
            if not mask.any():
                # explicit branch-name list: "name1,name2,..."
                wanted = {w.strip().lower() for w in which.split(",") if w.strip()}
                name_of = {self.names[b].lower(): b for b in range(n)}
                if wanted and wanted <= set(name_of):
                    for w in wanted:
                        mask[name_of[w]] = True
            if not mask.any():
                # regex over branch names (case-insensitive, search
                # semantics like the reference's regexp selectors)
                try:
                    pat = _re.compile(which, _re.IGNORECASE)
                except _re.error:
                    pat = None
                if pat is not None:
                    for b in range(n):
                        if pat.search(self.names[b]):
                            mask[b] = True
            if not mask.any():
                raise ValueError(f"no branches labeled {which!r}")
        return mask

    def label_set(self) -> List[str]:
        seen = []
        for lbl in self.labels:
            if lbl and lbl not in seen:
                seen.append(lbl)
        return seen

    # -- topology edits -----------------------------------------------------

    def collapse_internal_branches(self, branch_ids: Sequence[int]) -> "Tree":
        """New tree with the given INTERNAL branches removed: each dropped
        node's children reattach to its (nearest surviving) parent —
        polytomies form where branches vanish.

        Reference: ``trees.KillZeroBranches`` (``libv3/tasks/trees.bf:499``)
        / the Topology ``T - branches`` delete operator — applied by
        ``shared-load-file.bf:515`` to internal branches whose GTR length
        is < 1e-10 before the codon stages.
        """
        drop = {int(b) for b in branch_ids}
        for b in drop:
            if b < self.n_leaves or b >= self.n_branches:
                raise ValueError(f"branch {b} is not an internal branch")
        if not drop:
            return self
        keep = [n for n in range(self.n_nodes) if n not in drop]
        new_id = {old: i for i, old in enumerate(keep)}

        def live_parent(n: int) -> int:
            p = int(self.parent[n])
            while p in drop:
                p = int(self.parent[p])
            return p

        n_new = len(keep)
        parent = np.full(n_new, -1, dtype=np.int32)
        children: List[List[int]] = [[] for _ in range(n_new)]
        # preserve child order: walk each surviving internal node's children
        # expanding dropped children in place
        for old in keep:
            if old < self.n_leaves:
                continue

            def expand(c: int) -> List[int]:
                if c in drop:
                    out: List[int] = []
                    for cc in self.children[c]:
                        out.extend(expand(cc))
                    return out
                return [c]

            kids: List[int] = []
            for c in self.children[old]:
                kids.extend(expand(c))
            me = new_id[old]
            children[me] = [new_id[c] for c in kids]
            for c in kids:
                parent[new_id[c]] = me
        return Tree(
            names=[self.names[n] for n in keep],
            parent=parent,
            children=children,
            n_leaves=self.n_leaves,
            input_lengths=np.array([self.input_lengths[n] for n in keep]),
            labels=[self.labels[n] for n in keep],
            newick_string="",
        )

    # -- export -------------------------------------------------------------

    def to_newick(self, lengths: Optional[np.ndarray] = None, digits: int = 10) -> str:
        def fmt(node: int) -> str:
            if self.is_leaf(node):
                base = self.names[node]
            else:
                base = (
                    "(" + ",".join(fmt(c) for c in self.children[node]) + ")"
                    + self.names[node]
                )
            if lengths is not None and node != self.root:
                base += f":{lengths[node]:.{digits}g}"
            return base

        return fmt(self.root)


@dataclasses.dataclass
class LevelSchedule:
    """Padded per-level arrays driving the pruning scan.

    Padding uses a scratch node id ``n_nodes`` whose CLV row is all-ones and
    whose transition matrix is the identity, so padded entries contribute a
    multiplicative 1 — no masking needed in the inner loop.
    """

    node_ids: np.ndarray            # [depth, max_nodes]     int32 (pad: scratch)
    child_ids: np.ndarray           # [depth, max_nodes, arity] int32 (pad: scratch)
    n_nodes: int
    n_leaves: int
    depth: int
    arity: int

    @staticmethod
    def build(tree: Tree, min_depth: int = 0, min_width: int = 0) -> "LevelSchedule":
        """``min_depth``/``min_width`` pad the schedule to at least those
        shapes (all-scratch levels/slots contribute multiplicative 1) so
        different topologies over the same taxa share one compiled shape
        (shape bucketing for GARD's per-candidate NJ trees)."""
        levels = tree.levels()
        depth = max(len(levels), min_depth)
        max_nodes = max(max(len(lv) for lv in levels), min_width)
        arity = max(len(tree.children[nd]) for nd in range(tree.n_leaves, tree.n_nodes))
        scratch = tree.n_nodes
        # padded node slots scatter into per-slot scratch rows (unique
        # indices within each level's scatter); padded children gather the
        # shared all-ones row `scratch` with an identity P
        node_ids = np.tile(
            scratch + 1 + np.arange(max_nodes, dtype=np.int32), (depth, 1)
        )
        child_ids = np.full((depth, max_nodes, arity), scratch, dtype=np.int32)
        for d, lv in enumerate(levels):
            node_ids[d, : len(lv)] = lv
            for slot, nd in enumerate(lv):
                for k, c in enumerate(tree.children[nd]):
                    child_ids[d, slot, k] = c
        return LevelSchedule(
            node_ids=node_ids,
            child_ids=child_ids,
            n_nodes=tree.n_nodes,
            n_leaves=tree.n_leaves,
            depth=depth,
            arity=arity,
        )


def infer_nj_tree(distance: np.ndarray, names: List[str]) -> Tree:
    """Neighbor-joining tree from a distance matrix, mirroring the
    reference engine's implementation (``_Matrix::NeighborJoin``,
    matrix.cpp:8944) including its pair-scan order and slot reuse:
    the merged cluster takes the SMALLER member's slot and candidate
    pairs are scanned (c1 ascending, c2 < c1) with a strict minimum —
    on near-symmetric distance matrices (many exact Q ties) a different
    tie-break yields a measurably worse topology (GARD's HRVI baseline
    differs by ~15 lnL between conventions)."""
    n = len(names)
    if n < 2:
        raise ValueError("need >= 2 taxa")
    nodes: List[ParseNode] = []
    for nm in names:
        nd = ParseNode()
        nd.name = nm
        nodes.append(nd)
    D0 = distance.astype(np.float64)
    if n == 2:
        root = ParseNode()
        nodes[0].length = nodes[1].length = max(D0[0, 1] / 2, 0.0)
        nodes[0].parent = nodes[1].parent = root
        root.children = [nodes[0], nodes[1]]
    elif n == 3:
        # trees.bf:1377-1386 three-taxon formulas
        root = ParseNode()
        d01, d02, d12 = D0[0, 1], D0[0, 2], D0[1, 2]
        for nd, L in zip(nodes, ((d01 + d02 - d12) / 2,
                                 (d01 - d02 + d12) / 2,
                                 (d12 + d02 - d01) / 2)):
            nd.length = max(L, 0.0)
            nd.parent = root
        root.children = list(nodes)
    else:
        theData = D0.copy()
        net = np.zeros(n)
        for kk in range(n):
            for j in range(kk):
                net[kk] += theData[j, kk]
                net[j] += theData[j, kk]
        use_col = list(range(n))             # active slots, ascending
        node_of = {s: nodes[s] for s in range(n)}
        clades_made = 1
        while clades_made < n:
            k = n - 1 - clades_made
            if clades_made == n - 1:
                # final cluster attaches INTO the last internal node with
                # the full remaining distance (unrooted trifurcation);
                # matrix.cpp:8993-9001 picks the non-internal side to dangle
                top, dangling = node_of[use_col[0]], node_of[use_col[1]]
                if top.is_leaf:
                    top, dangling = dangling, top
                dangling.length = max(theData[use_col[0], use_col[1]], 0.0)
                dangling.parent = top
                top.children.append(dangling)
                root = top
                break
            rec = 1.0 / k
            best = np.inf
            mi = mj = -1
            for i in range(1, len(use_col)):
                c1 = use_col[i]
                for j in range(i):
                    c2 = use_col[j]
                    q = theData[c2, c1] - (net[c1] + net[c2]) * rec
                    if q < best:
                        best, mi, mj = q, c2, c1
            dij = theData[mi, mj]
            d = (dij - (net[mj] - net[mi]) * rec) * 0.5
            d2 = dij - d
            # negative-length clamping (matrix.cpp:9049-9060)
            if d < 0:
                d, d2 = 0.0, dij
            if d2 < 0:
                d2, d = 0.0, max(dij, 0.0)
            parent = ParseNode()
            na, nb = node_of[mi], node_of[mj]
            na.length = d
            nb.length = d2
            na.parent = nb.parent = parent
            parent.children = [na, nb]
            net[mi] = 0.0
            net[mj] = 0.0
            use_col.remove(mj)
            for k2 in use_col:
                if k2 == mi:
                    continue
                a = theData[min(k2, mi), max(k2, mi)]
                b = theData[min(k2, mj), max(k2, mj)]
                t = (a + b - dij) * 0.5
                net[k2] += t - (a + b)
                theData[min(k2, mi), max(k2, mi)] = t
                net[mi] += t
            node_of[mi] = parent             # merged cluster reuses slot mi
            clades_made += 1
    # name internal nodes
    counter = [0]

    def name_internals(nd: ParseNode):
        if not nd.is_leaf and not nd.name:
            nd.name = f"Node{counter[0]}"
            counter[0] += 1
        for c in nd.children:
            name_internals(c)

    name_internals(root)
    return Tree.from_parse(root)
