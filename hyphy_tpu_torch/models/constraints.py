"""General parameter-constraint surface for likelihood fits.

Counterpart of ``hyphy_tpu/models/constraints.py``.  The reference exposes
two batch-language constraint machines, re-expressed here declaratively:

* ``ReplicateConstraint ("this1.?.synRate := this2.?.synRate * R", ...)``
  (``batchlan.cpp`` ``HY_HBL_COMMAND_REPLICATE_CONSTRAINT``): tie one
  parameter to another through a shared factor — :class:`Proportional`,
  where the target becomes ``ratio * source`` with ``ratio`` optionally a
  NEW free scalar.
* ``MolecularClock (tree, {"t"})`` (``HY_HBL_COMMAND_MOLECULAR_CLOCK``,
  ``TemplateBatchFiles/MolecularClock.bf``): every root-to-tip path of a
  rooted tree has the same length.  A reparameterisation: the free
  parameters are the root height and, for each internal node, its height as
  a stick-breaking fraction of its parent's (so ``t_b >= 0`` by
  construction); the branch parameter is ``t_b = h(parent) - h(node)``.

A constraint has two methods, which ``LikelihoodFunction.fit(constraints=
[...])`` applies in order:

* ``transform_specs(specs) -> specs``: drop the dependent keys, add any new
  free keys;
* ``apply(params) -> params``: rebuild the dependent parameters from the
  free ones (inside the objective, differentiably, and on the result).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hyphy_tpu_torch.models.parameters import ParamSpec, Params, Specs


class Proportional:
    """``target := ratio * source`` (ReplicateConstraint's most common
    template, e.g. ``this1.?.nonSynRate := R * this2.?.synRate``).

    ``ratio_key``: name of a new free scalar multiplier (bounds
    [lower, upper]); pass ``ratio=value`` instead to pin a fixed factor
    with no new free parameter.
    """

    def __init__(
        self,
        target: str,
        source: str,
        ratio_key: Optional[str] = None,
        ratio: Optional[float] = None,
        ratio_init: float = 1.0,
        lower: float = 0.0,
        upper: float = 10000.0,
    ):
        if (ratio_key is None) == (ratio is None):
            raise ValueError("exactly one of ratio_key / ratio is required")
        self.target = target
        self.source = source
        self.ratio_key = ratio_key
        self.ratio = ratio
        self.ratio_init = ratio_init
        self.lower = lower
        self.upper = upper

    def transform_specs(self, specs: Specs) -> Specs:
        if self.target not in specs:
            raise KeyError(f"constraint target {self.target!r} not in specs")
        if self.source not in specs:
            raise KeyError(f"constraint source {self.source!r} not in specs")
        out = {k: v for k, v in specs.items() if k != self.target}
        if self.ratio_key is not None:
            out[self.ratio_key] = ParamSpec(
                init=self.ratio_init, lower=self.lower, upper=self.upper
            )
        return out

    def apply(self, params: Params) -> Params:
        out = dict(params)
        source = out[self.source]
        factor = out[self.ratio_key] if self.ratio_key is not None else self.ratio
        out[self.target] = factor * source
        return out


class MolecularClock:
    """Equal root-to-tip path lengths for a branch-time parameter vector.

    ``tree``: the partition's :class:`~hyphy_tpu_torch.tree.topology.Tree`;
    ``target``: the per-branch parameter key (shape ``[n_branches]``,
    branch b = node b's edge to its parent).  Free parameters introduced:

    * ``{target}_clock_height``: the root height (total tree depth), in
      the same units as the branch parameter;
    * ``{target}_clock_frac`` [n_internal - 1]: each internal non-root
      node's height as a fraction of its parent's (bounds (0, 1)), in
      descending node-id order, as the JAX package orders them.

    The JAX package sets the heights one node at a time in a Python loop
    (``constraints.py:145-147``), one op per internal node: 998 sequential
    ops and their backward per evaluation at 1000 taxa.  Here the internal
    nodes are grouped by their depth below the root, and each depth's
    heights are one multiply of its fractions by its parents' heights (a
    parent lies one depth above its children): as many ops as the tree is
    deep, with the same products, so the heights equal the JAX package's.
    """

    def __init__(self, tree, target: str = "t",
                 height_init: float = 0.3, height_upper: float = 10000.0):
        self.tree = tree
        self.target = target
        self.height_init = height_init
        self.height_upper = height_upper
        n = tree.n_nodes
        self.n_branches = tree.n_branches
        self.n_leaves = tree.n_leaves
        self.root = tree.root
        internal = [nd for nd in range(n) if nd >= tree.n_leaves and nd != tree.root]
        # post-order ids: parents have larger ids
        self.internal_order = np.asarray(sorted(internal, key=lambda nd: -nd), dtype=np.int64)
        self.parent = np.asarray(tree.parent, dtype=np.int64)
        self.frac_key = f"{target}_clock_frac"
        self.height_key = f"{target}_clock_height"
        depth = np.zeros(n, dtype=np.int64)
        for nd in self.internal_order:          # parents before children
            depth[nd] = depth[self.parent[nd]] + 1
        d_int = depth[self.internal_order]
        # per depth: (nodes, their fractions' indices, their parents)
        self._levels = []
        for d in range(1, int(d_int.max()) + 1 if d_int.size else 1):
            idx = np.nonzero(d_int == d)[0]
            nodes = self.internal_order[idx]
            self._levels.append((nodes, idx, self.parent[nodes]))
        self._branch_parent = self.parent[: self.n_branches]
        self._on = {}                           # device -> the index tensors

    def _indices(self, device):
        """The depth groups' and the branches' index tensors on ``device``
        (made once per device: a host-to-device copy per evaluation would
        make every evaluation wait for the card)."""
        key = str(device)
        if key not in self._on:
            def dev(a):
                return torch.as_tensor(a, device=device)
            self._on[key] = (dev(np.asarray([self.root])),
                             [tuple(dev(a) for a in lv) for lv in self._levels],
                             dev(self._branch_parent))
        return self._on[key]

    def transform_specs(self, specs: Specs) -> Specs:
        if self.target not in specs:
            raise KeyError(f"clock target {self.target!r} not in specs")
        out = {k: v for k, v in specs.items() if k != self.target}
        out[self.height_key] = ParamSpec(
            init=self.height_init, lower=1e-8, upper=self.height_upper
        )
        out[self.frac_key] = ParamSpec(
            init=0.5, lower=1e-6, upper=1.0 - 1e-6,
            shape=(len(self.internal_order),),
        )
        return out

    def heights(self, h_root: torch.Tensor, fracs: torch.Tensor) -> torch.Tensor:
        """[n_nodes] node heights: the root at ``h_root``, the leaves at 0,
        each internal node at its fraction of its parent's height."""
        root, levels, _ = self._indices(fracs.device)
        heights = torch.zeros((self.parent.shape[0],), dtype=h_root.dtype, device=fracs.device)
        heights = heights.index_put((root,), h_root.reshape(1))
        for nodes, idx, parents in levels:
            heights = heights.index_put((nodes,), fracs[idx] * heights[parents])
        return heights

    def apply(self, params: Params) -> Params:
        out = dict(params)
        h_root = out[self.height_key]
        fracs = out[self.frac_key]
        heights = self.heights(h_root, fracs)
        device = heights.device
        t = heights[self._indices(device)[2]] - heights[: self.n_branches]
        # the auxiliary keys stay in the dict (loglik ignores unknown keys;
        # the fit result then reports the height and fraction MLEs beside t)
        out[self.target] = torch.maximum(t, torch.full((), 1e-12, dtype=t.dtype, device=device))
        return out
