"""The likelihood function: partitions of (filter, tree, model).

Counterpart of ``hyphy_tpu/likelihood.py`` (the reference's
``_LikelihoodFunction``, ``src/core/likefunc.h:159``) on one device:
``loglik(params)`` evaluates every partition eagerly — model build, then
level-by-level pruning through the K1 kernel (a model's site-level rate
classes folded into K1's node axis and mixed in fp64), then the
pattern-weighted reduction in fp64 — and ``fit`` maximizes it with the
host L-BFGS-B driver over autograd gradients.  ``pattern_bucket``, ``schedule_pad``,
``covariance_matrix`` and ``profile_ci`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hyphy_tpu_torch.config import resolve_device, settings
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.models.base import ModelOutput, SubstitutionModel
from hyphy_tpu_torch.models.parameters import (
    Params,
    Specs,
    count_parameters,
    initial_params,
)
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.tree.topology import Tree


@dataclasses.dataclass
class Partition:
    filter: DataFilter
    tree: Tree
    model: SubstitutionModel
    name: str = ""

    def __post_init__(self):
        if set(self.filter.names) != set(self.tree.names[: self.tree.n_leaves]):
            raise ValueError("filter taxa and tree taxa differ")


class LikelihoodFunction:
    """Partitions + shared parameter index + compute on one device.

    Parameter naming: global (scalar) model parameters are shared across
    partitions when their names coincide; per-branch parameters (shape !=
    ()) get a per-partition prefix ``pK:``.
    """

    def __init__(self, partitions: Sequence[Partition], dtype=None, device=None):
        """``dtype``: compute dtype of the likelihood path — defaults to
        ``settings.likelihood_dtype(device)`` (fp64 on the CPU, fp32 on the
        card).  The pattern-weighted reduction always accumulates in fp64.
        ``device``: defaults to ``settings.device``; raises without CUDA
        unless the CPU is asked for."""
        self.device = resolve_device(device)
        if dtype is None:
            self.dtype = settings.likelihood_dtype(self.device)
        else:
            self.dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        self.partitions = list(partitions)
        for p in self.partitions:
            if p.model.device != self.device:
                raise ValueError(
                    f"model on {p.model.device}, likelihood function on {self.device}"
                )
        self._pruning_data = [
            pruning.build_pruning_data(p.tree, self.device) for p in self.partitions
        ]
        self._leaf_partials = []
        self._weights = []
        for p in self.partitions:
            lp = p.filter.leaf_partials()
            # align filter rows to the TREE's leaf order (the CLVs are
            # indexed by tree leaf ids) — reference MapTreeTipsToData
            tree_leaves = list(p.tree.names[: p.tree.n_leaves])
            if list(p.filter.names) != tree_leaves:
                order = [p.filter.names.index(nm) for nm in tree_leaves]
                lp = lp[np.asarray(order)]
            self._leaf_partials.append(
                torch.as_tensor(lp, device=self.device).to(self.dtype)
            )
            self._weights.append(torch.as_tensor(
                np.asarray(p.filter.pattern_weights, dtype=np.float64), device=self.device
            ))
        # parameter index: shared globals by name, locals prefixed
        self.specs: Specs = {}
        self._key_maps: List[Dict[str, str]] = []
        for i, part in enumerate(self.partitions):
            specs_i = part.model.parameter_specs(part.tree.n_branches)
            key_map = {}
            for name, spec in specs_i.items():
                key = name if len(self.partitions) == 1 or spec.is_shared() else f"p{i}:{name}"
                key_map[name] = key
                if key in self.specs and self.specs[key] != spec:
                    raise ValueError(f"conflicting specs for shared param {key}")
                self.specs[key] = spec
            self._key_maps.append(key_map)

    def partition_local_params(self, params: Params, i: int) -> Dict[str, torch.Tensor]:
        """Partition ``i``'s parameters under its local names (the inverse
        of the ``pK:`` prefixing)."""
        return {name: params[key] for name, key in self._key_maps[i].items()}

    def partition_key(self, i: int, name: str) -> str:
        """The joint-dict key of partition ``i``'s parameter ``name``."""
        return self._key_maps[i][name]

    # -- compute ------------------------------------------------------------

    def _partition_site_logliks(self, params: Params, i: int) -> torch.Tensor:
        part = self.partitions[i]
        local = {
            name: torch.as_tensor(params[key], device=self.device).to(self.dtype)
            for name, key in self._key_maps[i].items()
        }
        out: ModelOutput = part.model.build(local, part.tree.n_branches)
        if out.class_weights is None:
            return pruning.site_log_likelihoods(
                out.p_matrices, self._leaf_partials[i], out.root_freqs,
                self._pruning_data[i],
            )
        # site-level rate classes (the JAX package's
        # ``mixture_site_log_likelihoods``, one pruning per class): the
        # classes fold into K1's node axis through the grid form, one launch
        # per level for all of them, with the JAX package's ``finfo.tiny``
        # floor on each class's site likelihood (a class of likelihood 0
        # keeps a finite gradient); log sum_c w_c L_c in fp64
        per_class = pruning.site_log_likelihoods(
            out.p_matrices, self._leaf_partials[i], out.root_freqs,
            self._pruning_data[i], floor=True,
        )                                                    # [C, patterns]
        log_w = torch.log(torch.clamp_min(out.class_weights.to(torch.float64), 1e-300))
        return torch.logsumexp(per_class + log_w[:, None], dim=0)

    def site_log_likelihoods(self, params: Params) -> List[torch.Tensor]:
        """Per-pattern log-likelihood vectors, one per partition
        (reference: ``ConstructCategoryMatrix(SITE_LOG_LIKELIHOODS)``)."""
        return [
            self._partition_site_logliks(params, i) for i in range(len(self.partitions))
        ]

    def loglik(self, params: Params) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for i in range(len(self.partitions)):
            site = self._partition_site_logliks(params, i)
            # fp64 accumulation of the pattern-weighted reduction even when
            # the CLV path runs fp32 (reference: Neumaier-compensated sum,
            # likefunc.cpp:11059-11079)
            total = total + pruning.total_log_likelihood(
                site.to(torch.float64), self._weights[i]
            )
        return total

    # -- fitting ------------------------------------------------------------

    def fit(
        self,
        init: Optional[Params] = None,
        fixed: Optional[Dict[str, torch.Tensor]] = None,
        precision: Optional[float] = None,
        max_iterations: Optional[int] = None,
    ) -> "FitResult":
        """Maximize lnL over the free parameters (reference Optimize():
        here bounded L-BFGS-B on autograd gradients)."""
        from hyphy_tpu_torch.optimize.core import maximize

        def as_param(v):
            return torch.as_tensor(v, dtype=torch.float64, device=self.device)

        params = initial_params(self.specs, self.device)
        if init:
            params.update({k: as_param(v) for k, v in init.items() if k in params})
        fixed = {k: as_param(v) for k, v in (fixed or {}).items()}
        free_specs = {k: v for k, v in self.specs.items() if k not in fixed}
        free_init = {k: params[k] for k in free_specs}

        def objective(free: Params) -> torch.Tensor:
            return self.loglik({**free, **fixed})

        best, lnl, n_iter = maximize(
            objective,
            free_specs,
            free_init,
            precision=precision or settings.optimization_precision,
            max_iterations=max_iterations,
            device=self.device,
        )
        return FitResult(
            params={**best, **fixed},
            loglik=float(lnl),
            n_free_parameters=count_parameters(free_specs),
            n_iterations=int(n_iter),
            lf=self,
        )


@dataclasses.dataclass
class FitResult:
    params: Params
    loglik: float
    n_free_parameters: int
    n_iterations: int
    lf: Optional[LikelihoodFunction] = None
