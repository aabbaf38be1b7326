"""The likelihood function: partitions of (filter, tree, model).

Counterpart of ``hyphy_tpu/likelihood.py`` (the reference's
``_LikelihoodFunction``, ``src/core/likefunc.h:159``): ``loglik(params)``
evaluates every partition eagerly — model build, then level-by-level
pruning through the K1 kernel (a model's site-level rate classes folded
into K1's node axis and mixed in fp64), then the pattern-weighted
reduction in fp64 — with the pattern axis split over the device mesh when
there is one (``parallel/mesh.py``), and ``fit`` maximizes it with the
host L-BFGS-B optimizer over autograd gradients, under parameter constraints
(``models/constraints.py``) if asked; ``covariance_matrix`` (an autograd
Hessian) and ``profile_ci`` give the uncertainty of a fit.
``pattern_bucket`` and ``schedule_pad`` are not ported: they pad GARD's
candidates to shared shapes for XLA, and the port compiles nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

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
from hyphy_tpu_torch.parallel.mesh import resolve_mesh
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
    """Partitions + shared parameter index + compute on a device or a mesh.

    Parameter naming: global (scalar) model parameters are shared across
    partitions when their names coincide; per-branch parameters (shape !=
    ()) get a per-partition prefix ``pK:``.
    """

    def __init__(self, partitions: Sequence[Partition], dtype=None, device=None,
                 mesh="auto"):
        """``dtype``: compute dtype of the likelihood path — defaults to
        ``settings.likelihood_dtype(device)`` (fp64 on the CPU, fp32 on the
        card).  The pattern-weighted reduction always accumulates in fp64.
        ``device``: defaults to ``settings.device``; raises without CUDA
        unless the CPU is asked for.

        ``mesh``: devices over which every partition's leaf CLVs are split
        on the pattern axis, in contiguous blocks (the gene-level analogue
        of the reference's MPI site-template mode, ``likefunc.h:109``).
        The models and the parameters live on ``device``, the mesh's first
        device; the propagators are copied to each block's device, each
        block is pruned there, and the site vectors come back to ``device``
        for the fp64 reduction.  ``"auto"`` is ``settings.default_mesh``:
        every visible card where two or more are and the partitions' value
        and gradient (:func:`pruning.gene_bytes`) passes half of
        ``device``'s free memory, else none; ``None`` keeps every pattern
        on ``device``."""
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
        pdatas = [pruning.build_pruning_data(p.tree, self.device) for p in self.partitions]
        itemsize = torch.finfo(self.dtype).bits // 8
        # a site-level class mixture prunes once per class
        self.mesh = resolve_mesh(mesh, self.device, sum(
            pruning.gene_bytes(d, p.filter.n_patterns, p.model.n_states, itemsize)
            * getattr(p.model, "rate_classes", 1) for d, p in zip(pdatas, self.partitions)))
        self._pruning_data = []
        self._leaf_partials = []
        self._shards = []
        self._weights = []
        for p, pdata in zip(self.partitions, pdatas):
            lp = p.filter.leaf_partials()
            # align filter rows to the TREE's leaf order (the CLVs are
            # indexed by tree leaf ids) — reference MapTreeTipsToData
            tree_leaves = list(p.tree.names[: p.tree.n_leaves])
            if list(p.filter.names) != tree_leaves:
                order = [p.filter.names.index(nm) for nm in tree_leaves]
                lp = lp[np.asarray(order)]
            if self.mesh is None:
                self._pruning_data.append(pdata)
                self._leaf_partials.append(
                    torch.as_tensor(lp, device=self.device).to(self.dtype)
                )
            else:
                self._shards.append(pruning.shard_patterns(pdata, lp, self.mesh, self.dtype))
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

        def prune(floor=None):
            if self.mesh is not None:
                return pruning.sharded_site_log_likelihoods(
                    out.p_matrices, self._shards[i], out.root_freqs, floor)
            return pruning.site_log_likelihoods(
                out.p_matrices, self._leaf_partials[i], out.root_freqs,
                self._pruning_data[i], floor)

        if out.class_weights is None:
            return prune()
        # site-level rate classes (the JAX package's
        # ``mixture_site_log_likelihoods``, one pruning per class): the
        # classes fold into K1's node axis through the grid form, one launch
        # per level for all of them, with the JAX package's ``finfo.tiny``
        # floor on each class's site likelihood (a class of likelihood 0
        # keeps a finite gradient); log sum_c w_c L_c in fp64
        per_class = prune(floor=True)                        # [C, patterns]
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

    def initial_parameters(self) -> Params:
        return initial_params(self.specs, self.device)

    def fit(
        self,
        init: Optional[Params] = None,
        fixed: Optional[Dict[str, torch.Tensor]] = None,
        precision: Optional[float] = None,
        max_iterations: Optional[int] = None,
        constraints: Optional[Sequence] = None,
    ) -> "FitResult":
        """Maximize lnL over the free parameters (reference Optimize():
        here bounded L-BFGS-B on autograd gradients).

        ``constraints``: objects from :mod:`hyphy_tpu_torch.models.constraints`
        (``Proportional``, ``MolecularClock``) applied in order — each
        removes its dependent keys from the free set and rebuilds them
        inside the objective (the reference's ``ReplicateConstraint`` /
        ``MolecularClock`` dependent variables, re-evaluated in
        ``PreCompute``, likefunc.h:419) and on the result."""
        from hyphy_tpu_torch.optimize.core import maximize

        def as_param(v):
            return torch.as_tensor(v, dtype=torch.float64, device=self.device)

        constraints = list(constraints or [])
        specs = dict(self.specs)
        for c in constraints:
            specs = c.transform_specs(specs)
        params = initial_params(specs, self.device)
        if init:
            params.update({k: as_param(v) for k, v in init.items() if k in params})
        fixed = {k: as_param(v) for k, v in (fixed or {}).items()}
        free_specs = {k: v for k, v in specs.items() if k not in fixed}
        free_init = {k: params[k] for k in free_specs}

        def constrained(free: Params) -> Params:
            merged = {**free, **fixed}
            for c in constraints:
                merged = c.apply(merged)
            return merged

        def objective(free: Params) -> torch.Tensor:
            return self.loglik(constrained(free))

        best, lnl, n_iter = maximize(
            objective,
            free_specs,
            free_init,
            precision=precision or settings.optimization_precision,
            max_iterations=max_iterations,
            device=self.device,
        )
        with torch.no_grad():
            final = constrained(best)
        return FitResult(
            params=final,
            loglik=float(lnl),
            n_free_parameters=count_parameters(free_specs),
            n_iterations=int(n_iter),
            lf=self,
        )

    # -- uncertainty --------------------------------------------------------

    def covariance_matrix(
        self, params: Params, keys: Optional[Sequence[str]] = None
    ) -> Tuple[np.ndarray, List[str]]:
        """Asymptotic MLE covariance = inverse observed information
        (reference ``CovarianceMatrix``, ``likefunc.cpp:6535``, Hessian
        mode).  The Hessian is autograd's, in fp64 parameters, through the
        pruning's twice-differentiable K1 (the reference takes finite
        differences); the pseudo-inverse guards boundary and flat
        directions.  Returns (cov [k, k], flattened key labels)."""
        keys = list(keys or self.specs)
        labels: List[str] = []
        flat0, shapes = [], []
        base = {k: torch.as_tensor(v, device=self.device).detach() for k, v in params.items()}
        for k in keys:
            n = base[k].numel()
            labels.extend([k] if n == 1 else [f"{k}[{j}]" for j in range(n)])
            flat0.append(base[k].to(torch.float64).reshape(-1))
            shapes.append(base[k].shape)
        x0 = torch.cat(flat0)

        def unflatten(x):
            out = dict(base)
            off = 0
            for k, shp in zip(keys, shapes):
                n = shp.numel()
                out[k] = x[off: off + n].reshape(shp)
                off += n
            return out

        hess = torch.autograd.functional.hessian(lambda x: self.loglik(unflatten(x)), x0)
        info = -hess.detach().cpu().numpy()
        return np.linalg.pinv(info), labels

    def profile_ci(
        self,
        params: Params,
        key: str,
        loglik_mle: float,
        level: float = 0.95,
        iters: int = 60,
    ) -> Tuple[float, float]:
        """Profile-likelihood CI for a scalar parameter with the others
        FIXED at their MLEs (reference ``COVARIANCE_PRECISION`` < 1 path,
        ``likefunc.cpp:6565``; the fixed-nuisance profile the per-site
        methods take through ``parameters.GetProfileCI``): bracket each side
        by doubling steps, then bisect to the chi-square drop."""
        from scipy.stats import chi2 as _c2

        drop = float(_c2.ppf(level, 1)) / 2.0
        spec = self.specs[key]
        target = loglik_mle - drop
        mle = float(torch.as_tensor(params[key]))

        def lnl_at(v: float) -> float:
            p = dict(params)
            p[key] = torch.tensor(v, dtype=torch.float64, device=self.device)
            with torch.no_grad():
                return float(self.loglik(p))

        def search(side: int) -> float:
            bound = spec.upper if side > 0 else spec.lower
            far = mle
            for _ in range(40):
                step = max(abs(far), 1e-3)
                far = float(np.clip(far + side * step, spec.lower, spec.upper))
                if lnl_at(far) < target or far == bound:
                    break
            if lnl_at(far) > target:
                return float(far)  # the CI reaches the bound
            near = mle
            for _ in range(iters):
                mid = 0.5 * (near + far)
                if lnl_at(mid) > target:
                    near = mid
                else:
                    far = mid
                if abs(far - near) < 1e-10 * max(1.0, abs(mle)):
                    break
            return 0.5 * (near + far)

        return search(-1), search(+1)


@dataclasses.dataclass
class FitResult:
    params: Params
    loglik: float
    n_free_parameters: int
    n_iterations: int
    lf: Optional[LikelihoodFunction] = None

    def aic_c(self, n_samples: int) -> float:
        """AIC-c = 2p - 2lnL + 2p(p+1)/(n-p-1) (reference: aBSREL/GARD)."""
        p = self.n_free_parameters
        return 2 * p - 2 * self.loglik + 2 * p * (p + 1) / max(n_samples - p - 1, 1)
