"""Parameter specifications, bounds, and smooth bounded<->unbounded
transforms.

Counterpart of ``hyphy_tpu/models/parameters.py``.  The reference optimizes
bounded variables by mapping them to an unbounded space
(``docs/optimization.md:72``); default bounds are [0, 10000]
(``src/core/likefunc.h:61-62``).  Every free parameter is an entry of a
flat dict of fp64 tensors; constraints of the forms libv3 uses are derived
values inside model ``build`` functions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

DEFAULT_UPPER = 10000.0


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    init: float = 0.1
    lower: float = 0.0
    upper: float = DEFAULT_UPPER
    shape: Tuple[int, ...] = ()
    # Cross-partition sharing in a multi-partition LikelihoodFunction:
    # None = default rule (scalars shared, vectors per-partition);
    # True/False overrides it (reference: same-named global variables are
    # shared across partitions, shared-load-file.bf:716).
    shared: "bool | None" = None

    def initial(self, device) -> torch.Tensor:
        return torch.full(self.shape, self.init, dtype=torch.float64, device=device)

    def is_shared(self) -> bool:
        return self.shared if self.shared is not None else self.shape == ()


Specs = Dict[str, ParamSpec]
Params = Dict[str, torch.Tensor]


def initial_params(specs: Specs, device) -> Params:
    return {k: s.initial(device) for k, s in specs.items()}


# -- transforms -------------------------------------------------------------
# x in (l, u)  <->  y unbounded via scaled logit; picked so that for small
# (x - l) the map behaves like log(x - l): same conditioning as HyPhy's
# log-space steps.

_EPS = 1e-12


def to_unbounded(params: Params, specs: Specs) -> Params:
    out = {}
    for k, v in params.items():
        s = specs[k]
        z = (torch.clamp(v, s.lower + _EPS, s.upper - _EPS) - s.lower) / (s.upper - s.lower)
        out[k] = torch.log(z) - torch.log1p(-z)
    return out


def to_bounded(uparams: Params, specs: Specs) -> Params:
    out = {}
    for k, v in uparams.items():
        s = specs[k]
        out[k] = s.lower + (s.upper - s.lower) * torch.sigmoid(v)
    return out


def clip_to_bounds(params: Params, specs: Specs) -> Params:
    return {
        k: torch.clamp(v, specs[k].lower + _EPS, specs[k].upper - _EPS)
        for k, v in params.items()
    }


def flatten(params: Params):
    """dict -> (vector, unflatten) with deterministic key order."""
    keys = sorted(params)
    sizes = [int(np.prod(params[k].shape)) if params[k].shape else 1 for k in keys]
    shapes = {k: params[k].shape for k in keys}
    vec = torch.cat([params[k].reshape(-1) for k in keys])

    def unflatten(v):
        out, ofs = {}, 0
        for k, sz in zip(keys, sizes):
            out[k] = v[ofs : ofs + sz].reshape(shapes[k])
            ofs += sz
        return out

    return vec, unflatten


def count_parameters(specs: Specs) -> int:
    return sum(int(np.prod(s.shape)) if s.shape else 1 for s in specs.values())


def stick_breaking_weights(raw: torch.Tensor) -> torch.Tensor:
    """Mixture weights from K-1 stick-breaking fractions in (0,1)
    (reference: ``parameters.helper.stick_breaking``, BS_REL.bf:313-351)."""
    raw = torch.atleast_1d(raw)
    one = torch.ones((1,), dtype=raw.dtype, device=raw.device)
    remaining = torch.cat([one, torch.cumprod(1.0 - raw, dim=0)])
    return torch.cat([raw, one]) * remaining
