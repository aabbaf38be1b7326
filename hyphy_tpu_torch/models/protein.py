"""Amino-acid substitution models: empirical matrices (JTT, WAG, LG, ...)
and the general REV protein model.

Counterpart of ``hyphy_tpu/models/protein.py``.  The empirical models'
pairwise rates and default frequencies are published scientific constants
(Jones-Taylor-Thornton 1992, Whelan-Goldman 2001, Le-Gascuel 2008, ...); the
port carries its own copy of them as JSON under
``hyphy_tpu_torch/resources/protein`` (reference counterparts:
``libv3/models/protein/matrices/*.ibf``).

All are canonical models: ``q_xy = r_xy * pi_y``, diagonal = -row sum.
Frequency variants mirror the reference naming: base (model frequencies),
``+F`` (empirical from the data, :func:`frequencies.empirical_character`).
At 20 states the propagators take the shared-power Taylor route
(:meth:`SubstitutionModel._propagate`) in every dtype, as in the JAX
package.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from hyphy_tpu_torch.config import resolve_device
from hyphy_tpu_torch.data.genetic_code import AMINO_ACIDS
from hyphy_tpu_torch.models.base import (
    ModelOutput,
    SubstitutionModel,
    expected_rate,
    fill_diagonal_from_rows,
)
from hyphy_tpu_torch.models.parameters import ParamSpec, Params, Specs

RESOURCE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "resources", "protein")

EMPIRICAL_MODELS = ["LG", "WAG", "JTT", "JC69", "Dayhoff", "rtREV", "mtMAM", "mtREV24",
                    "mtMet", "mtVer", "mtInv", "gcpREV", "HIVBm", "HIVWm"]


@functools.lru_cache(maxsize=None)
def load_empirical(name: str) -> Dict:
    path = os.path.join(RESOURCE_DIR, f"{name}.json")
    if not os.path.exists(path):
        raise ValueError(f"unknown empirical protein model {name!r}; "
                         f"options: {EMPIRICAL_MODELS}")
    with open(path) as fh:
        return json.load(fh)


def rate_matrix_from_pairs(rates: Dict[str, float]) -> np.ndarray:
    """Symmetric 20x20 exchangeability matrix from {'AC': r, ...} pairs."""
    r = np.zeros((20, 20))
    for pair, v in rates.items():
        i, j = AMINO_ACIDS.index(pair[0]), AMINO_ACIDS.index(pair[1])
        r[i, j] = r[j, i] = v
    return r


class EmpiricalProtein(SubstitutionModel):
    """Fixed-exchangeability protein model with per-branch time t."""

    n_states = 20
    datatype = "protein"
    reversible = True

    def __init__(self, name: str = "LG", frequencies: Optional[np.ndarray] = None,
                 device=None):
        self.device = resolve_device(device)
        data = load_empirical(name)
        self.name = name
        self.exchangeabilities = rate_matrix_from_pairs(data["rates"])
        if frequencies is None:
            frequencies = np.asarray(data["frequencies"])
        self.frequencies = torch.as_tensor(
            np.asarray(frequencies, dtype=np.float64).reshape(20), device=self.device)
        self._exchange = torch.as_tensor(self.exchangeabilities, device=self.device)

    def parameter_specs(self, n_branches: int) -> Specs:
        return {"t": ParamSpec(init=0.1, lower=0.0, upper=10000.0, shape=(n_branches,))}

    def q_matrix(self, params: Params = None, dtype=torch.float64) -> torch.Tensor:
        """The generator in ``dtype`` (the parameters' when they hold ``t``)."""
        if params is not None and "t" in params:
            dtype = params["t"].dtype
        q = self._exchange.to(dtype) * self.frequencies.to(dtype)[None, :]
        return fill_diagonal_from_rows(q)

    def build(self, params: Params, n_branches: int) -> ModelOutput:
        q = self.q_matrix(params)
        p = self._propagate(q, self.frequencies, params["t"])
        return ModelOutput(p_matrices=p, root_freqs=self.frequencies)

    def branch_lengths(self, params: Params) -> torch.Tensor:
        q = self.q_matrix(params)
        return params["t"] * expected_rate(q, self.frequencies.to(q.dtype))


class ProteinREV(SubstitutionModel):
    """Fully general reversible protein model: 189 free exchangeabilities
    (one pinned) — the reference's ``models.protein.REV`` used by
    ProteinGTRFit workflows."""

    n_states = 20
    datatype = "protein"
    reversible = True

    PINNED = "IL"  # reference normalizes against one rate

    def __init__(self, frequencies: np.ndarray, baseline: str = "LG", device=None):
        self.device = resolve_device(device)
        self.frequencies = torch.as_tensor(
            np.asarray(frequencies, dtype=np.float64).reshape(20), device=self.device)
        self._init_rates = load_empirical(baseline)["rates"]
        self._pairs = [AMINO_ACIDS[i] + AMINO_ACIDS[j]
                       for i in range(20) for j in range(i + 1, 20)]
        self._ii = torch.tensor([AMINO_ACIDS.index(p[0]) for p in self._pairs],
                                device=self.device)
        self._jj = torch.tensor([AMINO_ACIDS.index(p[1]) for p in self._pairs],
                                device=self.device)

    def parameter_specs(self, n_branches: int) -> Specs:
        specs = {
            f"r_{p}": ParamSpec(
                init=max(self._init_rates.get(p, self._init_rates.get(p[::-1], 0.1)), 1e-4),
                lower=0.0, upper=10000.0,
            )
            for p in self._pairs
            if p != self.PINNED
        }
        specs["t"] = ParamSpec(init=0.1, lower=0.0, upper=10000.0, shape=(n_branches,))
        return specs

    def q_matrix(self, params: Params) -> torch.Tensor:
        dtype = params["t"].dtype if "t" in params else torch.float64
        one = torch.ones((), dtype=dtype, device=self.device)
        vals = torch.stack([one if p == self.PINNED else params[f"r_{p}"].to(dtype)
                            for p in self._pairs])
        q = torch.zeros((20, 20), dtype=dtype, device=self.device)
        q = q.index_put((self._ii, self._jj), vals).index_put((self._jj, self._ii), vals)
        q = q * self.frequencies.to(dtype)[None, :]
        return fill_diagonal_from_rows(q)

    def build(self, params: Params, n_branches: int) -> ModelOutput:
        q = self.q_matrix(params)
        p = self._propagate(q, self.frequencies, params["t"])
        return ModelOutput(p_matrices=p, root_freqs=self.frequencies)

    def branch_lengths(self, params: Params) -> torch.Tensor:
        q = self.q_matrix(params)
        return params["t"] * expected_rate(q, self.frequencies.to(q.dtype))
