"""Nucleotide substitution models: JC69, HKY85, GTR.

Counterpart of ``hyphy_tpu/models/dna.py``.  Parity notes (reference
``res/TemplateBatchFiles/libv3/models/DNA/*.bf``): all are canonical models
(``q_xy = rate_xy * pi_y``, diagonal = -row sum); GTR's exchangeabilities
are ``theta_<XY>`` with ``theta_AG := 1`` (``GTR.bf:75-80``); HKY85 uses
``kappa`` on transitions, 1 on transversions; branch time is the local
parameter ``t``.
"""

from __future__ import annotations

import numpy as np
import torch

from hyphy_tpu_torch.config import resolve_device
from hyphy_tpu_torch.data.genetic_code import NUCLEOTIDES
from hyphy_tpu_torch.models.base import (
    ModelOutput,
    SubstitutionModel,
    expected_rate,
    fill_diagonal_from_rows,
)
from hyphy_tpu_torch.models.parameters import ParamSpec, Params, Specs

# unordered nucleotide pairs in reference naming order
GTR_RATES = ["AC", "AG", "AT", "CG", "CT", "GT"]
TRANSITIONS = {"AG", "CT"}

# Q entries (i, j) filled by rate k: both directions of each pair
_ROWS = [NUCLEOTIDES.index(p[a]) for p in GTR_RATES for a in (0, 1)]
_COLS = [NUCLEOTIDES.index(p[1 - a]) for p in GTR_RATES for a in (0, 1)]


class NucleotideREV(SubstitutionModel):
    """General reversible nucleotide model with a configurable set of free
    exchangeabilities (GTR = all but AG; HKY = single kappa; JC = none)."""

    n_states = 4
    datatype = "nucleotide"
    reversible = True

    def __init__(self, frequencies: np.ndarray, equal_frequencies: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.frequencies = torch.as_tensor(
            np.asarray(frequencies, dtype=np.float64).reshape(4), device=self.device
        )
        self.equal_frequencies = equal_frequencies
        self._rows = torch.tensor(_ROWS, device=self.device)
        self._cols = torch.tensor(_COLS, device=self.device)

    # subclasses override
    def _rate_multipliers(self, params: Params) -> torch.Tensor:
        """[6] rate multipliers in GTR_RATES order."""
        raise NotImplementedError

    def parameter_specs(self, n_branches: int) -> Specs:
        specs = self._rate_specs()
        specs["t"] = ParamSpec(init=0.1, lower=0.0, upper=10000.0, shape=(n_branches,))
        return specs

    def _rate_specs(self) -> Specs:
        return {}

    def q_matrix(self, params: Params) -> torch.Tensor:
        rates = self._rate_multipliers(params)
        freqs = self.frequencies.to(rates.dtype)  # keep the fp32 path fp32
        vals = torch.repeat_interleave(rates, 2) * freqs[self._cols]
        q = torch.zeros((4, 4), dtype=rates.dtype, device=self.device)
        q = q.index_put((self._rows, self._cols), vals)
        return fill_diagonal_from_rows(q)

    def build(self, params: Params, n_branches: int) -> ModelOutput:
        q = self.q_matrix(params)
        p = self._propagate(q, self.frequencies, params["t"])
        return ModelOutput(p_matrices=p, root_freqs=self.frequencies)

    def branch_lengths(self, params: Params) -> torch.Tensor:
        q = self.q_matrix(params)
        return params["t"] * expected_rate(q, self.frequencies.to(q.dtype))


class GTR(NucleotideREV):
    """theta_AC..theta_GT free, theta_AG := 1 (GTR.bf)."""

    free_rates = ["AC", "AT", "CG", "CT", "GT"]

    def _rate_specs(self) -> Specs:
        return {f"theta_{p}": ParamSpec(init=0.25, lower=0.0, upper=10000.0)
                for p in self.free_rates}

    def _rate_multipliers(self, params: Params) -> torch.Tensor:
        dtype = params["theta_AC"].dtype
        one = torch.ones((), dtype=dtype, device=self.device)
        return torch.stack(
            [one if pair == "AG" else params[f"theta_{pair}"] for pair in GTR_RATES]
        )


class HKY85(NucleotideREV):
    """kappa on transitions (AG, CT), 1 on transversions (HKY85.bf)."""

    def _rate_specs(self) -> Specs:
        return {"kappa": ParamSpec(init=1.0, lower=0.0, upper=10000.0)}

    def _rate_multipliers(self, params: Params) -> torch.Tensor:
        k = params["kappa"]
        one = torch.ones_like(k)
        return torch.stack([one if p not in TRANSITIONS else k for p in GTR_RATES])


class JC69(NucleotideREV):
    """Equal rates, equal frequencies (JC69.bf)."""

    def __init__(self, device=None):
        super().__init__(np.full(4, 0.25), equal_frequencies=True, device=device)

    def _rate_specs(self) -> Specs:
        return {}

    def _rate_multipliers(self, params: Params) -> torch.Tensor:
        return torch.ones(6, dtype=params["t"].dtype, device=self.device)
