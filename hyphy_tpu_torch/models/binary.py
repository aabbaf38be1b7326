"""Binary (2-state) substitution model.

Counterpart of ``hyphy_tpu/models/binary.py`` (reference
``libv3/models/binary.bf``): a reversible 0/1 character model with
empirical or equal frequencies and a per-branch time ``t``, used for
presence/absence characters (gene families across genomes) and
morphological-style characters.  Its propagators take the shared-power
Taylor route of every model of at most 20 states
(:meth:`SubstitutionModel._propagate`), and its pruning runs K1 at 2
states."""

from __future__ import annotations

import numpy as np
import torch

from hyphy_tpu_torch.config import resolve_device
from hyphy_tpu_torch.models.base import (
    ModelOutput,
    SubstitutionModel,
    expected_rate,
    fill_diagonal_from_rows,
)
from hyphy_tpu_torch.models.parameters import ParamSpec, Params, Specs


class Binary(SubstitutionModel):
    """q_01 = pi_1, q_10 = pi_0 (canonical: rate x target frequency),
    diagonal = -row sum; one local time parameter per branch."""

    n_states = 2
    datatype = "binary"
    reversible = True

    def __init__(self, frequencies=None, device=None):
        self.device = resolve_device(device)
        freqs = np.asarray(
            [0.5, 0.5] if frequencies is None else frequencies, dtype=np.float64
        ).reshape(2)
        self.frequencies = torch.as_tensor(freqs / freqs.sum(), device=self.device)

    def parameter_specs(self, n_branches: int) -> Specs:
        return {
            "t": ParamSpec(init=0.1, lower=0.0, upper=10000.0, shape=(n_branches,))
        }

    def q_matrix(self, params: Params) -> torch.Tensor:
        pi = self.frequencies.to(params["t"].dtype)
        # [[0, 1], [1, 0]] * pi, made on the device (no host copy per call)
        q = (1.0 - torch.eye(2, dtype=pi.dtype, device=self.device)) * pi[None, :]
        return fill_diagonal_from_rows(q)

    def build(self, params: Params, n_branches: int) -> ModelOutput:
        q = self.q_matrix(params)
        p = self._propagate(q, self.frequencies, params["t"])
        return ModelOutput(p_matrices=p, root_freqs=self.frequencies)

    def branch_lengths(self, params: Params) -> torch.Tensor:
        q = self.q_matrix(params)
        return params["t"] * expected_rate(q, self.frequencies.to(q.dtype))
