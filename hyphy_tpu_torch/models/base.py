"""Substitution-model interface.

Counterpart of ``hyphy_tpu/models/base.py``.  A model is a plain Python
object that keeps its own precomputed tensors on one device and whose
``build`` maps a flat parameter dict to per-branch transition matrices;
``to(device)`` gives its copy on another device (a per-site objective is
built on each device of a mesh, ``parallel/mesh.py``).

Canonical-form semantics (parity-critical): for a canonical model the
engine multiplies each off-diagonal ``q_xy`` by ``pi_y`` and then sets the
diagonal to minus the row sum (reference ``_Matrix::MultByFreqs``,
``matrix.cpp:1546-1620``).  Model classes here do both explicitly.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from hyphy_tpu_torch.config import canonical_device, resolve_device
from hyphy_tpu_torch.models.parameters import Params, Specs
from hyphy_tpu_torch.ops import expm as expm_ops


@dataclasses.dataclass
class ModelOutput:
    """Everything the pruning engine needs for one partition:
    ``p_matrices`` ``[n_branches, S, S]`` and ``root_freqs`` ``[S]``; with
    C site-level rate classes, ``p_matrices`` ``[C, n_branches, S, S]`` and
    their weights ``class_weights`` ``[C]``."""

    p_matrices: torch.Tensor
    root_freqs: torch.Tensor
    class_weights: "torch.Tensor | None" = None


def fill_diagonal_from_rows(q: torch.Tensor) -> torch.Tensor:
    """diag(Q) = -sum of off-diagonals (the generator condition)."""
    n = q.shape[-1]
    eye = torch.eye(n, dtype=q.dtype, device=q.device)
    q = q * (1.0 - eye)
    return q - eye * torch.sum(q, dim=-1, keepdim=True)


def expected_rate(q: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """sum_x pi_x sum_{y!=x} q_xy = -sum_x pi_x q_xx — the substitutions/
    site per unit time (reference: ``_Matrix::BranchLengthExpression``,
    ``matrix.cpp:2644``)."""
    diag = torch.diagonal(q, dim1=-2, dim2=-1)
    return -torch.sum(pi * diag, dim=-1)


def _moved(value, device):
    """``value`` with every tensor in it (also in lists, tuples, dicts and
    models) copied to ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, SubstitutionModel):
        return value.to(device)
    if isinstance(value, (list, tuple)):
        return type(value)(_moved(v, device) for v in value)
    if isinstance(value, dict):
        return {k: _moved(v, device) for k, v in value.items()}
    return value


class SubstitutionModel:
    """Base class; subclasses define the state space and Q construction."""

    n_states: int
    reversible: bool = True
    datatype: str = "nucleotide"
    device: torch.device

    def to(self, device) -> "SubstitutionModel":
        """This model with its own tensors on ``device``: the model itself
        when it is there already, else a shallow copy whose tensor
        attributes (and those in its lists, tuples and dicts) are copied
        there."""
        device = resolve_device(device)
        if canonical_device(device) == canonical_device(self.device):
            return self
        out = copy.copy(self)
        for name, value in vars(self).items():
            setattr(out, name, _moved(value, device))
        out.device = device
        return out

    def parameter_specs(self, n_branches: int) -> Specs:
        raise NotImplementedError

    def build(self, params: Params, n_branches: int) -> ModelOutput:
        raise NotImplementedError

    def branch_lengths(self, params: Params) -> torch.Tensor:
        """Expected substitutions/site per branch at the current params."""
        raise NotImplementedError

    # helper shared by reversible models
    def _propagate(self, q, pi, t):
        """P(t_b) for all branches from one Q.

        Small-state models (nucleotide 4x4, amino-acid 20x20) use the
        shared-power Taylor propagator: the gradient of an
        eigendecomposition (``torch.linalg.eigh`` as much as JAX's) divides
        by eigenvalue gaps, so any degenerate-spectrum point (JC69 always;
        HKY85 at kappa=1) yields NaN gradients and silently kills the fit.
        Codon models keep the spectral route via their own propagators; a
        non-reversible generator of more states takes the scaling-and-
        squaring Taylor route of :func:`expm_ops.transition_matrix`, one
        matrix per branch, as in the JAX package."""
        if q.shape[-1] <= 20:
            return expm_ops.shared_taylor_propagators(q, t)
        if self.reversible:
            left, lam, right = expm_ops.reversible_spectral(q, pi)
            return expm_ops.spectral_propagators(left, lam, right, t)
        return expm_ops.transition_matrix(q, t)
