"""The system under test, driven through its public functions.

Helpers that :mod:`portbench.stages` share: the alignment loaded by the
port, the parameter points built with the port's own constructors, and
:func:`swapped`, which replaces for the length of a call the name through
which a stage reaches its optimizer, so that the objective the stage hands
over goes through the window's wrapper.  No program file is changed.  The
port (``hyphy_tpu_torch``) is imported here and in :mod:`portbench.stages`
only, inside functions.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.inputs import Inputs


@contextlib.contextmanager
def swapped(module, name, replacement):
    original = getattr(module, name)
    setattr(module, name, replacement(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def load(inputs: Inputs, device):
    from hyphy_tpu_torch.methods import common

    return common.load_codon_data(inputs.fasta, "Universal", inputs.data.newick, "All",
                                  device=device)


def _thetas(inputs: Inputs, device):
    return {f"theta_{p}": torch.tensor(v, dtype=torch.float64, device=device)
            for p, v in inputs.thetas.items() if p != "AG"}


def mg94_point(inputs: Inputs, data, device):
    """The global MG94xREV point of the generating process, built with the
    port's own model constructor: thetas, one omega, a synonymous rate per
    branch, the F3x4 frequencies of the alignment."""
    from hyphy_tpu_torch.methods import common
    from hyphy_tpu_torch.models.codon import MG94xREVPartitionedOmega

    n_branches = data.tree.n_branches
    model = MG94xREVPartitionedOmega(
        data.genetic_code, inputs.corners, inputs.codon_freqs, nuc_lengths=inputs.nuc_lengths,
        branch_groups=np.zeros(n_branches, dtype=np.int64), n_groups=1, free_lengths=True,
        device=device)
    params = _thetas(inputs, device)
    params["omega"] = torch.tensor([inputs.omega], dtype=torch.float64, device=device)
    params["alpha"] = torch.as_tensor(inputs.alphas, dtype=torch.float64, device=device)
    return common.MG94Fit(
        loglik=float("nan"), params=params, branch_lengths=inputs.nuc_lengths,
        alphas=inputs.alphas, betas=inputs.alphas * inputs.omega,
        omegas=np.array([inputs.omega]), corner_freqs=inputs.corners,
        codon_freqs=inputs.codon_freqs, n_parameters=0, model=model)


def gtr_point(inputs: Inputs, device):
    """The nucleotide GTR point of the generating process (thetas and the
    simulated branch lengths per nucleotide site), where a gene fit starts."""
    from hyphy_tpu_torch.methods import common

    return common.GTRFit(
        loglik=float("nan"), params=_thetas(inputs, device), branch_lengths=inputs.nuc_lengths,
        frequencies=inputs.corners.mean(axis=1), n_parameters=0, model=None)
