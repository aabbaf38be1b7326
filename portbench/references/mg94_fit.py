"""The MG94xREV gene likelihood worked out again at evaluations the fit
made, drawn from the seed: CF3x4 frequencies solved from the alignment, the
generator ``Q_syn + omega Q_nonsyn``, one propagator per branch at its
synonymous rate (the scaled stage: the scaler times the GTR point's branch
length), the pruning.  Numbers compared: ``lnl_gap`` and ``grad_gap``
(:func:`portbench.references._gene.compare`)."""

from __future__ import annotations

import torch

from portbench import reference
from portbench.references import _gene


def numbers(inputs, calls, rng, device, sample, control=False):
    corners = reference.cf3x4(inputs.data.states)
    freqs = reference.codon_frequencies(corners)
    freqs_t = torch.as_tensor(freqs, dtype=torch.float64, device=device)
    lengths = torch.as_tensor(inputs.nuc_lengths, dtype=torch.float64, device=device)

    def p_fn(leaves, dtype):
        q_syn, q_non = reference.mg94_bases(_gene.thetas_of(leaves, inputs.thetas), corners,
                                            device)
        q = reference.generator(q_syn, q_non, 1.0, leaves["omega"].reshape(-1)[0])
        alpha = leaves["scaler"] * lengths if "scaler" in leaves else leaves["alpha"]
        return reference.propagators(q, freqs_t, alpha, dtype)[None], None

    return _gene.compare(inputs, calls, rng, device, sample, freqs, p_fn, control)
