"""BUSTED's mixture likelihood worked out again at evaluations the fit made,
drawn from the seed (Murrell et al. 2015, Wisotsky et al. 2020): on every
branch the propagator is the mixture ``sum_k w_k expm(r_c t_b (Q_syn +
omega_k Q_nonsyn))`` over the omega classes, the weights by stick-breaking;
each synonymous-rate class ``r_c`` (normalized to mean 1 under its weights)
is pruned on its own and the classes are mixed per site.  Numbers compared:
``lnl_gap`` and ``grad_gap`` (:func:`portbench.references._gene.compare`)."""

from __future__ import annotations

import torch

from portbench import reference
from portbench.references import _gene


def _series(leaves, stem):
    out, i = [], 1
    while f"{stem}{i}" in leaves:
        out.append(leaves[f"{stem}{i}"])
        i += 1
    return out


def numbers(inputs, calls, rng, device, sample, control=False):
    freqs = torch.as_tensor(inputs.codon_freqs, dtype=torch.float64, device=device)

    def p_fn(leaves, dtype):
        q_syn, q_non = reference.mg94_bases(_gene.thetas_of(leaves, inputs.thetas),
                                            inputs.corners, device)
        omegas = _series(leaves, "test_omega_")
        w = reference.stick_breaking(_series(leaves, "test_w_"))
        rates = torch.stack(_series(leaves, "srv_rate_"))
        ws = reference.stick_breaking(_series(leaves, "srv_w_"))
        rates = rates / (rates * ws).sum()
        t = leaves["t"]
        times = (rates[:, None] * t[None]).reshape(-1)
        p = sum(w[k].to(dtype) * reference.propagators(reference.generator(q_syn, q_non, 1.0, omegas[k]),
                                             freqs, times, dtype)
                for k in range(len(omegas)))
        return p.reshape(rates.shape[0], t.shape[0], *p.shape[-2:]), torch.log(ws)

    return _gene.compare(inputs, calls, rng, device, sample, inputs.codon_freqs, p_fn,
                         control)
