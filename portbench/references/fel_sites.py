"""FEL's per-site objective worked out again: a sample of the window's
calls, drawn from the seed, and in each a sample of its items, each under
the parameters the program was asked for (the grid's, or those the
alternative or the null Nelder-Mead chose).  Number compared:
``site_lnl_gap``, the widest gap between a sampled item's site lnL as the
program returned it and as the reference gives it.  With ``control`` the
reference in TF32 (:func:`portbench.reference.tf32`) stands in the program's
place."""

from __future__ import annotations

import numpy as np
import torch

from portbench import reference


def numbers(inputs, calls, rng, device, sample, control=False):
    calls = [c for c in calls if c.kind == "site"]
    chosen = rng.choice(len(calls), size=min(sample["calls"], len(calls)), replace=False)
    columns, _, _ = reference.patterns(inputs.data.states)
    pruner = reference.Pruner(inputs.data.tree, device)
    thetas = {p: torch.tensor(v, dtype=torch.float64) for p, v in inputs.thetas.items()}
    q_syn, q_non = reference.mg94_bases(thetas, inputs.corners, device)
    freqs = torch.as_tensor(inputs.codon_freqs, dtype=torch.float64, device=device)
    alpha_hat = torch.as_tensor(inputs.alphas, dtype=torch.float64, device=device)
    gap = 0.0
    for c in sorted(chosen):
        call = calls[c]
        pick = np.sort(rng.choice(call.items, size=min(sample["items"], call.items),
                                  replace=False))
        sel = torch.as_tensor(pick, device=call.idx.device)
        idx = call.idx[sel].cpu().numpy()
        a = call.params["alpha"][sel].to(device, torch.float64)
        b = call.params.get("beta_test", call.params["alpha"])[sel].to(device, torch.float64)

        def site_lnl(dtype):
            with torch.no_grad():
                return reference.fel_site_logliks(pruner, columns[:, idx], q_syn, q_non, freqs,
                                                  alpha_hat, a, b, dtype)

        ref = site_lnl(torch.float64)
        if control:
            with reference.tf32():
                got = site_lnl(reference.CONTROL_DTYPE)
        else:
            got = call.value[sel].to(device, torch.float64)
        # a site lnL of -inf on both sides (a column the rates make impossible) agrees
        diff = torch.where(got == ref, torch.zeros_like(ref), (got - ref).abs())
        gap = max(gap, float(torch.nan_to_num(diff, nan=np.inf).max()))
    return {"site_lnl_gap": gap if len(chosen) else np.inf}
