"""What the gene stages' references share: the sampled evaluations, the
lnL and gradient of each worked out again, and the two numbers compared."""

from __future__ import annotations

import sys

import numpy as np
import torch

from portbench import reference


def compare(inputs, calls, rng, device, sample, freqs, p_fn, control=False):
    """``p_fn(leaves, dtype) -> (p [C, B, S, S], class log-weights [C] or
    None)`` from the point's parameters ``leaves`` (fp64, requiring grad).

    Both numbers are per unit of the reference's |lnL|, as fp32 round-off
    grows with it (a line search's probe reads |lnL| eight times the fit's):
    ``lnl_gap``, the widest ``|lnL - lnL_ref| / |lnL_ref|`` over the sampled
    evaluations, and ``grad_gap``, the widest ``sum_i |g_i - g_ref,i| |x_i| /
    |lnL_ref|`` over every parameter ``x_i`` of the point: the most by which
    the program's gradient mispredicts the first-order change of lnL over a
    step that moves no parameter by more than its own size.  With
    ``control`` the reference in TF32 (:func:`portbench.reference.tf32`)
    stands in the program's place."""
    graded = [c for c in calls if c.kind == "gene" and c.with_grad and c.grads]
    chosen = rng.choice(len(graded), size=min(sample["evaluations"], len(graded)), replace=False)
    columns, weights, _ = reference.patterns(inputs.data.states)
    pruner = reference.Pruner(inputs.data.tree, device)
    freqs = torch.as_tensor(freqs, dtype=torch.float64, device=device)

    def evaluate(call, dtype):
        leaves = {k: v.to(device, torch.float64).clone().requires_grad_()
                  for k, v in call.params.items()}
        lnl = reference.gene_loglik(pruner, columns, weights, freqs,
                                    lambda: p_fn(leaves, dtype), dtype=dtype)
        return lnl, {k: v.grad for k, v in leaves.items() if v.grad is not None}

    lnl_gap = grad_gap = 0.0
    for c in sorted(chosen):
        call = graded[c]
        ref_lnl, ref_grads = evaluate(call, torch.float64)
        if control:
            with reference.tf32():
                got_lnl, got_grads = evaluate(call, reference.CONTROL_DTYPE)
        else:
            got_lnl = float(call.value)
            got_grads = {k: -g for k, g in call.grads.items()}
        scale = abs(ref_lnl)
        lnl_gap = _widest(lnl_gap, abs(got_lnl - ref_lnl) / scale)
        gap = 0.0
        for key in sorted(got_grads):
            x = call.params[key].to(device, torch.float64).reshape(-1).abs()
            got = got_grads[key].to(device, torch.float64).reshape(-1)
            gap += float(((got - ref_grads[key].reshape(-1)).abs() * x).sum())
        gap /= scale
        grad_gap = _widest(grad_gap, gap)
        ranges = ", ".join(f"{k} [{float(v.min()):.6g}, {float(v.max()):.6g}]"
                           for k, v in sorted(call.params.items()))
        print(f"[portbench] evaluation {c} of {len(graded)}: lnL {got_lnl!r}, "
              f"reference {ref_lnl!r}, gradient gap {gap!r}; {ranges}", file=sys.stderr)
    if not len(chosen):
        return {"lnl_gap": np.inf, "grad_gap": np.inf}
    return {"lnl_gap": lnl_gap, "grad_gap": grad_gap}


def _widest(a: float, b: float) -> float:
    """The larger gap; a gap that is not a number counts as infinite."""
    return max(a if np.isfinite(a) else np.inf, b if np.isfinite(b) else np.inf)


def thetas_of(leaves, fixed):
    """Pair -> theta: the point's own where it has them, else ``fixed``."""
    return {p: leaves.get(f"theta_{p}", torch.tensor(fixed[p], dtype=torch.float64))
            for p in fixed}
