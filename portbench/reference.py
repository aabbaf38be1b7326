"""The plain reference that decides ``correct``.

Plain PyTorch (and SciPy for CF3x4's nine equations), written from the
published models and not from the program: nothing here imports the program
or JAX, and nothing the program made is read.  It works out again, from the
benchmark's own inputs (the simulated codons, the newick, the parameter
point), the MG94xREV bases, the codon frequencies, every propagator and the
pruning.

Precision.  Every propagator comes from the eigendecomposition of the
generator made symmetric by the codon frequencies (a reversible generator:
``expm(tQ) = D^-1/2 U e^{Lt} U^T D^1/2``).  The eigendecomposition is always
taken in float64; the products that assemble the propagators and the pruning
run in ``dtype``.  ``dtype=float64`` is the reference.  ``dtype=float32``
with ``torch.backends.cuda.matmul.allow_tf32 = True`` is its control: the
same arithmetic with every matrix product in TF32, as a program that let its
products drop to TF32 would compute.  The gradient of a propagator with
respect to its generator and its time is the Daleckii-Krein form
(:class:`SymmetricExpm`), which stays exact where eigenvalues lie close
together, where the backward of ``torch.linalg.eigh`` divides by their gaps.

Tree convention: :mod:`portbench.synth`'s (leaves in alignment order, then
internal nodes in post-order; branch ``b`` is the branch above node ``b``).
Patterns are the alignment's distinct columns in order of first occurrence.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import numpy as np
import torch

from portbench import synth

_PAIRS = ("AC", "AG", "AT", "CG", "CT", "GT")
_STATES = len(synth.SENSE_CODONS)


CONTROL_DTYPE = torch.float32


@contextlib.contextmanager
def tf32():
    """Matrix products in TF32 for the length of the block (the control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# data


def patterns(states: np.ndarray):
    """(pattern columns ``[taxa, P]``, weights ``[P]``, site -> pattern
    ``[codons]``): distinct columns in order of first occurrence."""
    _, first, inverse, counts = np.unique(states.T, axis=0, return_index=True,
                                          return_inverse=True, return_counts=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return states[:, first[order]], counts[order].astype(np.float64), rank[inverse.reshape(-1)]


def position_frequencies(states: np.ndarray) -> np.ndarray:
    """``[4, 3]`` observed nucleotide frequencies at each codon position."""
    codons = synth.SENSE_CODONS[states]
    out = np.zeros((4, 3))
    for pos, digits in enumerate((codons // 16, (codons // 4) % 4, codons % 4)):
        out[:, pos] = np.bincount(digits.reshape(-1), minlength=4) / digits.size
    return out


def codon_frequencies(corners: np.ndarray) -> np.ndarray:
    """``pi_c = n0[c0] n1[c1] n2[c2] / (1 - stop mass)`` over the sense codons."""
    def prod(codons):
        return corners[codons // 16, 0] * corners[(codons // 4) % 4, 1] * corners[codons % 4, 2]

    return prod(synth.SENSE_CODONS) / (1.0 - prod(synth.STOP_CODONS).sum())


def cf3x4(states: np.ndarray) -> np.ndarray:
    """Corrected F3x4 corner frequencies ``[4, 3]`` (Kosakovsky Pond et al.
    2010): the position frequencies ``n`` whose codon distribution, with the
    stop codons taken out, has the observed position frequencies.  Nine
    equations in nine unknowns, solved to round-off."""
    from scipy.optimize import least_squares

    obs = position_frequencies(states)
    stops = synth.STOP_CODONS
    digits = (stops // 16, (stops // 4) % 4, stops % 4)

    def corners(x):
        x = x.reshape(3, 3)
        return np.concatenate([x, 1.0 - x.sum(0, keepdims=True)], axis=0)

    def residual(x):
        n = corners(x)
        per_stop = n[digits[0], 0] * n[digits[1], 1] * n[digits[2], 2]
        implied = n.copy()
        for pos in range(3):
            taken = np.zeros(4)
            np.add.at(taken, digits[pos], per_stop)
            implied[:, pos] = n[:, pos] - taken
        implied /= 1.0 - per_stop.sum()
        return (implied - obs)[:3].reshape(-1)

    sol = least_squares(residual, obs[:3].reshape(-1), xtol=1e-15, ftol=1e-15, gtol=1e-15)
    return corners(sol.x)


# ---------------------------------------------------------------------------
# model


def _one_step_table():
    rows = []
    for a, ca in enumerate(synth.SENSE_CODONS):
        na = (ca // 16, (ca // 4) % 4, ca % 4)
        for b, cb in enumerate(synth.SENSE_CODONS):
            nb = (cb // 16, (cb // 4) % 4, cb % 4)
            diff = [p for p in range(3) if na[p] != nb[p]]
            if len(diff) != 1:
                continue
            p = diff[0]
            lo, hi = sorted((na[p], nb[p]))
            pair = synth.NUCLEOTIDES[lo] + synth.NUCLEOTIDES[hi]
            syn = synth.TRANSLATION[ca] == synth.TRANSLATION[cb]
            rows.append((a, b, _PAIRS.index(pair), nb[p], p, syn))
    return np.array(rows, dtype=np.int64)


_TABLE = _one_step_table()


def mg94_bases(thetas: Dict[str, torch.Tensor], corners: np.ndarray, device):
    """(Q_syn, Q_nonsyn) ``[61, 61]`` fp64 with zero diagonals (Muse & Gaut
    1994 with the GTR exchangeabilities, theta_AG = 1): entry x -> y for
    codons one nucleotide apart is ``theta_pair * n_pos(target nucleotide)``,
    synonymous or not."""
    one = torch.ones((), dtype=torch.float64, device=device)
    theta = torch.stack([one if p == "AG" else torch.as_tensor(thetas[p]).to(device)
                         for p in _PAIRS])
    t = torch.as_tensor(_TABLE, device=device)
    mult = torch.as_tensor(corners, dtype=torch.float64, device=device)[t[:, 3], t[:, 4]]
    entries = theta[t[:, 2]] * mult
    syn = t[:, 5].to(torch.float64)
    zeros = torch.zeros((_STATES, _STATES), dtype=torch.float64, device=device)
    idx = (t[:, 0], t[:, 1])
    return zeros.index_put(idx, entries * syn), zeros.index_put(idx, entries * (1.0 - syn))


def generator(q_syn, q_non, a, b):
    """``a Q_syn + b Q_nonsyn`` with the diagonal that makes rows sum to 0;
    ``a``, ``b`` scalars or ``[N]``."""
    a = torch.as_tensor(a, dtype=torch.float64, device=q_syn.device)
    b = torch.as_tensor(b, dtype=torch.float64, device=q_syn.device)
    m = a[..., None, None] * q_syn + b[..., None, None] * q_non
    return m - torch.diag_embed(m.sum(-1))


class SymmetricExpm(torch.autograd.Function):
    """``E[m] = U diag(exp(lam t_m)) U^T`` for a symmetric ``s`` ``[S, S]``
    and times ``t`` ``[M]``, with the eigendecomposition in fp64 and the
    assembly in ``dtype``.  Backward: the Daleckii-Krein form
    ``dE = U (F o (U^T dS U)) U^T``, ``F_ij = (e^{lam_i t} - e^{lam_j t}) /
    (lam_i - lam_j)`` (``t e^{lam t}`` on the diagonal), by ``expm1``."""

    @staticmethod
    def forward(ctx, s, t, dtype):
        lam, u = torch.linalg.eigh(s.detach().to(torch.float64))
        e = torch.exp(lam[None] * t.detach().to(torch.float64)[:, None])     # [M, S]
        ud = u.to(dtype)
        out = (ud[None] * e.to(dtype)[:, None, :]) @ ud.T[None]
        ctx.save_for_backward(lam, u, t)
        ctx.dtype = dtype
        return out

    @staticmethod
    def backward(ctx, grad):
        lam, u, t = ctx.saved_tensors
        dtype = ctx.dtype
        ud = u.to(dtype)
        g = ud.T[None] @ grad.to(dtype) @ ud[None]                            # [M, S, S]
        t64 = t.detach().to(torch.float64)
        e = torch.exp(lam[None] * t64[:, None])                                # [M, S]
        # (e^{x_i} - e^{x_j}) / (x_i - x_j) = e^{max} (1 - e^{-|x_i - x_j|}) / |x_i - x_j|
        x_i = lam[None, :, None] * t64[:, None, None]
        x_j = lam[None, None, :] * t64[:, None, None]
        gap = (x_i - x_j).abs()
        small = gap < 1e-8
        psi = torch.where(small, 1.0 - 0.5 * gap, -torch.expm1(-gap) / torch.where(small, 1.0, gap))
        f = t64[:, None, None] * torch.exp(torch.maximum(x_i, x_j)) * psi      # [M, S, S]
        grad_s = grad_t = None
        if ctx.needs_input_grad[0]:
            inner = (g * f.to(dtype)).sum(0)
            grad_s = (ud @ inner @ ud.T).to(torch.float64)
        if ctx.needs_input_grad[1]:
            diag = torch.diagonal(g, dim1=-2, dim2=-1).to(torch.float64)
            grad_t = (diag * lam[None] * e).sum(-1).to(t.dtype)
        return grad_s, grad_t, None


def propagators(q: torch.Tensor, freqs: torch.Tensor, times: torch.Tensor, dtype):
    """``expm(q t_m)`` ``[M, S, S]`` in ``dtype`` for a generator reversible
    under ``freqs``.  Codons of frequency 0 (a nucleotide never seen at one
    of their positions) can only be entered from one another: the others
    form a closed block, on which the propagators are taken, and the rest
    are left out of every likelihood (identity there)."""
    keep = freqs > 0
    if not bool(keep.all()):
        idx = torch.nonzero(keep)[:, 0]
        sub = propagators(q[idx][:, idx], freqs[idx], times, dtype)
        out = torch.eye(q.shape[-1], dtype=dtype, device=q.device).expand(
            times.shape[0], -1, -1).clone()
        out[:, idx[:, None], idx[None, :]] = sub
        return out
    root = torch.sqrt(freqs)
    s = root[:, None] * q / root[None, :]
    s = 0.5 * (s + s.T)
    e = SymmetricExpm.apply(s, times, dtype)
    # a transition probability is not negative: round-off below 0 is cut
    return torch.clamp_min((1.0 / root).to(dtype)[:, None] * e * root.to(dtype)[None, :], 0.0)


# ---------------------------------------------------------------------------
# pruning


class Pruner:
    """Felsenstein's pruning over ``tree``, level by level, every node's
    vector rescaled by its largest entry and the log of the scale carried in
    fp64."""

    def __init__(self, tree: synth.Tree, device):
        self.tree = tree
        self.device = device
        heights = tree.heights()
        self.levels = []
        for h in range(1, int(heights.max()) + 1):
            nodes = np.nonzero(heights == h)[0]
            for arity in sorted({len(tree.children[n]) for n in nodes}):
                group = np.array([n for n in nodes if len(tree.children[n]) == arity])
                kids = np.array([tree.children[n] for n in group])
                self.levels.append((torch.as_tensor(group, device=device),
                                    torch.as_tensor(kids, device=device)))

    def leaves(self, columns: np.ndarray, dtype) -> torch.Tensor:
        """``[taxa, P, S]`` leaf vectors: one-hot, all ones where missing."""
        st = torch.as_tensor(columns, device=self.device)[..., None]
        codes = torch.arange(_STATES, device=self.device)
        return ((st == codes) | (st < 0)).to(dtype)

    def site_logliks(self, p: torch.Tensor, leaves: torch.Tensor, freqs: torch.Tensor):
        """``[P]`` fp64 site lnLs under branch propagators ``p`` ``[B, S, S]``
        shared by every pattern, leaves ``[taxa, P, S]``."""
        n_taxa, n_pat, s = leaves.shape
        scale = torch.zeros((self.tree.n_nodes, n_pat), dtype=torch.float64, device=self.device)
        vec = torch.cat([leaves, torch.empty((self.tree.n_nodes - n_taxa, n_pat, s),
                                             dtype=leaves.dtype, device=self.device)])
        for nodes, kids in self.levels:
            msg = torch.einsum("wkij,wkpj->wkpi", p[kids], vec[kids]).prod(dim=1)
            top = torch.amax(msg, dim=-1)                                   # [W, P]
            top = torch.where(top > 0, top, torch.ones_like(top))
            vec = vec.index_put((nodes,), msg / top[..., None])
            scale = scale.index_put((nodes,), torch.log(top.to(torch.float64))
                                    + scale[kids].sum(dim=1))
        root = self.tree.root
        site = (vec[root] * freqs.to(vec.dtype)[None]).sum(-1).to(torch.float64)
        return torch.log(site) + scale[root]

    def per_item_logliks(self, p: torch.Tensor, leaves: torch.Tensor, freqs: torch.Tensor):
        """``[N]`` fp64 lnLs of N single columns, each under its own branch
        propagators ``p`` ``[N, B, S, S]``; leaves ``[taxa, N, S]``."""
        n_taxa, n, s = leaves.shape
        vec = torch.cat([leaves.transpose(0, 1),
                         torch.empty((n, self.tree.n_nodes - n_taxa, s), dtype=leaves.dtype,
                                     device=self.device)], dim=1)           # [N, nodes, S]
        scale = torch.zeros((n, self.tree.n_nodes), dtype=torch.float64, device=self.device)
        for nodes, kids in self.levels:
            msg = (p[:, kids] @ vec[:, kids][..., None])[..., 0].prod(dim=2)   # [N, W, S]
            top = torch.amax(msg, dim=-1)
            top = torch.where(top > 0, top, torch.ones_like(top))
            vec[:, nodes] = msg / top[..., None]
            scale[:, nodes] = torch.log(top.to(torch.float64)) + scale[:, kids].sum(dim=2)
        root = self.tree.root
        site = (vec[:, root] * freqs.to(vec.dtype)[None]).sum(-1).to(torch.float64)
        return torch.log(site) + scale[:, root]


# ---------------------------------------------------------------------------
# the quantities compared


def fel_site_logliks(pruner: Pruner, columns: np.ndarray, q_syn, q_non, freqs, alpha_hat,
                     a, b, dtype, block: int = 8) -> torch.Tensor:
    """FEL's per-site lnL (Kosakovsky Pond & Frost 2005): column ``n`` under
    branch generators ``alpha_hat_b (a_n Q_syn + b_n Q_nonsyn)``.
    ``columns`` ``[taxa, N]``; ``a``, ``b`` ``[N]``.  Returns ``[N]`` fp64."""
    out = []
    leaves = pruner.leaves(columns, dtype)
    for lo in range(0, columns.shape[1], block):
        ps = torch.stack([propagators(generator(q_syn, q_non, a[n], b[n]), freqs, alpha_hat, dtype)
                          for n in range(lo, min(lo + block, columns.shape[1]))])
        out.append(pruner.per_item_logliks(ps, leaves[:, lo: lo + block], freqs))
    return torch.cat(out)


def gene_loglik(pruner: Pruner, columns: np.ndarray, weights: np.ndarray, freqs,
                p_fn, class_log_weights=None, dtype=torch.float64, block: int = 512):
    """A gene's lnL ``sum_p w_p log sum_c W_c L_c(p)`` and its gradient.

    ``p_fn() -> (p [C, B, S, S], class log-weights [C] or None)``, built
    from parameters that require grad.  The pruning runs in pattern blocks
    against a detached copy of the propagators, whose gradient is then pushed
    back through ``p_fn``'s graph once.  Returns the lnL (fp64, detached)."""
    p, log_w = p_fn()
    p_leaf = p.detach().requires_grad_()
    lw_leaf = None if log_w is None else log_w.detach().requires_grad_()
    w = torch.as_tensor(weights, dtype=torch.float64, device=pruner.device)
    total = 0.0
    for lo in range(0, columns.shape[1], block):
        leaves = pruner.leaves(columns[:, lo: lo + block], dtype)
        sll = torch.stack([pruner.site_logliks(p_leaf[c], leaves, freqs)
                           for c in range(p_leaf.shape[0])])                # [C, Pb]
        if lw_leaf is None:
            site = sll[0]
        else:
            site = torch.logsumexp(sll + lw_leaf[:, None], dim=0)
        value = torch.dot(site, w[lo: lo + block])
        value.backward()
        total += float(value.detach())
    outs, grads = [p], [p_leaf.grad]
    if lw_leaf is not None and log_w.requires_grad:
        outs.append(log_w)
        grads.append(lw_leaf.grad)
    torch.autograd.backward(outs, grads)
    return total


def stick_breaking(fractions: Sequence[torch.Tensor]) -> torch.Tensor:
    """Weights ``[K]`` from K-1 fractions: ``w_1 = f_1``, ``w_k = f_k
    prod_{j<k} (1 - f_j)``, the last class the rest."""
    out, rest = [], torch.ones((), dtype=torch.float64, device=fractions[0].device)
    for f in fractions:
        out.append(rest * f)
        rest = rest * (1.0 - f)
    return torch.stack(out + [rest])
