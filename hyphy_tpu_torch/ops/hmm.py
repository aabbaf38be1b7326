"""Hidden-Markov rate variation across sites.

Counterpart of ``hyphy_tpu/ops/hmm.py`` (reference: ``SumUpHiddenMarkov``,
``src/core/likefunc2.cpp:1166``, the forward-algorithm lnL of the per-site,
per-rate-class likelihood lattice under a Markov chain over rate classes
along the ORIGINAL site order, patterns expanded through ``duplicateMap``;
``RunViterbi``, ``likefunc2.cpp:1284``, the most probable class path;
BUSTED's HMM synonymous-rate option).

Every recursion is a plain loop over sites in log space, with per-step
normalisation folded into a running shift (no 2^64 scalers).  Each step is
O(C^2) for C <= 10 classes, so the loops run on the host in fp64: the
lattice comes from the batched pruning on the card in one piece, and the
forward lnL's gradient flows back to it through autograd.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_HOST = dict(dtype=torch.float64, device="cpu")


def uniform_switching_matrix(n_classes: int, lam) -> torch.Tensor:
    """The stay/switch chain libv3 uses for HMM rate variation
    (``rate_variation.bf:52-56``): stay with probability ``1 - lam``,
    switch to any other class with probability ``lam / (C - 1)``."""
    lam = torch.as_tensor(lam, dtype=torch.float64)
    eye = torch.eye(n_classes, dtype=lam.dtype, device=lam.device)
    return lam / (n_classes - 1) * (1.0 - eye) + (1.0 - lam) * eye


def _lattice(class_site_logliks, duplicate_map, transition, initial):
    """Host fp64 ``[C, sites]`` log-likelihoods and the log transition and
    start tensors."""
    dm = torch.as_tensor(np.asarray(duplicate_map, dtype=np.int64))
    site_ll = class_site_logliks.to(**_HOST)[:, dm]
    log_t = torch.log(torch.clamp_min(torch.as_tensor(transition).to(**_HOST), 1e-300))
    log_init = torch.log(torch.clamp_min(torch.as_tensor(initial).to(**_HOST), 1e-300))
    return site_ll, log_t, log_init


def forward_log_likelihood(
    class_site_logliks: torch.Tensor,  # [C, patterns] log L(site | class)
    duplicate_map: np.ndarray,         # [sites] int site -> pattern
    transition: torch.Tensor,          # [C, C] row-stochastic P(next | cur)
    initial: torch.Tensor,             # [C] start distribution
) -> torch.Tensor:
    """Forward-algorithm lnL (reference ``SumUpHiddenMarkov``): sites in
    original order, hidden state = rate class.  A 0-d fp64 tensor on the
    lattice's device, differentiable in every input."""
    site_ll, log_t, log_init = _lattice(class_site_logliks, duplicate_map, transition, initial)
    first = log_init + site_ll[:, 0]
    shift0 = torch.max(first)
    log_alpha = first - shift0
    shifts = [shift0]
    for s in range(1, site_ll.shape[1]):
        new = torch.logsumexp(log_alpha[:, None] + log_t, dim=0) + site_ll[:, s]
        shift = torch.max(new)
        log_alpha = new - shift
        shifts.append(shift)
    total = torch.logsumexp(log_alpha, dim=0) + torch.stack(shifts).sum()
    return total.to(class_site_logliks.device)


def viterbi_path(
    class_site_logliks: torch.Tensor,
    duplicate_map: np.ndarray,
    transition: torch.Tensor,
    initial: torch.Tensor,
) -> Tuple[np.ndarray, float]:
    """Most probable class path (reference ``RunViterbi``).  Returns (path
    ``[sites]`` int32, joint log score); ties go to the lower class, as
    ``argmax`` breaks them in the JAX package."""
    with torch.no_grad():
        site_ll, log_t, log_init = (x.numpy() for x in _lattice(
            class_site_logliks, duplicate_map, transition, initial))
    n_sites = site_ll.shape[1]
    delta = log_init + site_ll[:, 0]
    backptr = np.empty((n_sites - 1, site_ll.shape[0]), dtype=np.int32)
    for s in range(1, n_sites):
        cand = delta[:, None] + log_t                   # [from, to]
        backptr[s - 1] = np.argmax(cand, axis=0)
        delta = np.max(cand, axis=0) + site_ll[:, s]
    state = int(np.argmax(delta))
    score = float(delta[state])
    path = np.empty(n_sites, dtype=np.int32)
    path[-1] = state
    for s in range(n_sites - 2, -1, -1):
        state = int(backptr[s, state])
        path[s] = state
    return path, score


def posterior_class_probabilities(
    class_site_logliks: torch.Tensor,
    duplicate_map: np.ndarray,
    transition: torch.Tensor,
    initial: torch.Tensor,
) -> torch.Tensor:
    """Forward-backward per-site class posteriors (reference:
    ``ConstructCategoryMatrix`` over HMM categories, ``likefunc2.cpp:309``
    +).  Returns ``[sites, C]`` fp64 on the lattice's device."""
    with torch.no_grad():
        site_ll, log_t, log_init = _lattice(class_site_logliks, duplicate_map,
                                            transition, initial)
        n_sites = site_ll.shape[1]
        first = log_init + site_ll[:, 0]
        alphas = [first - torch.max(first)]
        for s in range(1, n_sites):
            new = torch.logsumexp(alphas[-1][:, None] + log_t, dim=0) + site_ll[:, s]
            alphas.append(new - torch.max(new))
        betas = [torch.zeros_like(first)]
        for s in range(n_sites - 1, 0, -1):
            new = torch.logsumexp(log_t + (site_ll[:, s] + betas[-1])[None, :], dim=1)
            betas.append(new - torch.max(new))
        post = torch.stack(alphas) + torch.stack(betas[::-1])
        post = post - torch.logsumexp(post, dim=1, keepdim=True)
    return torch.exp(post).to(class_site_logliks.device)
