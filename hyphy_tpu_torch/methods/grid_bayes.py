"""Posterior inference over rate-grid weights with a Dirichlet prior —
shared by FUBAR, B-STILL and FADE.

A copy of ``hyphy_tpu/methods/grid_bayes.py`` (numpy only): the same
``np.random.Generator`` calls in the same order, so the same inputs and
seed give the same draws.

Reference: ``SelectionAnalyses/modules/grid_compute.ibf`` —
``RunVariationalBayes`` (:355, 0th-order VB), ``RunCollapsedGibbs``
(:277), ``ExecuteMCMC`` (:95, Metropolis-Hastings over weight vectors).

Inputs are per-site conditional likelihoods on the grid, normalized per
site: ``cond[g, s]`` with columns summing to 1.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def variational_bayes(
    cond: np.ndarray, concentration: float = 0.5,
    max_iterations: int = 100000, tolerance: float = 1e-8,
) -> np.ndarray:
    """0th-order VB fixed point (grid_compute.ibf:355): returns the
    posterior-mean grid weight vector [G]."""
    w = cond.sum(axis=1)
    for _ in range(max_iterations):
        last = w
        num = last[:, None] * cond
        site_post = num / num.sum(axis=0, keepdims=True)
        w = site_post.sum(axis=1) + concentration
        w = w / w.sum()
        if np.abs(w - last).max() <= tolerance:
            break
    return w


def collapsed_gibbs(
    cond: np.ndarray,
    concentration: float = 0.5,
    chain_length: int = 2_000_000,
    burn_in: int = 1_000_000,
    samples: int = 100,
    rng: np.random.Generator | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Collapsed Gibbs over grid weights (grid_compute.ibf:277): returns
    (posterior mean [G], sample matrix [n_samples, G])."""
    rng = rng or np.random.default_rng(0)
    n_grid = cond.shape[0]
    current = rng.dirichlet(np.full(n_grid, concentration))
    stride = max((chain_length - burn_in) // samples, 1)
    acc = []
    for step in range(1, chain_length + 1):
        num = current[:, None] * cond
        site_post = num / num.sum(axis=0, keepdims=True)
        current = rng.dirichlet(site_post.sum(axis=1) + concentration)
        if step > burn_in and (step - burn_in + 1) % stride == 0:
            acc.append(current)
            if len(acc) >= samples:
                break
    acc = np.asarray(acc)
    return acc.mean(axis=0), acc


def metropolis_hastings(
    cond: np.ndarray,
    weights: np.ndarray,
    concentration: float = 0.5,
    chain_length: int = 2_000_000,
    burn_in: int = 1_000_000,
    samples: int = 100,
    rng: np.random.Generator | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """MH over grid weight vectors (grid_compute.ibf:95): proposal moves
    mass between two random cells; returns (posterior mean, samples).
    ``weights``: per-site pattern weights (sites may be pattern-compressed).
    """
    rng = rng or np.random.default_rng(0)
    n_grid = cond.shape[0]
    current = np.full(n_grid, 1.0 / n_grid)

    def log_posterior(w):
        site_l = w @ cond
        return float(
            np.dot(np.log(np.maximum(site_l, 1e-300)), weights)
            + (concentration - 1.0) * np.log(np.maximum(w, 1e-300)).sum()
        )

    lp = log_posterior(current)
    stride = max((chain_length - burn_in) // samples, 1)
    acc = []
    accepted = 0
    for step in range(1, chain_length + 1):
        i, j = rng.integers(0, n_grid, 2)
        if i == j:
            continue
        delta = rng.uniform(0, current[i])
        prop = current.copy()
        prop[i] -= delta
        prop[j] += delta
        lp_new = log_posterior(prop)
        if np.log(rng.uniform()) < lp_new - lp:
            current, lp = prop, lp_new
            accepted += 1
        if step > burn_in and (step - burn_in + 1) % stride == 0:
            acc.append(current.copy())
            if len(acc) >= samples:
                break
    acc = np.asarray(acc) if acc else current[None]
    return acc.mean(axis=0), acc


def posterior_over_grid(
    method: str,
    cond: np.ndarray,
    concentration: float = 0.5,
    chain_length: int = 2_000_000,
    burn_in: int = 1_000_000,
    samples: int = 100,
    site_weights: np.ndarray | None = None,
    rng: np.random.Generator | None = None,
) -> Tuple[np.ndarray, np.ndarray | None]:
    """Dispatch on the method name; returns (posterior mean, samples|None)."""
    if method == "Variational-Bayes":
        return variational_bayes(cond, concentration), None
    if method == "Collapsed-Gibbs":
        return collapsed_gibbs(
            cond, concentration, chain_length, burn_in, samples, rng
        )
    if method in ("Metropolis-Hastings", "MCMC"):
        w = site_weights if site_weights is not None else np.ones(cond.shape[1])
        return metropolis_hastings(
            cond, w, concentration, chain_length, burn_in, samples, rng
        )
    raise ValueError(f"unknown grid posterior method {method!r}")
