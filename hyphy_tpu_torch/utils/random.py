"""Random deviates mirroring the reference's `_Matrix::Random` modes.

A copy of the numpy-only ``hyphy_tpu/utils/random.py`` (the port imports
nothing of the JAX package): for one seed it gives the same draws.

The reference's HBL ``Random`` builtin (``src/core/matrix.cpp:7646``)
dispatches on an options dict: Latin-hypercube resampling (used for
optimizer starting grids), Dirichlet, Gaussian (``GaussianDeviate``,
``matrix.cpp:9707``), Wishart / inverse-Wishart, and multinomial draws, all
driven by the Mersenne Twister seeded via ``RANDOM_SEED``
(``src/contrib/mersenne_twister.cpp``).  Here the same draws come from a
numpy Generator seeded by ``settings.random_seed`` — statistical outputs
are tested with loose tolerances (SURVEY §8.10), so bit parity with the
reference stream is explicitly not a goal.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from hyphy_tpu_torch.config import settings


def generator(seed: Optional[int] = None) -> np.random.Generator:
    return np.random.default_rng(
        settings.random_seed if seed is None else seed
    )


def latin_hypercube(
    n_samples: int,
    lower: np.ndarray,
    upper: np.ndarray,
    seed: Optional[int] = None,
) -> np.ndarray:
    """LHS sample in box [lower, upper] (reference: ``Random(..., "LHS")``
    starting grids for Optimize / BUSTED ``--starting-points``)."""
    rng = generator(seed)
    lower = np.asarray(lower, dtype=np.float64)
    upper = np.asarray(upper, dtype=np.float64)
    d = lower.shape[0]
    u = (rng.permuted(np.tile(np.arange(n_samples), (d, 1)), axis=1).T
         + rng.uniform(size=(n_samples, d))) / n_samples
    return lower + u * (upper - lower)


def dirichlet(alpha: np.ndarray, size=None, seed: Optional[int] = None) -> np.ndarray:
    """Dirichlet draw (reference: FUBAR/FADE grid-weight priors)."""
    return generator(seed).dirichlet(np.asarray(alpha, dtype=np.float64), size=size)


def gaussian(mean: np.ndarray, cov: np.ndarray, size=None, seed: Optional[int] = None):
    """Multivariate normal (reference ``GaussianDeviate``, matrix.cpp:9707)."""
    return generator(seed).multivariate_normal(
        np.asarray(mean, dtype=np.float64), np.asarray(cov, dtype=np.float64),
        size=size,
    )


def wishart(df: float, scale: np.ndarray, seed: Optional[int] = None) -> np.ndarray:
    """Wishart draw via the Bartlett decomposition (reference
    ``WishartDeviate``, matrix.cpp)."""
    rng = generator(seed)
    s = np.asarray(scale, dtype=np.float64)
    p = s.shape[0]
    chol = np.linalg.cholesky(s)
    a = np.zeros((p, p))
    for i in range(p):
        a[i, i] = np.sqrt(rng.chisquare(df - i))
        for j in range(i):
            a[i, j] = rng.normal()
    la = chol @ a
    return la @ la.T


def inverse_wishart(df: float, scale: np.ndarray, seed: Optional[int] = None) -> np.ndarray:
    return np.linalg.inv(wishart(df, np.linalg.inv(scale), seed=seed))


def multinomial(n: int, p: np.ndarray, size=None, seed: Optional[int] = None):
    """Multinomial counts (reference ``Random(..., "multinomial")``)."""
    return generator(seed).multinomial(n, np.asarray(p, dtype=np.float64), size=size)
