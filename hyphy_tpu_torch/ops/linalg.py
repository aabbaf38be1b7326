"""Dense linear-algebra utilities mirroring the reference's `_Matrix` ops.

Counterpart of ``hyphy_tpu/ops/linalg.py``.  The reference exposes
`Eigensystem`, `Inverse`, `LUDecompose`/`LUSolve` (``src/core/matrix.cpp``),
an LP solver `SimplexSolve` (``src/core/matrix.cpp:9326``) and `FisherExact`
(``src/core/fisher_exact.cpp``) as HBL builtins.  These are library calls in
both packages: ``torch.linalg`` for the dense ops, on the inputs' device,
and scipy and numpy on the host where the JAX package uses them.  No method
calls them; they have no kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def eigensystem(a) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues/vectors of a general square matrix (reference HBL
    ``Eigensystem``; symmetric input takes the symmetric solver).  Returns
    (values, vectors) with columns as eigenvectors; a nonsymmetric input is
    solved on the host by numpy, as the JAX package does, and comes back
    as complex tensors when numpy's result is complex."""
    a = torch.as_tensor(a)
    host = a.detach().cpu().numpy()
    if np.allclose(host, host.T, atol=1e-12):
        return torch.linalg.eigh(a)
    w, v = np.linalg.eig(np.asarray(host, dtype=np.float64))
    return torch.as_tensor(w, device=a.device), torch.as_tensor(v, device=a.device)


def inverse(a) -> torch.Tensor:
    """Matrix inverse (reference HBL ``Inverse``)."""
    return torch.linalg.inv(torch.as_tensor(a))


def lu_decompose(a):
    """LU factorization with partial pivoting (reference ``LUDecompose``).
    Returns (lu, pivots) in LAPACK's layout: 0-based pivot rows, as
    ``scipy.linalg.lu_factor`` and the JAX package give them (torch's are
    1-based)."""
    lu, piv = torch.linalg.lu_factor(torch.as_tensor(a))
    return lu, piv - 1


def lu_solve(lu_and_piv, b) -> torch.Tensor:
    """Solve A x = b from an LU factorization (reference ``LUSolve``); a
    vector ``b`` gives a vector."""
    lu, piv = lu_and_piv
    b = torch.as_tensor(b, dtype=lu.dtype, device=lu.device)
    vector = b.dim() == 1
    x = torch.linalg.lu_solve(lu, (piv + 1).to(torch.int32), b[:, None] if vector else b)
    return x[:, 0] if vector else x


def simplex_solve(
    objective: np.ndarray,
    a_ub: Optional[np.ndarray] = None,
    b_ub: Optional[np.ndarray] = None,
    a_eq: Optional[np.ndarray] = None,
    b_eq: Optional[np.ndarray] = None,
    maximize: bool = False,
    bounds=(0, None),
):
    """Linear program (reference ``SimplexSolve``, ``matrix.cpp:9326`` — a
    two-phase simplex over x >= 0).  On the host (scipy's HiGHS); returns
    (optimum, x) or None when infeasible."""
    from scipy.optimize import linprog

    c = np.asarray(objective, dtype=np.float64)
    res = linprog(
        -c if maximize else c,
        A_ub=a_ub, b_ub=b_ub, A_eq=a_eq, b_eq=b_eq,
        bounds=bounds, method="highs",
    )
    if not res.success:
        return None
    value = -res.fun if maximize else res.fun
    return float(value), np.asarray(res.x)


def fisher_exact_2x2(table: np.ndarray, alternative: str = "two-sided") -> float:
    """Exact p-value of a 2x2 contingency table (reference
    ``_Matrix::FisherExact``; the 2x2 case is the hypergeometric tail)."""
    from scipy.stats import fisher_exact as _fe

    return float(_fe(np.asarray(table, dtype=np.int64), alternative=alternative)[1])


def fisher_exact(table: np.ndarray, n_simulations: int = 100000, seed: int = 0) -> float:
    """Exact (2x2) or Monte-Carlo (RxC) contingency-table p-value.

    The reference implements the FEXACT network algorithm for general RxC
    tables (``fisher_exact.cpp``); for R,C > 2 the same p-value is
    estimated by simulating tables with fixed margins (Patefield sampling
    via scipy), with the JAX package's draws for a seed."""
    t = np.asarray(table, dtype=np.int64)
    if t.shape == (2, 2):
        return fisher_exact_2x2(t)
    from scipy.special import gammaln
    from scipy.stats import random_table

    rows, cols = t.sum(axis=1), t.sum(axis=0)
    rng = np.random.default_rng(seed)

    def log_prob(x):
        return (
            gammaln(rows + 1).sum() + gammaln(cols + 1).sum()
            - gammaln(t.sum() + 1) - gammaln(x + 1).sum()
        )

    obs = log_prob(t)
    sims = random_table(rows, cols).rvs(n_simulations, random_state=rng)
    hits = sum(1 for s in np.atleast_3d(sims) if log_prob(s) <= obs + 1e-12)
    return (hits + 1) / (n_simulations + 1)
