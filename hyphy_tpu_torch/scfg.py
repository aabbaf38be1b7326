"""Stochastic context-free grammars (inside-outside, CYK, EM).

A copy of the numpy-only ``hyphy_tpu/scfg.py`` (the port imports nothing
of the JAX package), counterpart of the reference's SCFG module
(``src/new/scfg.cpp``): a Chomsky-normal-form SCFG whose corpus
log-likelihood is computed by the inside algorithm (the reference stores
inside/outside probabilities in AVL-backed sparse maps, ``scfg.h:206-224``,
and exposes the corpus likelihood as a `_LikelihoodFunction` subclass so
HBL's `Optimize` can fit production probabilities).

The inside/outside DP runs on the host over dense ``[span, start,
nonterminal]`` arrays — spans are processed longest-last with one batched
einsum per span length (a contraction over split points and rule tensors)
— and production probabilities are fitted by inside-outside EM.  It stays
on the host, as in the JAX package: the grammars are small and the
recursion is sequential in span length.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.special import logsumexp

_TINY = 1e-300


@dataclasses.dataclass
class SCFG:
    """CNF grammar: start symbol is nonterminal 0.

    ``binary[a, b, c]``  = P(A_a -> B_b C_c)
    ``emission[a, t]``   = P(A_a -> t)
    Each nonterminal's outgoing probabilities (binary + emission) sum to 1.
    """

    binary: np.ndarray     # [N, N, N]
    emission: np.ndarray   # [N, T]

    def __post_init__(self):
        self.binary = np.asarray(self.binary, dtype=np.float64)
        self.emission = np.asarray(self.emission, dtype=np.float64)
        n = self.binary.shape[0]
        assert self.binary.shape == (n, n, n)
        assert self.emission.shape[0] == n

    @property
    def n_nonterminals(self) -> int:
        return self.binary.shape[0]

    @property
    def n_terminals(self) -> int:
        return self.emission.shape[1]

    def normalize(self) -> "SCFG":
        total = self.binary.reshape(self.n_nonterminals, -1).sum(1) + \
            self.emission.sum(1)
        total = np.maximum(total, _TINY)
        return SCFG(
            self.binary / total[:, None, None], self.emission / total[:, None]
        )

    # -- inside / outside ---------------------------------------------------

    def inside(self, tokens: Sequence[int]) -> np.ndarray:
        """Inside probabilities ``beta[l-1, i, a]`` = P(A_a =>* tokens[i:i+l])
        (reference: ``Scfg::ComputeInsideProb``, scfg.cpp).  Returned in
        *log* space, dense [L, L, N] (entries for i+l > L are -inf)."""
        toks = np.asarray(tokens, dtype=np.int64)
        L, n = len(toks), self.n_nonterminals
        with np.errstate(divide="ignore"):
            log_b = np.log(np.maximum(self.binary, _TINY))
            beta = np.full((L, L, n), -np.inf)
            beta[0, :, :] = np.log(np.maximum(self.emission[:, toks].T, _TINY))
            # mark truly-zero emissions as impossible
            beta[0, :, :][self.emission[:, toks].T <= 0] = -np.inf
        for l in range(2, L + 1):
            starts = L - l + 1
            # score[k, i, b, c] = beta[k-1, i, b] + beta[l-k-1, i+k, c]
            parts = []
            for k in range(1, l):
                left = beta[k - 1, :starts, :]                    # [S, B]
                right = beta[l - k - 1, k : k + starts, :]        # [S, C]
                parts.append(left[:, :, None] + right[:, None, :])
            stacked = np.stack(parts, axis=0)                     # [K, S, B, C]
            # contract rules: out[i, a] = lse_{k,b,c} (stacked + log_b[a])
            flat = stacked.reshape(-1, starts, n * n)             # [K, S, BC]
            lse_bc = logsumexp(
                flat[:, :, None, :] + log_b.reshape(1, 1, n, n * n), axis=3
            )                                                     # [K, S, A]
            beta[l - 1, :starts, :] = logsumexp(lse_bc, axis=0)
        return beta

    def outside(self, tokens: Sequence[int], beta: np.ndarray) -> np.ndarray:
        """Outside log-probabilities ``alpha[l-1, i, a]``
        (reference: ``Scfg::ComputeOutsideProb``)."""
        toks = np.asarray(tokens, dtype=np.int64)
        L, n = len(toks), self.n_nonterminals
        with np.errstate(divide="ignore"):
            log_b = np.log(np.maximum(self.binary, _TINY))
        alpha = np.full((L, L, n), -np.inf)
        alpha[L - 1, 0, 0] = 0.0  # start symbol spans everything
        for l in range(L - 1, 0, -1):
            for i in range(0, L - l + 1):
                acc = np.full(n, -np.inf)
                # as the RIGHT child: parent spans (i-k, l+k)
                for k in range(1, i + 1):
                    par = alpha[l + k - 1, i - k, :]              # [P]
                    sib = beta[k - 1, i - k, :]                   # [B]
                    term = logsumexp(
                        par[:, None, None] + log_b
                        + sib[None, :, None], axis=(0, 1),
                    )                                             # [C]
                    acc = np.logaddexp(acc, term)
                # as the LEFT child: parent spans (i, l+k)
                for k in range(1, L - (i + l) + 1):
                    par = alpha[l + k - 1, i, :]                  # [P]
                    sib = beta[k - 1, i + l, :]                   # [C]
                    term = logsumexp(
                        par[:, None, None] + np.swapaxes(log_b, 1, 2)
                        + sib[None, :, None], axis=(0, 1),
                    )                                             # [B]
                    acc = np.logaddexp(acc, term)
                alpha[l - 1, i, :] = acc
        return alpha

    def log_likelihood(self, tokens: Sequence[int]) -> float:
        """log P(string | grammar) from the start symbol."""
        beta = self.inside(tokens)
        return float(beta[len(tokens) - 1, 0, 0])

    def corpus_log_likelihood(self, corpus: Sequence[Sequence[int]]) -> float:
        """Sum over independent strings (reference: the SCFG's LF Compute)."""
        return float(sum(self.log_likelihood(s) for s in corpus))

    # -- CYK ------------------------------------------------------------------

    def cyk(self, tokens: Sequence[int]) -> Tuple[float, List]:
        """Most probable parse (reference: ``Scfg::CykTraceback``).
        Returns (log probability, parse tree) with tree nodes
        ``(nonterminal, start, length, children)``."""
        toks = np.asarray(tokens, dtype=np.int64)
        L, n = len(toks), self.n_nonterminals
        with np.errstate(divide="ignore"):
            log_b = np.log(np.maximum(self.binary, _TINY))
            gamma = np.full((L, L, n), -np.inf)
            gamma[0, :, :] = np.log(np.maximum(self.emission[:, toks].T, _TINY))
        back: Dict[Tuple[int, int, int], Tuple[int, int, int]] = {}
        for l in range(2, L + 1):
            for i in range(0, L - l + 1):
                best = np.full(n, -np.inf)
                arg = {}
                for k in range(1, l):
                    cand = (
                        log_b
                        + gamma[k - 1, i, :][None, :, None]
                        + gamma[l - k - 1, i + k, :][None, None, :]
                    )                                             # [A, B, C]
                    flat = cand.reshape(n, -1)
                    m = flat.max(axis=1)
                    better = m > best
                    if better.any():
                        idx = flat.argmax(axis=1)
                        for a in np.nonzero(better)[0]:
                            b, c = divmod(int(idx[a]), n)
                            arg[int(a)] = (k, b, c)
                        best = np.maximum(best, m)
                gamma[l - 1, i, :] = best
                for a, (k, b, c) in arg.items():
                    back[(l, i, a)] = (k, b, c)

        def build(l, i, a):
            if l == 1:
                return (a, i, 1, [])
            k, b, c = back[(l, i, a)]
            return (a, i, l, [build(k, i, b), build(l - k, i + k, c)])

        score = float(gamma[L - 1, 0, 0])
        tree = build(L, 0, 0) if np.isfinite(score) else None
        return score, tree

    # -- EM fit ----------------------------------------------------------------

    def em_step(self, corpus: Sequence[Sequence[int]]) -> "SCFG":
        """One inside-outside EM update of all production probabilities
        (reference: the SCFG optimization loop over `Optimize`)."""
        n, t = self.n_nonterminals, self.n_terminals
        exp_bin = np.zeros((n, n, n))
        exp_emit = np.zeros((n, t))
        with np.errstate(divide="ignore"):
            log_b = np.log(np.maximum(self.binary, _TINY))
        for tokens in corpus:
            toks = np.asarray(tokens, dtype=np.int64)
            L = len(toks)
            beta = self.inside(toks)
            ll = beta[L - 1, 0, 0]
            if not np.isfinite(ll):
                continue
            alpha = self.outside(toks, beta)
            # emissions
            post1 = np.exp(alpha[0, :, :] + beta[0, :, :] - ll)   # [L, A]
            for i in range(L):
                exp_emit[:, toks[i]] += post1[i]
            # binary rules
            for l in range(2, L + 1):
                for i in range(0, L - l + 1):
                    for k in range(1, l):
                        joint = (
                            alpha[l - 1, i, :][:, None, None]
                            + log_b
                            + beta[k - 1, i, :][None, :, None]
                            + beta[l - k - 1, i + k, :][None, None, :]
                            - ll
                        )
                        exp_bin += np.exp(joint)
        total = exp_bin.reshape(n, -1).sum(1) + exp_emit.sum(1)
        total = np.maximum(total, _TINY)
        new = SCFG(exp_bin / total[:, None, None], exp_emit / total[:, None])
        # keep structurally-zero rules zero
        new.binary[self.binary <= 0] = 0.0
        new.emission[self.emission <= 0] = 0.0
        return new.normalize()

    def fit_em(
        self,
        corpus: Sequence[Sequence[int]],
        max_iterations: int = 50,
        tol: float = 1e-6,
    ) -> Tuple["SCFG", List[float]]:
        g = self.normalize()
        trace = [g.corpus_log_likelihood(corpus)]
        for _ in range(max_iterations):
            g = g.em_step(corpus)
            trace.append(g.corpus_log_likelihood(corpus))
            if trace[-1] - trace[-2] < tol:
                break
        return g, trace
