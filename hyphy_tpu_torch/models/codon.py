"""Codon substitution models: the MG94xREV family.

Counterpart of ``hyphy_tpu/models/codon.py``: ``MG94Base`` with the
multiple-hit basis matrices and the grouped and per-branch propagators,
``MG94xREV`` (one omega) and ``MG94xREVLocal`` (per-branch alpha and
beta), ``MG94xREVPartitionedOmega`` with its ``multiple_hits`` option,
and FitMultiModel's ``MG94xREVMultiHit`` and ``MG94xREVMultiHitGDD`` (a
site-level omega distribution of K classes).

Q construction (parity-critical, reference ``MG_REV.bf:66-105``): entry
(x -> y) is nonzero iff codons differ at exactly one nucleotide position,
and equals

    theta_<nucpair> * (alpha | beta) * n_pos(target_nucleotide)

with ``theta_AG := 1`` and ``n`` the position-specific nucleotide
frequencies.  The model is NOT canonical; the diagonal is -row-sum.  Every
branch's generator is ``alpha_b * Q_syn + beta_b * Q_nonsyn``: when
``beta_b / alpha_b`` takes only G distinct values, all branches share G
generators.
"""

from __future__ import annotations

import numpy as np
import torch

from hyphy_tpu_torch.config import resolve_device
from hyphy_tpu_torch.data.genetic_code import GeneticCode
from hyphy_tpu_torch.models.base import (
    ModelOutput,
    SubstitutionModel,
    fill_diagonal_from_rows,
)
from hyphy_tpu_torch.models.dna import GTR_RATES
from hyphy_tpu_torch.models.parameters import ParamSpec, Params, Specs, stick_breaking_weights
from hyphy_tpu_torch.ops import expm as expm_ops

_PAIR_INDEX = {p: i for i, p in enumerate(GTR_RATES)}
_NUC = "ACGT"


class MG94Base(SubstitutionModel):
    """Shared machinery: sparse basis matrices Q_syn / Q_nonsyn."""

    datatype = "codon"
    reversible = True

    def __init__(self, gc: GeneticCode, corner_freqs: np.ndarray,
                 codon_freqs: np.ndarray, device=None):
        self.device = dev = resolve_device(device)
        self.gc = gc
        self.n_states = gc.n_states
        self.corner_freqs = np.asarray(corner_freqs)  # [4, 3]
        self.frequencies = torch.as_tensor(
            np.asarray(codon_freqs, dtype=np.float64).reshape(-1), device=dev
        )
        tbl = gc.one_step_table
        self._pair_i = torch.as_tensor(tbl["pairs"][:, 0].astype(np.int64), device=dev)
        self._pair_j = torch.as_tensor(tbl["pairs"][:, 1].astype(np.int64), device=dev)
        theta_idx = [
            _PAIR_INDEX[_NUC[min(fn, tn)] + _NUC[max(fn, tn)]]
            for fn, tn in zip(tbl["from_nuc"], tbl["to_nuc"])
        ]
        self._theta_idx = torch.tensor(theta_idx, dtype=torch.int64, device=dev)
        # position-specific frequency of the *target* nucleotide
        self._multiplier = torch.as_tensor(
            self.corner_freqs[tbl["to_nuc"], tbl["position"]].astype(np.float64),
            device=dev,
        )
        self._syn = torch.as_tensor(tbl["synonymous"].astype(np.float64), device=dev)

    # -- construction pieces ------------------------------------------------

    @staticmethod
    def theta_specs() -> Specs:
        """GTR exchangeabilities shared with the nucleotide fit; AG := 1."""
        return {
            f"theta_{p}": ParamSpec(init=0.25, lower=0.0, upper=10000.0)
            for p in GTR_RATES
            if p != "AG"
        }

    def _theta_vector(self, params: Params) -> torch.Tensor:
        dtype = params["theta_AC"].dtype
        one = torch.ones((), dtype=dtype, device=self.device)
        return torch.stack(
            [one if p == "AG" else params[f"theta_{p}"] for p in GTR_RATES]
        )

    def basis_matrices(self, params: Params):
        """(Q_syn, Q_nonsyn) [S,S] with zero diagonals, in the parameter
        dtype (an fp32 evaluation stays fp32 throughout)."""
        theta = self._theta_vector(params)
        dtype = theta.dtype
        entries = theta[self._theta_idx] * self._multiplier.to(dtype)
        s = self.n_states
        zeros = torch.zeros((s, s), dtype=dtype, device=self.device)
        syn = self._syn.to(dtype)
        idx = (self._pair_i, self._pair_j)
        q_syn = zeros.index_put(idx, entries * syn)
        q_non = zeros.index_put(idx, entries * (1.0 - syn))
        return q_syn, q_non

    def propagators_grouped(
        self,
        bases,                         # (Q_syn, Q_nonsyn) [S, S]
        alpha_b: torch.Tensor,         # [B] branch syn rates (the expm time)
        ratio_groups: torch.Tensor,    # [G] beta/alpha per group
        group_of_branch: np.ndarray,   # [B] int in [0, G), concrete
    ) -> torch.Tensor:
        """P_b = expm(alpha_b * (Q_syn + r_{g(b)} * Q_nonsyn)) — G
        generators shared by all branches.  Branches are partitioned per
        group on the host, so each group's propagators use shared factors
        instead of per-branch copies.  The JAX package passes the parameters
        and builds the single-hit bases here; the bases are passed in so the
        multi-hit ones take the same route."""
        q_syn, q_non = bases
        m = fill_diagonal_from_rows(
            q_syn[None] + ratio_groups[:, None, None] * q_non[None]
        )  # [G,S,S]
        # fp64: one eigh per group, shared-factor matmuls.  fp32: the
        # shared-power Taylor route, which stays at fp32 round-off (an fp32
        # eigendecomposition of a 61-state generator loses far more).
        use_spectral = m.dtype == torch.float64
        if use_spectral:
            left, lam, right = expm_ops.reversible_spectral(m, self.frequencies)

        def group_propagators(g, times):
            if use_spectral:
                return expm_ops.spectral_propagators(left[g], lam[g], right[g], times)
            return expm_ops.shared_taylor_propagators(m[g], times)

        groups = np.asarray(group_of_branch)
        n_groups = int(ratio_groups.shape[0])
        if n_groups == 1:
            return group_propagators(0, alpha_b)
        parts, order = [], []
        for g in range(n_groups):
            idx = np.nonzero(groups == g)[0]
            if idx.size == 0:
                continue
            order.append(idx)
            parts.append(group_propagators(g, alpha_b[torch.as_tensor(idx, device=self.device)]))
        perm = np.argsort(np.concatenate(order), kind="stable")
        return torch.cat(parts, dim=0)[torch.as_tensor(perm, device=self.device)]

    def propagators_local(self, bases, alpha_b: torch.Tensor,
                          beta_b: torch.Tensor) -> torch.Tensor:
        """P_b = expm(alpha_b Q_syn + beta_b Q_nonsyn), one generator per
        branch (``[B, S, S]``), from the bases ``(Q_syn, Q_nonsyn)`` (the
        JAX package passes the parameters and builds the single-hit bases
        here).

        Route: in fp64 the JAX package's — a batched ``eigh`` of the B
        symmetrised generators and spectral propagators at time 1.  In fp32
        the batched shared-power Taylor series
        (:func:`expm_ops.taylor_propagators_batched`, one generator per
        family at time 1), as :meth:`propagators_grouped` takes the Taylor
        route in fp32: the JAX package takes ``eigh`` in every dtype,
        though an fp32 eigendecomposition of a 61-state generator loses
        ~1e-2, which its own grouped route avoids."""
        q_syn, q_non = bases
        q = fill_diagonal_from_rows(
            alpha_b[:, None, None] * q_syn[None] + beta_b[:, None, None] * q_non[None]
        )
        ones = torch.ones_like(alpha_b)
        if q.dtype != torch.float64:
            return expm_ops.taylor_propagators_batched(q, ones)
        left, lam, right = expm_ops.reversible_spectral(q, self.frequencies)
        return expm_ops.spectral_propagators(left, lam, right, ones)

    def rate_per_branch(self, bases, alpha_b, beta_b) -> torch.Tensor:
        """Branch length in expected substitutions per NUCLEOTIDE site under
        the bases ``(Q_syn, Q_nonsyn)`` — codon-model branch lengths carry a
        1/3 factor (reference: ``model.BranchLengthExpression``,
        model_functions.bf:696).  The JAX package passes the parameters and
        builds the single-hit bases here; the bases are passed in so the
        multi-hit ones take the same rule."""
        q_syn, q_non = bases
        pi = self.frequencies.to(q_syn.dtype)
        rs = q_syn.sum(-1) @ pi
        rn = q_non.sum(-1) @ pi
        return (alpha_b * rs + beta_b * rn) / 3.0

    def syn_nonsyn_unit_rates(self, params: Params):
        """(rate_syn, rate_nonsyn) per unit alpha / beta at ``params``'
        thetas: the single-hit bases' row sums weighted by the codon
        frequencies (FUBAR's and B-STILL's branch scaling)."""
        q_syn, q_non = self.basis_matrices(params)
        pi = self.frequencies.to(q_syn.dtype)
        return q_syn.sum(-1) @ pi, q_non.sum(-1) @ pi

    # -- multiple instantaneous hits (MG_REV_MH.bf / MG_REV_TRIP.bf) --------

    def _multihit_tables(self):
        """Index tensors on the model's device (built once) for codon pairs
        differing at 2 or 3 positions: rate entry = prod(theta per changed
        position) * prod(target-nuc position frequency) * (alpha|beta) *
        delta[*psi] (``MG_REV_MH.bf:60-107``)."""
        if getattr(self, "_mh_tables", None) is not None:
            return self._mh_tables
        sense = [int(c) for c in self.gc.sense_codons]
        trans = self.gc.translation
        rows = {2: [], 3: []}
        for a, ca in enumerate(sense):
            na = (ca // 16, (ca // 4) % 4, ca % 4)
            for b, cb in enumerate(sense):
                nb = (cb // 16, (cb // 4) % 4, cb % 4)
                diff = [p for p in range(3) if na[p] != nb[p]]
                if len(diff) < 2:
                    continue
                th = [6, 6, 6]  # index 6 = padding (theta == 1)
                mult = 1.0
                for k, p in enumerate(diff):
                    th[k] = _PAIR_INDEX[_NUC[min(na[p], nb[p])] + _NUC[max(na[p], nb[p])]]
                    mult *= self.corner_freqs[nb[p], p]
                rows[len(diff)].append((a, b, th, mult, float(trans[ca] == trans[cb])))

        def dev(values, dtype):
            return torch.tensor(values, dtype=dtype, device=self.device)

        self._mh_tables = {
            d: dict(
                pair_i=dev([r[0] for r in rs], torch.int64),
                pair_j=dev([r[1] for r in rs], torch.int64),
                theta_idx=dev([r[2] for r in rs], torch.int64),
                multiplier=dev([r[3] for r in rs], torch.float64),
                syn=dev([r[4] for r in rs], torch.float64),
            )
            for d, rs in rows.items()
        }
        return self._mh_tables

    def multihit_basis_matrices(self, params: Params, hits: int):
        """(Q_syn, Q_nonsyn) [S,S] of the 2- or 3-hit entry set (zero
        diagonal), in the parameter dtype."""
        tbl = self._multihit_tables()[hits]
        theta = self._theta_vector(params)
        dtype = theta.dtype
        theta7 = torch.cat([theta, torch.ones(1, dtype=dtype, device=self.device)])
        entries = torch.prod(theta7[tbl["theta_idx"]], dim=1) * tbl["multiplier"].to(dtype)
        syn = tbl["syn"].to(dtype)
        zeros = torch.zeros((self.n_states, self.n_states), dtype=dtype, device=self.device)
        idx = (tbl["pair_i"], tbl["pair_j"])
        return zeros.index_put(idx, entries * syn), zeros.index_put(idx, entries * (1.0 - syn))


class MG94xREV(MG94Base):
    """'Global' model type: one omega, a per-branch time ``t``
    (reference: model_type = terms.global).  Propagators by
    :meth:`propagators_grouped`: fp64 spectral, fp32 shared-power Taylor."""

    def parameter_specs(self, n_branches: int) -> Specs:
        specs = self.theta_specs()
        specs["omega"] = ParamSpec(init=0.25, lower=0.0, upper=10000.0)
        specs["t"] = ParamSpec(init=0.05, lower=0.0, upper=10000.0, shape=(n_branches,))
        return specs

    def build(self, params: Params, n_branches: int) -> ModelOutput:
        p = self.propagators_grouped(
            self.basis_matrices(params), params["t"], params["omega"][None],
            np.zeros(n_branches, dtype=np.int64),
        )
        return ModelOutput(p_matrices=p, root_freqs=self.frequencies)

    def branch_lengths(self, params: Params) -> torch.Tensor:
        return self.rate_per_branch(
            self.basis_matrices(params), params["t"], params["t"] * params["omega"]
        )


class MG94xREVLocal(MG94Base):
    """'Local' model type: per-branch (alpha, beta) = (synRate, nonSynRate),
    one generator per branch (:meth:`propagators_local`: fp64 spectral, one
    ``eigh`` per branch; fp32 batched Taylor)."""

    def parameter_specs(self, n_branches: int) -> Specs:
        specs = self.theta_specs()
        specs["alpha"] = ParamSpec(init=0.05, lower=0.0, upper=10000.0, shape=(n_branches,))
        specs["beta"] = ParamSpec(init=0.05, lower=0.0, upper=10000.0, shape=(n_branches,))
        return specs

    def build(self, params: Params, n_branches: int) -> ModelOutput:
        p = self.propagators_local(self.basis_matrices(params), params["alpha"], params["beta"])
        return ModelOutput(p_matrices=p, root_freqs=self.frequencies)

    def branch_lengths(self, params: Params) -> torch.Tensor:
        return self.rate_per_branch(self.basis_matrices(params), params["alpha"], params["beta"])


class MG94xREVPartitionedOmega(MG94Base):
    """The 'Global MG94xREV' fit of the selection methods
    (``estimators.FitCodonModel`` with partitioned_omega +
    proportional_branch_length_scaler, ``shared-load-file.bf:706``):

      beta_b  := alpha_b * omega_{group(b)}
      alpha_b := scaler * nuc_branch_length_b   (from the GTR fit)

    Free parameters: 5 thetas, one omega per branch group, one scaler
    (initialized at 3), or, with ``free_lengths``, one alpha per branch.
    ``multiple_hits`` "Double" / "Double+Triple" adds the shared 2-hit rate
    ``delta`` (and 3-hit rate ``psi``): every generator becomes
    ``alpha_b (Q1s + delta Q2s + psi Q3s) + beta_b (Q1n + delta Q2n + psi
    Q3n)``.

    Route of the multi-hit generator: the JAX package builds its
    propagators through ``reversible_spectral`` at every dtype; here they go
    through :meth:`propagators_grouped` like the single-hit ones — fp64
    spectral, fp32 shared-power Taylor.  The same function by another route:
    an fp32 eigendecomposition of a 61-state generator loses ~1e-2.
    """

    def __init__(
        self,
        gc: GeneticCode,
        corner_freqs: np.ndarray,
        codon_freqs: np.ndarray,
        nuc_lengths: np.ndarray,        # [B] GTR branch lengths
        branch_groups: np.ndarray,      # [B] int group per branch
        n_groups: int,
        free_lengths: bool = False,     # if True, alpha_b free (init from nuc)
        multiple_hits: str = "None",    # "None" | "Double" | "Double+Triple"
        device=None,
    ):
        super().__init__(gc, corner_freqs, codon_freqs, device=device)
        self.nuc_lengths = torch.as_tensor(
            np.asarray(nuc_lengths, dtype=np.float64), device=self.device
        )
        self.branch_groups = np.asarray(branch_groups, dtype=np.int64)
        self._branch_groups_t = torch.as_tensor(self.branch_groups, device=self.device)
        self.n_groups = n_groups
        self.free_lengths = free_lengths
        self.multiple_hits = multiple_hits

    def parameter_specs(self, n_branches: int) -> Specs:
        specs = self.theta_specs()
        # omega is shared across partitions in a joint fit; the branch-length
        # scaler is per-partition (shared-load-file.bf:716)
        specs["omega"] = ParamSpec(
            init=0.25, lower=0.0, upper=10000.0, shape=(self.n_groups,), shared=True
        )
        if self.free_lengths:
            specs["alpha"] = ParamSpec(init=0.15, lower=0.0, upper=10000.0, shape=(n_branches,))
        else:
            specs["scaler"] = ParamSpec(init=3.0, lower=0.0, upper=10000.0, shared=False)
        if self.multiple_hits != "None":
            # global 2-hit (delta) / 3-hit (psi) rates shared across
            # branches and partitions (MG_REV_MH.bf / MG_REV_TRIP.bf)
            specs["delta"] = ParamSpec(init=0.05, lower=0.0, upper=100.0, shared=True)
            if self.multiple_hits == "Double+Triple":
                specs["psi"] = ParamSpec(init=0.05, lower=0.0, upper=100.0, shared=True)
        return specs

    def _alphas(self, params: Params) -> torch.Tensor:
        if self.free_lengths:
            return params["alpha"]
        return params["scaler"] * self.nuc_lengths.to(params["scaler"].dtype)

    def combined_basis_matrices(self, params: Params):
        """(Q_syn, Q_nonsyn) with the multiple-hit entry sets scaled by
        delta (2-hit) and psi (3-hit) when enabled."""
        qs, qn = self.basis_matrices(params)
        if self.multiple_hits != "None":
            q2s, q2n = self.multihit_basis_matrices(params, 2)
            qs = qs + params["delta"] * q2s
            qn = qn + params["delta"] * q2n
            if self.multiple_hits == "Double+Triple":
                q3s, q3n = self.multihit_basis_matrices(params, 3)
                qs = qs + params["psi"] * q3s
                qn = qn + params["psi"] * q3n
        return qs, qn

    def build(self, params: Params, n_branches: int) -> ModelOutput:
        p = self.propagators_grouped(
            self.combined_basis_matrices(params), self._alphas(params), params["omega"],
            self.branch_groups,
        )
        return ModelOutput(p_matrices=p, root_freqs=self.frequencies)

    def branch_lengths(self, params: Params) -> torch.Tensor:
        alpha = self._alphas(params)
        beta = alpha * params["omega"][self._branch_groups_t]
        return self.rate_per_branch(self.combined_basis_matrices(params), alpha, beta)


class MG94xREVMultiHit(MG94Base):
    """MG94xREV with double- (delta) and optionally triple-hit (psi)
    instantaneous substitutions and free branch rates (reference:
    ``models/codon/MG_REV_MH.bf``, ``MG_REV_TRIP.bf``; FitMultiModel's
    model shape).

    Q = alpha_b*(Q1s + d*Q2s + p*Q3s) + beta_b*(Q1n + d*Q2n + p*Q3n),
    beta_b = alpha_b * omega_{group(b)}; delta/psi are global rates.  The
    propagators take :meth:`propagators_grouped`'s route: fp64 spectral,
    fp32 shared-power Taylor (the JAX package: spectral at every dtype).
    """

    def __init__(
        self,
        gc: GeneticCode,
        corner_freqs: np.ndarray,
        codon_freqs: np.ndarray,
        branch_groups: np.ndarray,
        n_groups: int,
        triple: bool = False,
        device=None,
    ):
        super().__init__(gc, corner_freqs, codon_freqs, device=device)
        self.branch_groups = np.asarray(branch_groups, dtype=np.int64)
        self._branch_groups_t = torch.as_tensor(self.branch_groups, device=self.device)
        self.n_groups = n_groups
        self.triple = triple

    def parameter_specs(self, n_branches: int) -> Specs:
        specs = self.theta_specs()
        specs["omega"] = ParamSpec(init=0.25, lower=0.0, upper=10000.0, shape=(self.n_groups,))
        specs["alpha"] = ParamSpec(init=0.15, lower=0.0, upper=10000.0, shape=(n_branches,))
        # reference rate bounds: delta/psi in [0, 100] (MG_REV_MH.bf)
        specs["delta"] = ParamSpec(init=0.05, lower=0.0, upper=100.0)
        if self.triple:
            specs["psi"] = ParamSpec(init=0.05, lower=0.0, upper=100.0)
        return specs

    def _combined_bases(self, params: Params):
        q1s, q1n = self.basis_matrices(params)
        q2s, q2n = self.multihit_basis_matrices(params, 2)
        qs = q1s + params["delta"] * q2s
        qn = q1n + params["delta"] * q2n
        if self.triple:
            q3s, q3n = self.multihit_basis_matrices(params, 3)
            qs = qs + params["psi"] * q3s
            qn = qn + params["psi"] * q3n
        return qs, qn

    def build(self, params: Params, n_branches: int) -> ModelOutput:
        p = self.propagators_grouped(self._combined_bases(params), params["alpha"],
                                     params["omega"], self.branch_groups)
        return ModelOutput(p_matrices=p, root_freqs=self.frequencies)

    def branch_lengths(self, params: Params) -> torch.Tensor:
        alpha = params["alpha"]
        beta = alpha * params["omega"][self._branch_groups_t]
        return self.rate_per_branch(self._combined_bases(params), alpha, beta)


class MG94xREVMultiHitGDD(MG94xREVMultiHit):
    """MG94xREV(+MH) with a K-class general-discrete (GDD) site-level
    omega distribution — FitMultiModel's default model shape
    (``FitMultiModel.bf:25`` rate_classes = 3; GDD factory at ``:210``).

    Omega classes are free rates with stick-breaking weights; each class
    is a site-level category (``ModelOutput.class_weights``), i.e. the
    reference's ``_CategoryVariable`` machinery, not a branch-site
    mixture.  ``hits`` "None" / "Double" / "Double+Triple" adds the shared
    2-hit rate ``delta`` (and 3-hit rate ``psi``); ``triple_islands`` adds
    a separate rate for synonymous 3-hit substitutions
    (``terms.parameters.triple_hit_rate_syn``).

    ``build`` gives ``[K, branches, S, S]`` propagators, one set per class
    at the branch rates: fp64 one ``eigh`` per class, fp32 one shared-power
    Taylor series per class.  The likelihood folds the K sets into K1's
    node axis (one launch per level for all classes).
    """

    def __init__(self, gc, corner_freqs, codon_freqs, branch_groups, n_groups,
                 hits="None", rate_classes=3, triple_islands=False, device=None):
        triple = hits == "Double+Triple"
        super().__init__(gc, corner_freqs, codon_freqs, branch_groups, n_groups,
                         triple=triple, device=device)
        if rate_classes == 1 and n_groups != 1:
            raise ValueError("one rate class takes one branch group")
        self.hits = hits
        self.rate_classes = rate_classes
        self.triple_islands = triple_islands and triple
        # the propagator route: None follows the dtype (fp64 spectral, fp32
        # Taylor); True or False forces it (the card's checks hold fp64
        # Taylor card against host, where the spectral route's eigensolvers
        # part at short branches, ROADMAP 3.5)
        self.spectral = None

    def parameter_specs(self, n_branches: int) -> Specs:
        specs = super().parameter_specs(n_branches)
        if self.hits == "None":
            del specs["delta"]
        k = self.rate_classes
        if k > 1:
            del specs["omega"]
            specs["omega_c"] = ParamSpec(init=0.25, lower=0.0, upper=10000.0, shape=(k,))
            specs["omega_w"] = ParamSpec(init=0.5, lower=1e-6, upper=1.0 - 1e-6,
                                         shape=(k - 1,))
        if self.triple_islands:
            specs["psi_syn"] = ParamSpec(init=0.05, lower=0.0, upper=100.0)
        return specs

    def _combined_bases(self, params: Params):
        if self.hits == "None":
            return self.basis_matrices(params)
        if not self.triple_islands:
            return super()._combined_bases(params)
        q1s, q1n = self.basis_matrices(params)
        q2s, q2n = self.multihit_basis_matrices(params, 2)
        q3s, q3n = self.multihit_basis_matrices(params, 3)
        qs = q1s + params["delta"] * q2s + params["psi_syn"] * q3s
        qn = q1n + params["delta"] * q2n + params["psi"] * q3n
        return qs, qn

    def class_distribution(self, params: Params):
        """(omegas ``[K]``, weights ``[K]``)."""
        if self.rate_classes == 1:
            omega = params["omega"].reshape(1)
            return omega, torch.ones((1,), dtype=omega.dtype, device=omega.device)
        return params["omega_c"], stick_breaking_weights(params["omega_w"])

    def build(self, params: Params, n_branches: int) -> ModelOutput:
        omegas, weights = self.class_distribution(params)
        qs, qn = self._combined_bases(params)
        m = fill_diagonal_from_rows(qs[None] + omegas[:, None, None] * qn[None])   # [K,S,S]
        alpha = params["alpha"]
        if m.dtype == torch.float64 if self.spectral is None else self.spectral:
            left, lam, right = expm_ops.reversible_spectral(m, self.frequencies)
            p = expm_ops.spectral_propagators(left[:, None], lam[:, None], right[:, None],
                                              alpha[None, :])
        else:
            p = torch.stack([expm_ops.shared_taylor_propagators(mk, alpha) for mk in m])
        return ModelOutput(p_matrices=p, root_freqs=self.frequencies, class_weights=weights)

    def branch_lengths(self, params: Params) -> torch.Tensor:
        omegas, weights = self.class_distribution(params)
        qs, qn = self._combined_bases(params)
        pi = self.frequencies.to(qs.dtype)
        rs = qs.sum(-1) @ pi
        rn = qn.sum(-1) @ pi
        return params["alpha"] * (rs + torch.sum(omegas * weights) * rn) / 3.0
