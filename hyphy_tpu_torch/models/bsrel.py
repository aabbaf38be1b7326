"""BS_REL: branch-site random-effects likelihood machinery.

Counterpart of ``hyphy_tpu/models/bsrel.py`` (reference
``libv3/models/codon/BS_REL.bf``): "explicit form" models whose per-branch
transition matrix is a mixture of exponentials

    P_b(t) = sum_k w_k(b) expm(t_b * (Q_syn + omega_k(b) * Q_nonsyn))

(each branch-site draws its omega class independently, so the mixture
happens at the matrix level; ``tree.cpp:2999-3008``).  Site-level
synonymous rate variation (BUSTED --srv) scales every branch time by a
unit-mean GDD class value, a site-level mixture on top.

For G branch groups x K omega classes there are G*K generator families.
fp64 builds every family's propagators from one eigendecomposition each;
fp32 (the card's default) from shared-power Taylor series, because the
fp32 ``eigh`` loses ~1e-2 on 61-state generators (PERF.md): per group for
few groups of many branch times (BUSTED), else every branch's K families at
once by the batched per-generator series
(:func:`expm.taylor_propagators_batched`; RELAX, aBSREL).  The C
synonymous-rate classes are then pruned in ONE pass: their ``[C, B, S, S]``
propagators go to the grid form of :func:`pruning.site_log_likelihoods`,
which folds C into K1's node axis (one launch per level for all classes,
where the JAX package ``vmap``s one pruning per class).

With a device mesh (``parallel/mesh.py``) the leaf CLVs are split on the
pattern axis as in ``LikelihoodFunction``: the mixture propagators are
built once on the model's device and copied to each block's device, where
its levels run through K1 (the JAX package pads the patterns to a device
multiple, ``bsrel.py:95-127``; here the blocks are unequal and nothing is
padded).  The flux vectors and ancestors (``branch_class_site_logliks``,
BUSTED's joint reconstruction) stay on the model's device, over every
pattern.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.models.base import fill_diagonal_from_rows
from hyphy_tpu_torch.models.codon import MG94Base
from hyphy_tpu_torch.models.parameters import stick_breaking_weights
from hyphy_tpu_torch.ops import expm as expm_ops
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.ops.ancestral import branch_flux_vectors
from hyphy_tpu_torch.parallel.mesh import resolve_mesh

# bytes of one piece of branch_class_site_logliks' [branches, K, patterns, S]
# class messages
_FLUX_CHUNK_BYTES = 1 << 29
# bytes of the four [families, S, S] tensors (input, its symmetric form,
# eigenvectors, one factor) of one chunk of the spectral route's eigh
_EIGH_CHUNK_BYTES = 1 << 28
# the fp32 Taylor route's two forms: the per-group loop costs ~60 launches
# and two host reads per family whatever its times, the batched per-branch
# route device work per branch time.  The batched route takes a call whose
# C x B times number at most this many per group: on an H100 at 1998
# branches the loop's fp32 value took 29.3 ms against the batched 38.9 at
# 5994 times per group (BUSTED: one group, three synonymous-rate classes),
# and 33.1 against 18.6 at 666 (RELAX's alternative: three groups; PERF.md)
BATCHED_TIMES_PER_GROUP = 2048


def omega_distribution(params: Dict, prefix: str, k: int, error_sink: bool = False):
    """(omegas [k(+1)], weights [k(+1)]) from params ``{prefix}_omega_i``
    and stick-breaking fractions ``{prefix}_w_i``.

    ``error_sink`` prepends class 0 — the BUSTED-E misalignment-absorber
    (omega >= 100, weight <= 0.01; reference ``BUSTED.bf:196-226``)."""
    lo = 0 if error_sink else 1
    omegas = torch.stack([params[f"{prefix}_omega_{i}"] for i in range(lo, k + 1)])
    if omegas.shape[0] == 1:
        return omegas, torch.ones_like(omegas)
    fracs = torch.stack([params[f"{prefix}_w_{i}"] for i in range(lo, k)])
    return omegas, stick_breaking_weights(fracs)


def srv_distribution(params: Dict, k: int, prefix: str = "srv"):
    """Unit-mean GDD synonymous-rate classes (rate_variation.bf GDD)."""
    rates = torch.stack([params[f"{prefix}_rate_{i}"] for i in range(1, k + 1)])
    if k == 1:
        return torch.ones_like(rates), torch.ones_like(rates)
    fracs = torch.stack([params[f"{prefix}_w_{i}"] for i in range(1, k)])
    weights = stick_breaking_weights(fracs)
    mean = torch.sum(rates * weights)
    return rates / torch.clamp_min(mean, 1e-30), weights


def _log_weights(weights: torch.Tensor) -> torch.Tensor:
    """log of mixture weights floored at 1e-300, in fp64 (in fp32 the floor
    is 0 and the log -inf)."""
    return torch.log(torch.clamp_min(weights.to(torch.float64), 1e-300))


class BSRELEngine:
    """Per-partition BS_REL likelihood evaluator on the model's device.

    ``omegas`` / ``weights`` are ``[G, K]`` (BUSTED: the test and
    background distributions); ``group_of_branch`` maps each branch to its
    group.  ``basis_fn(params) -> (q_syn, q_nonsyn)`` overrides the
    one-step MG94 bases (BUSTED --multiple-hits, ``BUSTED.bf:329-352``).
    ``mesh``: the devices over which the pruning splits its patterns
    (``"auto"``: ``settings.default_mesh``, which engages every card only
    where the pruning over the synonymous-rate classes passes half of
    the model's card's free memory; ``None``: the model's device alone).
    """

    def __init__(
        self,
        mg94: MG94Base,
        pdata: pruning.PruningData,
        leaf_partials,                  # [n_leaves, patterns, S]
        pattern_weights,                # [patterns]
        group_of_branch: np.ndarray,    # [B] int
        srv_classes: int = 1,
        basis_fn=None,
        mesh="auto",
    ):
        self.model = mg94
        self.device = device = mg94.device
        self.pdata = pdata
        # CLVs and generators in the compute dtype (fp64 on the CPU, fp32
        # on the card); the pattern-weighted reduction stays fp64
        self.dtype = settings.likelihood_dtype(device)
        # the propagator route: spectral in fp64, shared-power Taylor in
        # fp32; settable, so that fp64 Taylor can be held against either
        self.spectral = self.dtype == torch.float64
        self.leaf_partials = torch.as_tensor(
            np.asarray(leaf_partials), device=device).to(self.dtype).contiguous()
        self.pattern_weights = torch.as_tensor(
            np.asarray(pattern_weights), dtype=torch.float64, device=device)
        groups = np.asarray(group_of_branch).astype(np.int64)
        self.group_of_branch = torch.as_tensor(groups, device=device)
        self.n_groups = int(groups.max()) + 1
        # branches of each group, and the order that puts their
        # concatenation back in branch order (the Taylor route builds each
        # group's families for its own branches only)
        self._group_branches: List[torch.Tensor] = [
            torch.as_tensor(np.nonzero(groups == g)[0], device=device)
            for g in range(self.n_groups)]
        order = np.concatenate([np.nonzero(groups == g)[0] for g in range(self.n_groups)])
        self._unsort = torch.as_tensor(np.argsort(order, kind="stable"), device=device)
        self.srv_classes = srv_classes
        self.freqs = mg94.frequencies.to(self.dtype)
        self.basis_fn = basis_fn or mg94.basis_matrices
        self.mesh = resolve_mesh(mesh, device, srv_classes * pruning.gene_bytes(
            pdata, self.leaf_partials.shape[1], mg94.n_states, self.leaf_partials.element_size()))
        self._shards = (None if self.mesh is None else
                        pruning.shard_patterns(pdata, self.leaf_partials, self.mesh, self.dtype))

    def _prune(self, p_matrices, floor=None):
        """Site lnLs of the leaves under ``p_matrices`` (one-set or grid
        form), over the mesh when there is one."""
        if self._shards is not None:
            return pruning.sharded_site_log_likelihoods(p_matrices, self._shards, self.freqs,
                                                        floor)
        return pruning.site_log_likelihoods(p_matrices, self.leaf_partials, self.freqs,
                                            self.pdata, floor)

    def _family_generators(self, params, omegas):
        """[G*K, S, S] generators in the compute dtype; per-group bases
        (``basis_fn`` returning [G,S,S] pairs) broadcast along the class
        axis, shared bases along both."""
        g, k = omegas.shape
        q_syn, q_non = self.basis_fn(params)
        if q_syn.dim() == 3:                                    # per-group
            m = q_syn[:, None] + omegas[:, :, None, None] * q_non[:, None]
            m = fill_diagonal_from_rows(m.reshape(g * k, *m.shape[2:]))
        else:
            m = fill_diagonal_from_rows(
                q_syn[None] + omegas.reshape(g * k)[:, None, None] * q_non[None])
        return m.to(self.dtype)

    def _spectral_factors(self, m, g, k):
        """Per-branch spectral factors of the families: left / right
        ``[B, K, S, S]``, eigenvalues ``[B, K, S]`` with the zero modes
        settled (the JAX package keeps their round-off, ROADMAP 3.15).  The
        eigendecompositions run in chunks of ``_EIGH_CHUNK_BYTES`` (G*K is
        B*K at one group per branch: 5994 families at 1000 taxa, K = 3)."""
        s = m.shape[-1]
        step = max(1, _EIGH_CHUNK_BYTES // (4 * s * s * m.element_size()))
        parts = [expm_ops.reversible_spectral(m[lo: lo + step], self.freqs)
                 for lo in range(0, m.shape[0], step)]
        left, lam, right = (torch.cat(x) if len(parts) > 1 else x[0] for x in zip(*parts))
        lam = expm_ops.settle_zero_modes(lam)
        gb = self.group_of_branch
        return (left.reshape(g, k, s, s)[gb], lam.reshape(g, k, s)[gb],
                right.reshape(g, k, s, s)[gb])

    def _taylor_by_group(self, m, k, times, combine):
        """The Taylor route: per group g and class kk, the shared-power Taylor
        propagators of family ``g*K + kk`` at ``times[..., branches of g]``
        (``[C, Bg]`` flattened), handed to ``combine(g, per_class)`` with
        ``per_class`` the K tensors ``[C, Bg, S, S]``; the groups' results
        are joined along the branch axis (axis 1) in branch order.  Each
        family's ladder goes as deep as its largest time needs
        (:func:`expm.ladder_depth`): the fits probe large thetas and
        branch lengths, where the default depth saturates."""
        parts = []
        for g, branches in enumerate(self._group_branches):
            t_g = times[:, branches].to(self.dtype)
            per_class = []
            for f in range(g * k, (g + 1) * k):
                depth = expm_ops.ladder_depth(m[f], t_g, 11, radius=2.0)
                p = expm_ops.shared_taylor_propagators(m[f], t_g.reshape(-1), depth)
                per_class.append(p.reshape(t_g.shape + m.shape[-2:]))
            parts.append(combine(g, per_class))
        if len(parts) == 1:
            return parts[0]
        return torch.cat(parts, dim=1).index_select(1, self._unsort)

    def _batched(self, times) -> bool:
        """Whether the fp32 Taylor route takes the batched per-branch form
        for srv-scaled ``times`` ``[C, B]`` (:data:`BATCHED_TIMES_PER_GROUP`;
        always at one group per branch)."""
        return not self.spectral and times.numel() <= BATCHED_TIMES_PER_GROUP * self.n_groups

    def _taylor_per_branch(self, m, k, times):
        """The per-branch Taylor route: ``[C, B, K, S, S]``, branch b's K
        families (``group_of_branch[b] * K + kk``) at its own C times, all
        B*K families in one :func:`expm.taylor_propagators_batched` call
        (one host read for the ladder depth, no loop over groups)."""
        s = m.shape[-1]
        c, b = times.shape
        fam = m.reshape(-1, k, s, s)[self.group_of_branch].reshape(b * k, s, s)
        t = times.to(self.dtype)[:, :, None].expand(c, b, k).reshape(c, b * k)
        return expm_ops.taylor_propagators_batched(fam, t).reshape(c, b, k, s, s)

    @staticmethod
    def _finish(p):
        return expm_ops.row_renormalize(expm_ops._clip_negative(p))

    def mixture_propagators(self, params, omegas, weights, times):
        """P_mix ``[C, B, S, S]`` for srv-scaled ``times`` ``[C, B]``
        (srv rate x branch time); ``omegas`` / ``weights`` ``[G, K]``.

        fp64: one eigendecomposition per family, the class weights folded
        into the scaled eigenbasis so that the mixture sum contracts in the
        same product.  fp32: each group's families at that group's branches
        by shared-power Taylor (the JAX package builds every family for
        every branch and selects by group, twice the memory at G = 2), then
        the class-weighted mix; with few times per group (:meth:`_batched`;
        one group per branch among them), every branch's families in one
        batched pass (the JAX package's selection would be ``[G*K, C*B, S,
        S]``: 178 GB at RELAX's G = B = 1998)."""
        g, k = omegas.shape
        m = self._family_generators(params, omegas)             # [G*K, S, S]
        w = weights.to(self.dtype)
        if self._batched(times):
            p = self._taylor_per_branch(m, k, times)
            return self._finish(torch.einsum("cbkij,bk->cbij", p, w[self.group_of_branch]))
        if not self.spectral:
            def mix(gi, per_class):
                out = w[gi, 0] * per_class[0]
                for kk in range(1, k):
                    out = out + w[gi, kk] * per_class[kk]
                return out

            return self._finish(self._taylor_by_group(m, k, times, mix))
        left, lam, right = self._spectral_factors(m, g, k)
        c, b = times.shape
        s = m.shape[-1]
        el = torch.exp(lam[None] * times[:, :, None, None])      # [C, B, K, S]
        el = el * w[self.group_of_branch][None, :, :, None]
        scaled = left[None] * el[..., None, :]                   # [C, B, K, S, S]
        p_mix = torch.matmul(scaled.permute(0, 1, 3, 2, 4).reshape(c, b, s, k * s),
                             right.reshape(b, k * s, s))
        return self._finish(p_mix)

    def branchsite_srv_propagators(self, params, omegas, weights, t_b, srv_rates,
                                   srv_weights):
        """P_b ``[B, S, S]`` when BOTH the omega class and the synonymous
        rate class are drawn independently per branch-site (the reference's
        "Branch-site" SRV mode, ``models.codon.BS_REL_SRV``,
        ``BUSTED.bf:393``): the mixture over the K x C product distribution
        happens inside each branch matrix, and pruning runs once.  fp64
        sums the classes' scaled eigenvalue factors (the JAX package's
        route); fp32 mixes Taylor propagators."""
        g, k = omegas.shape
        m = self._family_generators(params, omegas)
        t_scaled = srv_rates[:, None] * t_b[None, :]             # [C, B]
        w = weights.to(self.dtype)
        wsrv = srv_weights.to(self.dtype)
        if self._batched(t_scaled):
            p = self._taylor_per_branch(m, k, t_scaled)
            return self._finish(torch.einsum("c,cbkij,bk->bij", wsrv, p,
                                             w[self.group_of_branch]))
        if not self.spectral:
            def mix(gi, per_class):
                out = None
                for kk in range(k):
                    term = w[gi, kk] * torch.einsum("c,cbij->bij", wsrv, per_class[kk])
                    out = term if out is None else out + term
                return out[None]

            return self._finish(self._taylor_by_group(m, k, t_scaled, mix)[0])
        left, lam, right = self._spectral_factors(m, g, k)
        el = torch.einsum("c,cbks->bks", wsrv, torch.exp(lam[None] * t_scaled[:, :, None, None]))
        el = el * w[self.group_of_branch][:, :, None]            # [B, K, S]
        b, s = t_b.shape[0], m.shape[-1]
        p = torch.matmul((left * el[..., None, :]).permute(0, 2, 1, 3).reshape(b, s, k * s),
                         right.reshape(b, k * s, s))
        return self._finish(p)

    def branchsite_srv_site_log_likelihoods(self, params, omegas, weights, t_b, srv_rates,
                                            srv_weights):
        p = self.branchsite_srv_propagators(params, omegas, weights, t_b, srv_rates,
                                            srv_weights)
        return self._prune(p)

    def class_site_log_likelihoods(self, params, omegas, weights, t_b, srv_rates):
        """``[C, patterns]`` per-synonymous-rate-class site lnLs — the
        lattice mixed independently per site (below) or by the HMM across
        sites (``SumUpHiddenMarkov``, likefunc2.cpp:1166).  The C classes
        are one grid-form pruning, with the JAX package's ``finfo.tiny``
        floor on each class's site likelihood."""
        times = srv_rates[:, None] * t_b[None, :]                # [C, B]
        p_mix = self.mixture_propagators(params, omegas, weights, times)
        return self._prune(p_mix, floor=True)

    def site_log_likelihoods(self, params, omegas, weights, t_b, srv_rates, srv_weights):
        """``[patterns]`` fp64 log-likelihoods of the mixture model."""
        sll = self.class_site_log_likelihoods(params, omegas, weights, t_b, srv_rates)
        return torch.logsumexp(sll + _log_weights(srv_weights)[:, None], dim=0)

    def loglik(self, params, omegas, weights, t_b, srv_rates, srv_weights):
        sll = self.site_log_likelihoods(params, omegas, weights, t_b, srv_rates, srv_weights)
        return torch.dot(sll, self.pattern_weights)

    def _per_class_propagators(self, params, omegas, times):
        """``[C, B, K, S, S]`` unmixed per-class propagators at srv-scaled
        ``times`` — spectral in fp64, shared-power Taylor otherwise."""
        g, k = omegas.shape
        m = self._family_generators(params, omegas)
        if self._batched(times):
            p = self._taylor_per_branch(m, k, times)
        elif not self.spectral:
            p = self._taylor_by_group(m, k, times, lambda gi, per_class: torch.stack(per_class, 2))
        else:
            left, lam, right = self._spectral_factors(m, g, k)
            el = torch.exp(lam[None] * times[:, :, None, None])  # [C, B, K, S]
            p = torch.matmul(left[None] * el[..., None, :], right[None])
        return self._finish(p)

    def branch_class_site_logliks(self, params, omegas, weights, t_b, srv_rates, srv_weights,
                                  branch_ids):
        """``[n_sel, K, patterns]`` fp64 site lnLs with ONE branch's
        omega-mixture pinned to each class in turn (every other branch
        keeps the fitted mixture; the synonymous-rate mixture still applies
        site-wise).

        Reference: ``BUSTED.bf:1060-1092`` re-evaluates the whole LF per
        (branch, class); here each costs a matrix-vector product against
        the inside and outside vectors of :func:`branch_flux_vectors`, one
        inside/outside pass per synonymous-rate class.  ``branch_ids``:
        node indices whose branch is profiled."""
        with torch.no_grad():
            w_b = weights.to(self.dtype)[self.group_of_branch]    # [B, K]
            times = srv_rates[:, None] * t_b[None, :]
            p_all = self._per_class_propagators(params, omegas, times)
            sel = torch.as_tensor(np.asarray(branch_ids, dtype=np.int64), device=self.device)
            k = p_all.shape[2]
            patterns, s = self.leaf_partials.shape[1], self.leaf_partials.shape[2]
            step = max(1, _FLUX_CHUNK_BYTES // (k * patterns * s * self.leaf_partials.element_size()))
            out = []
            for ci in range(p_all.shape[0]):
                p_mix = self._finish(torch.einsum("bkij,bk->bij", p_all[ci], w_b))
                clv, log_clv, up, log_up = branch_flux_vectors(
                    p_mix, self.leaf_partials, self.freqs, self.pdata)
                rows = []
                for lo in range(0, sel.shape[0], step):
                    b = sel[lo: lo + step]
                    # sum_ij up[b,p,i] P_k[b,i,j] clv[b,p,j]
                    pushed = torch.einsum("nkij,npj->nkpi", p_all[ci, b], clv[b])
                    flux = (pushed * up[b][:, None]).sum(-1)
                    rows.append(torch.log(torch.clamp_min(flux.to(torch.float64), 1e-300))
                                + (log_clv[b] + log_up[b])[:, None, :])
                out.append(torch.cat(rows))
            stack = torch.stack(out)                              # [C, n_sel, K, patterns]
            return torch.logsumexp(stack + _log_weights(srv_weights)[:, None, None, None], dim=0)

    @staticmethod
    def class_posteriors(sll_bk, weights_k):
        """w_k exp(sll_k) normalized over k — the reference's
        ``busted.mixture_site_logl`` posterior (BUSTED.bf:1098)."""
        lp = sll_bk + _log_weights(weights_k)[None, :, None]
        return torch.exp(lp - torch.logsumexp(lp, dim=1, keepdim=True))
