"""The port's ancestral reconstruction against the JAX package's on
identical inputs: joint maximum-likelihood states and root lnL
(``joint_reconstruct``) on a binary tree, a trifurcation and a nine-child
polytomy; a 400-leaf star, where the reference's product of all children
underflows and the port's does not; and the draws of ``sample_ancestors``
for one generator seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyphy_tpu.data.filter import DataFilter as JDataFilter
from hyphy_tpu.ops import ancestral as jancestral
from hyphy_tpu.ops import pruning as jpruning
from hyphy_tpu.tree.topology import Tree as JTree
from hyphy_tpu.utils.synth import random_tree_newick, synthetic_codon_alignment
from hyphy_tpu_torch.ops import ancestral, pruning
from hyphy_tpu_torch.tree.topology import Tree

torch.set_num_threads(2)

N_CODONS, SEED = 30, 11
TREES = {
    "binary": random_tree_newick(8, seed=3),
    "polytomy": "((t0:0.1,t1:0.2,t2:0.05):0.05,(t3:0.1,t4:0.002):0.1,t5:0.3)",
    "wide": ("((t0:0.1,t1:0.2,t2:0.05,t3:0.1,t4:0.02,t5:0.3,t6:0.1,t7:0.05,t8:0.2):0.05,"
             "(t9:0.1,t10:0.2):0.1,t11:0.2)"),
}


def _problem(newick, concentration=0.3, seed=0):
    """Leaf partials of a synthetic codon alignment on ``newick``, random
    propagator rows (Dirichlet) and root frequencies, both packages'
    trees and schedules."""
    aln = synthetic_codon_alignment(newick.count("t"), N_CODONS, seed=SEED)
    filt = JDataFilter.from_alignment(aln, "codon")
    jtree = JTree.from_newick(newick, leaf_order=filt.names)
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    rng = np.random.default_rng(seed)
    s = filt.n_states
    return dict(p=rng.dirichlet(np.full(s, concentration), size=(tree.n_branches, s)),
                pi=rng.dirichlet(np.ones(s)), leaves=filt.leaf_partials().astype(np.float64),
                jtree=jtree, tree=tree, jdata=jpruning.build_pruning_data(jtree),
                tdata=pruning.build_pruning_data(tree, "cpu"))


def _joint_both(pr):
    ref = jancestral.joint_reconstruct(jnp.asarray(pr["p"]), jnp.asarray(pr["leaves"]),
                                       jnp.asarray(pr["pi"]), pr["jdata"])
    ours = ancestral.joint_reconstruct(torch.tensor(pr["p"]), torch.tensor(pr["leaves"]),
                                       torch.tensor(pr["pi"]), pr["tdata"])
    return ours, ref


@pytest.mark.parametrize("name", sorted(TREES))
def test_joint_reconstruct_matches(name):
    pr = _problem(TREES[name])
    ours, ref = _joint_both(pr)
    assert ours.internal_states.dtype == torch.int32
    assert ours.internal_states.shape == (pr["tree"].n_nodes - pr["tree"].n_leaves, N_CODONS)
    np.testing.assert_array_equal(ours.internal_states.numpy(), np.asarray(ref.internal_states))
    np.testing.assert_allclose(ours.root_loglik.numpy(), np.asarray(ref.root_loglik),
                               rtol=0, atol=1e-10)


def test_joint_reconstruct_unresolved_columns():
    """A fully missing column is unresolved everywhere (state -1), as in
    the reference, and a column with two taxa missing gets its states."""
    pr = _problem(TREES["binary"])
    pr["leaves"][:, 0] = 1.0                       # every taxon missing at pattern 0
    pr["leaves"][:2, 1] = 1.0                      # two taxa missing at pattern 1
    ours, ref = _joint_both(pr)
    states = ours.internal_states.numpy()
    assert (states[:, 0] == -1).all()
    np.testing.assert_array_equal(states, np.asarray(ref.internal_states))


def test_wide_star_does_not_underflow():
    """A 400-leaf star: the reference multiplies all 400 child messages
    (each ~0.05) before it renormalises, which underflows in fp64; the
    port's product, renormalised every four children, gives the root's
    state and max-product lnL of a log-space computation."""
    n = 400
    newick = "(" + ",".join(f"t{i}:0.1" for i in range(n)) + ")"
    pr = _problem(newick, concentration=1.0, seed=4)
    ours, ref = _joint_both(pr)
    # log-space reference: lnL_p = max_i [log pi_i + sum_c log max_j P_c[i,j] L_c[p,j]]
    msgs = np.max(pr["p"][:, None, :, :] * pr["leaves"][:, :, None, :], axis=-1)  # [c, p, i]
    scores = np.log(pr["pi"])[None, :] + np.log(msgs).sum(axis=0)              # [p, i]
    np.testing.assert_allclose(ours.root_loglik.numpy(), scores.max(axis=1), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(ours.internal_states.numpy()[0], np.argmax(scores, axis=1))
    assert (scores.max(axis=1) < -800).all()
    # the reference's product reached zero: its lnL sits at log(tiny), its
    # root state at the first state
    np.testing.assert_allclose(np.asarray(ref.root_loglik), np.log(np.finfo(np.float64).tiny))
    assert (np.asarray(ref.internal_states)[0] == 0).all()


@pytest.mark.parametrize("name", ["binary", "polytomy"])
def test_sample_ancestors_draws_equal(name):
    pr = _problem(TREES[name])
    ref = jancestral.sample_ancestors(pr["p"], pr["leaves"], pr["pi"], pr["jdata"],
                                      pr["jtree"].children, 4, np.random.default_rng(5))
    ours = ancestral.sample_ancestors(pr["p"], pr["leaves"], pr["pi"], pr["tdata"],
                                      pr["tree"].children, 4, np.random.default_rng(5))
    assert ours.shape == (4, pr["tree"].n_nodes - pr["tree"].n_leaves, N_CODONS)
    np.testing.assert_array_equal(ours, ref)


def _flux_both(pr):
    ref = jancestral.branch_flux_vectors(jnp.asarray(pr["p"]), jnp.asarray(pr["leaves"]),
                                         jnp.asarray(pr["pi"]), pr["jdata"], pr["jtree"].children)
    ours = ancestral.branch_flux_vectors(torch.tensor(pr["p"]), torch.tensor(pr["leaves"]),
                                         torch.tensor(pr["pi"]), pr["tdata"])
    return ours, ref


def _flux_site_logliks(flux, p):
    """Each branch's ``log sum_ij up P clv + log_clv + log_up``: ``[branches,
    patterns]``, every row the site lnL."""
    clv, log_clv, up, log_up = (x.numpy() for x in flux)
    nb = p.shape[0]
    inner = np.einsum("bpi,bij,bpj->bp", up[:nb], p, clv[:nb])
    with np.errstate(divide="ignore"):        # the reference's underflowed fluxes
        return np.log(inner) + log_clv[:nb] + log_up[:nb]


@pytest.mark.parametrize("name", sorted(TREES))
def test_branch_flux_vectors_match(name):
    """Inside and outside vectors and their log-scales equal the JAX
    package's (the wide tree's 9-child node renormalises every four
    children in the port, which changes only round-off at 30 codons), and
    every branch's flux gives the pruning's site lnL."""
    pr = _problem(TREES[name], seed=5)
    ours, ref = _flux_both(pr)
    for o, r in zip(ours, ref):
        assert o.shape == np.asarray(r).shape
    np.testing.assert_allclose(_flux_site_logliks(ours, pr["p"]),
                               _flux_site_logliks(tuple(torch.as_tensor(np.asarray(x))
                                                        for x in ref), pr["p"]),
                               rtol=1e-12, atol=0)
    sll = pruning.site_log_likelihoods(torch.tensor(pr["p"]), torch.tensor(pr["leaves"]),
                                       torch.tensor(pr["pi"]), pr["tdata"]).numpy()
    np.testing.assert_allclose(_flux_site_logliks(ours, pr["p"]), np.broadcast_to(
        sll, (pr["p"].shape[0], sll.shape[0])), rtol=1e-12, atol=0)
    if name != "wide":
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-12, atol=1e-300)


def test_branch_flux_wide_star_does_not_underflow():
    """A 400-leaf star: the reference multiplies all 400 child messages
    (inside) and all 399 siblings (outside) before it renormalises, and its
    fluxes fall to the 1e-300 floor; the port's, renormalised every four
    children, give every branch the site lnL of a log-space computation."""
    n = 400
    newick = "(" + ",".join(f"t{i}:0.1" for i in range(n)) + ")"
    pr = _problem(newick, concentration=1.0, seed=4)
    ours, ref = _flux_both(pr)
    msgs = np.einsum("cij,cpj->cpi", pr["p"], pr["leaves"])                 # [c, p, i]
    log_site = np.log(np.exp(np.log(pr["pi"])[None, :] + np.log(msgs).sum(axis=0)
                             - (np.log(msgs).sum(axis=0)).max(axis=1, keepdims=True)
                             ).sum(axis=1)) + np.log(msgs).sum(axis=0).max(axis=1)
    assert (log_site < -800).all()
    got = _flux_site_logliks(ours, pr["p"])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.broadcast_to(log_site, got.shape), rtol=1e-12, atol=0)
    ref_flux = _flux_site_logliks(tuple(torch.as_tensor(np.asarray(x)) for x in ref), pr["p"])
    assert not np.isfinite(ref_flux).all() or (np.abs(ref_flux - log_site) > 1.0).all()
