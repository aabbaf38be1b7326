"""The port's marginal ancestral posteriors (``ops/ancestral.py::
marginal_posteriors``) against the JAX package's on identical inputs (1e-10
absolute), on a binary tree, a trifurcation and a nine-child polytomy; on a
400-leaf star, where the JAX package multiplies all 400 children before it
renormalises and its posteriors fall to 0 (ROADMAP 3.24), against a
log-space computation."""

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


def _both(pr):
    ref = jancestral.marginal_posteriors(
        jnp.asarray(pr["p"]), jnp.asarray(pr["leaves"]), jnp.asarray(pr["pi"]), pr["jdata"],
        pr["jtree"].children, np.asarray(pr["jtree"].parent))
    ours = ancestral.marginal_posteriors(torch.tensor(pr["p"]), torch.tensor(pr["leaves"]),
                                         torch.tensor(pr["pi"]), pr["tdata"])
    return ours.numpy(), np.asarray(ref)


@pytest.mark.parametrize("name", sorted(TREES))
def test_marginal_posteriors_match_jax(name):
    pr = _problem(TREES[name])
    ours, ref = _both(pr)
    tree = pr["tree"]
    assert ours.shape == (tree.n_nodes - tree.n_leaves, N_CODONS, pr["leaves"].shape[2])
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-12)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-10)


def test_marginal_posteriors_fp32():
    """The fp32 path (the card's dtype) against fp64: rows sum to 1."""
    pr = _problem(TREES["binary"])
    p32 = ancestral.marginal_posteriors(torch.tensor(pr["p"]).float(),
                                        torch.tensor(pr["leaves"]).float(),
                                        torch.tensor(pr["pi"]).float(), pr["tdata"])
    p64 = _both(pr)[0]
    assert p32.dtype == torch.float32
    np.testing.assert_allclose(p32.double().numpy(), p64, rtol=0, atol=1e-5)


def test_wide_star_posterior_does_not_underflow():
    """A 400-leaf star: the root's posterior is pi times the product of
    its 400 children's messages, normalised; in log space here.  The JAX
    package multiplies all 400 messages before it renormalises, and the
    product underflows to 0 in every state, so its posteriors are 0; the
    port's, renormalised every four children, equal the log-space values."""
    n = 400
    newick = "(" + ",".join(f"t{i}:0.1" for i in range(n)) + ")"
    pr = _problem(newick, concentration=1.0, seed=4)
    ours, ref = _both(pr)
    msgs = np.einsum("cij,cpj->cpi", pr["p"], pr["leaves"])                 # [c, p, i]
    log_joint = np.log(pr["pi"])[None, :] + np.log(msgs).sum(axis=0)        # [p, i]
    assert (log_joint.max(axis=1) < -800).all()
    post = np.exp(log_joint - log_joint.max(axis=1, keepdims=True))
    post /= post.sum(axis=1, keepdims=True)
    assert ours.shape == (1, N_CODONS, pr["leaves"].shape[2])
    np.testing.assert_allclose(ours[0], post, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-12)
    # the reference's fault: every row at 0
    assert np.abs(ref).max() == 0.0
