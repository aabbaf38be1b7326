"""The port's pruning (``hyphy_tpu_torch/ops/pruning.py``, every level
through the K1 wrapper) against the JAX package's on the tiny fixture of
``tests/test_fast_methods.py`` (6 taxa x 20 codons, seed 11), with the same
transition matrices and leaf partials in both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyphy_tpu.data.filter import DataFilter as JDataFilter
from hyphy_tpu.ops import pruning as jpruning
from hyphy_tpu.tree.topology import Tree as JTree
from hyphy_tpu.utils.synth import random_tree_newick, synthetic_codon_alignment
from hyphy_tpu_torch.ops import pruning as tpruning
from hyphy_tpu_torch.tree.topology import Tree

torch.set_num_threads(2)

N_TAXA, N_CODONS, SEED = 6, 20, 11


# the fixture's random binary tree, and a tree whose first level mixes a
# trifurcation with a bifurcation (padded child slots) under a trifurcating root
TREES = {
    "binary": random_tree_newick(N_TAXA, seed=SEED),
    "polytomy": "((t0:0.1,t1:0.2,t2:0.05):0.05,(t3:0.1,t4:0.2):0.1,t5:0.3)",
}


@pytest.fixture(scope="module", params=sorted(TREES))
def problem(request):
    aln = synthetic_codon_alignment(N_TAXA, N_CODONS, seed=SEED)
    newick = TREES[request.param]
    filt = JDataFilter.from_alignment(aln, "codon")
    jtree = JTree.from_newick(newick, leaf_order=filt.names)
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    rng = np.random.default_rng(7)
    s = filt.n_states
    # row-stochastic transition matrices with a heavy diagonal, one per branch
    p = rng.uniform(0.0, 1.0, size=(tree.n_branches, s, s)) + 20.0 * np.eye(s)
    p /= p.sum(-1, keepdims=True)
    return dict(
        p=p, leaves=filt.leaf_partials().astype(np.float64),
        freqs=rng.dirichlet(np.ones(s)), weights=np.asarray(filt.pattern_weights, float),
        jdata=jpruning.build_pruning_data(jtree),
        tdata=tpruning.build_pruning_data(tree, "cpu"),
    )


def _jax_sites(pr, dtype):
    return np.asarray(jpruning.site_log_likelihoods(
        jnp.asarray(pr["p"], dtype), jnp.asarray(pr["leaves"], dtype),
        jnp.asarray(pr["freqs"], dtype), pr["jdata"]))


def _torch_sites(pr, dtype):
    return tpruning.site_log_likelihoods(
        torch.tensor(pr["p"], dtype=dtype), torch.tensor(pr["leaves"], dtype=dtype),
        torch.tensor(pr["freqs"], dtype=dtype), pr["tdata"]).numpy()


def test_schedule_matches_jax(problem):
    jl, tl = problem["jdata"].ulevels, problem["tdata"].ulevels
    assert len(jl) == len(tl)
    for (jo, jcs, jcb), (to, tcs, tcb) in zip(jl, tl):
        assert jo == to
        np.testing.assert_array_equal(jcs, tcs)
        np.testing.assert_array_equal(jcb, tcb)


def test_site_log_likelihoods_fp64(problem):
    ours = _torch_sites(problem, torch.float64)
    assert ours.dtype == np.float64
    np.testing.assert_allclose(ours, _jax_sites(problem, jnp.float64), rtol=1e-10)


def test_site_log_likelihoods_fp32(problem):
    ours = _torch_sites(problem, torch.float32)
    # the log-scale accumulator and the root log are fp64 in both packages
    assert ours.dtype == np.float64
    np.testing.assert_allclose(ours, _jax_sites(problem, jnp.float32), atol=1e-4, rtol=0)


def test_gradient_wrt_transition_matrices(problem):
    w = problem["weights"]

    def jtotal(p):
        sll = jpruning.site_log_likelihoods(
            p, jnp.asarray(problem["leaves"]), jnp.asarray(problem["freqs"]),
            problem["jdata"])
        return jpruning.total_log_likelihood(sll, jnp.asarray(w))

    ref = np.asarray(jax.grad(jtotal)(jnp.asarray(problem["p"])))
    p = torch.tensor(problem["p"], requires_grad=True)
    sll = tpruning.site_log_likelihoods(
        p, torch.tensor(problem["leaves"]), torch.tensor(problem["freqs"]),
        problem["tdata"])
    tpruning.total_log_likelihood(sll, torch.tensor(w)).backward()
    np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-10, atol=1e-12)


# a nine-leaf polytomy beside three cherries under a five-way root: the port
# splits the first level into arity classes (the JAX package pads all four
# nodes to nine children)
WIDE = ("((t0:0.1,t1:0.2,t2:0.05,t3:0.1,t4:0.02,t5:0.3,t6:0.1,t7:0.05,t8:0.2):0.05,"
        "(t9:0.1,t10:0.2):0.1,(t11:0.05,t12:0.1):0.2,(t13:0.3,t14:0.01):0.1,t15:0.2)")


def test_wide_level_is_split_and_matches_jax():
    aln = synthetic_codon_alignment(16, N_CODONS, seed=SEED)
    filt = JDataFilter.from_alignment(aln, "codon")
    tree = Tree.from_newick(WIDE, leaf_order=filt.names)
    tdata = tpruning.build_pruning_data(tree, "cpu")
    assert [cs.shape for _, cs, _ in tdata.ulevels] == [(3, 2), (1, 12), (1, 8)]
    assert [off for off, _, _ in tdata.ulevels] == [16, 19, 20]
    rng = np.random.default_rng(9)
    s = filt.n_states
    p = rng.uniform(0.0, 1.0, size=(tree.n_branches, s, s)) + 20.0 * np.eye(s)
    pr = dict(p=p / p.sum(-1, keepdims=True), leaves=filt.leaf_partials().astype(np.float64),
              freqs=rng.dirichlet(np.ones(s)), tdata=tdata,
              jdata=jpruning.build_pruning_data(JTree.from_newick(WIDE, leaf_order=filt.names)))
    np.testing.assert_allclose(_torch_sites(pr, torch.float64), _jax_sites(pr, jnp.float64),
                               rtol=1e-10)


def test_star_tree_does_not_underflow():
    """A 200-leaf star: the reference multiplies all 200 child messages
    before it renormalises, which underflows fp32 (sites at log(tiny)); the
    port multiplies them four at a time and combines the chunks with
    renormalisation, so fp32 stays near fp64, and fp64 (in range in both
    packages here) matches the reference."""
    n = 200
    aln = synthetic_codon_alignment(n, N_CODONS, seed=SEED)
    filt = JDataFilter.from_alignment(aln, "codon")
    newick = "(" + ",".join(f"t{i}:0.1" for i in range(n)) + ")"
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    rng = np.random.default_rng(4)
    s = filt.n_states
    p = rng.uniform(0.0, 1.0, size=(tree.n_branches, s, s)) + 20.0 * np.eye(s)
    pr = dict(p=p / p.sum(-1, keepdims=True), leaves=filt.leaf_partials().astype(np.float64),
              freqs=rng.dirichlet(np.ones(s)), tdata=tpruning.build_pruning_data(tree, "cpu"),
              jdata=jpruning.build_pruning_data(JTree.from_newick(newick, leaf_order=filt.names)))
    ours64 = _torch_sites(pr, torch.float64)
    np.testing.assert_allclose(ours64, _jax_sites(pr, jnp.float64), rtol=1e-10)
    ref32 = _jax_sites(pr, jnp.float32)
    assert (ref32 < np.log(np.finfo(np.float32).tiny) + 1).mean() > 0.5
    np.testing.assert_allclose(_torch_sites(pr, torch.float32), ours64, atol=1e-2, rtol=0)
