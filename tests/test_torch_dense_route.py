"""The port's dense per-site route (``ops/pruning.py::
single_site_log_likelihood_dense``: materialised per-branch propagators,
batched over sites) against the JAX package's one-site function site by
site (1e-12 relative), and against the port's Taylor per-site route on the
same generators (fp64, 1e-9 absolute per site)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from hyphy_tpu.ops import pruning as jpruning
from hyphy_tpu.tree.topology import Tree as JTree
from hyphy_tpu.utils.synth import random_tree_newick
from hyphy_tpu_torch.ops import expm as texpm
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.tree.topology import Tree

torch.set_num_threads(2)

TREES = {
    "binary": random_tree_newick(9, seed=2),
    "polytomy": ("((t0:0.1,t1:0.2,t2:0.05,t3:0.1,t4:0.02,t5:0.3):0.05,"
                 "(t6:0.1,t7:0.2):0.1,t8:0.2)"),
}


def _generators(rng, n, s):
    q = np.abs(rng.normal(size=(n, s, s))) * rng.uniform(0.02, 0.2, size=(n, 1, 1))
    idx = np.arange(s)
    q[:, idx, idx] = 0.0
    q[:, idx, idx] = -q.sum(-1)
    return q


def _setup(name, s=61, n_sites=6, seed=1):
    rng = np.random.default_rng(seed)
    newick = TREES[name]
    jtree, tree = JTree.from_newick(newick), Tree.from_newick(newick)
    times = rng.uniform(0.01, 1.5, size=tree.n_branches)
    leaves = np.abs(rng.normal(size=(n_sites, tree.n_leaves, s))) + 0.05
    leaves[:, 0] = np.eye(s)[rng.integers(0, s, size=n_sites)]     # one resolved leaf
    pi = rng.dirichlet(np.ones(s))
    return rng, jtree, tree, times, leaves, pi


@pytest.mark.parametrize("name", sorted(TREES))
def test_dense_matches_jax_site_by_site(name):
    rng, jtree, tree, times, leaves, pi = _setup(name)
    q = _generators(rng, 1, 61)[0]
    p = np.stack([sla.expm(q * t) for t in times])
    jdata = jpruning.build_pruning_data(jtree)
    one = jax.jit(lambda lv: jpruning.single_site_log_likelihood_dense(
        jnp.asarray(p), lv, jnp.asarray(pi), jdata))
    ref = np.array([float(one(jnp.asarray(lv))) for lv in leaves])
    data = pruning.build_pruning_data(tree, "cpu")
    ours = pruning.single_site_log_likelihood_dense(
        torch.tensor(p), torch.tensor(leaves), torch.tensor(pi), data).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0)
    # one propagator set per site gives the same where the sets are equal
    per_site = pruning.single_site_log_likelihood_dense(
        torch.tensor(p)[None].expand(len(leaves), -1, -1, -1).contiguous(),
        torch.tensor(leaves), torch.tensor(pi), data).numpy()
    np.testing.assert_allclose(per_site, ours, rtol=1e-14, atol=0)


@pytest.mark.parametrize("name", sorted(TREES))
def test_dense_matches_the_taylor_route(name):
    """Per-site generators in two branch groups: the dense route on their
    propagators (``transition_matrix``, fp64) against the Taylor vector
    action of ``taylor_action_factors`` on the same generators."""
    n_sites = 16
    rng, _, tree, times, leaves, pi = _setup(name, s=61, n_sites=n_sites, seed=3)
    q = torch.tensor(_generators(rng, 2 * n_sites, 61).reshape(n_sites, 2, 61, 61))
    group = torch.as_tensor(np.arange(tree.n_branches) % 2)
    t = torch.tensor(times)
    p = texpm.transition_matrix(q[:, group], t[None, :].expand(n_sites, -1))   # [N, B, S, S]
    data = pruning.build_pruning_data(tree, "cpu")
    dense = pruning.single_site_log_likelihood_dense(
        p, torch.tensor(leaves), torch.tensor(pi), data).numpy()
    qn, m2p, r, j = texpm.taylor_action_factors(q, t)
    rows = torch.arange(tree.n_branches)
    taylor = pruning.single_site_log_likelihood_taylor(
        qn, m2p, r[:, group, rows], j[:, group, rows], group,
        texpm.taylor_action_terms(torch.float64), torch.tensor(leaves),
        torch.tensor(pi), data).numpy()
    assert np.isfinite(dense).all()
    np.testing.assert_allclose(dense, taylor, rtol=0, atol=1e-9)
