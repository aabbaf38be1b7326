"""The port's ``LikelihoodFunction.covariance_matrix`` (an autograd Hessian
through the pruning's twice-differentiable K1), ``profile_ci``,
``initial_parameters`` and ``FitResult.aic_c`` against the JAX package's, at
the JAX package's fitted parameters: on ``tests/test_engine.py::
TestUncertainty``'s JC69 fit and on a GTR fit of a 6-taxon fixture (the
covariance of the exchangeabilities and one branch, and the profile CI of a
scalar), to 1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyphy_tpu.data.alignment import Alignment as JAlignment
from hyphy_tpu.data.filter import DataFilter as JDataFilter
from hyphy_tpu.likelihood import LikelihoodFunction as JLikelihoodFunction
from hyphy_tpu.likelihood import Partition as JPartition
from hyphy_tpu.models.dna import GTR as JGTR
from hyphy_tpu.models.dna import JC69 as JJC69
from hyphy_tpu.tree.topology import Tree as JTree
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.data.alignment import Alignment
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.likelihood import FitResult, LikelihoodFunction, Partition
from hyphy_tpu_torch.models.dna import GTR, JC69
from hyphy_tpu_torch.tree.topology import Tree
from hyphy_tpu_torch.utils.synth import random_tree_newick, synthetic_codon_alignment

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    saved = settings.device
    settings.device = "cpu"
    yield
    settings.device = saved


def _both(names, seqs, newick, model):
    jfilt = JDataFilter.from_alignment(JAlignment(names, seqs), "nucleotide")
    filt = DataFilter.from_alignment(Alignment(names, seqs), "nucleotide")
    jtree = JTree.from_newick(newick, leaf_order=jfilt.names)
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    if model == "JC69":
        jm, tm = JJC69(), JC69(device="cpu")
    else:
        freqs = filt.harvest_frequencies(1, 1, False)[:, 0]
        jm, tm = JGTR(freqs), GTR(freqs, device="cpu")
    jlf = JLikelihoodFunction([JPartition(jfilt, jtree, jm)])
    # the JAX side's loglik jit-compiled once: its profile CI and Hessian
    # call it eagerly otherwise (the test's time, not its numbers)
    jlf.loglik = jax.jit(jlf.loglik)
    lf = LikelihoodFunction([Partition(filt, tree, tm)], device="cpu")
    res = jlf.fit(precision=1e-6)
    params = {k: np.asarray(v, dtype=np.float64) for k, v in res.params.items()}
    return jlf, lf, res, params


@pytest.fixture(scope="module")
def jc69():
    return _both(["A", "B", "C"],
                 ["ACGTTACGGT" * 4, "ACGTAACGGT" * 4, "AAGTAACGCT" * 4],
                 "((A:0.1,B:0.2):0.05,C:0.3)", "JC69")


@pytest.fixture(scope="module")
def gtr():
    aln = synthetic_codon_alignment(6, 40, seed=21)
    return _both(aln.names, aln.sequences, random_tree_newick(6, seed=21), "GTR")


def _torch(params):
    return {k: torch.tensor(v) for k, v in params.items()}


@pytest.mark.parametrize("fixture, keys", [
    ("jc69", None),
    ("gtr", None),
    ("gtr", ["theta_AC", "theta_CT", "t"]),
], ids=["jc69-all", "gtr-all", "gtr-subset"])
def test_covariance_matches_jax(request, fixture, keys):
    jlf, lf, _, params = request.getfixturevalue(fixture)
    jcov, jlabels = jlf.covariance_matrix({k: jnp.asarray(v) for k, v in params.items()},
                                          keys=keys)
    cov, labels = lf.covariance_matrix(_torch(params), keys=keys)
    assert labels == jlabels
    assert cov.shape == (len(labels), len(labels))
    np.testing.assert_allclose(cov, cov.T, atol=1e-10 * np.abs(cov).max())
    np.testing.assert_allclose(cov, np.asarray(jcov), rtol=1e-6, atol=1e-6 * np.abs(jcov).max())
    # the information matrix is not the zero matrix of a first-order-only
    # backward
    assert np.abs(np.diag(cov)).max() > 0


@pytest.mark.parametrize("key", ["theta_CT", "theta_AT"])
def test_profile_ci_matches_jax(gtr, key):
    jlf, lf, res, params = gtr
    jlo, jhi = jlf.profile_ci({k: jnp.asarray(v) for k, v in params.items()}, key, res.loglik)
    lo, hi = lf.profile_ci(_torch(params), key, res.loglik)
    assert lo <= float(params[key]) <= hi
    assert lo == pytest.approx(jlo, rel=1e-6) and hi == pytest.approx(jhi, rel=1e-6)


def test_initial_parameters_and_aic_c(gtr):
    jlf, lf, res, params = gtr
    jinit, init = jlf.initial_parameters(), lf.initial_parameters()
    assert sorted(jinit) == sorted(init)
    for k in jinit:
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(jinit[k]))
    ours = FitResult(params=_torch(params), loglik=res.loglik,
                     n_free_parameters=res.n_free_parameters, n_iterations=0, lf=lf)
    for n in (5, res.n_free_parameters + 1, 240):
        assert ours.aic_c(n) == res.aic_c(n)
