"""The port's 2-state model (``models/binary.py``) against the JAX
package's: Q, the propagators and the lnL at a point (1e-9), the fit of
``tests/test_data.py::TestBinaryModel`` (within 0.15 lnL, ROADMAP 3.4), and
a presence/absence matrix simulated along a 40-taxon tree, whose pruning
runs every level through K1 at 2 states (its plain version here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyphy_tpu as ht
from hyphy_tpu.likelihood import LikelihoodFunction as JLikelihoodFunction
from hyphy_tpu.likelihood import Partition as JPartition
from hyphy_tpu.models.binary import Binary as JBinary
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.data.alignment import read_alignment
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
from hyphy_tpu_torch.models.binary import Binary
from hyphy_tpu_torch.ops import level_products as lp_mod
from hyphy_tpu_torch.tree.topology import Tree

torch.set_num_threads(2)

_FIXTURE = ">a\n0101100110\n>b\n0101110110\n>c\n1101100010\n>d\n1001101010\n"


@pytest.fixture(autouse=True)
def _on_cpu():
    saved = settings.device
    settings.device = "cpu"
    yield
    settings.device = saved


def _pair(path, newick):
    jfilt = ht.DataFilter.from_alignment(ht.read_alignment(str(path)), "binary")
    jtree = ht.Tree.from_newick(newick, leaf_order=jfilt.names)
    jfreqs = jfilt.harvest_frequencies(1, 1, False)[:, 0]
    jlf = JLikelihoodFunction([JPartition(jfilt, jtree, JBinary(jfreqs))])
    filt = DataFilter.from_alignment(read_alignment(str(path)), "binary")
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    freqs = filt.harvest_frequencies(1, 1, False)[:, 0]
    np.testing.assert_array_equal(freqs, jfreqs)
    lf = LikelihoodFunction([Partition(filt, tree, Binary(freqs, device="cpu"))], device="cpu")
    return jlf, lf


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    fa = tmp_path_factory.mktemp("binary") / "bin.fasta"
    fa.write_text(_FIXTURE)
    jlf, lf = _pair(fa, "((a,b),(c,d))")
    return jlf, lf, jlf.fit(precision=1e-5)


@pytest.fixture(scope="module")
def simulated(tmp_path_factory):
    """400 characters along a 40-taxon tree under Binary([0.6, 0.4]) with
    the port's simulator (the chip run's input, cut in size)."""
    from hyphy_tpu_torch.utils.simulate import simulate_states
    from hyphy_tpu_torch.utils.synth import random_tree_newick

    newick = random_tree_newick(40, seed=11)
    tree = Tree.from_newick(newick)
    model = Binary([0.6, 0.4], device="cpu")
    t = torch.as_tensor(np.random.default_rng(11).uniform(0.02, 0.4, tree.n_branches))
    p = model.build({"t": t}, tree.n_branches).p_matrices.numpy()
    states = simulate_states(tree, p, np.array([0.6, 0.4]), 400, np.random.default_rng(11))
    fa = tmp_path_factory.mktemp("binary_sim") / "sim.fasta"
    fa.write_text("".join(f">{tree.names[i]}\n{''.join('01'[s] for s in states[i])}\n"
                          for i in range(tree.n_leaves)))
    return _pair(fa, newick)


def test_q_and_propagators_match_jax():
    freqs = np.array([0.62, 0.38])
    t = np.array([0.0, 1e-4, 0.05, 0.7, 4.0, 60.0])
    jm, tm = JBinary(freqs), Binary(freqs, device="cpu")
    jq = np.asarray(jm.q_matrix({"t": jnp.asarray(t)}))
    tq = tm.q_matrix({"t": torch.as_tensor(t)}).numpy()
    np.testing.assert_allclose(tq, jq, rtol=1e-15, atol=0)
    jp = np.asarray(jm.build({"t": jnp.asarray(t)}, len(t)).p_matrices)
    tp = tm.build({"t": torch.as_tensor(t)}, len(t)).p_matrices.numpy()
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-12)
    # the closed form of the 2-state chain
    decay = np.exp(-t)[:, None, None]
    exact = freqs[None, None, :] + (np.eye(2)[None] - freqs[None, None, :]) * decay
    np.testing.assert_allclose(tp, exact, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tm.branch_lengths({"t": torch.as_tensor(t)}).numpy(),
        np.asarray(jm.branch_lengths({"t": jnp.asarray(t)})), rtol=1e-14)


@pytest.mark.parametrize("fixture", ["small", "simulated"])
def test_lnl_and_gradient_at_a_point_match_jax(request, fixture):
    jlf, lf = request.getfixturevalue(fixture)[:2]
    n_b = lf.partitions[0].tree.n_branches
    t = np.random.default_rng(2).uniform(0.01, 0.8, n_b)
    jl = float(jlf.loglik({"t": jnp.asarray(t)}))
    tt = torch.tensor(t, requires_grad=True)
    before = lp_mod.level_products.launches
    tl = lf.loglik({"t": tt})
    assert lp_mod.level_products.launches == before        # the plain version on the CPU
    assert abs(float(tl.detach()) - jl) <= 1e-9 * abs(jl)
    import jax

    jg = np.asarray(jax.grad(lambda x: jlf.loglik({"t": x}))(jnp.asarray(t)))
    tg = torch.autograd.grad(tl, tt)[0].numpy()
    np.testing.assert_allclose(tg, jg, rtol=1e-9, atol=1e-12)


def test_fit_matches_jax(small):
    jlf, lf, jres = small
    res = lf.fit(precision=1e-5)
    assert np.isfinite(res.loglik) and res.loglik < 0
    assert abs(res.loglik - jres.loglik) <= 0.15, (res.loglik, jres.loglik)


def test_simulated_fit_matches_jax(simulated):
    jlf, lf = simulated
    jres = jlf.fit(precision=1e-3)
    res = lf.fit(precision=1e-3)
    assert abs(res.loglik - jres.loglik) <= 0.15, (res.loglik, jres.loglik)
