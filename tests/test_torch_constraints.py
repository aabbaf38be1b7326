"""The port's parameter constraints (``models/constraints.py``) and
``LikelihoodFunction.fit(constraints=...)`` against the JAX package's, on
``tests/test_constraints_simulate.py``'s fixture (6 taxa x 24 codons, read
as nucleotides under GTR).

At the same free point ``apply`` gives the JAX package's parameters to
1e-12 and the constrained lnL to 1e-9; the constrained fits end within
0.15 lnL of the JAX package's (ROADMAP 3.4: device against host L-BFGS),
satisfy their constraints exactly, and lie no higher than the free fit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyphy_tpu as ht
from hyphy_tpu.likelihood import LikelihoodFunction as JLikelihoodFunction
from hyphy_tpu.likelihood import Partition as JPartition
from hyphy_tpu.models import constraints as jcon
from hyphy_tpu.models.dna import GTR as JGTR
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.data.alignment import read_alignment
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
from hyphy_tpu_torch.models import constraints as tcon
from hyphy_tpu_torch.models.dna import GTR
from hyphy_tpu_torch.tree.topology import Tree
from hyphy_tpu_torch.utils.synth import random_tree_newick, synthetic_codon_alignment

torch.set_num_threads(2)

N_TAXA, N_CODONS, SEED = 6, 24, 5


@pytest.fixture(autouse=True)
def _on_cpu():
    saved = settings.device
    settings.device = "cpu"
    yield
    settings.device = saved


def _constraints(pkg, tree):
    return {
        "ratio_key": pkg.Proportional("theta_AC", "theta_AT", ratio_key="R"),
        "fixed_ratio": pkg.Proportional("theta_AC", "theta_AT", ratio=1.0),
        "clock": pkg.MolecularClock(tree, target="t"),
    }


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Both packages' GTR likelihood functions, and the JAX package's free
    and constrained fits (one module-scoped run)."""
    aln = synthetic_codon_alignment(N_TAXA, N_CODONS, seed=SEED)
    fa = tmp_path_factory.mktemp("constraints") / "tiny.fasta"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    newick = random_tree_newick(N_TAXA, seed=SEED)

    jaln = ht.read_alignment(str(fa))
    jfilt = ht.DataFilter.from_alignment(jaln, "nucleotide")
    jtree = ht.Tree.from_newick(newick, leaf_order=jfilt.names)
    jlf = JLikelihoodFunction([JPartition(
        jfilt, jtree, JGTR(jfilt.harvest_frequencies(1, 1, False)[:, 0]))])

    filt = DataFilter.from_alignment(read_alignment(str(fa)), "nucleotide")
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    lf = LikelihoodFunction([Partition(
        filt, tree, GTR(filt.harvest_frequencies(1, 1, False)[:, 0], device="cpu"))],
        device="cpu")
    jax_fits = {"free": jlf.fit(precision=1e-4)}
    for name, con in _constraints(jcon, jtree).items():
        jax_fits[name] = jlf.fit(precision=1e-4, constraints=[con])
    return dict(jlf=jlf, jtree=jtree, lf=lf, tree=tree, jax_fits=jax_fits)


def _free_point(specs, rng):
    """A random point inside the bounds of the constrained specs."""
    out = {}
    for k, s in specs.items():
        lo, hi = max(s.lower, 1e-3), min(s.upper, 2.0)
        if k.endswith("_clock_frac"):
            lo, hi = 0.2, 0.9
        out[k] = rng.uniform(lo, hi, size=s.shape)
    return out


@pytest.mark.parametrize("name", ["ratio_key", "fixed_ratio", "clock"])
def test_apply_and_lnl_match_jax(both, name):
    jcons = _constraints(jcon, both["jtree"])[name]
    tcons = _constraints(tcon, both["tree"])[name]
    jspecs = jcons.transform_specs(dict(both["jlf"].specs))
    tspecs = tcons.transform_specs(dict(both["lf"].specs))
    assert sorted(jspecs) == sorted(tspecs)
    for k in jspecs:
        assert (jspecs[k].init, jspecs[k].lower, jspecs[k].upper, tuple(jspecs[k].shape)) == (
            tspecs[k].init, tspecs[k].lower, tspecs[k].upper, tuple(tspecs[k].shape)), k
    point = _free_point(tspecs, np.random.default_rng(3))
    jp = jcons.apply({k: jnp.asarray(v) for k, v in point.items()})
    tp = tcons.apply({k: torch.as_tensor(v) for k, v in point.items()})
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-12, atol=0)
    jl = float(both["jlf"].loglik(jp))
    tl = float(both["lf"].loglik(tp))
    assert abs(tl - jl) <= 1e-9 * abs(jl), (tl, jl)


def test_clock_heights_one_op_per_depth_equal_the_node_loop():
    """The port's per-depth heights against the JAX package's node-by-node
    loop on a 60-taxon tree (1e-12 relative), with as many index writes as
    the tree is deep."""
    from hyphy_tpu.tree.topology import Tree as JTree

    newick = random_tree_newick(60, seed=9)
    jtree, tree = JTree.from_newick(newick), Tree.from_newick(newick)
    jc, tc = jcon.MolecularClock(jtree), tcon.MolecularClock(tree)
    rng = np.random.default_rng(4)
    point = {"t": np.zeros(tree.n_branches), "t_clock_height": np.asarray(1.7),
             "t_clock_frac": rng.uniform(0.05, 0.95, size=len(tc.internal_order))}
    jt = np.asarray(jc.apply({k: jnp.asarray(v) for k, v in point.items()})["t"])
    tt = tc.apply({k: torch.as_tensor(v) for k, v in point.items()})["t"].numpy()
    np.testing.assert_allclose(tt, jt, rtol=1e-12, atol=0)
    depth = max(len(tc._levels), 1)
    assert depth < len(tc.internal_order) // 3


@pytest.mark.parametrize("name", ["ratio_key", "fixed_ratio", "clock"])
def test_constrained_fit_matches_jax(both, name):
    lf, tree = both["lf"], both["tree"]
    con = _constraints(tcon, tree)[name]
    res = lf.fit(precision=1e-4, constraints=[con])
    jres = both["jax_fits"][name]
    jfree = both["jax_fits"]["free"]
    assert abs(res.loglik - jres.loglik) <= 0.15, (res.loglik, jres.loglik)
    assert res.n_free_parameters == jres.n_free_parameters
    assert res.loglik <= jfree.loglik + 1e-3
    p = {k: v.numpy() for k, v in res.params.items()}
    if name == "ratio_key":
        assert float(p["theta_AC"]) == pytest.approx(float(p["R"]) * float(p["theta_AT"]),
                                                     rel=1e-15)
    elif name == "fixed_ratio":
        assert float(p["theta_AC"]) == float(p["theta_AT"])
    else:
        t = p["t"]
        assert (t >= 0).all()
        parent = np.asarray(tree.parent)
        for leaf in range(tree.n_leaves):
            total, nd = 0.0, leaf
            while nd != tree.root:
                total += t[nd]
                nd = parent[nd]
            assert total == pytest.approx(float(p["t_clock_height"]), rel=1e-12)
    # the fit's lnL is the likelihood at its constrained parameters
    assert float(lf.loglik(res.params)) == pytest.approx(res.loglik, abs=1e-9)
