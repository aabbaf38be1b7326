"""The port's gene-likelihood slice against the JAX package: the data
layer, parameter conversion, ``LikelihoodFunction.loglik`` and its
gradients for GTR, HKY85, JC69 and MG94xREV, and the staged fits
load -> GTR -> global MG94xREV on the tiny fixture of
``tests/test_fast_methods.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyphy_tpu.methods.common as jcommon
from hyphy_tpu.data.filter import DataFilter as JDataFilter
from hyphy_tpu.data.genetic_code import GeneticCode as JGeneticCode
from hyphy_tpu.likelihood import LikelihoodFunction as JLikelihoodFunction
from hyphy_tpu.likelihood import Partition as JPartition
from hyphy_tpu.models import frequencies as jfreq
from hyphy_tpu.models.codon import MG94xREVPartitionedOmega as JMG94
from hyphy_tpu.models import dna as jdna
from hyphy_tpu.tree.topology import LevelSchedule as JLevelSchedule
from hyphy_tpu.tree.topology import Tree as JTree
from hyphy_tpu.utils import synth as jsynth
import hyphy_tpu_torch.methods.common as tcommon
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.convert import params_from_numpy, params_to_numpy
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.data.genetic_code import GeneticCode
from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
from hyphy_tpu_torch.models import frequencies as tfreq
from hyphy_tpu_torch.models.codon import MG94xREVPartitionedOmega
from hyphy_tpu_torch.models import dna
from hyphy_tpu_torch.tree.topology import LevelSchedule, Tree
from hyphy_tpu_torch.utils import synth

torch.set_num_threads(2)

N_TAXA, N_CODONS, SEED = 6, 20, 11


@pytest.fixture(autouse=True)
def _on_cpu():
    saved = settings.device
    settings.device = "cpu"
    yield
    settings.device = saved


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    aln = synth.synthetic_codon_alignment(N_TAXA, N_CODONS, seed=SEED)
    fa = tmp_path_factory.mktemp("tiny") / "tiny.fasta"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    return {"aln": aln, "fasta": str(fa), "tree": synth.random_tree_newick(N_TAXA, seed=SEED)}


def test_synth_is_bit_identical():
    assert synth.random_tree_newick(50, seed=3) == jsynth.random_tree_newick(50, seed=3)
    a = synth.synthetic_codon_alignment(7, 40, seed=5)
    b = jsynth.synthetic_codon_alignment(7, 40, seed=5)
    assert a.names == b.names and a.sequences == b.sequences


@pytest.mark.parametrize("datatype", ["nucleotide", "codon"])
def test_data_layer_matches(tiny, datatype):
    ours = DataFilter.from_alignment(tiny["aln"], datatype)
    ref = JDataFilter.from_alignment(tiny["aln"], datatype)
    assert ours.names == ref.names
    np.testing.assert_array_equal(ours.leaf_partials(), ref.leaf_partials())
    np.testing.assert_array_equal(ours.pattern_weights, ref.pattern_weights)
    tree = Tree.from_newick(tiny["tree"], leaf_order=ours.names)
    jtree = JTree.from_newick(tiny["tree"], leaf_order=ref.names)
    assert len(tree.levels()) == len(jtree.levels())
    for a, b in zip(tree.levels(), jtree.levels()):
        np.testing.assert_array_equal(a, b)
    sa, sb = LevelSchedule.build(tree), JLevelSchedule.build(jtree)
    np.testing.assert_array_equal(sa.node_ids, sb.node_ids)
    np.testing.assert_array_equal(sa.child_ids, sb.child_ids)


def test_params_round_trip():
    rng = np.random.default_rng(0)
    params_np = {"omega": rng.uniform(size=2), "theta_AC": np.asarray(0.3)}
    back = params_to_numpy(params_from_numpy(params_np, "cpu", torch.float64))
    for k, v in params_np.items():
        assert back[k].dtype == np.float64 and back[k].shape == np.shape(v)
        np.testing.assert_array_equal(back[k], v)
    as32 = params_from_numpy(params_np, "cpu", torch.float32)
    assert all(v.dtype == torch.float32 for v in as32.values())


def _both_models(tiny, kind):
    """(port LF, JAX LF, parameter point) for one model kind: the models'
    initial values, with the nucleotide models' branch times set to the
    tree's lengths and MG94's alpha set to 0.3 on every branch.

    Both packages take fp64 codon propagators from an eigendecomposition,
    whose absolute round-off (~1e-15) is a large relative error in the P
    entries of multi-step codon changes across short branches (~1e-14 at a
    length of 2e-3).  Site lnLs lean on such entries, so two LAPACK builds
    disagree in lnL by an amount that grows as branches shorten: on this
    fixture the JAX package's own jitted and eager evaluations differ by
    9e-9 at alpha = 0.15 and by 1e-9 at alpha = 0.3."""
    aln = tiny["aln"]
    datatype = "codon" if kind == "mg94" else "nucleotide"
    filt = DataFilter.from_alignment(aln, datatype)
    jfilt = JDataFilter.from_alignment(aln, datatype)
    tree = Tree.from_newick(tiny["tree"], leaf_order=filt.names)
    jtree = JTree.from_newick(tiny["tree"], leaf_order=jfilt.names)
    nb = tree.n_branches
    if kind == "jc69":
        model, jmodel = dna.JC69(), jdna.JC69()
    elif kind in ("gtr", "hky85"):
        freqs = tfreq.empirical_nucleotide(filt)
        name = kind.upper()
        model, jmodel = getattr(dna, name)(freqs), getattr(jdna, name)(freqs)
    else:
        corners, codon_freqs = tfreq.f3x4(filt, GeneticCode("Universal"))
        lengths = np.maximum(np.abs(tree.input_lengths[:-1]), 1e-3)
        args = (corners, codon_freqs, lengths, np.zeros(nb, np.int32), 1)
        model = MG94xREVPartitionedOmega(GeneticCode("Universal"), *args, free_lengths=True)
        jmodel = JMG94(JGeneticCode("Universal"), *args, free_lengths=True)
    lf = LikelihoodFunction([Partition(filt, tree, model)])
    jlf = JLikelihoodFunction([JPartition(jfilt, jtree, jmodel)], mesh=None)
    point = {k: np.asarray(s.initial(), np.float64) for k, s in jlf.specs.items()}
    if kind == "mg94":
        point["alpha"] = np.full(nb, 0.3)
    else:
        point["t"] = np.maximum(tree.input_lengths[:-1], 1e-6)
    return lf, jlf, point


@pytest.mark.parametrize("kind", ["gtr", "hky85", "jc69", "mg94"])
def test_loglik_and_gradient_match(tiny, kind):
    lf, jlf, point = _both_models(tiny, kind)
    assert lf.dtype == torch.float64 and set(lf.specs) == set(jlf.specs)
    ref_val, ref_grad = jax.value_and_grad(jlf.loglik)(
        {k: jnp.asarray(v) for k, v in point.items()})
    params = {k: v.requires_grad_() for k, v in params_from_numpy(point, "cpu").items()}
    val = lf.loglik(params)
    val.backward()
    assert abs(val.item() - float(ref_val)) <= 1e-8
    for k in point:
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(ref_grad[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)


def test_staged_fits_match(tiny):
    data = tcommon.load_codon_data(tiny["fasta"], tree_newick=tiny["tree"])
    jdata = jcommon.load_codon_data(tiny["fasta"], tree_newick=tiny["tree"])
    assert data.device.type == "cpu"
    np.testing.assert_array_equal(data.branch_groups, jdata.branch_groups)
    gtr = tcommon.fit_gtr(data)
    jgtr = jcommon.fit_gtr(jdata)
    assert abs(gtr.loglik - jgtr.loglik) <= 1e-3
    mg = tcommon.fit_partitioned_mg94(data, gtr)
    jmg = jcommon.fit_partitioned_mg94(jdata, jgtr)
    assert abs(mg.loglik - jmg.loglik) <= 1e-3
    assert mg.n_parameters == jmg.n_parameters
    np.testing.assert_allclose(mg.corner_freqs, jmg.corner_freqs, atol=1e-6)
    stat, p = tcommon.lrt(mg.loglik, gtr.loglik, 1)
    assert (stat, p) == jcommon.lrt(mg.loglik, gtr.loglik, 1)


def test_fp64_taylor_route_matches_at_short_branches(tiny):
    """At bench.py's kind of point (alpha = the tree's lengths, down to
    1e-3) the two packages' fp64 spectral lnLs drift apart (see
    ``_both_models``); fp64 propagators from the Taylor route keep the tiny
    entries accurate, and the two packages agree there."""
    from hyphy_tpu.models.base import fill_diagonal_from_rows as jfill
    from hyphy_tpu.ops import expm as jexpm
    from hyphy_tpu.ops import pruning as jpruning
    from hyphy_tpu_torch.models.base import fill_diagonal_from_rows
    from hyphy_tpu_torch.ops import expm, pruning

    lf, jlf, point = _both_models(tiny, "mg94")
    tree = lf.partitions[0].tree
    point["alpha"] = np.maximum(np.abs(tree.input_lengths[:-1]), 1e-3)
    weights = np.asarray(lf.partitions[0].filter.pattern_weights, np.float64)

    jmodel, jp = jlf.partitions[0].model, {k: jnp.asarray(v) for k, v in point.items()}
    q_syn, q_non = jmodel.basis_matrices(jp)
    p = jexpm.shared_taylor_propagators(jfill(q_syn + jp["omega"][0] * q_non), jp["alpha"])
    ref = float(jnp.dot(jpruning.site_log_likelihoods(
        p, jlf._leaf_partials[0], jmodel.frequencies, jlf._pruning_data[0]), weights))

    model, tp = lf.partitions[0].model, params_from_numpy(point, "cpu")
    q_syn, q_non = model.basis_matrices(tp)
    p = expm.shared_taylor_propagators(
        fill_diagonal_from_rows(q_syn + tp["omega"][0] * q_non), tp["alpha"])
    ours = float(pruning.site_log_likelihoods(
        p, lf._leaf_partials[0], model.frequencies, lf._pruning_data[0]) @ torch.from_numpy(weights))
    assert abs(ours - ref) <= 1e-8
