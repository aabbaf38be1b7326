"""The port's FitMultiModel against the JAX package's.

* ``MG94xREVMultiHitGDD``: ``class_distribution`` and the class mixture's
  site lnL through ``LikelihoodFunction`` (the classes folded into K1's
  node axis, mixed in fp64) within 1e-9 relative of the JAX package's
  ``mixture_site_log_likelihoods``, with each hits option, with
  ``triple_islands`` and with one class; its gradient within 1e-6; the
  folded classes equal to each class pruned alone; the card's fp32 Taylor
  route within 0.03 per pattern; ``MG94xREVMultiHit`` alone.
* ``fmm.run``: its three lnLs within 0.15 and its LRTs within 0.3 of the
  JAX package's run, the JSON's keys and shapes the JAX package's.

The fixture is the multi-hit alignment of ``tests/torch_carry.py`` (6 taxa
x 20 codons, simulated with delta 0.2 and psi 0.1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyphy_tpu.data.filter import DataFilter as JDataFilter
from hyphy_tpu.data.genetic_code import GeneticCode as JGeneticCode
from hyphy_tpu.likelihood import LikelihoodFunction as JLikelihoodFunction
from hyphy_tpu.likelihood import Partition as JPartition
from hyphy_tpu.methods import fmm as jfmm
from hyphy_tpu.models import codon as jcodon
from hyphy_tpu.tree.topology import Tree as JTree
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.convert import params_from_numpy
from hyphy_tpu_torch.data.alignment import read_alignment
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.data.genetic_code import GeneticCode
from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
from hyphy_tpu_torch.methods import fmm
from hyphy_tpu_torch.models import codon
from hyphy_tpu_torch.models import frequencies as tfreq
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.tree.topology import Tree
from tests.torch_carry import write_simulated_fasta

torch.set_num_threads(2)

N_TAXA, N_CODONS, SEED = 6, 20, 4

# (hits, rate classes, triple islands)
CASES = [("None", 3, False), ("Double", 3, False), ("Double+Triple", 3, False),
         ("Double+Triple", 3, True), ("Double", 1, False)]


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    fasta, newick = write_simulated_fasta(tmp_path_factory.mktemp("fmm") / "mh.fasta",
                                          N_TAXA, N_CODONS, SEED)
    return {"fasta": fasta, "newick": newick}


@pytest.fixture(scope="module")
def jax_run(fixture):
    return jfmm.run(fixture["fasta"], tree=fixture["newick"])


def _models(fixture, hits, k, islands):
    aln = read_alignment(fixture["fasta"])
    gc, jgc = GeneticCode("Universal"), JGeneticCode("Universal")
    filt = DataFilter.from_alignment(aln, "codon", genetic_code=gc)
    jfilt = JDataFilter.from_alignment(aln, "codon", genetic_code=jgc)
    tree = Tree.from_newick(fixture["newick"], leaf_order=filt.names)
    jtree = JTree.from_newick(fixture["newick"], leaf_order=jfilt.names)
    corners, codon_freqs = tfreq.f3x4(filt, gc)
    groups = np.zeros(tree.n_branches, dtype=np.int64)
    ours = codon.MG94xREVMultiHitGDD(gc, corners, codon_freqs, groups, 1, hits=hits,
                                     rate_classes=k, triple_islands=islands, device="cpu")
    ref = jcodon.MG94xREVMultiHitGDD(jgc, corners, codon_freqs, groups, 1, hits=hits,
                                     rate_classes=k, triple_islands=islands)
    lf = LikelihoodFunction([Partition(filt, tree, ours)], device="cpu")
    jlf = JLikelihoodFunction([JPartition(jfilt, jtree, ref)])
    return ours, ref, lf, jlf, tree


def _point(specs, n_branches):
    rng = np.random.default_rng(2)
    values = {"omega_c": [0.08, 0.6, 3.0], "omega_w": [0.35, 0.6], "delta": 0.3, "psi": 0.15,
              "psi_syn": 0.4, "omega": [0.4]}
    point = {}
    for k, s in specs.items():
        if k.startswith("theta"):
            point[k] = rng.uniform(0.3, 2.0)
        elif k == "alpha":
            point[k] = rng.uniform(0.05, 0.4, size=n_branches)
        else:
            point[k] = np.asarray(values[k], dtype=np.float64).reshape(s.shape)
    return {k: np.asarray(v, dtype=np.float64) for k, v in point.items()}


@pytest.mark.parametrize("hits, k, islands", CASES,
                         ids=["1H", "2H", "3H", "3H-islands", "2H-one-class"])
def test_gdd_mixture_matches(fixture, hits, k, islands):
    ours, ref, lf, jlf, tree = _models(fixture, hits, k, islands)
    assert sorted(lf.specs) == sorted(jlf.specs)
    point = _point(lf.specs, tree.n_branches)
    params = params_from_numpy(point, "cpu")
    jparams = {key: jnp.asarray(v) for key, v in point.items()}
    omegas, weights = ours.class_distribution(params)
    jomegas, jweights = ref.class_distribution(jparams)
    np.testing.assert_allclose(omegas.numpy(), np.asarray(jomegas).reshape(-1), rtol=1e-12)
    np.testing.assert_allclose(weights.numpy(), np.asarray(jweights), rtol=1e-12)
    assert abs(float(weights.sum()) - 1.0) <= 1e-12
    got = lf.site_log_likelihoods(params)[0].numpy()
    want = np.asarray(jlf.site_log_likelihoods(jparams)[0])
    np.testing.assert_allclose(got, want, rtol=1e-9)
    np.testing.assert_allclose(ours.branch_lengths(params).numpy(),
                               np.asarray(ref.branch_lengths(jparams)), rtol=1e-12)
    # the gradient of the mixture
    tparams = {key: v.clone().requires_grad_(True) for key, v in params.items()}
    grads = torch.autograd.grad(lf.loglik(tparams), list(tparams.values()))
    jgrads = jax.grad(jlf.loglik)(jparams)
    for key, g in zip(tparams, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[key]), rtol=1e-6, atol=1e-9)


def test_folded_classes_equal_each_class_alone(fixture):
    """The K classes in one grid-form pruning (one K1 launch per level)
    equal each class's propagators pruned alone by the one-set form; the
    fp32 Taylor route (the card's) within 0.03 per pattern, the fp64 Taylor
    route within 1e-9 relative of the fp64 spectral one."""
    ours, _, lf, _, tree = _models(fixture, "Double+Triple", 3, False)
    params = params_from_numpy(_point(lf.specs, tree.n_branches), "cpu")
    out = ours.build(params, tree.n_branches)
    assert out.p_matrices.shape[0] == 3
    leaves = lf._leaf_partials[0]
    data = lf._pruning_data[0]
    folded = pruning.site_log_likelihoods(out.p_matrices, leaves, out.root_freqs, data,
                                          floor=True)
    for c in range(3):
        alone = pruning.site_log_likelihoods(out.p_matrices[c], leaves, out.root_freqs, data)
        np.testing.assert_allclose(folded[c].numpy(), alone.numpy(), rtol=1e-12)
    spectral = lf.site_log_likelihoods(params)[0].numpy()
    lf32 = LikelihoodFunction(lf.partitions, dtype=torch.float32, device="cpu")
    assert np.abs(lf32.site_log_likelihoods(params)[0].numpy() - spectral).max() <= 0.03
    # the fp64 Taylor route (the card's checks hold it card against host)
    ours.spectral = False
    np.testing.assert_allclose(lf.site_log_likelihoods(params)[0].numpy(), spectral, rtol=1e-9)


def test_multihit_model_matches(fixture):
    aln = read_alignment(fixture["fasta"])
    gc, jgc = GeneticCode("Universal"), JGeneticCode("Universal")
    filt = DataFilter.from_alignment(aln, "codon", genetic_code=gc)
    tree = Tree.from_newick(fixture["newick"], leaf_order=filt.names)
    corners, codon_freqs = tfreq.f3x4(filt, gc)
    groups = (np.arange(tree.n_branches) % 2).astype(np.int64)
    for triple in (False, True):
        ours = codon.MG94xREVMultiHit(gc, corners, codon_freqs, groups, 2, triple=triple,
                                      device="cpu")
        ref = jcodon.MG94xREVMultiHit(jgc, corners, codon_freqs, groups, 2, triple=triple)
        specs = ours.parameter_specs(tree.n_branches)
        point = _point({k: v for k, v in specs.items() if k != "omega"}, tree.n_branches)
        point["omega"] = np.array([0.3, 1.5])
        params = params_from_numpy(point, "cpu")
        jparams = {key: jnp.asarray(v) for key, v in point.items()}
        np.testing.assert_allclose(ours.build(params, tree.n_branches).p_matrices.numpy(),
                                   np.asarray(ref.build(jparams, tree.n_branches).p_matrices),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(ours.branch_lengths(params).numpy(),
                                   np.asarray(ref.branch_lengths(jparams)), rtol=1e-12)


def test_run_matches(fixture, jax_run):
    ours = fmm.run(fixture["fasta"], tree=fixture["newick"])
    for a, b in ((ours.loglik_standard, jax_run.loglik_standard),
                 (ours.loglik_double, jax_run.loglik_double),
                 (ours.loglik_triple, jax_run.loglik_triple)):
        assert abs(a - b) <= 0.15
    got, want = ours.json, jax_run.json
    for name, test in want["test results"].items():
        assert abs(got["test results"][name]["LRT"] - test["LRT"]) <= 0.3
        assert 0.0 <= got["test results"][name]["p-value"] <= 1.0
    assert sorted(got) == sorted(want)
    assert sorted(got["fits"]) == sorted(want["fits"])
    for name, fit in want["fits"].items():
        assert sorted(got["fits"][name]) == sorted(fit)
        if "Rate Distributions" in fit:
            ours_rd, want_rd = got["fits"][name]["Rate Distributions"], fit["Rate Distributions"]
            assert sorted(ours_rd) == sorted(want_rd)
            assert sorted(ours_rd["parameters"]) == sorted(want_rd["parameters"])
            weights = [w for _, w in ours_rd["non-synonymous/synonymous rate ratio"]]
            assert len(weights) == 3 and abs(sum(weights) - 1.0) <= 1e-6
    for block in ("Evidence Ratios", "Site Log Likelihood"):
        for key, rows in want[block].items():
            assert np.asarray(got[block][key]).shape == np.asarray(rows).shape
            assert np.isfinite(np.asarray(got[block][key])).all()
    np.testing.assert_allclose(np.asarray(got["Site Log Likelihood"]["Standard"]).sum(),
                               ours.loglik_standard, rtol=1e-9)
