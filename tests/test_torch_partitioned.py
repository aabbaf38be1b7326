"""The port's CHARSET partitions and joint fits against the JAX package's,
on a NEXUS file both packages read: 6 taxa x 30 codons in three CHARSETs
(one ending mid-codon), one TREE per partition (``tests/torch_carry.py``).

* Loading, pooled frequencies, and the joint GTR and MG94 (None / Double /
  Double+Triple) log-likelihoods at the same parameters, in fp64.
* FEL end to end, each package fitting its own joint global models; and
  the per-site stage of every partition on the JAX run's carried fits.

The JAX runs are shared through module-scoped fixtures."""

import numpy as np
import pytest
import torch

import hyphy_tpu.methods.common as jcommon
from hyphy_tpu.likelihood import LikelihoodFunction as JLikelihoodFunction
from hyphy_tpu.likelihood import Partition as JPartition
from hyphy_tpu.methods import fel as jfel
from hyphy_tpu.models import frequencies as jfreq
from hyphy_tpu.models.codon import MG94xREVPartitionedOmega as JMG94
from hyphy_tpu.models.dna import GTR as JGTR
import hyphy_tpu_torch.methods.common as tcommon
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.convert import params_from_numpy
from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
from hyphy_tpu_torch.methods import fel
from hyphy_tpu_torch.models import frequencies as tfreq
from hyphy_tpu_torch.models.codon import MG94xREVPartitionedOmega
from hyphy_tpu_torch.models.dna import GTR
from tests.torch_carry import CHARSETS, calls, carry_into, spy_fits, write_partitioned_nexus

torch.set_num_threads(2)

N_CODONS = 30
LOGLIK_RTOL = 1e-10      # joint lnL at identical parameters, fp64
FIT_ATOL = 1e-3          # fitted joint lnL, each package's own fit
FREQ_ATOL = 1e-12        # pooled frequencies


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")


@pytest.fixture(scope="module")
def nexus(tmp_path_factory):
    return write_partitioned_nexus(tmp_path_factory.mktemp("parts") / "parts.nex",
                                   n_codons=N_CODONS)


@pytest.fixture(scope="module")
def loaded(nexus):
    return (jcommon.load_codon_data_multi(nexus),
            tcommon.load_codon_data_multi(nexus, device="cpu"))


@pytest.fixture(scope="module")
def fel_runs(nexus):
    """JAX and port ``fel.run`` on the partitioned file, the JAX run's
    joint global fits recorded on the way."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        spy_fits(jcommon, mp, seen)
        jres = jfel.run(nexus)
    saved = settings.device
    settings.device = "cpu"
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("HYPHY_TPU_PROGRESS", "0")
            tres = fel.run(nexus)
    finally:
        settings.device = saved
    return jres, tres, seen


def test_partitions_load_alike(loaded):
    jmd, tmd = loaded
    assert tmd.n_partitions == jmd.n_partitions == len(CHARSETS)
    assert tmd.partition_names == jmd.partition_names == [n for n, _ in CHARSETS]
    # codon 21 (nucleotides 61-63) is snapped into the second partition
    assert [p.n_sites for p in tmd.parts] == [p.n_sites for p in jmd.parts] == [10, 11, 9]
    assert tmd.n_sites == N_CODONS
    for t, j in zip(tmd.parts, jmd.parts):
        np.testing.assert_array_equal(t.codon_filter.pattern_weights, j.codon_filter.pattern_weights)
        np.testing.assert_array_equal(t.codon_filter.leaf_partials(), j.codon_filter.leaf_partials())
        np.testing.assert_array_equal(t.nuc_filter.leaf_partials(), j.nuc_filter.leaf_partials())
        assert t.tree.to_newick() == j.tree.to_newick()
    # each partition takes its own tree, in declaration order
    assert len({p.tree.to_newick() for p in tmd.parts}) == len(CHARSETS)


@pytest.mark.parametrize("which", ["empirical_nucleotide", "f3x4", "cf3x4"])
def test_pooled_frequencies_match(loaded, which):
    jmd, tmd = loaded
    if which == "empirical_nucleotide":
        ours = tfreq.empirical_nucleotide([p.nuc_filter for p in tmd.parts])
        ref = jfreq.empirical_nucleotide([p.nuc_filter for p in jmd.parts])
        # pooled over the partitions, not one partition's
        assert np.abs(ours - tfreq.empirical_nucleotide(tmd.parts[0].nuc_filter)).max() > 1e-3
    else:
        kwargs = {"device": "cpu"} if which == "cf3x4" else {}
        ours = np.concatenate(getattr(tfreq, which)(
            [p.codon_filter for p in tmd.parts], tmd.genetic_code, **kwargs), axis=None)
        ref = np.concatenate(getattr(jfreq, which)(
            [p.codon_filter for p in jmd.parts], jmd.genetic_code), axis=None)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=FREQ_ATOL)


def _point(specs, seed=5):
    """A parameter point away from the initial values, where the fp64
    spectral route is well conditioned (branch rates 0.1-0.4)."""
    rng = np.random.default_rng(seed)
    point = {}
    for k, s in sorted(specs.items()):
        if k.startswith("theta"):
            point[k] = np.asarray(rng.uniform(0.3, 2.0))
        elif k in ("delta", "psi"):
            point[k] = np.asarray(0.2 if k == "delta" else 0.1)
        elif k == "omega":
            point[k] = np.full(s.shape, 0.4)
        else:
            point[k] = rng.uniform(0.1, 0.4, size=s.shape)
    return point


@pytest.mark.parametrize("model", ["gtr", "mg94-None", "mg94-Double", "mg94-Double+Triple"])
def test_joint_loglik_matches_at_same_parameters(loaded, model):
    jmd, tmd = loaded
    if model == "gtr":
        freqs = jfreq.empirical_nucleotide([p.nuc_filter for p in jmd.parts])
        jparts = [JPartition(p.nuc_filter, p.tree, JGTR(freqs)) for p in jmd.parts]
        tparts = [Partition(p.nuc_filter, p.tree, GTR(freqs, device="cpu")) for p in tmd.parts]
    else:
        mh = model.split("-", 1)[1]
        corners, codon_freqs = jfreq.cf3x4([p.codon_filter for p in jmd.parts], jmd.genetic_code)

        def models(cls, md, **kw):
            return [cls(md.genetic_code, corners, codon_freqs,
                        nuc_lengths=np.full(p.tree.n_branches, 0.1),
                        branch_groups=p.branch_groups, n_groups=1, free_lengths=True,
                        multiple_hits=mh, **kw) for p in md.parts]

        jparts = [JPartition(p.codon_filter, p.tree, m)
                  for p, m in zip(jmd.parts, models(JMG94, jmd))]
        tparts = [Partition(p.codon_filter, p.tree, m)
                  for p, m in zip(tmd.parts, models(MG94xREVPartitionedOmega, tmd, device="cpu"))]
    jlf = JLikelihoodFunction(jparts, dtype="float64")
    tlf = LikelihoodFunction(tparts, dtype="float64", device="cpu")
    assert sorted(tlf.specs) == sorted(jlf.specs)
    assert any(k.startswith("p2:") for k in tlf.specs)      # per-partition lengths
    point = _point(jlf.specs)
    ref = float(jlf.loglik({k: np.asarray(v) for k, v in point.items()}))
    with torch.no_grad():
        ours = float(tlf.loglik(params_from_numpy(point, "cpu")))
    assert np.isfinite(ours)
    assert abs(ours - ref) <= LOGLIK_RTOL * abs(ref), (ours, ref)
    # the joint dict maps back to each partition's local names
    length = "t" if model == "gtr" else "alpha"
    local = tlf.partition_local_params(point, 2)
    assert local["theta_AC"] is point["theta_AC"] and local[length] is point[f"p2:{length}"]
    assert tlf.partition_key(1, length) == f"p1:{length}"


def test_joint_fits_match(fel_runs):
    jres, tres, _ = fel_runs
    for name in ("Nucleotide GTR", "Global MG94xREV"):
        ours = tres.json["fits"][name]["Log Likelihood"]
        ref = jres.json["fits"][name]["Log Likelihood"]
        assert abs(ours - ref) <= FIT_ATOL, (name, ours, ref)
        assert tres.json["fits"][name]["estimated parameters"] == \
            jres.json["fits"][name]["estimated parameters"]
    np.testing.assert_allclose(tres.mg94.omegas, jres.mg94.omegas, rtol=1e-2)


def test_partitioned_fel_end_to_end(fel_runs):
    jres, tres, _ = fel_runs
    ours, ref = tres.json, jres.json
    assert sorted(ours) == sorted(ref)
    for key in ("input", "fits", "MLE", "data partitions", "tested"):
        assert sorted(ours[key]) == sorted(ref[key]), key
    assert ours["input"]["partition count"] == len(CHARSETS)
    assert sorted(ours["input"]["trees"]) == sorted(ref["input"]["trees"]) == ["0", "1", "2"]
    assert ours["data partitions"] == ref["data partitions"]
    assert ours["MLE"]["headers"] == ref["MLE"]["headers"]
    assert sorted(ours["MLE"]["content"]) == ["0", "1", "2"]
    for k in ours["MLE"]["content"]:
        mine = np.asarray(ours["MLE"]["content"][k])
        theirs = np.asarray(ref["MLE"]["content"][k])
        assert mine.shape == theirs.shape and np.isfinite(mine).all()
        np.testing.assert_array_equal(calls(mine), calls(theirs))
        np.testing.assert_allclose(mine[:, 3], theirs[:, 3], rtol=0, atol=0.05)


def test_partitioned_per_site_stage_on_carried_fits(nexus, fel_runs, monkeypatch):
    jres, _, seen = fel_runs
    carry_into(monkeypatch, seen)
    res = fel.run(nexus)
    assert res.json["MLE"]["headers"] == jres.json["MLE"]["headers"]
    for k, rows in res.json["MLE"]["content"].items():
        ours, ref = np.asarray(rows), np.asarray(jres.json["MLE"]["content"][k])
        np.testing.assert_allclose(ours[:, 3:5], ref[:, 3:5], rtol=0, atol=1e-6)
        for col in range(3):
            big = np.abs(ref[:, col]) > 1e-6
            np.testing.assert_allclose(ours[big, col], ref[big, col], rtol=1e-5)
