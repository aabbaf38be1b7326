"""The port's BGM against the JAX package's.

* The host NumPy, copied: ``k2_local_score`` (K2 and BDeu, 0-2 parents),
  ``DiscreteBGM.order_mcmc`` at one seed (edge marginals and score trace)
  and ``substitution_counts`` (with and without the amino-acid map, with
  invalid states, ``min_subs`` 1 and 3) equal to the JAX package's on the
  same inputs (1e-12, integers exactly).
* ``bgm.run`` on a codon alignment simulated along 8 taxa (40 codons):
  the GTR and MG94 lnL within 0.15 of the JAX run's; on the JAX run's
  fitted GTR and MG94 parameters carried into the port, the substitution
  map equal to the JAX map and the edge table and score trace equal to the
  JAX run's at the same seed (1e-12); and, past every site's count, the
  same error result as the JAX package's."""

import numpy as np
import pytest
import torch

from hyphy_tpu.data.genetic_code import GeneticCode as JGeneticCode
from hyphy_tpu.methods import bgm as jbgm
from hyphy_tpu.methods import common as jcommon
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.methods import bgm
from hyphy_tpu_torch.methods import common as tcommon
from hyphy_tpu_torch.utils.synth import simulated_codon_alignment
from tests.torch_carry import carried_gtr, carried_mg94_fit

torch.set_num_threads(2)

N_TAXA, N_CODONS, SEED, MEAN_BRANCH = 8, 40, 3, 0.2
RUN = dict(steps=3000, burnin=300, samples=20)


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")


def _network_data(seed, cases=40, nodes=6):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 2, size=(cases, nodes))
    data[:, 1] = data[:, 0] ^ (rng.uniform(size=cases) < 0.1)     # one dependent pair
    return data


def _substitution_inputs(seed):
    """Joint states of a 7-node tree (4 leaves), 12 sites, invalid (-1)
    cells, and the branches 0, 2, 3 and 5 tested."""
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 61, size=(7, 12))
    states[rng.uniform(size=states.shape) < 0.1] = -1
    states[:, :3] = states[6, :3]                                  # no change at three sites
    parent = np.array([4, 4, 5, 5, 6, 6, -1])
    tested = np.array([True, False, True, True, False, True])
    return states, parent, tested


NUMPY_CASES = (
    [f"k2-{n}" for n in range(3)] + [f"bdeu-{n}" for n in range(3)]
    + ["order_mcmc", "subs-aa-min1", "subs-aa-min3", "subs-plain-min1"]
)


@pytest.mark.parametrize("case", NUMPY_CASES)
def test_numpy_parts_match_jax(case):
    if case.startswith(("k2", "bdeu")):
        data = _network_data(1)
        parents = ((), (1,), (1, 3))[int(case[-1])]
        ess = 0.0 if case.startswith("k2") else 2.0
        ours = bgm.k2_local_score(data, 0, parents, 2, ess)
        ref = jbgm.k2_local_score(data, 0, parents, 2, ess)
        assert ours == pytest.approx(ref, rel=1e-12, abs=1e-12)
    elif case == "order_mcmc":
        data = _network_data(2)
        options = dict(steps=600, burnin=100, samples=25, seed=5)
        edge, trace = bgm.DiscreteBGM(data, max_parents=2).order_mcmc(**options)
        jedge, jtrace = jbgm.DiscreteBGM(data, max_parents=2).order_mcmc(**options)
        assert trace.shape == jtrace.shape == (25,)
        np.testing.assert_allclose(edge, jedge, rtol=0, atol=1e-12)
        np.testing.assert_allclose(trace, jtrace, rtol=1e-12, atol=0)
        assert edge.max() > 0.5          # the dependent pair is found
    else:
        states, parent, tested = _substitution_inputs(3)
        aa = (np.asarray(JGeneticCode("Universal").sense_amino_acids)
              if "-aa-" in case else None)
        min_subs = int(case[-1])
        ours = bgm.substitution_counts(states, parent, tested, aa, min_subs)
        ref = jbgm.substitution_counts(states, parent, tested, aa, min_subs)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert ours[0].shape[1] < 12 and ours[0].sum() > 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run (its fits and substitution map recorded), the port's own
    run, the port's run on the JAX run's fits, and both packages' runs on
    those fits with ``min_subs`` past every site."""
    aln, newick = simulated_codon_alignment(N_TAXA, N_CODONS, seed=SEED,
                                            mean_branch=MEAN_BRANCH)
    fasta = tmp_path_factory.mktemp("bgm") / "sim.fasta"
    fasta.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    fasta = str(fasta)
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        mp.setenv("HYPHY_TPU_MESH", "off")
        mp.setattr(settings, "device", "cpu")
        for module, name in ((jcommon, "fit_gtr"), (jcommon, "fit_partitioned_mg94"),
                             (jbgm, "substitution_counts")):
            def spy(*args, _original=getattr(module, name), _name=name, **kwargs):
                out = _original(*args, **kwargs)
                seen.setdefault(_name, out)      # the first run's
                return out

            mp.setattr(module, name, spy)
        ref = jbgm.run(fasta, newick, **RUN)
        ours = bgm.run(fasta, newick, device="cpu", **RUN)

        jgtr, jmg = seen["fit_gtr"], seen["fit_partitioned_mg94"]

        class _OneGTR:
            parts, loglik, n_parameters = [jgtr], jgtr.loglik, jgtr.n_parameters

        mp.setattr(tcommon, "fit_gtr", lambda data, **kw: carried_gtr(_OneGTR).parts[0])
        mp.setattr(tcommon, "fit_partitioned_mg94",
                   lambda data, gtr, **kw: carried_mg94_fit(jmg, data))
        carried = bgm.run(fasta, newick, device="cpu", **RUN)
        mp.setattr(jcommon, "fit_gtr", lambda *a, **kw: jgtr)
        mp.setattr(jcommon, "fit_partitioned_mg94", lambda *a, **kw: jmg)
        few = dict(RUN, min_subs=2 * N_TAXA)
        ref_few = jbgm.run(fasta, newick, **few)
        ours_few = bgm.run(fasta, newick, device="cpu", **few)
    return dict(ref=ref, ours=ours, carried=carried, jmap=seen["substitution_counts"],
                ref_few=ref_few, ours_few=ours_few)


def test_fits_match_jax(runs):
    fits, jfits = runs["ours"].json["fits"], runs["ref"]["fits"]
    assert sorted(fits) == sorted(jfits) == ["Global MG94xREV", "Nucleotide GTR"]
    for name in fits:
        assert abs(fits[name]["Log Likelihood"] - jfits[name]["Log Likelihood"]) <= 0.15
        assert fits[name]["estimated parameters"] == jfits[name]["estimated parameters"]
    assert sorted(runs["ours"].json) == sorted(runs["ref"])


def test_map_and_table_match_on_carried_fits(runs):
    """On the JAX run's fits: the same substitution map (K8 in fp64 on both
    sides), the same edge table and score trace at the same seed."""
    carried, ref = runs["carried"], runs["ref"]
    counts, sites, branches = runs["jmap"]
    assert np.array_equal(carried.counts, counts)
    assert np.array_equal(carried.site_indices, sites)
    assert np.array_equal(carried.branch_indices, branches)
    assert counts.shape == (2 * N_TAXA - 2, 23)
    rows, jrows = (np.asarray(r["MLE"]["content"]["0"], dtype=np.float64)
                   for r in (carried.json, ref))
    assert rows.shape == jrows.shape == (23 * 22 // 2, 8)
    np.testing.assert_allclose(rows, jrows, rtol=0, atol=1e-12)
    np.testing.assert_allclose(carried.json["trace"], ref["trace"], rtol=1e-12, atol=0)
    assert carried.json["MLE"]["headers"] == ref["MLE"]["headers"]
    assert carried.json["settings"] == ref["settings"]
    p = rows[:, 2:5]
    assert (p >= 0).all() and (p[:, 2] <= 1 + 1e-12).all()


def test_too_few_sites_match_jax(runs):
    ours, ref = runs["ours_few"], runs["ref_few"]
    assert ours.edge is None and ours.counts.shape[1] <= 2
    assert ours.json["error"] == ref["error"]
    assert ours.json["MLE"] == ref["MLE"] == {"headers": jbgm.TABLE_HEADERS, "content": []}
    assert sorted(ours.json) == sorted(ref)
