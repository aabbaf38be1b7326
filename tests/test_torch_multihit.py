"""The port's multiple-hit MG94 model and FEL's ``--multiple-hits`` against
the JAX package's, on the tiny fixture of ``tests/test_torch_fel.py``
cut to 12 codons (6 taxa, seed 11), in fp64.

* The 2- and 3-hit basis matrices, the folded bases and branch lengths at
  the same parameters.
* The global MG94 fit with Double+Triple hits from the JAX package's GTR
  fit, on an alignment simulated under that model.
* FEL's per-site stage on the JAX run's carried global fits, per-site
  rates ("Estimate", Double+Triple) and global rates ("Global", Double).

The JAX runs are shared through a module-scoped fixture."""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import hyphy_tpu.methods.common as jcommon
import hyphy_tpu.utils.simulate as jsimulate
from hyphy_tpu.data.genetic_code import GeneticCode as JGeneticCode
from hyphy_tpu.methods import fel as jfel
from hyphy_tpu.models.codon import MG94xREVPartitionedOmega as JMG94
from hyphy_tpu.utils import synth as jsynth
import hyphy_tpu_torch.methods.common as tcommon
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.convert import params_from_numpy
from hyphy_tpu_torch.data.genetic_code import GeneticCode
from hyphy_tpu_torch.methods import fel
from hyphy_tpu_torch.models.codon import MG94xREVPartitionedOmega
from tests.torch_carry import (carried_gtr, carried_mg94, carry_into, spy_fits,
                               write_simulated_fasta)

torch.set_num_threads(2)

N_TAXA, N_CODONS, SEED = 6, 12, 11
MATRIX_ATOL = 1e-12      # basis matrices and branch lengths, fp64
FIT_ATOL = 1e-3          # fitted global lnL
# (multiple_hits, site_multihit)
CASES = {"Double+Triple-Estimate": ("Double+Triple", "Estimate"),
         "Double-Global": ("Double", "Global")}


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    aln = jsynth.synthetic_codon_alignment(N_TAXA, N_CODONS, seed=SEED)
    fa = tmp_path_factory.mktemp("mh") / "tiny.fasta"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    return {"fasta": str(fa), "tree": jsynth.random_tree_newick(N_TAXA, seed=SEED)}


@pytest.fixture(scope="module")
def jax_runs(tiny):
    """JAX ``fel.run`` per case, its global fits recorded on the way."""
    runs = {}
    for case, (mh, site_mh) in CASES.items():
        seen = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("HYPHY_TPU_PROGRESS", "0")
            spy_fits(jcommon, mp, seen)
            result = jfel.run(tiny["fasta"], tree=tiny["tree"], multiple_hits=mh,
                              site_multihit=site_mh)
        runs[case] = (result, seen)
    return runs


def _models(mh):
    rng = np.random.default_rng(3)
    corners = rng.uniform(0.1, 1.0, size=(4, 3))
    corners /= corners.sum(axis=0)
    jgc, tgc = JGeneticCode("Universal"), GeneticCode("Universal")
    codon_freqs = rng.uniform(0.5, 1.5, size=tgc.n_states)
    codon_freqs /= codon_freqs.sum()
    kw = dict(nuc_lengths=np.full(9, 0.1), branch_groups=np.zeros(9, dtype=np.int32),
              n_groups=1, free_lengths=True, multiple_hits=mh)
    jm = JMG94(jgc, corners, codon_freqs, **kw)
    tm = MG94xREVPartitionedOmega(tgc, corners, codon_freqs, device="cpu", **kw)
    point = {k: np.asarray(rng.uniform(0.2, 2.0, size=s.shape))
             for k, s in sorted(jm.parameter_specs(9).items())}
    return jm, tm, point


@pytest.mark.parametrize("hits", [2, 3])
def test_multihit_basis_matrices_match(hits):
    jm, tm, point = _models("Double+Triple")
    ref = jm.multihit_basis_matrices({k: np.asarray(v) for k, v in point.items()}, hits)
    ours = tm.multihit_basis_matrices(params_from_numpy(point, "cpu"), hits)
    for o, r in zip(ours, ref):
        assert np.count_nonzero(np.asarray(r)) > 0
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=MATRIX_ATOL)


@pytest.mark.parametrize("mh", ["Double", "Double+Triple"])
def test_multihit_model_matches(mh):
    """Specs, the folded bases and the branch lengths of the model."""
    jm, tm, point = _models(mh)
    assert sorted(tm.parameter_specs(9)) == sorted(jm.parameter_specs(9))
    jp, tp = {k: np.asarray(v) for k, v in point.items()}, params_from_numpy(point, "cpu")
    for o, r in zip(tm.combined_basis_matrices(tp), jm.combined_basis_matrices(jp)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=MATRIX_ATOL)
    np.testing.assert_allclose(tm.branch_lengths(tp).numpy(),
                               np.asarray(jm.branch_lengths(jp)), rtol=0, atol=MATRIX_ATOL)


def test_multihit_global_fit_matches(tmp_path):
    """The global MG94 fit with Double+Triple hits, both packages from the
    JAX package's GTR fit, on 8 taxa x 30 codons simulated under the model
    (on ``synthetic_codon_alignment``'s random codon replacements the
    multi-hit surface has a ridge — omega 4 or 300 at lnL 0.06-0.09 apart —
    on which the two optimizers stop at different points)."""
    fasta, newick = write_simulated_fasta(tmp_path / "sim.fasta", 8, 30, SEED)
    jmd = jcommon.load_codon_data_multi(fasta, tree_newick=newick)
    jgtr = jcommon.fit_gtr_multi(jmd)
    jmd, jgtr_kept = jcommon.kill_zero_branches_multi(jmd, jgtr)
    jmg = jcommon.fit_partitioned_mg94_multi(jmd, jgtr_kept, multiple_hits="Double+Triple")
    md = tcommon.load_codon_data_multi(fasta, tree_newick=newick, device="cpu")
    md, gtr = tcommon.kill_zero_branches_multi(md, carried_gtr(jgtr))
    mg = tcommon.fit_partitioned_mg94_multi(md, gtr, multiple_hits="Double+Triple")
    assert abs(mg.loglik - jmg.loglik) <= FIT_ATOL, (mg.loglik, jmg.loglik)
    assert mg.n_parameters == jmg.n_parameters
    for key in ("delta", "psi"):
        assert float(mg.parts[0].params[key]) == pytest.approx(
            float(jmg.parts[0].params[key]), rel=2e-2)


@pytest.fixture(scope="module")
def carried_estimate(tiny, jax_runs):
    """The port's data and the JAX run's Double+Triple global MG94 fit
    carried onto it, with the JAX fit."""
    _, seen = jax_runs["Double+Triple-Estimate"]
    md = tcommon.load_codon_data_multi(tiny["fasta"], tree_newick=tiny["tree"], device="cpu")
    md, _ = tcommon.kill_zero_branches_multi(md, carried_gtr(seen["fit_gtr_multi"]))
    mg = carried_mg94(seen["fit_partitioned_mg94_multi"], md)
    return md.parts[0], mg.parts[0], seen["fit_partitioned_mg94_multi"].parts[0]


def test_bootstrap_simulates_each_sites_null_multihit_rates(carried_estimate):
    """With per-site delta/psi the bootstrap draws each site under its own
    null rates: the states equal ``hyphy_tpu.utils.simulate.simulate_states``
    on ``scipy`` propagators of ``c (Q1s + d Q2s + p Q3s + Q1n + d Q2n + p
    Q3n)`` (every branch tested: beta := c) built from the JAX model's
    bases, and a site planted with delta/psi far from the global ones is
    the only one whose draws differ from those under the global rates."""
    data, mgp, jfit = carried_estimate
    assert data.tested_branches.all()
    filt = data.codon_filter
    n_patterns, n_taxa = filt.n_patterns, filt.n_sequences
    sites = np.nonzero(~filt.constant_pattern_mask())[0]
    delta, psi = float(jfit.params["delta"]), float(jfit.params["psi"])
    rng = np.random.default_rng(5)
    null = {"alpha": rng.uniform(0.5, 2.0, n_patterns), "beta_nuisance": np.ones(n_patterns),
            "delta": np.full(n_patterns, delta), "psi": np.full(n_patterns, psi)}
    planted = sites[0]
    null["delta"][planted], null["psi"][planted] = delta + 50.0, psi + 50.0
    ours = fel._simulate_null_states(data, mgp, null, 4, 7)

    q1 = [np.asarray(q) for q in jfit.model.basis_matrices(jfit.params)]
    q2 = [np.asarray(q) for q in jfit.model.multihit_basis_matrices(jfit.params, 2)]
    q3 = [np.asarray(q) for q in jfit.model.multihit_basis_matrices(jfit.params, 3)]
    draws = np.random.default_rng(7)
    ref = np.full((n_patterns * 4, n_taxa), -1)
    for s in sites:
        qs, qn = (q1[i] + null["delta"][s] * q2[i] + null["psi"][s] * q3[i] for i in (0, 1))
        q = null["alpha"][s] * (qs + qn)
        q -= np.diag(q.sum(axis=1))
        p = np.stack([sla.expm(q * t) for t in np.asarray(jfit.alphas)])
        st = jsimulate.simulate_states(data.tree, p, np.asarray(jfit.model.frequencies), 4, draws)
        ref[s * 4: (s + 1) * 4] = st[:n_taxa].T
    np.testing.assert_array_equal(ours, ref)

    folded = fel._simulate_null_states(
        data, mgp, {k: null[k] for k in ("alpha", "beta_nuisance")}, 4, 7)
    rows = np.arange(n_patterns * 4) // 4 == planted
    assert (folded[rows] != ours[rows]).any()
    np.testing.assert_array_equal(folded[~rows], ours[~rows])


def test_resample_draws_under_the_null_fits_multihit_rates(carried_estimate, monkeypatch):
    """``resample`` with per-site delta/psi: the simulation gets every
    pattern's null alpha (the "alpha=beta" column) and its own null delta
    and psi, and the bootstrap p-values are multiples of 1/(N+1)."""
    data, mgp, _ = carried_estimate
    seen = {}
    simulate = fel._simulate_null_states

    def spy(data_, mgp_, null, *rest):
        seen["null"] = null
        return simulate(data_, mgp_, null, *rest)

    monkeypatch.setattr(fel, "_simulate_null_states", spy)
    table, headers = fel.solve_partition(data, mgp, resample=2, resample_seed=3)
    null = seen["null"]
    assert sorted(null) == ["alpha", "beta_nuisance", "delta", "psi"]
    filt = data.codon_filter
    varied = ~filt.constant_pattern_mask()
    first = np.unique(filt.duplicate_map, return_index=True)[1]     # a site per pattern
    np.testing.assert_array_equal(null["alpha"][varied], table[first, 2][varied])
    for key in ("delta", "psi"):
        rates = null[key][varied]
        assert ((rates >= 0) & (rates <= 100)).all() and np.ptp(rates) > 1e-3
    assert [h[0] for h in headers][6:] == ["p-asmp", "2H rate", "3H rate"]
    p = table[:, 4]
    assert np.allclose(np.round(p * 3) / 3, p) and (p >= 1 / 3 - 1e-12).all()


@pytest.mark.parametrize("case", list(CASES))
def test_per_site_stage_matches_on_carried_fits(tiny, jax_runs, case, monkeypatch):
    mh, site_mh = CASES[case]
    jres, seen = jax_runs[case]
    carry_into(monkeypatch, seen)
    res = fel.run(tiny["fasta"], tree=tiny["tree"], multiple_hits=mh, site_multihit=site_mh)
    assert res.headers == jres.headers
    assert res.headers[6][0] == "2H rate" and (mh == "Double") == (len(res.headers) == 7)
    ours, ref = res.site_table, jres.site_table
    assert ours.shape == ref.shape == (N_CODONS, len(res.headers))
    np.testing.assert_allclose(ours[:, 3:5], ref[:, 3:5], rtol=0, atol=1e-6)
    rates = [0, 1, 2] + list(range(6, ours.shape[1]))   # alpha, beta, alpha=beta, 2H, 3H
    for col in rates:
        big = np.abs(ref[:, col]) > 1e-6
        np.testing.assert_allclose(ours[big, col], ref[big, col], rtol=1e-5,
                                   err_msg=res.headers[col][0])
