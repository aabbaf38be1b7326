"""The port's FEL against the JAX package's on the tiny fixture of
``tests/test_fast_methods.py`` (6 taxa x 20 codons, seed 11).

* The per-site stage on identical inputs: the port's ``fel.run`` with its
  GTR and MG94 fits replaced by the JAX run's fits, carried across, so
  that both packages fit the sites from the same global point.
* FEL end to end, each package fitting its own global models.

The three JAX runs are shared through a module-scoped fixture.  fp32 is
set with ``HYPHY_TPU_PRECISION=float32``, which both packages read at
call time; it takes the Taylor route, fp64 the spectral route."""

import numpy as np
import pytest
import torch

import hyphy_tpu.methods.common as jcommon
from hyphy_tpu.methods import fel as jfel
from hyphy_tpu.utils import synth as jsynth
import hyphy_tpu_torch.methods.common as tcommon
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.convert import params_from_numpy
from hyphy_tpu_torch.methods import fel
from hyphy_tpu_torch.models.codon import MG94xREVPartitionedOmega
from hyphy_tpu_torch.models.dna import GTR

torch.set_num_threads(2)

N_TAXA, N_CODONS, SEED = 6, 20, 11
# (precision, srv, branches): the third case has background branches (the
# fixture's internal branches all collapse, so three leaves are tested)
CASES = {
    "fp64-srv-all": ("float64", True, "All"),
    "fp32-srv-all": ("float32", True, "All"),
    "fp64-nosrv-background": ("float64", False, "t0,t1,t2"),
}


@pytest.fixture(autouse=True)
def _on_cpu():
    saved = settings.device
    settings.device = "cpu"
    yield
    settings.device = saved


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    aln = jsynth.synthetic_codon_alignment(N_TAXA, N_CODONS, seed=SEED)
    fa = tmp_path_factory.mktemp("tiny") / "tiny.fasta"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    return {"fasta": str(fa), "tree": jsynth.random_tree_newick(N_TAXA, seed=SEED)}


@pytest.fixture(scope="module")
def jax_runs(tiny):
    """JAX ``fel.run`` per case, with its GTR fit (before the zero-length
    collapse) and its MG94 fit captured on the way."""
    runs = {}
    for case, (precision, srv, branches) in CASES.items():
        seen = {}

        def spy(name):
            original = getattr(jcommon, name)

            def wrapped(*args, **kwargs):
                seen[name] = original(*args, **kwargs)
                return seen[name]

            return wrapped

        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("HYPHY_TPU_PRECISION", precision)
            mp.setenv("HYPHY_TPU_PROGRESS", "0")
            for name in ("fit_gtr_multi", "fit_partitioned_mg94_multi"):
                mp.setattr(jcommon, name, spy(name))
            result = jfel.run(tiny["fasta"], tree=tiny["tree"], srv=srv, branches=branches)
        runs[case] = (result, seen["fit_gtr_multi"], seen["fit_partitioned_mg94_multi"])
    return runs


def _carried_gtr(jgtr):
    """The JAX run's GTR fit as the port's (parameters through
    ``params_from_numpy``)."""
    g = jgtr.parts[0]
    gtr = tcommon.GTRFit(
        loglik=g.loglik,
        params=params_from_numpy({k: np.asarray(v) for k, v in g.params.items()}, "cpu"),
        branch_lengths=np.asarray(g.branch_lengths), frequencies=np.asarray(g.frequencies),
        n_parameters=g.n_parameters, model=GTR(np.asarray(g.frequencies), device="cpu"))
    return tcommon.MultiGTRFit(loglik=jgtr.loglik, parts=[gtr], n_parameters=jgtr.n_parameters)


def _carried_mg94(jmg, data):
    """The JAX run's MG94 fit as the port's, on the port's (collapsed)
    data: the port's model rebuilt from the JAX fit's frequencies."""
    m = jmg.parts[0]
    model = MG94xREVPartitionedOmega(
        data.genetic_code, m.corner_freqs, m.codon_freqs,
        nuc_lengths=np.array(m.alphas), branch_groups=data.branch_groups,
        n_groups=int(data.branch_groups.max()) + 1, free_lengths=True, device="cpu")
    mg = tcommon.MG94Fit(
        loglik=m.loglik,
        params=params_from_numpy({k: np.asarray(v) for k, v in m.params.items()}, "cpu"),
        branch_lengths=np.array(m.branch_lengths), alphas=np.array(m.alphas),
        betas=np.asarray(m.betas), omegas=np.asarray(m.omegas),
        corner_freqs=np.asarray(m.corner_freqs), codon_freqs=np.asarray(m.codon_freqs),
        n_parameters=m.n_parameters, model=model)
    return tcommon.MultiMG94Fit(loglik=jmg.loglik, parts=[mg], omegas=mg.omegas,
                                n_parameters=jmg.n_parameters)


def _calls(table):
    """Site calls: p <= 0.1, with the sign of beta - alpha."""
    return np.where(table[:, 4] <= 0.1, np.sign(table[:, 1] - table[:, 0]), 0)


@pytest.mark.parametrize("case", list(CASES))
def test_per_site_stage_matches_on_identical_inputs(tiny, jax_runs, case, monkeypatch):
    precision, srv, branches = CASES[case]
    jres, jgtr, jmg = jax_runs[case]
    monkeypatch.setenv("HYPHY_TPU_PRECISION", precision)
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")
    monkeypatch.setattr(tcommon, "fit_gtr_multi", lambda md, precision=1e-5: _carried_gtr(jgtr))
    monkeypatch.setattr(tcommon, "fit_partitioned_mg94_multi",
                        lambda md, gtr, precision=1e-5, multiple_hits="None":
                            _carried_mg94(jmg, md.parts[0]))
    res = fel.run(tiny["fasta"], tree=tiny["tree"], srv=srv, branches=branches)

    np.testing.assert_array_equal(res.data.tested_branches, jres.data.tested_branches)
    assert res.headers == jres.headers
    ours, ref = res.site_table, jres.site_table
    assert ours.shape == ref.shape == (N_CODONS, 6)
    if precision == "float64":
        np.testing.assert_allclose(ours[:, 3:5], ref[:, 3:5], rtol=0, atol=1e-6)
        for col in range(3):          # alpha, beta, alpha=beta
            big = np.abs(ref[:, col]) > 1e-6
            np.testing.assert_allclose(ours[big, col], ref[big, col], rtol=1e-5,
                                       err_msg=res.headers[col][0])
    else:
        np.testing.assert_allclose(ours[:, 3], ref[:, 3], rtol=0, atol=1e-2)
        np.testing.assert_array_equal(_calls(ours), _calls(ref))


def test_fel_end_to_end_matches(tiny, jax_runs, monkeypatch):
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")
    jres = jax_runs["fp64-srv-all"][0]
    res = fel.run(tiny["fasta"], tree=tiny["tree"])
    assert abs(res.mg94.loglik - jres.mg94.loglik) <= 1e-3
    assert sorted(res.json) == sorted(jres.json)
    for key in ("input", "fits", "MLE", "data partitions", "tested"):
        assert sorted(res.json[key]) == sorted(jres.json[key]), key
    assert res.json["MLE"]["headers"] == jres.json["MLE"]["headers"]
    ours = np.asarray(res.json["MLE"]["content"]["0"])
    ref = np.asarray(jres.json["MLE"]["content"]["0"])
    assert ours.shape == ref.shape == (N_CODONS, 6) and np.isfinite(ours).all()
    np.testing.assert_array_equal(_calls(ours), _calls(ref))
    np.testing.assert_allclose(ours[:, 3], ref[:, 3], rtol=0, atol=0.05)
    # constant patterns get zero rows (p-value 1)
    constant = res.data.codon_filter.constant_pattern_mask()[res.data.codon_filter.duplicate_map]
    assert constant.any()
    np.testing.assert_array_equal(ours[constant], [[0, 0, 0, 0, 1, 0]] * int(constant.sum()))
