"""The port's LEISR against the JAX package's.

* The per-site objective lnL(r) at the JAX run's baseline fit, at r = 1 and
  three other rates, on the fp64 spectral route (the JAX package's) within
  1e-9, and the card's fp32 Taylor route within 0.03 per pattern.
* ``vmapped_profile_ci`` on the JAX run's own MLEs: both bounds within 1e-6
  in log r.
* The whole run, protein (LG) and nucleotide (GTR): the baseline fit within
  0.15 lnL, and from the JAX run's fitted branch lengths carried across, the
  rates and bounds within 1e-3 relative, r = 0 and a lower bound of 0 at
  constant patterns.
* A residue the data lack (+F frequency 0): the JAX package's spectral route
  divides by the square root of that frequency and returns positive site
  lnLs (ROADMAP 3.21); the port takes the Taylor route, held to a pruning of
  ``scipy.linalg.expm`` propagators.

Fixtures: 8 taxa x 40 residues simulated under WAG; 6 taxa x 60
nucleotides of ``synthetic_codon_alignment``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from hyphy_tpu.data.filter import DataFilter as JDataFilter
from hyphy_tpu.methods import leisr as jleisr
from hyphy_tpu.ops import expm as jexpm
from hyphy_tpu.ops import pruning as jpruning
from hyphy_tpu.tree.topology import Tree as JTree
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.data.alignment import Alignment
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.likelihood import FitResult
from hyphy_tpu_torch.methods import leisr
from hyphy_tpu_torch.models import frequencies as tfreq
from hyphy_tpu_torch.models.protein import EmpiricalProtein
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.tree.topology import Tree
from hyphy_tpu_torch.utils import synth
from tests.torch_carry import protein_alignment

torch.set_num_threads(2)

N_TAXA, N_SITES, SEED = 8, 40, 3
RATES = [1.0, 0.3, 2.5, 1e-3]


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")


def _write(path, names, seqs):
    path.write_text("".join(f">{n}\n{s}\n" for n, s in zip(names, seqs)))
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("leisr")
    names, seqs, newick = protein_alignment(N_TAXA, N_SITES, SEED)
    codons = synth.synthetic_codon_alignment(6, 20, seed=11)
    return {
        "protein": (_write(d / "p.fasta", names, seqs), newick, "LG"),
        "nucleotide": (_write(d / "n.fasta", codons.names, codons.sequences),
                       synth.random_tree_newick(6, seed=11), "GTR"),
    }


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """The JAX package's run of each datatype, with its baseline fit."""
    out = {}
    for datatype, (fasta, newick, model) in inputs.items():
        seen = {}
        original = jleisr.LikelihoodFunction.fit

        def spy(self, *args, **kwargs):
            seen["fit"] = original(self, *args, **kwargs)
            return seen["fit"]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jleisr.LikelihoodFunction, "fit", spy)
            result = jleisr.run(fasta, datatype=datatype, model=model, tree=newick)
        out[datatype] = (result, seen["fit"])
    return out


def _setup(inputs, datatype, jfit):
    """Both packages' filters, trees and models, and the JAX fit's params
    as the port's."""
    fasta, newick, model = inputs[datatype]
    from hyphy_tpu_torch.data.alignment import read_alignment

    aln = read_alignment(fasta)
    filt = DataFilter.from_alignment(aln, datatype)
    jfilt = JDataFilter.from_alignment(aln, datatype)
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    jtree = JTree.from_newick(newick, leaf_order=jfilt.names)
    if datatype == "protein":
        mdl = EmpiricalProtein(model, frequencies=tfreq.empirical_character(filt), device="cpu")
    else:
        mdl = leisr._nucleotide_model(model, filt, "cpu")
    params = {k: torch.tensor(np.asarray(v)) for k, v in jfit.params.items()}
    return filt, jfilt, tree, jtree, mdl, params


def _jax_objective(jfit, jfilt, jtree, datatype, model_name):
    """The JAX package's per-site lnL(r) at its fit (``leisr.py:155-167``)."""
    if datatype == "protein":
        from hyphy_tpu.models.protein import EmpiricalProtein as JEmp
        from hyphy_tpu.models import frequencies as jfreq

        mdl = JEmp(model_name, frequencies=jfreq.empirical_character(jfilt))
    else:
        mdl = jleisr._nucleotide_model(model_name, jfilt)
    params = {k: jnp.asarray(v) for k, v in jfit.params.items()}
    q = mdl.q_matrix(params)
    left, lam, right = jexpm.reversible_spectral(q[None], mdl.frequencies)
    pdata = jpruning.build_pruning_data(jtree)
    lp = jnp.asarray(jfilt.leaf_partials())
    t_hat = params["t"]

    def site(i, r):
        return jpruning.single_site_log_likelihood_spectral(
            left[0], lam[0], right[0], r * t_hat, lp[:, i, :], mdl.frequencies, pdata)

    return site


@pytest.mark.parametrize("datatype", ["protein", "nucleotide"])
def test_site_objective_matches(inputs, jax_runs, datatype):
    _, jfit = jax_runs[datatype]
    filt, jfilt, tree, jtree, mdl, params = _setup(inputs, datatype, jfit)
    jsite = _jax_objective(jfit, jfilt, jtree, datatype, inputs[datatype][2])
    n = filt.n_patterns
    idx = torch.arange(n)
    ours64 = leisr.site_log_likelihood(mdl, params, filt, tree, torch.float64, spectral=True)
    ours32 = leisr.site_log_likelihood(mdl, params, filt, tree, torch.float32, spectral=False)
    for r in RATES:
        rr = torch.full((n,), r, dtype=torch.float64)
        want = np.asarray(jax.vmap(jsite)(jnp.arange(n), jnp.full(n, r)))
        got = ours64(idx, rr).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-9)
        assert np.abs(ours32(idx, rr).numpy().astype(np.float64) - want).max() <= 0.03


@pytest.mark.parametrize("datatype", ["protein", "nucleotide"])
def test_profile_ci_matches(inputs, jax_runs, datatype):
    """Both packages' bisections on the same MLEs and lnLs (the JAX run's)."""
    result, jfit = jax_runs[datatype]
    filt, jfilt, tree, jtree, mdl, params = _setup(inputs, datatype, jfit)
    jsite = _jax_objective(jfit, jfilt, jtree, datatype, inputs[datatype][2])
    n = filt.n_patterns
    first_site = np.unique(filt.duplicate_map, return_index=True)[1]      # per pattern
    r_mle = result.site_table[first_site, 0]
    lnl = np.asarray(jax.vmap(jsite)(jnp.arange(n), jnp.asarray(r_mle)))
    jlo, jhi = jleisr.vmapped_profile_ci(jsite, jnp.arange(n), jnp.asarray(r_mle),
                                         jnp.asarray(lnl))
    obj = leisr.site_log_likelihood(mdl, params, filt, tree, torch.float64, spectral=True)
    lo, hi = leisr.vmapped_profile_ci(obj, torch.arange(n), torch.tensor(r_mle),
                                      torch.tensor(lnl))
    np.testing.assert_allclose(np.log(lo.numpy()), np.log(np.asarray(jlo)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.log(hi.numpy()), np.log(np.asarray(jhi)), rtol=0, atol=1e-6)
    assert (lo.numpy() <= np.maximum(r_mle, 1e-8) * (1 + 1e-9)).all()
    assert (hi.numpy() >= r_mle * (1 - 1e-9)).all()


@pytest.mark.parametrize("datatype", ["protein", "nucleotide"])
def test_run_matches(inputs, jax_runs, datatype, monkeypatch):
    fasta, newick, model = inputs[datatype]
    result, jfit = jax_runs[datatype]
    ours = leisr.run(fasta, datatype=datatype, model=model, tree=newick)
    assert abs(ours.baseline_loglik - result.baseline_loglik) <= 0.15
    # from the JAX run's baseline fit carried across
    carried = FitResult(params={k: torch.tensor(np.asarray(v)) for k, v in jfit.params.items()},
                        loglik=jfit.loglik, n_free_parameters=jfit.n_free_parameters,
                        n_iterations=0)
    monkeypatch.setattr(leisr, "fit_baseline", lambda lf, tree, precision: carried)
    ours = leisr.run(fasta, datatype=datatype, model=model, tree=newick)
    got, want = ours.site_table, result.site_table
    assert got.shape == want.shape == (result.site_table.shape[0], 5)
    assert ours.headers == result.headers
    assert sorted(ours.json) == sorted(result.json)
    assert ours.json["fits"].keys() == result.json["fits"].keys()
    # r = 0 and a lower bound of 0 at constant patterns, in both
    constant = want[:, 0] == 0
    assert constant.any() and (got[constant, :2] == 0).all()
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=1e-9)
    # rates and bounds 1e-3 relative; rates at the simplex's floor (flat
    # profiles, r ~ 1e-13) and bounds at the bisection's floor (1e-8) stop
    # where each simplex ends
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=1e-3, atol=1e-6)
    est = got[:, 0] > 0
    assert (got[est, 1] <= got[est, 0] + 1e-6).all() and (got[est, 2] >= got[est, 0] - 1e-6).all()
    assert (got[:, 4] >= got[:, 3] - 1e-6).all()


def test_absent_residue_takes_the_taylor_route():
    """A fault of the reference (ROADMAP 3.21): with a residue missing from
    the data, the +F frequency of that residue is 0 and the spectral route
    returns garbage (site lnLs above 0) in the JAX package; the port's
    objective takes the Taylor route there, held to a pruning of
    ``scipy.linalg.expm`` propagators."""
    names, seqs, newick = protein_alignment(7, 30, 1, mean_branch=0.3)
    assert len(set("".join(seqs))) < 20
    aln = Alignment(names=names, sequences=seqs)
    filt = DataFilter.from_alignment(aln, "protein")
    jfilt = JDataFilter.from_alignment(aln, "protein")
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    jtree = JTree.from_newick(newick, leaf_order=jfilt.names)
    freqs = tfreq.empirical_character(filt)
    mdl = EmpiricalProtein("LG", frequencies=freqs, device="cpu")
    t = np.asarray(tree.input_lengths[:-1])

    class _Fit:
        params = {"t": t}

    jsite = _jax_objective(_Fit, jfilt, jtree, "protein", "LG")
    n = filt.n_patterns
    jvals = np.asarray(jax.vmap(jsite)(jnp.arange(n), jnp.ones(n)))
    assert not (np.isfinite(jvals) & (jvals < 0)).all()
    q = mdl.q_matrix().numpy()
    p = np.stack([sla.expm(q * tb) for tb in t])
    want = pruning.site_log_likelihoods(torch.tensor(p), torch.as_tensor(filt.leaf_partials()),
                                        mdl.frequencies, pruning.build_pruning_data(tree, "cpu"))
    for dtype in (torch.float64, torch.float32):
        obj = leisr.site_log_likelihood(mdl, {"t": torch.tensor(t)}, filt, tree, dtype,
                                        spectral=dtype == torch.float64)
        got = obj(torch.arange(n), torch.ones(n, dtype=torch.float64)).numpy()
        bound = 1e-9 if dtype == torch.float64 else 0.03
        np.testing.assert_allclose(got.astype(np.float64), want.numpy(), rtol=0, atol=bound)
