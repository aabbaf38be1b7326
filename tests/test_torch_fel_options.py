"""FEL's ``--resample`` in the port against the JAX package, on the tiny
fixture of ``tests/test_torch_fel.py`` (6 taxa x 20 codons, seed 11),
fp64, the per-site stage run on the JAX run's carried global fits; the
site-chunked solve against one batch; and the CLI with every option on a
CHARSET NEXUS.  ``--ci`` is held in ``tests/test_torch_fel_ci.py``.

One JAX run and one port run are shared through a module-scoped
fixture."""

import json

import numpy as np
import pytest
import torch

import hyphy_tpu.methods.common as jcommon
import hyphy_tpu.utils.simulate as jsimulate
from hyphy_tpu.methods import fel as jfel
from hyphy_tpu.utils import synth as jsynth
from hyphy_tpu_torch import cli
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.methods import fel
from hyphy_tpu_torch.optimize import batched
from tests.torch_carry import carry_into, spy_fits, write_partitioned_nexus

torch.set_num_threads(2)

N_TAXA, N_CODONS, SEED = 6, 20, 11
N_REPS, RESAMPLE_SEED = 4, 7
# LRT and p within 1e-6; rates within 1e-5 relative where above 1e-6 (as
# tests/test_torch_fel.py)
P_ATOL, RATE_RTOL = 1e-6, 1e-5


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    aln = jsynth.synthetic_codon_alignment(N_TAXA, N_CODONS, seed=SEED)
    fa = tmp_path_factory.mktemp("opts") / "tiny.fasta"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    return {"fasta": str(fa), "tree": jsynth.random_tree_newick(N_TAXA, seed=SEED)}


def _jax_run(tiny, **options):
    """JAX ``fel.run`` with its global fits, the arguments of its bootstrap
    and the states it simulated recorded on the way."""
    seen = {"states": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        spy_fits(jcommon, mp, seen)
        boot, draw = jfel._bootstrap_pvalues, jsimulate.simulate_states

        def bootstrap(*args):
            seen["bootstrap_args"] = args
            return boot(*args)

        def simulate(*args, **kwargs):
            seen["states"].append(draw(*args, **kwargs))
            return seen["states"][-1]

        mp.setattr(jfel, "_bootstrap_pvalues", bootstrap)
        mp.setattr(jsimulate, "simulate_states", simulate)
        result = jfel.run(tiny["fasta"], tree=tiny["tree"], **options)
    return result, seen


@pytest.fixture(scope="module")
def runs(tiny):
    """The JAX run with ``resample``, and the port's per-site stage on its
    carried fits, simulating from the JAX run's null fits (so that both
    draw from the same propagators); the port's states and replicate LRTs
    recorded."""
    options = dict(resample=N_REPS, resample_seed=RESAMPLE_SEED)
    jres, seen = _jax_run(tiny, **options)
    ours = {}
    saved = settings.device
    settings.device = "cpu"
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("HYPHY_TPU_PROGRESS", "0")
            carry_into(mp, seen)
            simulate, bootstrap = fel._simulate_null_states, fel._bootstrap_pvalues
            null_common, null_bg = seen["bootstrap_args"][9:11]

            def simulate_jax_nulls(data, mgp, _null, *rest):
                null = {"alpha": np.asarray(null_common), "beta_nuisance": np.asarray(null_bg)}
                ours["states"] = simulate(data, mgp, null, *rest)
                return ours["states"]

            def recorded(*args):
                ours["p"], ours["lrt_sim"] = bootstrap(*args)
                return ours["p"], ours["lrt_sim"]

            mp.setattr(fel, "_simulate_null_states", simulate_jax_nulls)
            mp.setattr(fel, "_bootstrap_pvalues", recorded)
            ours["result"] = fel.run(tiny["fasta"], tree=tiny["tree"], **options)
    finally:
        settings.device = saved
    return jres, seen, ours


def _hold_base_columns(ours, ref, headers):
    np.testing.assert_allclose(ours[:, 3], ref[:, 3], rtol=0, atol=P_ATOL)
    for col in range(3):              # alpha, beta, alpha=beta
        big = np.abs(ref[:, col]) > 1e-6
        np.testing.assert_allclose(ours[big, col], ref[big, col], rtol=RATE_RTOL,
                                   err_msg=headers[col][0])


def test_bootstrap_states_match_the_jax_package(runs):
    """Same seed, same null fits: the port's simulated columns are the JAX
    package's, draw for draw."""
    jres, seen, ours = runs
    filt = ours["result"].data.codon_filter
    n_taxa = filt.n_sequences
    sites = np.nonzero(~filt.constant_pattern_mask())[0]
    assert len(seen["states"]) == len(sites) > 0
    ref = np.full((filt.n_patterns * N_REPS, n_taxa), -1)
    for s, st in zip(sites, seen["states"]):
        ref[s * N_REPS: (s + 1) * N_REPS] = st[:n_taxa].T
    np.testing.assert_array_equal(ours["states"], ref)


def test_bootstrap_pvalues_match(runs):
    """Bootstrap p equal, or one step of 1/(N+1) apart at sites where a
    replicate's LRT ties the observed one within 1e-6 (the two packages'
    LRTs agree to that); the asymptotic p in "p-asmp"."""
    jres, _, ours = runs
    res = ours["result"]
    assert res.headers == jres.headers and res.headers[6][0] == "p-asmp"
    mine, ref = res.site_table, jres.site_table
    _hold_base_columns(mine, ref, res.headers)
    np.testing.assert_allclose(mine[:, 6], ref[:, 6], rtol=0, atol=P_ATOL)
    step = 1.0 / (N_REPS + 1)
    p = mine[:, 4]
    assert np.allclose(np.round(p / step) * step, p) and (p >= step - 1e-12).all()
    dup = res.data.codon_filter.duplicate_map
    lrt_obs = mine[:, 3]
    ties = (np.abs(ours["lrt_sim"][dup] - lrt_obs[:, None]) <= 1e-6).any(axis=1)
    differ = np.abs(p - ref[:, 4]) > 1e-12
    assert not (differ & ~ties).any(), np.nonzero(differ & ~ties)
    np.testing.assert_allclose(np.abs(p - ref[:, 4])[differ], step)


def test_chunked_solve_matches_one_batch(tiny, runs, monkeypatch):
    """Nelder-Mead freezes converged sites by mask: the per-site stage in
    chunks of 3 patterns gives every site exactly its one-batch result."""
    _, seen, _ = runs
    carry_into(monkeypatch, seen)
    res = fel.run(tiny["fasta"], tree=tiny["tree"])
    n_patterns = res.data.codon_filter.n_patterns
    assert n_patterns > 6
    one, _ = fel.solve_partition(res.data, res.mg94)
    monkeypatch.setattr(batched, "site_chunk", lambda n_items, bytes_per_item, device, free=None: 3)
    chunked, _ = fel.solve_partition(res.data, res.mg94)
    np.testing.assert_array_equal(chunked, one)
    np.testing.assert_array_equal(one, res.site_table)


def test_cli_runs_every_option_on_charsets(tmp_path):
    """``warmup fel`` with ``--ci``, ``--resample``, ``--multiple-hits`` and
    ``--site-multihit`` on a two-CHARSET NEXUS: one block per partition,
    the options' columns in the reference's order.  Without SRV and with
    global 2H rates the profile has no nuisance to refit, so the CI's 61
    steps are single evaluations."""
    nexus = write_partitioned_nexus(tmp_path / "two.nex", n_taxa=5, n_codons=12,
                                    charsets=[("left", "1-18"), ("right", "19-36")])
    out = tmp_path / "two.json"
    rc = cli.main(["warmup", "fel", "--alignment", nexus, "--output", str(out), "--srv", "No",
                   "--ci", "Yes", "--resample", "2", "--multiple-hits", "Double",
                   "--site-multihit", "Global"])
    assert rc == 0
    result = json.loads(out.read_text())
    assert result["input"]["partition count"] == 2
    assert [h[0] for h in result["MLE"]["headers"]] == [
        "alpha", "beta", "alpha=beta", "LRT", "p-value", "Total branch length",
        "dN/dS LB", "dN/dS MLE", "dN/dS UB", "p-asmp", "2H rate"]
    for k in ("0", "1"):
        table = np.asarray(result["MLE"]["content"][k])
        assert table.shape == (6, 11) and np.isfinite(table).all()
        assert (table[:, 6] <= table[:, 7]).all() and (table[:, 7] <= table[:, 8]).all()
        assert np.allclose(table[:, 4] * 3, np.round(table[:, 4] * 3))
