"""The port's BUSTED against the JAX package's.

* End to end (``busted.run``, SRV 3 x 3, 2 starting points, precision
  1e-3) on an alignment simulated along an 8-taxon tree with omega 4 at
  every seventh codon: the unconstrained and constrained fits of the
  port's ``maximize_jax`` no worse than the JAX package's by 0.15 lnL, the
  LRT within 0.3, the p-value on the same side of 0.05; the JAX objective
  at the port's MLE equal to the port's value; the constrained fit from
  the JAX run's MLE, carried across.  One JAX run, module-scoped.
* ``--save-fit``: a second run loads the snapshot and skips the fit; a
  snapshot of other data is refused.
* ``--error-sink``: the port's BUSTED-E JSON through both packages'
  ``error-filter`` gives the same masks.
* ``--srv-hmm``, ``--srv-branchsite`` and ``--multiple-hits`` end to end
  (capped), with the Viterbi path in the JSON.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyphy_tpu.methods.common as jcommon
from hyphy_tpu.methods import busted as jbusted
from hyphy_tpu.methods import error_filter as jerror_filter
from hyphy_tpu.utils import synth as jsynth
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.io import serialize
from hyphy_tpu_torch.methods import busted, error_filter
from hyphy_tpu_torch.utils.synth import simulated_codon_alignment
from torch_carry import carried_busted

torch.set_num_threads(2)

SIM_TAXA, SIM_CODONS, SIM_SEED = 8, 40, 3
OPTIONS = dict(starting_points=2, precision=1e-3)


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")
    monkeypatch.setenv("HYPHY_TPU_MESH", "off")


def _write(path, names, seqs):
    path.write_text("".join(f">{n}\n{s}\n" for n, s in zip(names, seqs)))
    return str(path)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("busted")
    omegas = np.full(SIM_CODONS, 0.3)
    omegas[::7] = 4.0
    aln, newick = simulated_codon_alignment(SIM_TAXA, SIM_CODONS, seed=SIM_SEED,
                                            mean_branch=0.1, site_omegas=omegas)
    syn = jsynth.synthetic_codon_alignment(6, 40, seed=5)
    other = jsynth.synthetic_codon_alignment(6, 40, seed=6)
    return {"sim": _write(d / "sim.fasta", aln.names, aln.sequences), "sim_tree": newick,
            "syn": _write(d / "syn.fasta", syn.names, syn.sequences),
            "other": _write(d / "other.fasta", other.names, other.sequences),
            "syn_tree": jsynth.random_tree_newick(6, seed=5), "dir": d}


@pytest.fixture(scope="module")
def runs(fixtures):
    """The JAX run (with its MG94 fit captured) and the port's."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        mp.setenv("HYPHY_TPU_MESH", "off")
        original = jcommon.fit_partitioned_mg94

        def spy(*args, **kwargs):
            seen["jmg94"] = original(*args, **kwargs)
            return seen["jmg94"]

        mp.setattr(jcommon, "fit_partitioned_mg94", spy)
        seen["jax"] = jbusted.run(fixtures["sim"], tree=fixtures["sim_tree"], **OPTIONS)
        seen["port"] = busted.run(fixtures["sim"], tree=fixtures["sim_tree"], device="cpu",
                                  **OPTIONS)
    return seen


def test_fits_match_jax(runs):
    ours, ref = runs["port"], runs["jax"]
    assert ours.unconstrained_lnl >= ref.unconstrained_lnl - 0.15
    assert ours.null_lnl >= ref.null_lnl - 0.15
    assert abs(ours.lrt - ref.lrt) <= 0.3
    assert (ours.p_value <= 0.05) == (ref.p_value <= 0.05)
    assert sorted(ours.json) == sorted(ref.json)
    dist = ours.json["fits"]["Unconstrained model"]["Rate Distributions"]
    assert sorted(dist) == sorted(ref.json["fits"]["Unconstrained model"]["Rate Distributions"])
    er = np.asarray(ours.json["Evidence Ratios"]["optimized null"][0])
    assert er.shape == (SIM_CODONS,) and np.isfinite(er).all()


def test_jax_objective_at_the_port_mle(runs):
    """The JAX package's BUSTED objective at the port's MLE gives the
    port's value (1e-8 relative)."""
    ours, ref = runs["port"], runs["jax"]
    point = {k: jnp.asarray(v.detach().numpy()) for k, v in ours.alt_params.items()}
    value = float(ref.context["loglik"](point))
    assert abs(value - ours.unconstrained_lnl) <= 1e-8 * abs(value)


def test_constrained_fit_from_the_jax_mle(runs, fixtures):
    """The port's constrained fit (omega_3 := 1) from the JAX run's MLE,
    carried across with its MG94 fit: no worse than the JAX package's."""
    ref = runs["jax"]
    jparams = {k: np.asarray(v) for k, v in ref.alt_params.items()}
    params, mgp = carried_busted(jparams, runs["jmg94"], runs["port"].data)
    ctx = runs["port"].context
    with torch.no_grad():
        start = float(ctx["loglik"](params))
    assert abs(start - ref.unconstrained_lnl) <= 1e-6 * abs(start)
    one = torch.tensor(1.0, dtype=torch.float64)
    _, null_lnl = busted.fit_constrained(ctx["loglik"], ctx["specs"], params,
                                         {"test_omega_3": one}, OPTIONS["precision"])
    assert null_lnl >= ref.null_lnl - 0.15
    assert np.allclose(mgp.alphas, runs["jmg94"].alphas)


def test_save_fit_reuses_the_snapshot(fixtures, monkeypatch):
    path = str(fixtures["dir"] / "fit.json")
    opts = dict(tree=fixtures["syn_tree"], srv=False, device="cpu", starting_points=2,
                precision=1e-2, save_fit=path)
    first = busted.run(fixtures["syn"], **opts)
    snap = serialize.load_snapshot(path, expect_model="BUSTED")
    assert snap is not None and set(snap["parameters"]) == set(first.context["specs"])
    calls = []
    original = busted.fit_unconstrained
    monkeypatch.setattr(busted, "fit_unconstrained",
                        lambda *a, **k: calls.append(1) or original(*a, **k))
    second = busted.run(fixtures["syn"], **opts)
    assert not calls and second.unconstrained_lnl == first.unconstrained_lnl
    assert abs(second.null_lnl - first.null_lnl) <= 1e-9 * abs(first.null_lnl)
    # a snapshot of other data (another fingerprint) is refused: the fit runs
    fingerprint = serialize.data_fingerprint(["a"], ["ATG"])
    assert serialize.load_snapshot(path, expect_fingerprint=fingerprint) is None
    busted.run(fixtures["other"], **opts)
    assert calls == [1]


def test_unconstrained_refit_when_the_null_is_higher(fixtures, monkeypatch):
    """An unconstrained fit that ends below the constrained one is refit
    from the constrained MLE, which the alternative holds (omega_3 = 1):
    here the unconstrained "fit" is the best starting candidate, unfitted,
    so the constrained fit from it climbs above it."""
    def unfitted(loglik, specs, candidates, starting_points, precision):
        with torch.no_grad():
            value, best = max((float(loglik(c)), i) for i, c in enumerate(candidates))
        return candidates[best], value

    fits = []
    original = busted.maximize
    monkeypatch.setattr(busted, "fit_unconstrained", unfitted)
    monkeypatch.setattr(busted, "maximize",
                        lambda *a, **k: fits.append(a[1]) or original(*a, **k))
    res = busted.run(fixtures["syn"], tree=fixtures["syn_tree"], srv=False, device="cpu",
                     starting_points=2, precision=1e-2)
    assert len(fits) == 2 and "test_omega_3" in fits[1]      # the null, then the refit
    assert res.unconstrained_lnl >= res.null_lnl - 1e-6
    with torch.no_grad():
        assert float(res.context["loglik"](res.alt_params)) == pytest.approx(
            res.unconstrained_lnl, rel=1e-12)


@pytest.fixture(scope="module")
def busted_e(fixtures):
    """The port's BUSTED-E run and its JSON file."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        res = busted.run(fixtures["syn"], tree=fixtures["syn_tree"], srv=False,
                         error_sink=True, device="cpu", starting_points=2, precision=1e-2)
    path = fixtures["dir"] / "busted_e.json"
    path.write_text(json.dumps(res.json))
    return res, path


# (threshold, ratio, site threshold): the defaults mask 1 cell of the
# fixture, the lower ones 26 and 240 (whole columns among them)
@pytest.mark.parametrize("thresholds", [(100.0, 20.0, 0.4), (1.0, 0.5, 0.3), (0.1, 0.1, 0.3)])
def test_error_filter_matches_jax_on_the_port_json(busted_e, thresholds):
    """The port's BUSTED-E JSON through both packages' error-filter: equal
    masked cells and masked sequences."""
    res, path = busted_e
    attrs = res.json["branch attributes"]["0"]
    posteriors = np.stack([np.asarray(b["Posterior prob omega class by site"])
                           for b in attrs.values()])
    np.testing.assert_allclose(posteriors.sum(axis=1), 1.0, atol=1e-12)
    assert len(res.json["substitutions"]["0"]) == 40
    threshold, ratio, site_threshold = thresholds
    ours = error_filter.run(str(path), threshold=threshold, ratio=ratio,
                            site_threshold=site_threshold)
    ref = jerror_filter.run(str(path), threshold=threshold, ratio=ratio,
                            site_threshold=site_threshold)
    assert ours.masked_sites == ref.masked_sites
    assert ours.sequences == ref.sequences and ours.total_masked == ref.total_masked
    assert all(len(s) == 3 * 40 for s in ours.sequences.values())


@pytest.mark.parametrize("option", ["srv_hmm", "srv_branchsite", "multiple_hits"])
def test_options_end_to_end(fixtures, option, monkeypatch):
    """Each option through ``busted.run`` with capped optimizers: finite
    fits and its JSON block (the HMM's Viterbi path over every site)."""
    monkeypatch.setattr(settings, "warmup", True)
    kwargs = {"multiple_hits": "Double+Triple"} if option == "multiple_hits" else {option: True}
    res = busted.run(fixtures["syn"], tree=fixtures["syn_tree"], device="cpu", **kwargs)
    assert np.isfinite([res.unconstrained_lnl, res.null_lnl]).all()
    assert 0.0 <= res.p_value <= 1.0
    dist = res.json["fits"]["Unconstrained model"]["Rate Distributions"]
    assert len(dist["Synonymous site-to-site rates"]) == 3
    if option == "srv_hmm":
        path = res.json["Synonymous rate HMM"]["Viterbi path"]
        assert len(path) == 40 and set(path) <= {0, 1, 2}
    if option == "multiple_hits":
        assert len(dist["Multiple hit rates"]) == 2


def test_substitution_map_matches_the_reference_loop(fixtures):
    """``busted.substitution_map`` against the JAX package's per-site,
    per-node loop (``busted.py:420-451``, copied here) on random internal
    states with unresolved (-1) entries, over leaves with gaps."""
    from hyphy_tpu_torch.data.genetic_code import codon_string
    from hyphy_tpu_torch.methods import common

    aln = jsynth.synthetic_codon_alignment(7, 30, seed=9)
    seqs = [s[:6] + "---" + s[9:] if i % 3 == 0 else s for i, s in enumerate(aln.sequences)]
    fa = _write(fixtures["dir"] / "gaps.fasta", aln.names, seqs)
    data = common.load_codon_data(fa, tree_newick=jsynth.random_tree_newick(7, seed=9),
                                  device="cpu")
    filt, tree = data.codon_filter, data.tree
    rng = np.random.default_rng(1)
    internal = rng.integers(-1, 61, size=(tree.n_nodes - tree.n_leaves, filt.n_units))
    sense = data.genetic_code.sense_codons

    def state_str(node, site):
        if node < tree.n_leaves:
            vec = filt.resolution_table[filt.leaf_codes[node, filt.duplicate_map[site]]]
            nz = np.nonzero(vec)[0]
            if nz.size == 1:
                return codon_string(int(sense[nz[0]]))
            return "---" if nz.size == 0 or nz.size == vec.size else "NNN"
        st = internal[node - tree.n_leaves, site]
        return codon_string(int(sense[st])) if st >= 0 else "---"

    expect = {}
    for site in range(filt.n_units):
        entry = {"root": state_str(tree.n_nodes - 1, site)}
        for node in range(tree.n_nodes - 1):
            s_n, s_p = state_str(node, site), state_str(tree.parent[node], site)
            if s_n != s_p:
                entry[tree.names[node]] = s_n
        expect[str(site)] = entry
    got = busted.substitution_map(data, internal)
    assert got == expect
    assert list(got["2"]) == list(expect["2"])
