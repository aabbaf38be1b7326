"""The port's GARD against the JAX package's.

* ``tn93_distance`` (the port's numpy form against the JAX package's,
  which takes its native C++ path where it builds) on sequences with gaps
  and IUPAC codes, a pair with no site in common (5.0) and a saturated pair
  (5.0); ``caic`` and ``_variable_sites``: equal to 1e-12 / exactly.
* ``_Evaluator.evaluate``: the lnL of the baseline and of three breakpoint
  vectors that both packages' runs fitted within 0.15 of each other, with
  equal parameter counts; a vector with a partition of one site is
  infinitely bad in both.
* The genetic algorithm's logic, exactly: the port's ``run`` resumed from
  the JAX run's checkpoint, with the JAX run's baseline fit carried in (so
  no optimizer noise enters), fits nothing and returns the JAX run's
  breakpoints, improvements, potential breakpoints and site support (1e-9).
* A fresh port run finds the JAX run's breakpoints.
* With fewer distinct two-breakpoint models than the population, where the
  JAX package's seeding loop never ends, the port's run ends (ROADMAP 3.23).

The fixture joins two halves of 120 sites simulated under GTR along two
different 8-taxon trees; the runs are capped (candidate stride 16,
population 4, 2 stagnant generations, 2 breakpoints) so that the JAX run
fits about a dozen models."""

import json

import numpy as np
import pytest
import torch

from hyphy_tpu.data.alignment import read_alignment as jread
from hyphy_tpu.data.filter import DataFilter as JDataFilter
from hyphy_tpu.methods import gard as jgard
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.convert import params_from_numpy
from hyphy_tpu_torch.data.alignment import read_alignment
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.likelihood import FitResult, LikelihoodFunction
from hyphy_tpu_torch.methods import gard
from hyphy_tpu_torch.models.parameters import count_parameters
from tests.torch_carry import write_recombinant_fasta

torch.set_num_threads(2)

N_TAXA, HALF, TREE_SEEDS = 8, 120, (5, 6)
RUN = dict(candidate_stride=16, population=4, stagnant_generations=2, max_breakpoints=2)


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")


def _spy_fits(mp, module, log):
    """Record (lnL, parameter count) of every c-AIC a run computes, keyed
    by the sorted breakpoints (the baseline by ())."""
    current = []
    evaluate, caic = module._Evaluator.evaluate, module.caic

    def spied_evaluate(self, breakpoints):
        current.append(tuple(sorted(int(b) for b in breakpoints)))
        try:
            return evaluate(self, breakpoints)
        finally:
            current.pop()

    def spied_caic(loglik, n_params, n_samples):
        log[current[-1] if current else ()] = (float(loglik), int(n_params))
        return caic(loglik, n_params, n_samples)

    mp.setattr(module._Evaluator, "evaluate", spied_evaluate)
    mp.setattr(module, "caic", spied_caic)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run (its checkpoint, fits and baseline fit recorded), a fresh
    port run, and the port's run resumed from the JAX run's checkpoint with
    the JAX baseline fit carried in."""
    d = tmp_path_factory.mktemp("gard")
    fasta = write_recombinant_fasta(d / "rec.fasta", N_TAXA, HALF, TREE_SEEDS)
    jlog, log, baseline = {}, {}, []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        mp.setenv("HYPHY_TPU_MESH", "off")
        mp.setattr(settings, "device", "cpu")
        _spy_fits(mp, jgard, jlog)
        jfit = jgard.LikelihoodFunction.fit

        def first_fit(self, *args, **kwargs):
            res = jfit(self, *args, **kwargs)
            if not baseline:
                baseline.append(res)
            return res

        mp.setattr(jgard.LikelihoodFunction, "fit", first_fit)
        ref = jgard.run(fasta, checkpoint=str(d / "jax.json"), **RUN)
        with open(d / "jax.json") as fh:
            saved = json.load(fh)["masterList"]
        _spy_fits(mp, gard, log)
        ours = gard.run(fasta, checkpoint=str(d / "port.json"), device="cpu", **RUN)

        jbase = baseline[0]

        def carried_baseline(self, *args, **kwargs):
            n_free = count_parameters(self.specs)
            assert n_free == jbase.n_free_parameters
            params = params_from_numpy({k: np.asarray(v) for k, v in jbase.params.items()},
                                       "cpu")
            return FitResult(params=params, loglik=jbase.loglik, n_free_parameters=n_free,
                             n_iterations=0, lf=self)

        mp.setattr(LikelihoodFunction, "fit", carried_baseline)
        replay = gard.run(fasta, checkpoint=str(d / "jax.json"), device="cpu", **RUN)
    return dict(fasta=fasta, ref=ref, ours=ours, replay=replay, jlog=jlog, log=log,
                saved=saved)


def _tn93_fasta(path):
    """Seven sequences of 48 sites: t1 a few changes from t0 with gaps and
    IUPAC codes, t2 and t3 gapped in complementary halves (no site in
    common), t4 unrelated to t0 (saturated), t5 and t6 ambiguous."""
    rng = np.random.default_rng(0)
    t0 = "".join(rng.choice(list("ACGT"), 48))
    t1 = list(t0)
    for i, c in ((3, "G"), (10, "T"), (17, "-"), (18, "-"), (25, "R"), (30, "N"), (40, "Y")):
        t1[i] = c
    t2 = t0[:24] + "-" * 24
    t3 = "-" * 24 + "".join(rng.choice(list("ACGT"), 24))
    t4 = "".join(rng.choice(list("ACGT"), 48))
    t5 = "".join(c if i % 5 else "N" for i, c in enumerate(t0))
    t6 = "".join(c if i % 7 else "K" for i, c in enumerate(t4))
    seqs = [t0, "".join(t1), t2, t3, t4, t5, t6]
    path.write_text("".join(f">t{i}\n{s}\n" for i, s in enumerate(seqs)))
    return str(path)


@pytest.mark.parametrize("case", ["tn93", "caic", "variable_sites"])
def test_numpy_parts_match_jax(tmp_path, case):
    fasta = _tn93_fasta(tmp_path / "tn93.fasta")
    filt = DataFilter.from_alignment(read_alignment(fasta), "nucleotide")
    jfilt = JDataFilter.from_alignment(jread(fasta), "nucleotide")
    if case == "tn93":
        d, jd = gard.tn93_distance(filt), jgard.tn93_distance(jfilt)
        assert d.shape == jd.shape == (7, 7)
        np.testing.assert_allclose(d, jd, rtol=1e-12, atol=1e-12)
        assert d[2, 3] == jd[2, 3] == 5.0            # no site in common
        assert d[0, 4] == jd[0, 4] == 5.0            # saturated
        assert 0 < d[0, 1] < 0.5 and np.all(np.diag(d) == 0)
    elif case == "caic":
        for loglik, k, n in ((-1234.5, 17, 240), (-10.0, 3, 4), (-10.0, 5, 3), (0.0, 0, 1)):
            assert gard.caic(loglik, k, n) == jgard.caic(loglik, k, n)
    else:
        sites, jsites = gard._variable_sites(filt), jgard._variable_sites(jfilt)
        assert sites.dtype == jsites.dtype and np.array_equal(sites, jsites)
        assert 0 < len(sites) < 48


def test_evaluator_matches_jax(runs):
    """The baseline and three breakpoint vectors both runs fitted: lnL
    within 0.15, equal parameter counts; a one-site partition is inf."""
    log, jlog = runs["log"], runs["jlog"]
    common = sorted(set(log) & set(jlog), key=lambda key: (len(key), key))
    keys = [()] + [k for k in common if len(k) == 2][:1]
    keys += [k for k in common if len(k) == 1][: 4 - len(keys)]
    assert len(keys) == 4 and keys[0] == ()
    for key in keys:
        assert abs(log[key][0] - jlog[key][0]) <= 0.15, key
        assert log[key][1] == jlog[key][1], key
    assert log[()][1] == 3 + 5 + (2 * N_TAXA - 3)
    filt = DataFilter.from_alignment(read_alignment(runs["fasta"]), "nucleotide")
    jfilt = JDataFilter.from_alignment(jread(runs["fasta"]), "nucleotide")
    ours = gard._Evaluator(filt, gard._variable_sites(filt), 1e-4, device="cpu")
    ref = jgard._Evaluator(jfilt, jgard._variable_sites(jfilt), 1e-4)
    assert ours.evaluate((0,)) == ref.evaluate((0,)) == np.inf
    assert ours.evaluations == ref.evaluations == 0


def test_resumed_search_replays_the_jax_run(runs):
    """From the JAX run's checkpoint, with its baseline fit carried in: no
    candidate is fitted, and the search ends where the JAX run's did."""
    replay, ref = runs["replay"], runs["ref"]
    assert replay.json["totalModelCount"] == 0
    assert replay.breakpoints == ref.breakpoints
    assert replay.json["potentialBreakpoints"] == ref.json["potentialBreakpoints"]
    assert replay.baseline_caic == pytest.approx(ref.baseline_caic, rel=1e-12)
    assert replay.best_caic == pytest.approx(ref.best_caic, rel=1e-12)
    assert sorted(replay.improvements) == sorted(ref.improvements)
    for n, imp in ref.improvements.items():
        assert replay.improvements[n]["breakpoints"] == [int(b) for b in imp["breakpoints"]]
        assert replay.improvements[n]["deltaAICc"] == pytest.approx(imp["deltaAICc"], abs=1e-9)
    support, jsupport = replay.site_support, ref.site_support
    assert sorted(support) == sorted(jsupport)
    for bp in support:
        assert support[bp] == pytest.approx(jsupport[bp], abs=1e-9)
    assert replay.json["breakpointData"] == ref.json["breakpointData"]
    # the baseline and every fitted model, beside the vectors with an empty
    # partition (inf, never fitted)
    fitted = [v for v in runs["saved"].values() if np.isfinite(v[0])]
    assert len(fitted) == ref.json["totalModelCount"] + 1


def test_fresh_run_finds_the_jax_breakpoints(runs):
    ours, ref = runs["ours"], runs["ref"]
    assert ours.breakpoints == [int(b) for b in ref.breakpoints]
    assert len(ours.breakpoints) == 1 and abs(ours.breakpoints[0] - HALF) <= 16
    assert ours.best_caic < ours.baseline_caic
    assert ours.json["potentialBreakpoints"] == ref.json["potentialBreakpoints"]
    assert sorted(ours.json) == sorted(ref.json)
    assert abs(ours.baseline_caic - ref.baseline_caic) <= 0.3


def test_small_population_space_ends(runs, tmp_path):
    """Three candidates give three two-breakpoint models, fewer than a
    population of 4: the JAX package's seeding loop never ends there
    (ROADMAP 3.23); the port's takes the three, runs the search and keeps
    the single breakpoint."""
    ours = gard.run(runs["fasta"], device="cpu", candidate_stride=30, population=4,
                    stagnant_generations=2, max_breakpoints=2)
    assert ours.json["potentialBreakpoints"] == 3
    assert ours.json["totalModelCount"] <= 3 + 3
    assert len(ours.breakpoints) == 1 and abs(ours.breakpoints[0] - HALF) <= 30
