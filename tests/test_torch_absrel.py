"""The port's aBSREL against the JAX package's.

* Objective level, fp64: the JAX package's ``BSRELEngine.loglik`` with the
  padded per-branch distributions that ``hyphy_tpu/methods/absrel.py``
  builds (its ``branch_distributions``, ``srv_dist`` and multiple-hit
  ``basis_fn`` closures written out below, with their lines) against the
  port's ``ABSRELModel.loglik``, one group per branch, at mixed class counts
  (1 to 5 per branch), with synonymous rate variation (3 classes) and with
  Double+Triple per-branch bases, at one numpy point made from a seed: values
  to 1e-9 relative, gradients against ``jax.grad`` to 1e-6 relative.
  Branch lengths are 0.3-0.9 (ROADMAP 3.5).
* The per-branch route in the branch-site SRV propagators (against the
  JAX package) and in the branch-pinned site lnLs (against the per-group
  loop).
* The distributions, the Holm-Bonferroni correction and the mixed-chi^2
  p-value against the JAX package's; the refit of the full model from a
  branch null's MLE (ROADMAP 3.16).
* Run level: ``absrel.run --srv Yes`` in both packages on a 5-taxon x
  20-codon alignment simulated with omega 4 at every seventh codon (the
  JAX package compiles each of its fits, ~10 s apiece on the CPU): the
  baseline and full lnLs within 0.15 (ROADMAP 3.4's L-BFGS tolerance), the
  same class counts per branch, the same positive branches; SRV posteriors
  summing to 1 and rates of unit mean (1e-6); the port's SRV rates and
  posteriors at the JAX run's final point equal to the JAX JSON's (1e-9),
  and its own run's within 1e-6 of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyphy_tpu.data.alignment import read_alignment as jread
from hyphy_tpu.data.filter import DataFilter as JFilter
from hyphy_tpu.data.genetic_code import GeneticCode as JCode
from hyphy_tpu.methods import absrel as jabsrel
from hyphy_tpu.models import frequencies as jfreq
from hyphy_tpu.models.bsrel import BSRELEngine as JEngine
from hyphy_tpu.models.bsrel import srv_distribution as jsrv_distribution
from hyphy_tpu.models.codon import MG94Base as JMG94
from hyphy_tpu.ops import pruning as jpruning
from hyphy_tpu.tree.topology import Tree as JTree
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.convert import params_from_numpy
from hyphy_tpu_torch.methods import absrel, common
from hyphy_tpu_torch.models import bsrel
from hyphy_tpu_torch.models.codon import MG94Base
from hyphy_tpu_torch.utils.synth import simulated_codon_alignment

torch.set_num_threads(2)

N_TAXA, N_CODONS, SEED = 8, 40, 3
RUN_TAXA, RUN_CODONS = 5, 20
KMAX = absrel.KMAX
# name -> (SRV classes, multiple hits)
CASES = {"mixed-classes": (1, "None"), "srv": (3, "None"),
         "double-triple": (1, "Double+Triple"), "srv-double": (3, "Double")}


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")
    monkeypatch.setenv("HYPHY_TPU_MESH", "off")


def _simulated(directory, n_taxa, n_codons):
    omegas = np.full(n_codons, 0.3)
    omegas[::7] = 4.0
    aln, newick = simulated_codon_alignment(n_taxa, n_codons, seed=SEED, mean_branch=0.1,
                                            site_omegas=omegas)
    fa = directory / f"sim_{n_taxa}.fasta"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    return str(fa), newick


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    fasta, newick = _simulated(tmp_path_factory.mktemp("absrel"), N_TAXA, N_CODONS)
    jgc = JCode("Universal")
    jfilt = JFilter.from_alignment(jread(fasta), "codon", genetic_code=jgc)
    jtree = JTree.from_newick(newick, leaf_order=jfilt.names)
    corners, codon_freqs = jfreq.f3x4(jfilt, jgc)
    data = common.load_codon_data(fasta, tree_newick=newick, device="cpu")
    return dict(jgc=jgc, jfilt=jfilt, jtree=jtree, data=data, corners=np.asarray(corners),
                codon_freqs=np.asarray(codon_freqs))


def _point(b, seed=0):
    rng = np.random.default_rng(seed)
    return {"theta_AC": 0.5, "theta_AT": 0.3, "theta_CG": 0.8, "theta_CT": 2.0,
            "theta_GT": 0.4, "t": np.linspace(0.3, 0.9, b),
            "omega_last": rng.uniform(0.2, 6.0, b),
            "omega_raw": rng.uniform(0.0, 1.0, (b, KMAX - 1)),
            "fracs": rng.uniform(0.05, 0.95, (b, KMAX - 1)),
            "delta": rng.uniform(0.01, 0.5, b), "psi": rng.uniform(0.01, 0.5, b),
            "srv_rate_1": 0.4, "srv_rate_2": 1.0, "srv_rate_3": 2.5, "srv_w_1": 0.3,
            "srv_w_2": 0.6}


def _class_counts(b, seed=1):
    """Every count 1 to 5 at least once, the rest drawn."""
    counts = np.random.default_rng(seed).integers(1, KMAX + 1, b)
    counts[:KMAX] = np.arange(1, KMAX + 1)
    return counts


# -- the JAX package's objective, as absrel.py builds it ----------------------

def _j_branch_distributions(params, n_classes, b):               # absrel.py:182-198
    idx_k = jnp.arange(KMAX)
    n = jnp.asarray(n_classes)[:, None]
    omegas = jnp.where(
        idx_k[None, :] < n - 1,
        jnp.pad(params["omega_raw"], ((0, 0), (0, 1)), constant_values=1.0),
        jnp.where(idx_k[None, :] == n - 1, params["omega_last"][:, None], 1.0))
    fr = jnp.where(idx_k[None, : KMAX - 1] >= n - 1, 1.0, params["fracs"])
    rem = jnp.concatenate([jnp.ones((b, 1)), jnp.cumprod(1.0 - fr, axis=1)], axis=1)
    weights = jnp.concatenate([fr, jnp.ones((b, 1))], axis=1) * rem
    return omegas, weights


def _j_basis(mg94, triple):                                      # absrel.py:144-155
    def basis_fn(params):
        q1s, q1n = mg94.basis_matrices(params)
        q2s, q2n = mg94.multihit_basis_matrices(params, 2)
        d = params["delta"][:, None, None]
        qs = q1s[None] + d * q2s[None]
        qn = q1n[None] + d * q2n[None]
        if triple:
            q3s, q3n = mg94.multihit_basis_matrices(params, 3)
            p = params["psi"][:, None, None]
            qs = qs + p * q3s[None]
            qn = qn + p * q3n[None]
        return qs, qn
    return basis_fn


def _j_loglik(fx, c_srv, mh):                                    # absrel.py:157-212
    b = fx["data"].tree.n_branches
    mg94 = JMG94(fx["jgc"], fx["corners"], fx["codon_freqs"])
    basis_fn = None if mh == "None" else _j_basis(mg94, mh == "Double+Triple")
    engine = JEngine(mg94, jpruning.build_pruning_data(fx["jtree"]),
                     jnp.asarray(fx["jfilt"].leaf_partials()), fx["jfilt"].pattern_weights,
                     np.arange(b, dtype=np.int32), srv_classes=c_srv, basis_fn=basis_fn,
                     mesh=None)

    def loglik(params, n_classes):
        omegas, weights = _j_branch_distributions(params, n_classes, b)
        if c_srv > 1:
            rates, wsrv = jsrv_distribution(params, c_srv)
        else:
            rates, wsrv = jnp.ones((1,)), jnp.ones((1,))
        return engine.loglik(params, omegas, weights, params["t"], rates, wsrv)
    return loglik


def _model(fx, c_srv, mh):
    mg94 = MG94Base(fx["data"].genetic_code, fx["corners"], fx["codon_freqs"], device="cpu")
    return absrel.ABSRELModel(mg94, fx["data"], mh, srv=c_srv > 1, srv_classes=c_srv)


@pytest.mark.parametrize("case", sorted(CASES))
def test_objective_and_gradient_match_jax(fixture, case):
    c_srv, mh = CASES[case]
    model = _model(fixture, c_srv, mh)
    b = model.n_branches
    assert model.engine.n_groups == b
    point = {k: v for k, v in _point(b).items() if k in model.specs}
    counts = _class_counts(b)
    jloglik = _j_loglik(fixture, c_srv, mh)
    jpoint = {k: jnp.asarray(v) for k, v in point.items()}
    ref = float(jloglik(jpoint, jnp.asarray(counts)))
    jgrad = jax.grad(jloglik)(jpoint, jnp.asarray(counts))
    params = {k: v.requires_grad_() for k, v in params_from_numpy(point, "cpu").items()}
    value = model.loglik(params, model.classes(counts))
    value.backward()
    assert abs(float(value.detach()) - ref) <= 1e-9 * abs(ref)
    for k in point:
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(jgrad[k]), rtol=1e-6,
                                   atol=1e-8 * abs(ref), err_msg=k)
    # the per-branch Taylor route (batched families) against the spectral one
    with torch.no_grad():
        model.engine.spectral = False
        taylor = float(model.loglik(params, model.classes(counts)))
    assert abs(taylor - ref) <= 1e-9 * abs(ref)


def test_per_branch_route_in_the_other_engine_entry_points(fixture, monkeypatch):
    """The per-branch route also serves the branch-site SRV propagators and
    the per-class propagators under the branch-pinned site lnLs: with one
    group per branch (mixed class counts, 3 SRV classes), the branch-site
    SRV site lnLs against the JAX package's (1e-9 relative, fp64
    spectral), and both entry points' fp64 Taylor values on the batched
    route against the per-group loop (1e-12 relative)."""
    model = _model(fixture, 3, "None")
    engine = model.engine
    b = model.n_branches
    point = {k: v for k, v in _point(b).items() if k in model.specs}
    params = params_from_numpy(point, "cpu")
    omegas, weights = absrel.branch_distributions(params, model.classes(_class_counts(b)))
    rates, wsrv = model.srv_dist(params)
    jmodel = JMG94(fixture["jgc"], fixture["corners"], fixture["codon_freqs"])
    jengine = JEngine(jmodel, jpruning.build_pruning_data(fixture["jtree"]),
                      jnp.asarray(fixture["jfilt"].leaf_partials()),
                      fixture["jfilt"].pattern_weights, np.arange(b, dtype=np.int32),
                      srv_classes=3, mesh=None)
    jargs = [jnp.asarray(x.numpy()) for x in (omegas, weights, params["t"], rates, wsrv)]
    ref = np.asarray(jengine.branchsite_srv_site_log_likelihoods(
        {k: jnp.asarray(v) for k, v in point.items()}, *jargs))
    args = (params, omegas, weights, params["t"], rates, wsrv)
    with torch.no_grad():
        np.testing.assert_allclose(engine.branchsite_srv_site_log_likelihoods(*args).numpy(),
                                   ref, rtol=1e-9, atol=0)
        engine.spectral = False
        out = {}
        for per_group_times in (bsrel.BATCHED_TIMES_PER_GROUP, 0):       # batched, loop
            monkeypatch.setattr(bsrel, "BATCHED_TIMES_PER_GROUP", per_group_times)
            out[per_group_times] = (engine.branchsite_srv_site_log_likelihoods(*args),
                                    engine.branch_class_site_logliks(*args, np.arange(b)))
    for batched, loop in zip(*out.values()):
        np.testing.assert_allclose(batched.numpy(), loop.numpy(), rtol=1e-12, atol=0)


def test_distributions_and_corrections_match_jax(fixture):
    b = fixture["data"].tree.n_branches
    point = _point(b)
    counts = _class_counts(b)
    ours = absrel.branch_distributions(params_from_numpy(point, "cpu"),
                                       torch.as_tensor(counts))
    ref = _j_branch_distributions({k: jnp.asarray(v) for k, v in point.items()}, counts, b)
    for a, r in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-15, atol=0)
    weights = ours[1].numpy()
    np.testing.assert_allclose(weights.sum(axis=1), 1.0, atol=1e-14)
    assert all((weights[i, counts[i]:] == 0).all() for i in range(b))
    p = {"a": 0.01, "b": 0.04, "c": 0.03, "d": 0.5, "e": 0.2}
    assert absrel.holm_bonferroni(p) == jabsrel.holm_bonferroni(p)
    for lrt in (0.0, 0.5, 3.0, 12.0):
        ref_p = 0.5 * (1.0 - 0.4 * (1.0 - jabsrel.common.chi2_sf(lrt, 1))
                       - 0.6 * (1.0 - jabsrel.common.chi2_sf(lrt, 2)))
        assert absrel.mixed_chi2_p(lrt) == pytest.approx(ref_p, rel=1e-15)


def test_full_refit_from_a_branch_null(fixture):
    """A branch null that ends above the full model is followed by a refit
    of the full model from the null's MLE, which it holds (ROADMAP 3.16):
    here the "full model" is an unfitted point, so the null climbs above
    it."""
    model = _model(fixture, 1, "None")
    b = model.n_branches
    counts = np.ones(b, dtype=np.int64)
    point = {k: v for k, v in _point(b).items() if k in model.specs}
    params = params_from_numpy(point, "cpu")
    tested = np.zeros(b, dtype=bool)
    tested[int(np.argmax(point["omega_last"]))] = True
    with torch.no_grad():
        start_lnl = float(model.loglik(params, model.classes(counts)))
    names = fixture["data"].tree.names
    full, full_lnl, nulls = absrel.test_branches(model, params, start_lnl, counts, tested,
                                                 names, 1e-2)
    (null_lnl,) = nulls.values()
    assert null_lnl > start_lnl
    assert full_lnl >= null_lnl - 1e-6
    with torch.no_grad():
        assert float(model.loglik(full, model.classes(counts))) == pytest.approx(full_lnl,
                                                                                 rel=1e-12)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``run --srv Yes`` in both packages, with the port's model and the
    JAX run's final point and class counts (the arguments of each
    package's ``_srv_json``)."""
    fasta, newick = _simulated(tmp_path_factory.mktemp("absrel_run"), RUN_TAXA, RUN_CODONS)
    seen = {}
    ours_json, ref_json = absrel._srv_json, jabsrel._srv_json

    def ours_spy(model, params, n_classes, filt):
        seen["model"], seen["filt"] = model, filt
        return ours_json(model, params, n_classes, filt)

    def ref_spy(engine, params, branch_distributions, srv_dist, n_classes, filt):
        seen["point"] = {k: np.asarray(v) for k, v in params.items()}
        seen["n_classes"] = np.asarray(n_classes)
        return ref_json(engine, params, branch_distributions, srv_dist, n_classes, filt)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        mp.setenv("HYPHY_TPU_MESH", "off")
        mp.setattr(settings, "device", "cpu")
        mp.setattr(absrel, "_srv_json", ours_spy)
        mp.setattr(jabsrel, "_srv_json", ref_spy)
        options = dict(tree=newick, srv=True, precision=1e-3)
        return absrel.run(fasta, device="cpu", **options), jabsrel.run(fasta, **options), seen


def test_run_matches_jax(runs):
    """Both runs' lnLs within 0.15 (ROADMAP 3.4's L-BFGS tolerance), the
    same class counts and calls; the SRV rates and site posteriors of the
    port's JSON at the JAX run's final point equal the JAX JSON's (1e-9),
    and those of the port's own run lie within 1e-6 of them (the two runs'
    fits stop at one point: 1.5e-8 apart in the posteriors, 3.0e-8 in the
    rates)."""
    ours, ref, seen = runs
    assert abs(ours.baseline_lnl - ref.baseline_lnl) <= 0.15
    assert ours.full_lnl >= ref.full_lnl - 0.15
    np.testing.assert_array_equal(ours.n_classes, ref.n_classes)
    assert sorted(ours.positive_branches) == sorted(ref.positive_branches)
    assert sorted(ours.branch_p) == sorted(ref.branch_p)
    assert sorted(ours.json) == sorted(ref.json)
    for name, p in ours.branch_p_corrected.items():
        assert (p <= 0.05) == (ref.branch_p_corrected[name] <= 0.05)
    rates = np.asarray(ours.json["Synonymous site-to-site rates"])
    assert abs(rates[:, 1].sum() - 1.0) <= 1e-6 and abs(rates[:, 0] @ rates[:, 1] - 1.0) <= 1e-6
    post = np.asarray(ours.json["Synonymous site-posteriors"])
    assert post.shape == (3, RUN_CODONS)
    np.testing.assert_allclose(post.sum(axis=0), 1.0, atol=1e-6)
    keys = ("Synonymous site-posteriors", "Synonymous site-to-site rates")
    at_ref = absrel._srv_json(seen["model"], params_from_numpy(seen["point"], "cpu"),
                              seen["n_classes"], seen["filt"])
    for key in keys:
        np.testing.assert_allclose(at_ref[key], ref.json[key], rtol=0, atol=1e-9, err_msg=key)
        np.testing.assert_allclose(ours.json[key], ref.json[key], rtol=0, atol=1e-6, err_msg=key)
    # Holm's correction keeps the order of the uncorrected p-values
    order = sorted(ours.branch_p, key=ours.branch_p.get)
    corrected = [ours.branch_p_corrected[n] for n in order]
    assert corrected == sorted(corrected)
