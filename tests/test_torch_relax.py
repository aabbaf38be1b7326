"""The port's RELAX against the JAX package's.

* Objective level, fp64: the JAX package's ``BSRELEngine.loglik`` with the
  omegas and weights that ``hyphy_tpu/methods/relax.py`` builds (its
  closures written out below, with their lines) against the port's
  objective builders, at one numpy point made from a seed and carried into
  both packages: the general-descriptive model (one group per branch), the
  alternative, the null (K = 1), the partitioned descriptive model and
  group mode with and without a nuisance set; values to 1e-9 relative,
  gradients against ``jax.grad`` to 1e-6 relative.  Branch lengths are
  0.3-0.9, where the fp64 spectral route is well conditioned (ROADMAP 3.5).
* The batched per-generator Taylor propagators
  (``expm.taylor_propagators_batched``) in fp64 against the port's
  per-family ``shared_taylor_propagators``, the JAX package's
  ``jax.vmap(shared_taylor_propagators)`` with the times diagonal, the
  spectral route and ``scipy.linalg.expm`` (1e-10), past the default ladder
  depth too; in fp32 against the per-family route (1e-6) and fp64 (1e-4:
  the squaring ladder amplifies fp32 round-off at long times).
* The per-branch route: the general-descriptive value by the batched
  per-branch Taylor propagators equal to the per-group loop's (1e-12) and
  to the spectral route's (1e-9); an fp32 omega^K past fp32's range gives a
  non-finite value, not an exception.
* The refit of the alternative from the null's MLE (ROADMAP 3.16).
* Run level: ``relax.run`` in both packages, ``--models Minimal`` and group
  mode, on a 5-taxon x 20-codon alignment simulated the same way (the JAX
  package compiles each of its seven fits per run, ~10-20 s apiece on the
  CPU): the MG94 and alternative lnLs within 0.15 (ROADMAP 3.4's L-BFGS
  tolerance), the null from the JAX run's alternative MLE no worse than the
  JAX null by 0.15 with the same call at p <= 0.05, and the JAX null from
  the port's alternative MLE at the port's own null (1e-6 in Minimal mode,
  the fits' precision 1e-3 in group mode) with the port's call.

The objective-level alignment is simulated along an 8-taxon tree, 40
codons, with omega 4 at every seventh codon; its first three leaves are
labelled FG, the next three REF.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyphy_tpu.data.alignment import read_alignment as jread
from hyphy_tpu.data.filter import DataFilter as JFilter
from hyphy_tpu.data.genetic_code import GeneticCode as JCode
from hyphy_tpu.methods import relax as jrelax
from hyphy_tpu.models import frequencies as jfreq
from hyphy_tpu.models.bsrel import BSRELEngine as JEngine
from hyphy_tpu.models.codon import MG94Base as JMG94
from hyphy_tpu.ops import expm as jexpm
from hyphy_tpu.ops import pruning as jpruning
from hyphy_tpu.tree.topology import Tree as JTree
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.convert import params_from_numpy
from hyphy_tpu_torch.data.alignment import read_alignment
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.data.genetic_code import GeneticCode
from hyphy_tpu_torch.methods import relax
from hyphy_tpu_torch.models import bsrel
from hyphy_tpu_torch.models.bsrel import BSRELEngine
from hyphy_tpu_torch.models.codon import MG94Base
from hyphy_tpu_torch.models.base import fill_diagonal_from_rows
from hyphy_tpu_torch.ops import expm, pruning
from hyphy_tpu_torch.tree.topology import Tree
from hyphy_tpu_torch.utils.synth import simulated_codon_alignment

torch.set_num_threads(2)

N_TAXA, N_CODONS, SEED, K = 8, 40, 3, 3
RUN_TAXA, RUN_CODONS = 5, 20
RUN_OPTIONS = dict(precision=1e-3)
# |the JAX null fitted from the port's alternative MLE - the port's null|:
# in Minimal mode both optimizers take the same path (ROADMAP 3.18); in
# group mode their paths part within the fits' stopping precision
NULL_FROM_THE_PORTS_START = {"minimal": 1e-6, "groups": RUN_OPTIONS["precision"]}


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")
    monkeypatch.setenv("HYPHY_TPU_MESH", "off")


def _simulated(directory, n_taxa, n_codons, labelled):
    """An alignment simulated along ``n_taxa`` taxa with omega 4 at every
    seventh codon, and its tree with the first ``labelled`` leaves labelled
    FG, the next ``labelled`` REF, the other branches unlabelled."""
    omegas = np.full(n_codons, 0.3)
    omegas[::7] = 4.0
    aln, newick = simulated_codon_alignment(n_taxa, n_codons, seed=SEED, mean_branch=0.1,
                                            site_omegas=omegas)
    fa = directory / f"sim_{n_taxa}.fasta"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    names = Tree.from_newick(newick).names[:n_taxa]
    for n in names[:labelled]:
        newick = newick.replace(f"{n}:", f"{n}{{FG}}:")
    for n in names[labelled: 2 * labelled]:
        newick = newick.replace(f"{n}:", f"{n}{{REF}}:")
    return str(fa), newick


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    fa, labelled = _simulated(tmp_path_factory.mktemp("relax"), N_TAXA, N_CODONS, 3)
    jgc = JCode("Universal")
    jfilt = JFilter.from_alignment(jread(fa), "codon", genetic_code=jgc)
    jtree = JTree.from_newick(labelled, leaf_order=jfilt.names)
    corners, codon_freqs = jfreq.f3x4(jfilt, jgc)
    gc = GeneticCode("Universal")
    filt = DataFilter.from_alignment(read_alignment(fa), "codon", genetic_code=gc)
    tree = Tree.from_newick(labelled, leaf_order=filt.names)
    return dict(jgc=jgc, jfilt=jfilt, jtree=jtree, gc=gc, filt=filt, tree=tree,
                corners=np.asarray(corners), codon_freqs=np.asarray(codon_freqs))


def _engines(fx, groups):
    jmodel = JMG94(fx["jgc"], fx["corners"], fx["codon_freqs"])
    jengine = JEngine(jmodel, jpruning.build_pruning_data(fx["jtree"]),
                      jnp.asarray(fx["jfilt"].leaf_partials()), fx["jfilt"].pattern_weights,
                      groups, mesh=None)
    model = MG94Base(fx["gc"], fx["corners"], fx["codon_freqs"], device="cpu")
    engine = BSRELEngine(model, pruning.build_pruning_data(fx["tree"], "cpu"),
                         fx["filt"].leaf_partials(), fx["filt"].pattern_weights, groups)
    return jengine, engine


def _classic_groups(tree):
    group = np.full(tree.n_branches, 2, dtype=np.int32)
    group[tree.select_branches("REF")] = 1
    group[tree.select_branches("FG")] = 0
    return group


def _point(tree, seed=0):
    """One numpy point for every model of this file."""
    rng = np.random.default_rng(seed)
    b = tree.n_branches
    point = {"theta_AC": 0.5, "theta_AT": 0.3, "theta_CG": 0.8, "theta_CT": 2.0,
             "theta_GT": 0.4, "t": np.linspace(0.3, 0.9, b),
             "k_branch": rng.uniform(0.3, 2.5, b), "K": 0.7, "K_1": 1.8, "K_2": 0.4}
    for prefix in ("ge", "ref", "unc", "pd_test", "pd_ref", "pd_unc"):
        point[f"{prefix}_omega_1"] = rng.uniform(0.05, 0.4)
        point[f"{prefix}_omega_2"] = rng.uniform(0.5, 0.95)
        point[f"{prefix}_omega_3"] = rng.uniform(1.5, 5.0)
        point[f"{prefix}_w_1"] = rng.uniform(0.3, 0.8)
        point[f"{prefix}_w_2"] = rng.uniform(0.3, 0.8)
    return point


# -- the JAX package's objectives, as relax.py builds them -------------------

def _jones():
    return jnp.ones((1,))


def _j_general_descriptive(engine, b):                         # relax.py:151-160
    def loglik(params):
        om = jrelax._get_omegas(params, "ge", K)
        w = jrelax._get_weights(params, "ge", K)
        omegas = jnp.power(jnp.maximum(om, 1e-10)[None, :], params["k_branch"][:, None])
        return engine.loglik(params, omegas, jnp.broadcast_to(w, (b, K)), params["t"],
                             _jones(), _jones())
    return loglik


def _j_alternative(engine, null=False):                        # relax.py:197-211, 255-258
    def loglik(params):
        k_value = jnp.asarray(1.0) if null else params["K"]
        om_ref = jnp.maximum(jrelax._get_omegas(params, "ref", K), 1e-10)
        w = jrelax._get_weights(params, "ref", K)
        omegas = jnp.stack([jnp.power(om_ref, k_value), om_ref,
                            jrelax._get_omegas(params, "unc", K)])
        return engine.loglik(params, omegas, jnp.broadcast_to(w, (3, K)), params["t"],
                             _jones(), _jones())
    return loglik


def _j_partitioned(engine, prefixes):                          # relax.py:278-283
    def loglik(params):
        omegas = jnp.stack([jrelax._get_omegas(params, p, K) for p in prefixes])
        weights = jnp.stack([jrelax._get_weights(params, p, K) for p in prefixes])
        return engine.loglik(params, omegas, weights, params["t"], _jones(), _jones())
    return loglik


def _j_groups(engine, n_groups, has_unc):                      # relax.py:438-455
    def loglik(params):
        om_ref = jnp.maximum(jrelax._get_omegas(params, "ref", K), 1e-10)
        w = jrelax._get_weights(params, "ref", K)
        rows = [om_ref] + [jnp.power(om_ref, params[f"K_{gi}"]) for gi in range(1, n_groups)]
        w_rows = [w] * n_groups
        if has_unc:
            rows.append(jnp.maximum(jrelax._get_omegas(params, "unc", K), 1e-10))
            w_rows.append(jrelax._get_weights(params, "unc", K))
        return engine.loglik(params, jnp.stack(rows), jnp.stack(w_rows), params["t"],
                             _jones(), _jones())
    return loglik


def _models(fx, name):
    """(JAX objective, port objective, the point's keys) for one model."""
    tree = fx["tree"]
    b = tree.n_branches
    thetas = ["theta_AC", "theta_AT", "theta_CG", "theta_CT", "theta_GT", "t"]

    def dist(prefix):
        return [f"{prefix}_omega_{i}" for i in (1, 2, 3)] + [f"{prefix}_w_{i}" for i in (1, 2)]

    if name == "general descriptive":
        jengine, engine = _engines(fx, np.arange(b, dtype=np.int32))
        return (_j_general_descriptive(jengine, b), relax.general_descriptive_objective(engine, K),
                thetas + dist("ge") + ["k_branch"])
    groups = _classic_groups(tree)
    if name in ("alternative", "null"):
        jengine, engine = _engines(fx, groups)
        port = relax.alternative_objective(engine, K, True)
        keys = thetas + dist("ref") + [f"unc_omega_{i}" for i in (1, 2, 3)] + ["K"]
        if name == "null":
            def null(params):
                return port(dict(params, K=torch.ones_like(params["K"])))
            return _j_alternative(jengine, null=True), null, keys
        return _j_alternative(jengine), port, keys
    if name == "partitioned descriptive":
        jengine, engine = _engines(fx, groups)
        prefixes = ["pd_test", "pd_ref", "pd_unc"]
        return (_j_partitioned(jengine, prefixes), relax.partitioned_objective(engine, K, prefixes),
                thetas + sum((dist(p) for p in prefixes), []))
    # group mode: reference REF first, then FG and the unlabelled branches
    # as a third labelled set (no nuisance set), or FG only with the
    # unlabelled branches as the nuisance set
    group = np.full(b, -1, dtype=np.int32)
    group[tree.select_branches("REF")] = 0
    group[tree.select_branches("FG")] = 1
    if name == "groups":
        group[group < 0] = 2
        n_groups, has_unc = 3, False
    else:
        group[group < 0] = 2
        n_groups, has_unc = 2, True
    jengine, engine = _engines(fx, group)
    keys = thetas + dist("ref") + [f"K_{gi}" for gi in range(1, n_groups)]
    if has_unc:
        keys += dist("unc")
    return (_j_groups(jengine, n_groups, has_unc), relax.group_objective(engine, K, n_groups,
                                                                          has_unc), keys)


MODELS = ["general descriptive", "alternative", "null", "partitioned descriptive", "groups",
          "groups with a nuisance set"]


@pytest.mark.parametrize("name", MODELS)
def test_objective_and_gradient_match_jax(fixture, name):
    jloglik, loglik, keys = _models(fixture, name)
    point = {k: v for k, v in _point(fixture["tree"]).items() if k in keys}
    jpoint = {k: jnp.asarray(v) for k, v in point.items()}
    ref = float(jloglik(jpoint))
    jgrad = jax.grad(jloglik)(jpoint)
    params = {k: v.requires_grad_() for k, v in params_from_numpy(point, "cpu").items()}
    value = loglik(params)
    value.backward()
    assert abs(float(value) - ref) <= 1e-9 * abs(ref)
    for k in keys:
        if name == "null" and k == "K":
            continue                       # K is pinned: no gradient on either side
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(jgrad[k]), rtol=1e-6,
                                   atol=1e-8 * abs(ref), err_msg=k)


def _families(fx, n, seed=4):
    """``n`` MG94 generators with random thetas and omegas 0.05-30, and
    per-family times for two synonymous-rate classes; the first family's
    longest time needs a ladder past the default depth of 11."""
    rng = np.random.default_rng(seed)
    model = MG94Base(fx["gc"], fx["corners"], fx["codon_freqs"], device="cpu")
    qs = []
    for _ in range(n):
        thetas = {k: torch.tensor(rng.uniform(0.2, 3.0), dtype=torch.float64)
                  for k in ("theta_AC", "theta_AT", "theta_CG", "theta_CT", "theta_GT")}
        q_syn, q_non = model.basis_matrices(thetas)
        qs.append(fill_diagonal_from_rows(q_syn + rng.uniform(0.05, 30.0) * q_non))
    t = rng.uniform(0.01, 2.0, (2, n))
    t[1, 0] = 400.0
    return torch.stack(qs), torch.tensor(t)


def test_batched_taylor_propagators(fixture):
    import scipy.linalg as sla

    q, t = _families(fixture, 12)
    ours = expm.taylor_propagators_batched(q, t)                         # [2, F, S, S]
    assert ours.shape == (2, 12, 61, 61)
    pi = torch.as_tensor(fixture["codon_freqs"])
    left, lam, right = expm.reversible_spectral(q, pi)
    for f in range(q.shape[0]):
        depth = expm.ladder_depth(q[f], t[:, f], 11, radius=2.0)
        np.testing.assert_allclose(ours[:, f].numpy(),
                                   expm.shared_taylor_propagators(q[f], t[:, f], depth).numpy(),
                                   rtol=0, atol=1e-13)
        spectral = expm.spectral_propagators(left[f], lam[f], right[f], t[:, f])
        np.testing.assert_allclose(ours[:, f].numpy(), spectral.numpy(), rtol=0, atol=1e-10)
        for c in range(2):
            np.testing.assert_allclose(ours[c, f].numpy(),
                                       sla.expm(q[f].numpy() * float(t[c, f])), rtol=0, atol=1e-10)
    # the JAX package's vmap over families, at every family's own times
    # (within its default depth: the first family's long time left out)
    ref = jax.vmap(jexpm.shared_taylor_propagators)(jnp.asarray(q.numpy()),
                                                    jnp.asarray(t.numpy().T))   # [F, 2, S, S]
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref)[:, 0], rtol=0, atol=1e-10)
    np.testing.assert_allclose(ours[1, 1:].numpy(), np.asarray(ref)[1:, 1], rtol=0, atol=1e-10)
    # one time per family; fp32 against fp64
    np.testing.assert_array_equal(expm.taylor_propagators_batched(q, t[0]).numpy(),
                                  ours[0].numpy())
    # fp32: the per-family route's arithmetic (1e-6), and fp64's within the
    # ladder's amplification of fp32 round-off at ||Q t|| up to ~200 (1e-4)
    q32, t32 = q[1:].float(), t[:, 1:].float()
    ours32 = expm.taylor_propagators_batched(q32, t32)
    for f in range(q32.shape[0]):
        depth = expm.ladder_depth(q32[f], t32[:, f], 11, radius=2.0)
        np.testing.assert_allclose(
            ours32[:, f].numpy(), expm.shared_taylor_propagators(q32[f], t32[:, f], depth).numpy(),
            rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours32.double().numpy(), ours[:, 1:].numpy(), rtol=0, atol=1e-4)
    # a generator past fp32's range: non-finite propagators, no exception
    big = q[:2].float() * 1e38
    assert not torch.isfinite(expm.taylor_propagators_batched(big, t[0, :2].float())).all()


def test_per_branch_route_matches_the_group_loop_and_spectral(fixture, monkeypatch):
    """The general-descriptive value on the per-branch Taylor route (all
    B*K families in one batched call) equals the per-group loop's (1e-12
    relative) and the spectral route's (1e-9)."""
    b = fixture["tree"].n_branches
    _, engine = _engines(fixture, np.arange(b, dtype=np.int32))
    loglik = relax.general_descriptive_objective(engine, K)
    params = params_from_numpy(_point(fixture["tree"]), "cpu")
    with torch.no_grad():
        spectral = float(loglik(params))
        engine.spectral = False
        assert engine._batched(params["t"][None])
        batched = float(loglik(params))
        monkeypatch.setattr(bsrel, "BATCHED_TIMES_PER_GROUP", 0)
        loop = float(loglik(params))
    assert abs(batched - loop) <= 1e-12 * abs(loop)
    assert abs(batched - spectral) <= 1e-9 * abs(spectral)


def test_fp32_power_past_the_range_is_non_finite(fixture, monkeypatch):
    """omega_3^K at omega 1e4, K 50 passes fp32's range: the fp32
    alternative gives a non-finite value (which ``maximize_jax`` treats as a
    failed step), not an exception; at K 1 it is finite."""
    monkeypatch.setenv("HYPHY_TPU_PRECISION", "float32")
    _, engine = _engines(fixture, _classic_groups(fixture["tree"]))
    assert engine.dtype == torch.float32
    loglik = relax.alternative_objective(engine, K, True)
    point = dict(_point(fixture["tree"]), ref_omega_3=1e4, K=50.0)
    with torch.no_grad():
        assert not np.isfinite(float(loglik(params_from_numpy(point, "cpu"))))
        point["K"] = 1.0
        assert np.isfinite(float(loglik(params_from_numpy(point, "cpu"))))


def test_alternative_refit_from_the_null(fixture):
    """An alternative that ends below its null is refit from the null's
    MLE, which it holds at K = 1 (ROADMAP 3.16): here the "alternative" is
    an unfitted point, so the null fit from it climbs above it."""
    _, engine = _engines(fixture, _classic_groups(fixture["tree"]))
    loglik = relax.alternative_objective(engine, K, True)
    specs = dict(MG94Base.theta_specs())
    specs.update(relax._omega_specs("ref", K))
    specs.update(relax._weight_specs("ref", K))
    specs.update(relax._omega_specs("unc", K))
    specs["K"] = relax.ParamSpec(init=1.0, lower=0.0, upper=50.0)
    specs["t"] = relax.ParamSpec(init=0.1, lower=0.0, upper=1e4,
                                 shape=(fixture["tree"].n_branches,))
    start = params_from_numpy({k: v for k, v in _point(fixture["tree"]).items() if k in specs},
                              "cpu")
    with torch.no_grad():
        start_lnl = float(loglik(start))
    one = torch.tensor(1.0, dtype=torch.float64)
    null_params, null_lnl, alt_params, alt_lnl = relax.fit_null(
        loglik, specs, start, start_lnl, {"K": one}, 1e-2)
    assert null_lnl > start_lnl
    assert alt_lnl >= null_lnl - 1e-6
    with torch.no_grad():
        assert float(loglik(alt_params)) == pytest.approx(alt_lnl, rel=1e-12)
    assert float(null_params["K"]) == 1.0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """RELAX --models Minimal and group mode in both packages, with the JAX
    runs' alternative MLEs (the JAX fit whose specs hold K and whose value
    is the reported alternative lnL), and the JAX package's null
    (``relax.py:251-261``: its alternative objective with every K := 1,
    through its ``maximize``) fitted from the port's alternative MLE."""
    fasta, newick = _simulated(tmp_path_factory.mktemp("relax_run"), RUN_TAXA, RUN_CODONS, 2)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        mp.setenv("HYPHY_TPU_MESH", "off")
        mp.setattr(settings, "device", "cpu")
        fits, original = [], jrelax.maximize

        def spy(objective, specs, init, **kwargs):
            params, value, it = original(objective, specs, init, **kwargs)
            fits.append(({k: np.asarray(v) for k, v in params.items()}, float(value), objective,
                         specs))
            return params, value, it

        mp.setattr(jrelax, "maximize", spy)
        minimal = dict(tree=newick, test="FG", reference="REF", models="Minimal", **RUN_OPTIONS)
        groups = dict(tree=newick, reference="Unlabeled", groups=["FG", "REF", "Unlabeled"],
                      **RUN_OPTIONS)
        for name, options in (("minimal", minimal), ("groups", groups)):
            fits.clear()
            ours = relax.run(fasta, device="cpu", **options)
            ref = jrelax.run(fasta, **options)
            alt_lnl = ref.fits["RELAX alternative"]
            jalt, jobjective, jspecs = next((p, o, sp) for p, v, o, sp in fits
                                            if v == alt_lnl and any(k.startswith("K") for k in p))
            k_names = [k for k in jspecs if k.startswith("K")]

            def jnull(free, objective=jobjective, k_names=k_names):
                return objective(dict(free, **{k: jnp.asarray(1.0) for k in k_names}))

            start = {k: jnp.asarray(v.detach().numpy())
                     for k, v in ours.models["alternative"][2].items() if k not in k_names}
            _, jnull_lnl, _ = original(jnull, {k: v for k, v in jspecs.items() if k not in k_names},
                                       start, precision=RUN_OPTIONS["precision"])
            out[name] = (ours, ref, jalt, float(jnull_lnl))
    return out


@pytest.mark.parametrize("mode", ["minimal", "groups"])
def test_run_matches_jax(runs, mode):
    """The MG94 and alternative fits within 0.15 of the JAX package's.  Each
    package's null starts from its own alternative MLE with K := 1: on this
    fixture the two alternatives end 5e-5 lnL apart (K 0.031 and 0.033) and
    the Minimal nulls in different optima 0.165 apart (ROADMAP 3.18).  So
    the nulls are held from a common start, in both directions: the port's
    null refit from the JAX run's alternative MLE no worse than the JAX
    null by 0.15, with its LRT calling as the JAX run does; and the JAX
    package's null fitted from the port's alternative MLE as close to the
    port's own null as NULL_FROM_THE_PORTS_START says, its LRT as close to
    the port's LRT, and calling as the port's run does."""
    ours, ref, jalt, jnull_from_ours = runs[mode]
    mg = "MG94xREV with separate rates for branch sets"
    assert abs(ours.fits[mg] - ref.fits[mg]) <= 0.15
    assert ours.fits["RELAX alternative"] >= ref.fits["RELAX alternative"] - 0.15
    assert ours.fits["RELAX alternative"] >= ours.fits["RELAX null"] - 1e-6
    loglik, specs, _ = ours.models["alternative"]
    start = params_from_numpy(jalt, "cpu")
    k_names = [k for k in specs if k.startswith("K")]
    fixed = {k: torch.tensor(1.0, dtype=torch.float64) for k in k_names}
    with torch.no_grad():
        assert float(loglik(start)) == pytest.approx(ref.fits["RELAX alternative"], rel=1e-9)
    _, null_lnl, _, alt_lnl = relax.fit_null(loglik, specs, start, ref.fits["RELAX alternative"],
                                             fixed, RUN_OPTIONS["precision"])
    assert null_lnl >= ref.fits["RELAX null"] - 0.15
    lrt = max(2.0 * (max(alt_lnl, ours.fits["RELAX alternative"]) - null_lnl), 0.0)
    p = relax.common.chi2_sf(lrt, len(k_names))
    assert (p <= 0.05) == (ref.p_value <= 0.05)
    tol = NULL_FROM_THE_PORTS_START[mode]
    assert abs(jnull_from_ours - ours.fits["RELAX null"]) <= tol
    lrt = max(2.0 * (ours.fits["RELAX alternative"] - jnull_from_ours), 0.0)
    assert abs(ours.lrt - lrt) <= 2 * tol
    assert ours.p_value == pytest.approx(relax.common.chi2_sf(ours.lrt, len(k_names)), rel=1e-12)
    assert (ours.p_value <= 0.05) == (relax.common.chi2_sf(lrt, len(k_names)) <= 0.05)
    assert sorted(ours.json) == sorted(ref.json)
    tr, jtr = ours.json["test results"], ref.json["test results"]
    assert sorted(tr) == sorted(jtr)
    if mode == "groups":
        assert tr["degrees of freedom"] == jtr["degrees of freedom"] == 2
        assert sorted(tr["relaxation or intensification parameter"]) == ["FG", "REF"]
    dists = ours.json["fits"]["RELAX alternative"]["Rate Distributions"]
    assert sorted(dists) == sorted(ref.json["fits"]["RELAX alternative"]["Rate Distributions"])
