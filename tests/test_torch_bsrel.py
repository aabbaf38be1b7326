"""The port's BS-REL engine (``models/bsrel.py``) against the JAX
package's at fixed parameter points, on the 6-taxon x 40-codon fixture of
``tests/test_bustedph_efilter.py``: site lnLs and totals for synonymous
rate variation on and off, K = 2 and 3, two branch groups, the error-sink
class, the Double+Triple multi-hit bases and branch-site SRV; the fp64
Taylor propagators against the spectral ones; the gradient of the
folded-class mixture lnL; the branch-pinned site lnLs and class
posteriors.  Branch lengths are 0.3-0.9 so that the fp64 spectral route is
well conditioned (ROADMAP 3.5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyphy_tpu.data.alignment import read_alignment as jread
from hyphy_tpu.data.filter import DataFilter as JFilter
from hyphy_tpu.data.genetic_code import GeneticCode as JCode
from hyphy_tpu.models import frequencies as jfreq
from hyphy_tpu.models.bsrel import BSRELEngine as JEngine
from hyphy_tpu.models.codon import MG94Base as JMG94
from hyphy_tpu.ops import pruning as jpruning
from hyphy_tpu.tree.topology import Tree as JTree
from hyphy_tpu.utils.synth import random_tree_newick, synthetic_codon_alignment
from hyphy_tpu_torch.data.alignment import read_alignment
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.data.genetic_code import GeneticCode
from hyphy_tpu_torch.models import bsrel
from hyphy_tpu_torch.models.bsrel import BSRELEngine, omega_distribution, srv_distribution
from hyphy_tpu_torch.models.codon import MG94Base
from hyphy_tpu_torch.models.parameters import stick_breaking_weights
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.tree.topology import Tree

torch.set_num_threads(2)

THETAS = {"theta_AC": 0.5, "theta_AT": 0.3, "theta_CG": 0.8, "theta_CT": 2.0, "theta_GT": 0.4}
# name -> (srv classes, omegas [G, K], weights [G, K], multiple hits)
CASES = {
    "srv3-k3-two-groups": (3, [[0.2, 1.0, 3.0], [0.1, 0.5, 1.5]],
                           [[0.6, 0.3, 0.1], [0.5, 0.4, 0.1]], False),
    "nosrv-k2": (1, [[0.3, 2.5]], [[0.8, 0.2]], False),
    "srv2-error-sink": (2, [[150.0, 0.2, 0.9, 4.0]], [[0.005, 0.6, 0.3, 0.095]], False),
    "srv3-multihit": (3, [[0.2, 1.0, 3.0]], [[0.6, 0.3, 0.1]], True),
}
SRV = ([1.0, 0.7, 1.5], [0.3, 0.3, 0.4])
MH = {"delta": 0.1, "psi": 0.05}


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    aln = synthetic_codon_alignment(6, 40, seed=5)
    fa = tmp_path_factory.mktemp("bsrel") / "a.fasta"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    newick = random_tree_newick(6, seed=5)
    jgc = JCode("Universal")
    jfilt = JFilter.from_alignment(jread(str(fa)), "codon", genetic_code=jgc)
    jtree = JTree.from_newick(newick, leaf_order=jfilt.names)
    corners, codon_freqs = jfreq.f3x4(jfilt, jgc)
    gc = GeneticCode("Universal")
    filt = DataFilter.from_alignment(read_alignment(str(fa)), "codon", genetic_code=gc)
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    return dict(jgc=jgc, jfilt=jfilt, jtree=jtree, gc=gc, filt=filt, tree=tree,
                corners=np.asarray(corners), codon_freqs=np.asarray(codon_freqs),
                t=np.linspace(0.3, 0.9, tree.n_branches))


def _basis(model, mh):
    if not mh:
        return None

    def basis_fn(params):
        q1s, q1n = model.basis_matrices(params)
        q2s, q2n = model.multihit_basis_matrices(params, 2)
        q3s, q3n = model.multihit_basis_matrices(params, 3)
        return (q1s + params["delta"] * q2s + params["psi"] * q3s,
                q1n + params["delta"] * q2n + params["psi"] * q3n)

    return basis_fn


def _engines(fx, n_groups, srv_classes, mh):
    groups = np.zeros(fx["tree"].n_branches, dtype=np.int32)
    if n_groups == 2:
        groups[:3] = 1
    jmodel = JMG94(fx["jgc"], fx["corners"], fx["codon_freqs"])
    jengine = JEngine(jmodel, jpruning.build_pruning_data(fx["jtree"]),
                      jnp.asarray(fx["jfilt"].leaf_partials()), fx["jfilt"].pattern_weights,
                      groups, srv_classes, basis_fn=_basis(jmodel, mh), mesh=None)
    model = MG94Base(fx["gc"], fx["corners"], fx["codon_freqs"], device="cpu")
    engine = BSRELEngine(model, pruning.build_pruning_data(fx["tree"], "cpu"),
                         fx["filt"].leaf_partials(), fx["filt"].pattern_weights, groups,
                         srv_classes, basis_fn=_basis(model, mh))
    return jengine, engine


def _point(fx, case):
    c, omegas, weights, mh = CASES[case]
    point = dict(THETAS, omegas=np.array(omegas), weights=np.array(weights),
                 t=fx["t"], rates=np.array(SRV[0][:c]),
                 wsrv=np.array(SRV[1][:c]) / np.sum(SRV[1][:c]))
    if mh:
        point.update(MH)
    return point


def _call(engine, method, point, lib):
    """``engine.method(params, omegas, weights, t, rates[, wsrv])``."""
    conv = jnp.asarray if lib == "jax" else (lambda x: torch.tensor(np.asarray(x, np.float64)))
    params = {k: conv(v) for k, v in point.items()
              if k.startswith("theta") or k in ("delta", "psi", "t")}
    args = [params, conv(point["omegas"]), conv(point["weights"]), conv(point["t"]),
            conv(point["rates"])]
    if method != "class_site_log_likelihoods":
        args.append(conv(point["wsrv"]))
    out = getattr(engine, method)(*args)
    return np.asarray(out) if lib == "jax" else out.detach().numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_site_log_likelihoods_match_jax(fixture, case, monkeypatch):
    c, omegas, _, mh = CASES[case]
    jengine, engine = _engines(fixture, len(omegas), c, mh)
    point = _point(fixture, case)
    for method in ("site_log_likelihoods", "class_site_log_likelihoods", "loglik"):
        ref = _call(jengine, method, point, "jax")
        ours = _call(engine, method, point, "torch")
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=0)
    # fp64 Taylor propagators against the spectral ones, in both forms of
    # the Taylor route (batched per branch at this size; the per-group loop)
    spectral = _call(engine, "site_log_likelihoods", point, "torch")
    engine.spectral = False
    for per_group_times in (bsrel.BATCHED_TIMES_PER_GROUP, 0):
        monkeypatch.setattr(bsrel, "BATCHED_TIMES_PER_GROUP", per_group_times)
        np.testing.assert_allclose(_call(engine, "site_log_likelihoods", point, "torch"),
                                   spectral, rtol=1e-9, atol=0)


@pytest.mark.parametrize("srv_classes", [1, 3])
def test_branchsite_srv_matches_jax(fixture, srv_classes, monkeypatch):
    jengine, engine = _engines(fixture, 1, srv_classes, False)
    point = _point(fixture, "srv3-multihit" if srv_classes == 3 else "nosrv-k2")
    point["rates"], point["wsrv"] = point["rates"][:srv_classes], point["wsrv"][:srv_classes]
    point["wsrv"] = point["wsrv"] / point["wsrv"].sum()
    method = "branchsite_srv_site_log_likelihoods"
    ref = _call(jengine, method, point, "jax")
    np.testing.assert_allclose(_call(engine, method, point, "torch"), ref, rtol=1e-9, atol=0)
    engine.spectral = False
    for per_group_times in (bsrel.BATCHED_TIMES_PER_GROUP, 0):
        monkeypatch.setattr(bsrel, "BATCHED_TIMES_PER_GROUP", per_group_times)
        np.testing.assert_allclose(_call(engine, method, point, "torch"), ref, rtol=1e-9, atol=0)


def test_distributions_match_jax():
    from hyphy_tpu.models import bsrel as jbsrel

    params = {"test_omega_0": 150.0, "test_omega_1": 0.2, "test_omega_2": 0.7,
              "test_omega_3": 3.0, "test_w_0": 0.004, "test_w_1": 0.6, "test_w_2": 0.3,
              "srv_rate_1": 0.3, "srv_rate_2": 1.1, "srv_rate_3": 4.0, "srv_w_1": 0.5,
              "srv_w_2": 0.3}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v, dtype=torch.float64) for k, v in params.items()}
    for sink in (False, True):
        for a, b in zip(omega_distribution(tp, "test", 3, sink),
                        jbsrel.omega_distribution(jp, "test", 3, sink)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15, atol=0)
    for a, b in zip(srv_distribution(tp, 3), jbsrel.srv_distribution(jp, 3)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15, atol=0)
    w = stick_breaking_weights(torch.tensor([0.3, 0.5], dtype=torch.float64))
    np.testing.assert_allclose(w.numpy(), [0.3, 0.35, 0.35], rtol=1e-15)


def _named_point(fx):
    """BUSTED-style named parameters (SRV 3 x 3, one group)."""
    return dict(THETAS, test_omega_1=0.2, test_omega_2=0.8, test_omega_3=3.0, test_w_1=0.6,
                test_w_2=0.7, srv_rate_1=0.5, srv_rate_2=1.0, srv_rate_3=2.5, srv_w_1=0.4,
                srv_w_2=0.5, t=fx["t"])


def _mixture_lnl(engine, params, dist):
    omegas, weights = dist["omega"](params, "test", 3)
    rates, wsrv = dist["srv"](params, 3)
    return engine.loglik(params, omegas[None], weights[None], params["t"], rates, wsrv)


def test_gradient_matches_jax_and_finite_differences(fixture):
    """The gradient of the folded-class mixture lnL (K1's autograd function
    and the grid form's halving sums carry it) against ``jax.grad`` (1e-6
    relative) and central differences."""
    from hyphy_tpu.models import bsrel as jbsrel

    jengine, engine = _engines(fixture, 1, 3, False)
    point = _named_point(fixture)
    jgrad = jax.grad(lambda p: _mixture_lnl(jengine, p, {
        "omega": jbsrel.omega_distribution, "srv": jbsrel.srv_distribution}))(
        {k: jnp.asarray(v) for k, v in point.items()})
    params = {k: torch.tensor(np.asarray(v, np.float64), requires_grad=True)
              for k, v in point.items()}
    dist = {"omega": omega_distribution, "srv": srv_distribution}
    value = _mixture_lnl(engine, params, dist)
    value.backward()
    for k in point:
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(jgrad[k]), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    h = 1e-6
    with torch.no_grad():
        for k in ("test_omega_3", "srv_rate_2", "theta_CT"):
            up = {n: v.detach().clone() for n, v in params.items()}
            down = {n: v.detach().clone() for n, v in params.items()}
            up[k] += h
            down[k] -= h
            fd = (_mixture_lnl(engine, up, dist) - _mixture_lnl(engine, down, dist)) / (2 * h)
            assert abs(float(fd) - float(params[k].grad)) <= 1e-5 * max(1.0, abs(float(fd)))


@pytest.mark.parametrize("case", ["srv3-k3-two-groups", "srv2-error-sink"])
def test_branch_class_site_logliks_match_jax(fixture, case):
    """The branch-pinned site lnLs and the class posteriors (1e-9), and the
    identity behind them: a branch's pinned site lnLs, re-mixed with its
    group's weights, give the site lnL."""
    c, omegas, weights, _ = CASES[case]
    jengine, engine = _engines(fixture, len(omegas), c, False)
    point = _point(fixture, case)
    branches = np.arange(fixture["tree"].n_branches)
    conv = {"jax": jnp.asarray, "torch": lambda x: torch.tensor(np.asarray(x, np.float64))}
    args = {lib: [{k: f(v) for k, v in point.items() if k.startswith("theta") or k == "t"},
                  f(point["omegas"]), f(point["weights"]), f(point["t"]), f(point["rates"]),
                  f(point["wsrv"])] for lib, f in conv.items()}
    ref = np.asarray(jengine.branch_class_site_logliks(*args["jax"], fixture["jtree"].children,
                                                       branches))
    ours = engine.branch_class_site_logliks(*args["torch"], branches)
    assert ours.shape == ref.shape == (len(branches), len(omegas[0]), fixture["filt"].n_patterns)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-9, atol=0)
    post = BSRELEngine.class_posteriors(ours, args["torch"][2][0]).numpy()
    jpost = np.asarray(JEngine.class_posteriors(jnp.asarray(ref), args["jax"][2][0]))
    np.testing.assert_allclose(post, jpost, rtol=0, atol=1e-9)
    np.testing.assert_allclose(post.sum(axis=1), 1.0, atol=1e-12)
    sll = _call(engine, "site_log_likelihoods", point, "torch")
    gob = engine.group_of_branch.numpy()
    logw = np.log(np.asarray(weights))[gob]                          # [B, K]
    remixed = np.logaddexp.reduce(ours.numpy() + logw[:, :, None], axis=1)
    np.testing.assert_allclose(remixed, np.broadcast_to(sll, remixed.shape), rtol=1e-12, atol=0)


def test_huge_srv_times_reach_the_stationary_limit(fixture):
    """A synonymous-rate class of weight w normalises to a rate up to 1/w,
    so the fits probe times of 1e15 and more, where the spectral route's
    zero-mode round-off gave garbage (ROADMAP 3.15): the class-mixed
    propagators at t = 1e16 are the stationary rows, and the site lnLs of a
    point with such a class (omega_3 = 1e4) are finite, below 0 and equal
    to the fp64 Taylor route's (1e-9 relative)."""
    _, engine = _engines(fixture, 1, 3, False)
    point = _point(fixture, "srv3-multihit")
    point.update(omegas=np.array([[0.2, 1.0, 1e4]]), rates=np.array([1e16, 1.0, 1.0]),
                 wsrv=np.array([1e-12, 0.5, 0.5 - 1e-12]))
    params = {k: torch.tensor(np.asarray(point[k], np.float64)) for k in THETAS}
    times = torch.full((1, fixture["tree"].n_branches), 1e16, dtype=torch.float64)
    p = engine.mixture_propagators(params, torch.tensor(point["omegas"]),
                                   torch.tensor([[0.6, 0.3, 0.1]], dtype=torch.float64), times)
    np.testing.assert_allclose(p.numpy(), np.broadcast_to(fixture["codon_freqs"], p.shape),
                               rtol=0, atol=1e-12)
    spectral = _call(engine, "site_log_likelihoods", point, "torch")
    assert np.isfinite(spectral).all() and (spectral < 0).all()
    engine.spectral = False
    np.testing.assert_allclose(_call(engine, "site_log_likelihoods", point, "torch"), spectral,
                               rtol=1e-9, atol=0)
