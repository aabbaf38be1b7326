"""The port's per-site pieces against the JAX package on identical inputs:
``taylor_action_factors``, the two per-site pruning routes (Taylor vector
action and spectral) batched over sites, ``grid_best_starts`` and the
batched Nelder-Mead.  The JAX side runs its per-site functions under
``vmap``, as ``hyphy_tpu/methods/fel.py`` does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyphy_tpu.data.filter import DataFilter as JDataFilter
from hyphy_tpu.models.parameters import ParamSpec as JParamSpec
from hyphy_tpu.ops import expm as jexpm
from hyphy_tpu.ops import pruning as jpruning
from hyphy_tpu.optimize import batched as jbatched
from hyphy_tpu.optimize import nelder_mead as jnm
from hyphy_tpu.tree.topology import Tree as JTree
from hyphy_tpu.utils.synth import random_tree_newick, synthetic_codon_alignment
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.models.parameters import ParamSpec
from hyphy_tpu_torch.ops import expm, pruning
from hyphy_tpu_torch.optimize import batched, nelder_mead
from hyphy_tpu_torch.tree.topology import Tree

torch.set_num_threads(2)

N_TAXA, N_CODONS, SEED = 6, 20, 11
DTYPES = {"float64": (torch.float64, jnp.float64), "float32": (torch.float32, jnp.float32)}
# the fixture's random binary tree; one with a trifurcation beside a
# bifurcation (padded child slots gather the scratch row); and a nine-leaf
# polytomy beside cherries, whose level the port splits by arity
TREES = {
    "binary": random_tree_newick(N_TAXA, seed=SEED),
    "polytomy": "((t0:0.1,t1:0.2,t2:0.05):0.05,(t3:0.1,t4:0.002):0.1,t5:0.3)",
    "wide": ("((t0:0.1,t1:0.2,t2:0.05,t3:0.1,t4:0.02,t5:0.3,t6:0.1,t7:0.05,t8:0.2):0.05,"
             "(t9:0.1,t10:0.2):0.1,(t11:0.05,t12:0.1):0.2,(t13:0.3,t14:0.01):0.1,t15:0.2)"),
}


def _generators(rng, shape, pi, scale):
    """Reversible generators ``[*shape, S, S]`` with stationary ``pi``:
    random exchangeabilities, each generator scaled by its own factor."""
    s = pi.shape[0]
    ex = rng.uniform(0.1, 1.0, size=shape + (s, s))
    ex = (ex + np.swapaxes(ex, -1, -2)) / 2
    q = ex * pi * rng.uniform(*scale, size=shape + (1, 1))
    q[..., np.arange(s), np.arange(s)] = 0.0
    q[..., np.arange(s), np.arange(s)] = -q.sum(-1)
    return q


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_taylor_action_factors_match(name):
    tdt, jdt = DTYPES[name]
    rng = np.random.default_rng(3)
    pi = rng.dirichlet(np.ones(61))
    q = _generators(rng, (3, 2), pi, (0.2, 40.0))
    # branch times from 1e-3 up, and one past the ladder's saturation
    t = np.concatenate([np.exp(rng.uniform(np.log(1e-3), np.log(5.0), 7)), [1e4]])
    ours = expm.taylor_action_factors(torch.tensor(q, dtype=tdt), torch.tensor(t, dtype=tdt))
    ref = jax.vmap(lambda qq: jexpm.taylor_action_factors(qq, jnp.asarray(t, jdt)))(
        jnp.asarray(q.reshape(6, 61, 61), jdt))
    assert expm.taylor_action_terms(tdt) == jexpm.taylor_action_terms(jdt)
    tol = dict(rtol=1e-12, atol=0) if name == "float64" else dict(rtol=1e-5, atol=1e-7)
    for what, a, b in zip(("qn", "m2p", "r"), ours[:3], ref[:3]):
        np.testing.assert_allclose(a.reshape(b.shape).numpy(), np.asarray(b), err_msg=what, **tol)
    assert ours[3].dtype == torch.int32
    np.testing.assert_array_equal(ours[3].reshape(6, -1).numpy(), np.asarray(ref[3]))
    assert int(ours[3].max()) == 2 ** 12 - 1      # the saturated time


@pytest.fixture(scope="module", params=sorted(TREES))
def site_problem(request):
    """Leaf partials of the fixture's first 8 codon patterns, per-site
    generators for two branch groups, and both packages' schedules."""
    newick = TREES[request.param]
    aln = synthetic_codon_alignment(newick.count("t"), N_CODONS, seed=SEED)
    filt = JDataFilter.from_alignment(aln, "codon")
    jtree = JTree.from_newick(newick, leaf_order=filt.names)
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    rng = np.random.default_rng(5)
    pi = rng.dirichlet(np.ones(filt.n_states) * 5)
    n_sites = 8
    groups = np.where(np.arange(tree.n_branches) < 3, 0, 1).astype(np.int32)
    return dict(
        leaves=np.swapaxes(filt.leaf_partials()[:, :n_sites], 0, 1).astype(np.float64),
        q=_generators(rng, (n_sites, 2), pi, (0.3, 3.0)), pi=pi,
        times=np.maximum(np.abs(tree.input_lengths[:-1]), 1e-3), groups=groups,
        jdata=jpruning.build_pruning_data(jtree),
        tdata=pruning.build_pruning_data(tree, "cpu"),
    )


def _jax_taylor(pr, n_groups, jdt):
    times = jnp.asarray(pr["times"], jdt)
    gob = jnp.asarray(pr["groups"] if n_groups == 2 else np.zeros_like(pr["groups"]))
    terms = jexpm.taylor_action_terms(jdt)
    rows = jnp.arange(times.shape[0])

    def one(q, leaves):
        qn, m2p, r, j = jax.vmap(lambda m: jexpm.taylor_action_factors(m, times))(q)
        r_b, j_b = (r[gob, rows], j[gob, rows]) if n_groups == 2 else (r[0], j[0])
        return jpruning.single_site_log_likelihood_taylor(
            qn, m2p, r_b, j_b, gob, terms, leaves, jnp.asarray(pr["pi"], jdt), pr["jdata"])

    return np.asarray(jax.vmap(one)(jnp.asarray(pr["q"][:, :n_groups], jdt),
                                    jnp.asarray(pr["leaves"], jdt)))


def _jax_spectral(pr, n_groups):
    pi = jnp.asarray(pr["pi"])
    times = jnp.asarray(pr["times"])
    gob = jnp.asarray(pr["groups"])

    def one(q, leaves):
        left, lam, right = jexpm.reversible_spectral(q, pi)
        if n_groups == 2:
            return jpruning.single_site_log_likelihood_spectral(
                left[gob], lam[gob], right[gob], times, leaves, pi, pr["jdata"])
        return jpruning.single_site_log_likelihood_spectral(
            left[0], lam[0], right[0], times, leaves, pi, pr["jdata"])

    return np.asarray(jax.vmap(one)(jnp.asarray(pr["q"][:, :n_groups]),
                                    jnp.asarray(pr["leaves"])))


def _groups(pr, n_groups):
    return torch.as_tensor(pr["groups"] if n_groups == 2 else np.zeros_like(pr["groups"]))


def _torch_taylor(pr, n_groups, tdt):
    times = torch.tensor(pr["times"], dtype=tdt)
    gob = _groups(pr, n_groups).long()
    qn, m2p, r, j = expm.taylor_action_factors(
        torch.tensor(pr["q"][:, :n_groups], dtype=tdt), times)
    rows = torch.arange(times.shape[0])
    r, j = r[:, gob, rows], j[:, gob, rows]
    return pruning.single_site_log_likelihood_taylor(
        qn, m2p, r, j, gob, expm.taylor_action_terms(tdt),
        torch.tensor(pr["leaves"], dtype=tdt), torch.tensor(pr["pi"], dtype=tdt),
        pr["tdata"]).numpy()


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_taylor_route_matches(site_problem, n_groups, name):
    tdt, jdt = DTYPES[name]
    ours = _torch_taylor(site_problem, n_groups, tdt)
    assert ours.dtype == np.dtype(name) and ours.shape == (8,)
    ref = _jax_taylor(site_problem, n_groups, jdt)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-10 if name == "float64" else 1e-4)


@pytest.mark.parametrize("n_groups", [1, 2])
def test_spectral_route_matches(site_problem, n_groups):
    pr = site_problem
    left, lam, right = expm.reversible_spectral(
        torch.tensor(pr["q"][:, :n_groups]), torch.tensor(pr["pi"]))
    ours = pruning.single_site_log_likelihood_spectral(
        left, lam, right, torch.tensor(pr["times"]), _groups(pr, n_groups),
        torch.tensor(pr["leaves"]), torch.tensor(pr["pi"]), pr["tdata"]).numpy()
    np.testing.assert_allclose(ours, _jax_spectral(pr, n_groups), rtol=0, atol=1e-10)
    # both routes are the same likelihood in fp64
    np.testing.assert_allclose(ours, _torch_taylor(pr, n_groups, torch.float64),
                               rtol=0, atol=1e-8)


# -- optimizers ---------------------------------------------------------------
# A smooth bounded objective per item, written in both frameworks: a
# quadratic bowl in log-parameter space with an item-specific centre and a
# cross term, maximised inside [0, 10000].

_KEYS = ("alpha", "beta_nuisance", "beta_test")


def _centres(n_items):
    rng = np.random.default_rng(17)
    return rng.uniform(np.log(0.05), np.log(20.0), size=(n_items, len(_KEYS)))


def _bowl(xp, c, logs):
    d = [lg - c[..., i] for i, lg in enumerate(logs)]
    return -(d[0] ** 2 + 2.0 * d[1] ** 2 + 0.5 * d[2] ** 2 + 0.6 * d[0] * d[2]) - 3.0


def _jax_objective(centres):
    c = jnp.asarray(centres)
    return lambda i, p: _bowl(jnp, c[i], [jnp.log(p[k]) for k in _KEYS])


def _torch_objective(centres, counter=None):
    c = torch.tensor(centres)

    def objective(idx, p):
        if counter is not None:
            counter.append(idx.shape[0])
        return _bowl(torch, c[idx], [torch.log(p[k]) for k in _KEYS])

    return objective


def _grid():
    g = np.array([(0.01, 0.1), (1.0, 0.1), (1.0, 5.0), (10.0, 0.5), (10.0, 50.0), (100.0, 1.0)])
    return {"alpha": g[:, 0], "beta_test": g[:, 1], "beta_nuisance": g[:, 1][::-1].copy()}


def test_grid_best_starts_match():
    centres = _centres(16)
    grid = _grid()
    ours, values = batched.grid_best_starts(
        _torch_objective(centres), {k: torch.tensor(v) for k, v in grid.items()}, 16)
    ref, ref_values = jbatched.grid_best_starts(
        _jax_objective(centres), {k: jnp.asarray(v) for k, v in grid.items()}, 16)
    np.testing.assert_allclose(values.numpy(), np.asarray(ref_values), rtol=1e-14)
    for k in grid:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


def test_grid_first_maximum_wins():
    grid = {"alpha": torch.tensor([1.0, 2.0, 3.0, 4.0])}
    flat = {0: [0.0, 5.0, 5.0, 1.0], 1: [2.0, 2.0, 2.0, 2.0]}

    def objective(idx, p):
        pos = (p["alpha"] - 1.0).long()
        return torch.tensor([flat[int(i)][int(g)] for i, g in zip(idx, pos)])

    starts, _ = batched.grid_best_starts(objective, grid, 2)
    np.testing.assert_array_equal(starts["alpha"].numpy(), [2.0, 1.0])


def _specs(pkg):
    return {k: pkg(init=1.0, lower=0.0, upper=10000.0) for k in _KEYS}


def test_vmapped_nelder_mead_matches():
    n_items = 16
    centres = _centres(n_items)
    grid = _grid()
    starts, _ = batched.grid_best_starts(
        _torch_objective(centres), {k: torch.tensor(v) for k, v in grid.items()}, n_items)
    params, values = nelder_mead.vmapped_nelder_mead(
        _torch_objective(centres), _specs(ParamSpec), starts, n_items)
    jstarts, _ = jbatched.grid_best_starts(
        _jax_objective(centres), {k: jnp.asarray(v) for k, v in grid.items()}, n_items)
    jparams, jvalues = jnm.vmapped_nelder_mead(
        _jax_objective(centres), _specs(JParamSpec), jstarts, n_items)
    np.testing.assert_allclose(values.numpy(), np.asarray(jvalues), rtol=0, atol=1e-8)
    for k in _KEYS:
        assert params[k].dtype == torch.float64
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]),
                                   rtol=1e-8, atol=0, err_msg=k)
    # every item converged near its centre (the bowl's maximum is -3)
    assert (values.numpy() > -3.0 - 1e-4).all()


def test_nelder_mead_single_matches():
    centres = _centres(1)[0]
    init = {"alpha": 0.3, "beta_nuisance": 2.0, "beta_test": 7.0}
    ours, value = nelder_mead.nelder_mead(
        lambda p: _bowl(torch, torch.tensor(centres), [torch.log(p[k]) for k in _KEYS]),
        _specs(ParamSpec), {k: torch.tensor(v, dtype=torch.float64) for k, v in init.items()})
    ref, ref_value = jnm.nelder_mead(
        lambda p: _bowl(jnp, jnp.asarray(centres), [jnp.log(p[k]) for k in _KEYS]),
        _specs(JParamSpec), {k: jnp.asarray(v) for k, v in init.items()})
    assert abs(float(value) - float(ref_value)) <= 1e-8
    for k in _KEYS:
        assert abs(float(ours[k]) - float(ref[k])) <= 1e-8 * float(ref[k])


def test_nelder_mead_warmup_caps_iterations(monkeypatch):
    """Under ``settings.warmup`` the loop stops after 32 iterations: n + 1
    initial evaluations, then three per iteration."""
    centres = _centres(4)
    starts = {k: torch.full((4,), 5000.0) for k in _KEYS}
    for warmup, expect in ((True, 4 + 3 * 32), (False, None)):
        monkeypatch.setattr(settings, "warmup", warmup)
        calls = []
        nelder_mead.vmapped_nelder_mead(
            _torch_objective(centres, calls), _specs(ParamSpec), starts, 4)
        if expect is not None:
            assert len(calls) == expect
        else:
            assert len(calls) > 4 + 3 * 32


def test_routes_on_a_star_tree_do_not_underflow():
    """A 200-leaf star (as collapsing zero-length branches leaves of a tree
    fitted to star-like data): the port's fp32 Taylor route stays near its
    fp64 route, and both fp64 routes match the reference's, which is in
    range there."""
    n, n_sites = 200, 6
    aln = synthetic_codon_alignment(n, N_CODONS, seed=SEED)
    filt = JDataFilter.from_alignment(aln, "codon")
    newick = "(" + ",".join(f"t{i}:0.1" for i in range(n)) + ")"
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    rng = np.random.default_rng(8)
    pi = rng.dirichlet(np.ones(filt.n_states) * 5)
    pr = dict(leaves=np.swapaxes(filt.leaf_partials()[:, :n_sites], 0, 1).astype(np.float64),
              q=_generators(rng, (n_sites, 2), pi, (0.3, 3.0)), pi=pi,
              times=np.full(tree.n_branches, 0.1), groups=np.zeros(tree.n_branches, np.int32),
              jdata=jpruning.build_pruning_data(JTree.from_newick(newick, leaf_order=filt.names)),
              tdata=pruning.build_pruning_data(tree, "cpu"))
    ours64 = _torch_taylor(pr, 1, torch.float64)
    np.testing.assert_allclose(ours64, _jax_taylor(pr, 1, jnp.float64), rtol=0, atol=1e-10)
    np.testing.assert_allclose(_torch_taylor(pr, 1, torch.float32), ours64, rtol=0, atol=1e-2)
    left, lam, right = expm.reversible_spectral(torch.tensor(pr["q"][:, :1]), torch.tensor(pi))
    spectral = pruning.single_site_log_likelihood_spectral(
        left, lam, right, torch.tensor(pr["times"]), _groups(pr, 1),
        torch.tensor(pr["leaves"]), torch.tensor(pi), pr["tdata"]).numpy()
    np.testing.assert_allclose(spectral, _jax_spectral(pr, 1), rtol=0, atol=1e-10)


# -- the fused four-probe body -------------------------------------------------

def test_fused_probes_equal_sequential():
    """The JAX package's fused body (all four probes in one 4N-item call)
    gives every item the decisions and values of the three sequential
    probes: bit for bit, in a quarter of the objective calls per iteration
    (plus the n + 1 calls of the initial simplex)."""
    n_items = 16
    centres = _centres(n_items)
    starts = {k: torch.full((n_items,), v) for k, v in zip(_KEYS, (0.3, 2.0, 7.0))}
    out = {}
    for fused in (False, True):
        calls = []
        out[fused] = nelder_mead.vmapped_nelder_mead(
            _torch_objective(centres, calls), _specs(ParamSpec), starts, n_items,
            max_iterations=40, fused=fused)
        assert set(calls[len(_KEYS) + 1:]) == {4 * n_items if fused else n_items}
        out[fused] += (len(calls) - len(_KEYS) - 1,)
    assert out[False][2] == 3 * out[True][2] == 3 * 40
    for k in _KEYS:
        assert torch.equal(out[True][0][k], out[False][0][k]), k
    assert torch.equal(out[True][1], out[False][1])


def test_fused_probes_on_a_site_objective(site_problem):
    """The same on a per-site Taylor-route objective, whose batch sets the
    ladder's trip count: the fused batch walks as many bits as its largest
    time needs, and the extra steps are no-ops for the others."""
    pr = site_problem
    times = torch.tensor(pr["times"])
    leaves = torch.tensor(pr["leaves"])
    q_syn = torch.tensor(pr["q"][:, 0])
    q_non = torch.tensor(pr["q"][:, 1])

    def objective(idx, p):
        from hyphy_tpu_torch.models.base import fill_diagonal_from_rows

        m = fill_diagonal_from_rows(p["alpha"][:, None, None] * q_syn[idx]
                                    + p["beta_test"][:, None, None] * q_non[idx])[:, None]
        qn, m2p, r, j = expm.taylor_action_factors(m, times)
        return pruning.single_site_log_likelihood_taylor(
            qn, m2p, r[:, 0], j[:, 0], torch.zeros(times.shape[0], dtype=torch.int64),
            expm.taylor_action_terms(torch.float64), leaves[idx], torch.tensor(pr["pi"]),
            pr["tdata"])

    specs = {k: ParamSpec(init=1.0, lower=0.0, upper=10000.0) for k in ("alpha", "beta_test")}
    starts = {"alpha": torch.full((8,), 0.5), "beta_test": torch.full((8,), 2.0)}
    seq = nelder_mead.vmapped_nelder_mead(objective, specs, starts, 8, max_iterations=12,
                                          fused=False)
    fused = nelder_mead.vmapped_nelder_mead(objective, specs, starts, 8, max_iterations=12,
                                            fused=True)
    for k in specs:
        np.testing.assert_array_equal(fused[0][k].numpy(), seq[0][k].numpy(), err_msg=k)
    np.testing.assert_array_equal(fused[1].numpy(), seq[1].numpy())


def test_fused_probes_opt_in(monkeypatch):
    """As in the JAX package: ``HYPHY_TPU_NM_FUSED=1``, and only off the CPU."""
    monkeypatch.delenv("HYPHY_TPU_NM_FUSED", raising=False)
    assert not nelder_mead.fused_probes("cuda")
    monkeypatch.setenv("HYPHY_TPU_NM_FUSED", "1")
    assert nelder_mead.fused_probes("cuda") and not nelder_mead.fused_probes("cpu")

