"""The port's PRIME against the JAX package's on a 6-taxon x 12-codon
fixture (``synthetic_codon_alignment(6, 12, seed=5)``).

* The per-site objective at fixed points, from the JAX run's MG94 fit
  carried across: the port's spectral route and its fp64 Taylor route
  against the JAX package's spectral route (its only route), built from
  ``hyphy_tpu/ops`` as ``prime.py:128-156`` builds it.
* ``prime.run`` end to end in both packages (one JAX run, shared through
  a module-scoped fixture)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import hyphy_tpu.methods.common as jcommon
from hyphy_tpu.methods import prime as jprime
from hyphy_tpu.models.base import fill_diagonal_from_rows as jfill
from hyphy_tpu.ops import expm as jexpm
from hyphy_tpu.ops import pruning as jpruning
from hyphy_tpu.utils import synth as jsynth
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.methods import common, prime
from hyphy_tpu_torch.models.base import fill_diagonal_from_rows
from hyphy_tpu_torch.ops import expm, pruning
from torch_carry import carried_mg94_fit

torch.set_num_threads(2)

N_TAXA, N_CODONS, SEED = 6, 12, 5
# (alpha, beta, lambdas): ordinary points, and |lambda| = 10 with the
# modifier at its e^9.2 cap on most non-synonymous pairs
POINTS = [
    (1.0, 0.5, [0.1] * 5),
    (0.3, 2.0, [-1.0, 0.5, 0.0, 2.0, -0.3]),
    (1.0, 1.0, [-10.0, 0.1, 0.1, 0.1, 0.1]),
    (2.0, 50.0, [-10.0, 0.1, 0.1, 0.1, 0.1]),
]
# per-property nulls that may stop apart (LRTs more than 0.05 apart): on
# flat null surfaces lambda runs to its +-10 bound and the two packages'
# Nelder-Mead simplexes stop at different points; the port's null may stop
# higher (a smaller LRT), never lower
MAX_APART_NULLS = 4


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")
    monkeypatch.setenv("HYPHY_TPU_MESH", "off")


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    aln = jsynth.synthetic_codon_alignment(N_TAXA, N_CODONS, seed=SEED)
    fa = tmp_path_factory.mktemp("prime") / "a.fasta"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    newick = jsynth.random_tree_newick(N_TAXA, seed=SEED)
    labelled = newick.replace("t0:", "t0{Foreground}:").replace("t1:", "t1{Foreground}:")
    return {"fasta": str(fa), "tree": newick, "labelled": labelled}


@pytest.fixture(scope="module")
def jax_run(fixture):
    """JAX ``prime.run`` with its MG94 fit captured."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        mp.setenv("HYPHY_TPU_MESH", "off")
        original = jcommon.fit_partitioned_mg94

        def spy(*args, **kwargs):
            seen["mg94"] = original(*args, **kwargs)
            return seen["mg94"]

        mp.setattr(jcommon, "fit_partitioned_mg94", spy)
        seen["result"] = jprime.run(fixture["fasta"], tree=fixture["tree"])
    return seen


def _jax_objective(jmg, jdata, dists, has_background):
    """The JAX package's per-site objective, as ``prime.py`` builds it."""
    q_syn, q_non = jmg.model.basis_matrices(jmg.params)
    freqs = jmg.model.frequencies
    leaves = jnp.asarray(jdata.codon_filter.leaf_partials())
    pdata = jpruning.build_pruning_data(jdata.tree)
    gob = jnp.asarray(np.where(jdata.tested_branches, 0, 1).astype(np.int32))
    alpha_hat = jnp.asarray(jmg.alphas)

    def site(i, alpha, beta, lams, beta_bg):
        mod = jnp.exp(jnp.clip(-(lams[:, None, None] * dists).sum(0), -23.0, 9.2))
        q_t = jfill(alpha * q_syn + beta * q_non * mod)
        if has_background:
            m = jnp.stack([q_t, jfill(alpha * q_syn + beta_bg * q_non)])
            left, lam_e, right = jexpm.reversible_spectral(m, freqs)
            return jpruning.single_site_log_likelihood_spectral(
                left[gob], lam_e[gob], right[gob], alpha_hat, leaves[:, i, :], freqs, pdata)
        left, lam_e, right = jexpm.reversible_spectral(q_t, freqs)
        return jpruning.single_site_log_likelihood_spectral(
            left, lam_e, right, alpha_hat, leaves[:, i, :], freqs, pdata)

    return jax.jit(jax.vmap(site, in_axes=(0, None, None, None, None)))


@pytest.mark.parametrize("background", [False, True])
def test_objective_matches_jax_spectral(fixture, jax_run, background):
    """Both routes of the port against the JAX spectral route at the JAX
    fit's MG94 point, 1e-9 on every pattern's lnL (the points keep the
    spectral route well conditioned; |lambda| = 10 included)."""
    newick = fixture["labelled"] if background else fixture["tree"]
    branches = "Foreground" if background else "All"
    jdata = jcommon.load_codon_data(fixture["fasta"], tree_newick=newick, branches=branches)
    data = common.load_codon_data(fixture["fasta"], tree_newick=newick, branches=branches)
    assert bool((~data.tested_branches).any()) == background
    mgp = carried_mg94_fit(jax_run["mg94"], data)
    dists_np = np.stack(prime.property_distance_tensors(data.genetic_code))
    ref_fn = _jax_objective(jax_run["mg94"], jdata, jnp.asarray(dists_np), background)
    dists = torch.as_tensor(dists_np)
    spectral = prime.site_log_likelihood(data, mgp, dists, torch.float64, spectral=True)
    taylor = prime.site_log_likelihood(data, mgp, dists, torch.float64, spectral=False)
    n = data.codon_filter.n_patterns
    idx = torch.arange(n)
    ones = torch.ones(5, dtype=torch.float64)
    for alpha, beta, lams in POINTS:
        ref = np.asarray(ref_fn(jnp.arange(n), alpha, beta, jnp.asarray(lams), 0.7))
        p = {"alpha": torch.full((n,), alpha, dtype=torch.float64),
             "beta": torch.full((n,), beta, dtype=torch.float64),
             "beta_bg": torch.full((n,), 0.7, dtype=torch.float64)}
        p.update({f"lambda_{k}": torch.full((n,), lams[k], dtype=torch.float64)
                  for k in range(5)})
        for route in (spectral, taylor):
            np.testing.assert_allclose(route(idx, p, ones).numpy(), ref, rtol=0, atol=1e-9)


def test_taylor_route_holds_where_the_spectral_route_does_not(fixture, jax_run):
    """At lambda = +10 the non-synonymous rates fall to e^-23 of beta: the
    eigendecomposition's round-off leaves the spectral route (the JAX
    package's) 1e-5 away from scipy's ``expm``, while the Taylor route
    (with the ladder as deep as the point needs) holds 1e-9 (ROADMAP
    3.5)."""
    data = common.load_codon_data(fixture["fasta"], tree_newick=fixture["tree"])
    mgp = carried_mg94_fit(jax_run["mg94"], data)
    dists = torch.as_tensor(np.stack(prime.property_distance_tensors(data.genetic_code)))
    lams = torch.tensor([10.0, 0.1, 0.1, 0.1, 0.1], dtype=torch.float64)
    q_syn, q_non = mgp.model.basis_matrices(mgp.params)
    mod = torch.exp(torch.clamp(-torch.einsum("p,pij->ij", lams, dists), -23.0, 9.2))
    q = fill_diagonal_from_rows(q_syn + q_non * mod).numpy()
    p_exact = torch.as_tensor(np.stack([sla.expm(q * t) for t in mgp.alphas]))
    exact = pruning.site_log_likelihoods(
        p_exact, torch.as_tensor(data.codon_filter.leaf_partials()), mgp.model.frequencies,
        pruning.build_pruning_data(data.tree, "cpu"))
    n = data.codon_filter.n_patterns
    p = {"alpha": torch.ones(n, dtype=torch.float64), "beta": torch.ones(n, dtype=torch.float64)}
    p.update({f"lambda_{k}": torch.full((n,), float(lams[k]), dtype=torch.float64)
              for k in range(5)})
    ones = torch.ones(5, dtype=torch.float64)
    taylor = prime.site_log_likelihood(data, mgp, dists, torch.float64, spectral=False)
    spectral = prime.site_log_likelihood(data, mgp, dists, torch.float64, spectral=True)
    assert float((taylor(torch.arange(n), p, ones) - exact).abs().max()) <= 1e-9
    assert float((spectral(torch.arange(n), p, ones) - exact).abs().max()) >= 1e-7


def test_ladder_depth_covers_the_largest_time():
    """The ladder deepens with ||Q t|| past its default and never
    saturates: j = floor(t_eff / radius) < 2^depth."""
    q = torch.zeros((1, 2, 3, 3), dtype=torch.float64)
    q[0, 1, 0, 1] = 5000.0
    times = torch.tensor([0.01, 3.0], dtype=torch.float64)
    depth = expm.ladder_depth(q, times, 12)
    assert depth == 15 and 3.0 * 2.0 ** 13 < 2.0 ** depth          # ||Q|| -> 2^13
    assert expm.ladder_depth(q, times, 11, radius=2.0) == 14
    assert expm.ladder_depth(q * 1e-3, times, 12) == 12
    # past the default depth, the shared-power propagators at the deeper
    # ladder match scipy's expm where the default one saturates
    gen = torch.tensor([[-900.0, 900.0, 0.0], [1.0, -2.0, 1.0], [0.0, 0.01, -0.01]],
                       dtype=torch.float64)
    t = torch.tensor([10.0], dtype=torch.float64)
    exact = sla.expm(gen.numpy() * 10.0)
    deep = expm.shared_taylor_propagators(gen, t, expm.ladder_depth(gen, t, 11, radius=2.0))
    np.testing.assert_allclose(deep[0].numpy(), exact, rtol=0, atol=1e-10)
    assert np.abs(expm.shared_taylor_propagators(gen, t)[0].numpy() - exact).max() > 1e-3


def test_run_matches_jax(fixture, jax_run):
    """``prime.run`` end to end: the same headers; the full fit's lnL,
    alpha and beta to the Nelder-Mead's tolerance; every per-property null
    lnL no lower than the JAX package's (LRT no larger than its + 0.05),
    and within 0.05 at all but MAX_APART_NULLS of the 60 nulls."""
    res = prime.run(fixture["fasta"], tree=fixture["tree"])
    jres = jax_run["result"]
    assert res.headers == jres.headers
    assert sorted(res.json) == sorted(jres.json)
    ours, ref = res.site_table, jres.site_table
    assert ours.shape == ref.shape == (N_CODONS, 18) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours[:, 2], ref[:, 2], rtol=0, atol=1e-3)
    for col in (0, 1):
        np.testing.assert_allclose(ours[:, col], ref[:, col], rtol=1e-3, atol=1e-3)
    lrt_cols = [4 + 3 * k for k in range(5)]
    lrt, ref_lrt = ours[:, lrt_cols], ref[:, lrt_cols]
    assert (lrt <= ref_lrt + 0.05).all()
    assert int((np.abs(lrt - ref_lrt) > 0.05).sum()) <= MAX_APART_NULLS
    p_vals = ours[:, [c + 1 for c in lrt_cols]]
    assert ((p_vals >= 0) & (p_vals <= 1)).all()
