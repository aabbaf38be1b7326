"""The port's MEME against the JAX package's.

* The two mixture routes on identical inputs: the Taylor vector action in
  its ``mix_weights`` mode and the spectral mixture, batched over sites in
  the port and ``vmap``-ed in the JAX package, on a binary tree, a
  trifurcation and a nine-child polytomy.
* The stick-breaking weights, and the branch EBFs of a few sites against
  forced mixture likelihoods computed with the JAX package's route.
* ``meme.run`` at K = 2 with the JAX run's GTR and MG94 fits carried
  across (``tests/test_torch_meme_options.py`` has K = 3 with background
  branches and multiple hits, and ``resample``).

The fixture is an alignment simulated along a 6-taxon tree with two sites
under omega = 8, shared by the tests of both files."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyphy_tpu.methods.common as jcommon
from hyphy_tpu.data.filter import DataFilter as JDataFilter
from hyphy_tpu.methods import meme as jmeme
from hyphy_tpu.models.base import fill_diagonal_from_rows as jfill
from hyphy_tpu.ops import expm as jexpm
from hyphy_tpu.ops import pruning as jpruning
from hyphy_tpu.tree.topology import Tree as JTree
from hyphy_tpu.utils import synth as jsynth
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.methods import meme
from hyphy_tpu_torch.ops import expm, pruning
from hyphy_tpu_torch.tree.topology import Tree
from torch_carry import carry_into, spy_fits

torch.set_num_threads(2)

N_TAXA, N_CODONS, SEED, PLANTED = 6, 16, 7, (2, 9)
TREES = {
    "binary": jsynth.random_tree_newick(N_TAXA, seed=11),
    "polytomy": "((t0:0.1,t1:0.2,t2:0.05):0.05,(t3:0.1,t4:0.002):0.1,t5:0.3)",
    "wide": ("((t0:0.1,t1:0.2,t2:0.05,t3:0.1,t4:0.02,t5:0.3,t6:0.1,t7:0.05,t8:0.2):0.05,"
             "(t9:0.1,t10:0.2):0.1,t11:0.2)"),
}
N_SITES, N_FAMILIES = 6, 3


def write_fixture(directory):
    """The planted alignment as FASTA; returns (path, newick)."""
    omegas = np.full(N_CODONS, 0.3)
    omegas[list(PLANTED)] = 8.0
    aln, newick = jsynth.simulated_codon_alignment(N_TAXA, N_CODONS, seed=SEED,
                                                   site_omegas=omegas, mean_branch=0.15)
    path = directory / "meme.fasta"
    path.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    return str(path), newick


def run_both(fasta, newick, **options):
    """The JAX package's ``meme.run`` and the port's with the JAX run's
    global fits carried across; both silent, the port on the CPU."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        spy_fits(jcommon, mp, seen)
        ref = jmeme.run(fasta, tree=newick, **options)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        mp.setattr(settings, "device", "cpu")
        carry_into(mp, seen)
        ours = meme.run(fasta, tree=newick, **options)
    return ours, ref


def assert_tables_match(ours, ref, k):
    """Site rows of both packages' MEME tables: the likelihoods, LRTs and
    p-values within 1e-5, the FEL rates within 1e-5 relative, the calls at
    p <= 0.1 equal; the mixture's rates and weights within 0.15 absolute,
    because at sites where a class is empty or beta+ ~ alpha the mixture is
    flat along them and the two Nelder-Mead runs stop at different points
    of equal likelihood."""
    headers = ref.json["MLE"]["headers"]
    assert ours.headers == headers
    a, b = ours.site_table, ref.site_table
    assert a.shape == b.shape == (N_CODONS, len(headers))
    names = [h[0] for h in headers]
    col = {name: i for i, name in enumerate(names)}
    for name in ("MEME LogL", "FEL LogL", "LRT MEME vs FEL", "LRT", "p-value"):
        np.testing.assert_allclose(a[:, col[name]], b[:, col[name]], rtol=0, atol=1e-5,
                                   err_msg=name)
    for name in ("FEL &alpha;", "FEL &beta;"):
        big = np.abs(b[:, col[name]]) > 1e-6
        np.testing.assert_allclose(a[big, col[name]], b[big, col[name]], rtol=1e-5, err_msg=name)
    p = col["p-value"]
    np.testing.assert_array_equal(a[:, p] <= 0.1, b[:, p] <= 0.1)
    mixture = [i for i, name in enumerate(names) if name.startswith(("&alpha;", "&beta;", "p<"))]
    assert len(mixture) == 2 * k + 1
    np.testing.assert_allclose(a[:, mixture], b[:, mixture], rtol=0, atol=0.15)
    return a[:, p] <= 0.1


# -- the mixture routes ------------------------------------------------------

def _generators(rng, shape, pi, scale):
    """Reversible generators ``[*shape, S, S]`` with stationary ``pi``."""
    s = pi.shape[0]
    ex = rng.uniform(0.1, 1.0, size=shape + (s, s))
    ex = (ex + np.swapaxes(ex, -1, -2)) / 2
    q = ex * pi * rng.uniform(*scale, size=shape + (1, 1))
    q[..., np.arange(s), np.arange(s)] = 0.0
    q[..., np.arange(s), np.arange(s)] = -q.sum(-1)
    return q


def _mixture_problem(name):
    """Leaf partials of 6 sites, 3 generator families per site and random
    per-site branch weights (two branches on one family each)."""
    newick = TREES[name]
    aln = jsynth.synthetic_codon_alignment(newick.count("t"), 20, seed=11)
    filt = JDataFilter.from_alignment(aln, "codon")
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    rng = np.random.default_rng(6)
    pi = rng.dirichlet(np.ones(filt.n_states) * 5)
    weights = rng.dirichlet(np.ones(N_FAMILIES), size=(N_SITES, tree.n_branches))
    weights[:, :2] = np.eye(N_FAMILIES)[[2, 0]]       # two branches on one family each
    return dict(
        leaves=np.swapaxes(filt.leaf_partials()[:, :N_SITES], 0, 1).astype(np.float64),
        q=_generators(rng, (N_SITES, N_FAMILIES), pi, (0.3, 30.0)), pi=pi, weights=weights,
        times=np.maximum(np.abs(tree.input_lengths[:-1]), 1e-3),
        jdata=jpruning.build_pruning_data(JTree.from_newick(newick, leaf_order=filt.names)),
        tdata=pruning.build_pruning_data(tree, "cpu"))


@pytest.fixture(scope="module", params=sorted(TREES))
def mixture_problem(request):
    return _mixture_problem(request.param)


def _torch_taylor_mixture(pr, tdt):
    qn, m2p, r, j = expm.taylor_action_factors(torch.tensor(pr["q"], dtype=tdt),
                                               torch.tensor(pr["times"], dtype=tdt))
    return pruning.single_site_log_likelihood_taylor(
        qn, m2p, r.transpose(1, 2), j.transpose(1, 2), None, expm.taylor_action_terms(tdt),
        torch.tensor(pr["leaves"], dtype=tdt), torch.tensor(pr["pi"], dtype=tdt), pr["tdata"],
        mix_weights=torch.tensor(pr["weights"], dtype=tdt)).numpy()


def _check_taylor_mixture(pr, name):
    tdt, jdt = (torch.float64, jnp.float64) if name == "float64" else (torch.float32, jnp.float32)
    times = jnp.asarray(pr["times"], jdt)
    n_b = times.shape[0]

    def one(q, leaves, w):
        qn, m2p, r, j = jax.vmap(lambda m: jexpm.taylor_action_factors(m, times))(q)
        return jpruning.single_site_log_likelihood_taylor(
            qn, m2p, r.T, j.T, jnp.zeros(n_b, jnp.int32), jexpm.taylor_action_terms(jdt),
            leaves, jnp.asarray(pr["pi"], jdt), pr["jdata"], mix_weights=w)

    ref = np.asarray(jax.vmap(one)(jnp.asarray(pr["q"], jdt), jnp.asarray(pr["leaves"], jdt),
                                   jnp.asarray(pr["weights"], jdt)))
    ours = _torch_taylor_mixture(pr, tdt)
    assert ours.dtype == np.dtype(name) and ours.shape == (N_SITES,)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-9 if name == "float64" else 1e-4)


def test_taylor_mixture_route_matches(mixture_problem):
    _check_taylor_mixture(mixture_problem, "float64")


def test_taylor_mixture_route_fp32_matches():
    _check_taylor_mixture(_mixture_problem("binary"), "float32")


def test_spectral_mixture_route_matches(mixture_problem):
    pr = mixture_problem
    pi, times = jnp.asarray(pr["pi"]), jnp.asarray(pr["times"])
    comp_index = jnp.tile(jnp.arange(N_FAMILIES, dtype=jnp.int32), (times.shape[0], 1))

    def one(q, leaves, w):
        left, lam, right = jexpm.reversible_spectral(q, pi)
        return jpruning.single_site_log_likelihood_spectral_mixture(
            left, lam, right, comp_index, w, times, leaves, pi, pr["jdata"])

    ref = np.asarray(jax.vmap(one)(jnp.asarray(pr["q"]), jnp.asarray(pr["leaves"]),
                                   jnp.asarray(pr["weights"])))
    left, lam, right = expm.reversible_spectral(torch.tensor(pr["q"]), torch.tensor(pr["pi"]))
    ours = pruning.single_site_log_likelihood_spectral_mixture(
        left, lam, right, torch.tensor(pr["weights"]), torch.tensor(pr["times"]),
        torch.tensor(pr["leaves"]), torch.tensor(pr["pi"]), pr["tdata"]).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-9)
    # both routes are the same likelihood in fp64
    np.testing.assert_allclose(ours, _torch_taylor_mixture(pr, torch.float64), rtol=0, atol=1e-8)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_stick_weights_match(k):
    ws = np.random.default_rng(k).uniform(size=(5, k - 1))
    ours = meme._stick_weights(torch.tensor(ws)).numpy()
    ref = np.stack([np.asarray(jmeme._stick_weights(jnp.asarray(w))) for w in ws])
    np.testing.assert_allclose(ours, ref, rtol=1e-15, atol=0)
    np.testing.assert_allclose(ours.sum(axis=1), 1.0, rtol=1e-14)


# -- the method ---------------------------------------------------------------

@pytest.fixture(scope="module")
def k2_runs(tmp_path_factory):
    fasta, newick = write_fixture(tmp_path_factory.mktemp("meme"))
    return run_both(fasta, newick, rate_classes=2)


def test_meme_k2_matches_with_carried_fits(k2_runs):
    ours, ref = k2_runs
    assert_tables_match(ours, ref, 2)
    assert ours.json["analysis settings"] == ref.json["analysis settings"]
    assert sorted(ours.json) == sorted(ref.json)


def test_branch_ebfs_match(k2_runs):
    """EBFs of four sites at chosen mixture points, against forced mixture
    likelihoods from the JAX package's spectral route (the JAX package's
    EBF stage is a closure of its ``run``)."""
    ours, ref = k2_runs
    data, mgp, jdata, jmg = ours.data, ours.mg94, ref.data, ref.mg94
    sites_idx = [0, 3, 7, 12]
    point = {"alpha": [0.5, 1.0, 2.0, 0.8], "omega_1": [0.1, 0.5, 0.0, 0.9],
             "w_1": [0.7, 0.4, 0.9, 0.5], "beta_plus": [3.0, 8.0, 1.5, 20.0]}
    tested = jdata.tested_branches
    tested_idx = np.nonzero(tested)[0]
    q_syn, q_non = jmg.model.basis_matrices(jmg.params)
    freqs = jmg.model.frequencies
    n_b = jdata.tree.n_branches
    comp_index = jnp.tile(jnp.arange(2, dtype=jnp.int32), (n_b, 1)).at[~tested].set(2)
    leaves = jnp.asarray(jdata.codon_filter.leaf_partials())
    schedule = jpruning.build_pruning_data(jdata.tree)

    @jax.jit
    def jax_lnl(site, a, omega, beta_plus, cw):
        m = jfill(jnp.stack([a * q_syn + b * q_non for b in (omega * a, beta_plus, 0.0 * a)]))
        left, lam, right = jexpm.reversible_spectral(m, freqs)
        cw = jnp.where(jnp.asarray(tested)[:, None], cw, jnp.asarray([1.0, 0.0]))
        return jpruning.single_site_log_likelihood_spectral_mixture(
            left, lam, right, comp_index, cw, jnp.asarray(jmg.alphas), leaves[:, site, :],
            freqs, schedule)

    expect, mix_lnl = [], []
    for n, site in enumerate(sites_idx):
        a, om, w1, bp = (point[key][n] for key in ("alpha", "omega_1", "w_1", "beta_plus"))
        w = np.array([w1, 1.0 - w1])
        mix = float(jax_lnl(site, a, om, bp, jnp.broadcast_to(jnp.asarray(w), (n_b, 2))))
        forced = []
        for b in tested_idx:
            cw = np.broadcast_to(w, (n_b, 2)).copy()
            cw[b] = [1.0, 0.0]
            forced.append(float(jax_lnl(site, a, om, bp, jnp.asarray(cw))))
        post_pos = np.clip(1.0 - w1 * np.exp(np.array(forced) - mix), 0.0, 1.0)
        expect.append(post_pos / (1.0 - post_pos) * (w1 / (1.0 - w1)))
        mix_lnl.append(mix)

    sites = meme.mixture_sites(data, mgp, torch.float64, spectral=True, rate_classes=2)
    alt = {key: torch.tensor(v, dtype=torch.float64) for key, v in point.items()}
    # the port's mixture lnL at the same points, then its EBF from the JAX lnL
    np.testing.assert_allclose(
        sites.loglik(torch.tensor(sites_idx), alt).numpy(), mix_lnl, rtol=0, atol=1e-9)
    alt["lnl"] = torch.tensor(mix_lnl, dtype=torch.float64)
    ebf = meme.branch_ebfs(sites, alt, tested_idx, sites_idx=torch.tensor(sites_idx), chunk=7)
    assert ebf.shape == (4, len(tested_idx))
    np.testing.assert_allclose(ebf, np.array(expect), rtol=1e-6, atol=0)
    # chunks of 7 items and one batch of all items give the same EBFs
    whole = meme.branch_ebfs(sites, alt, tested_idx, sites_idx=torch.tensor(sites_idx))
    np.testing.assert_array_equal(ebf, whole)
