"""The port's FUBAR and B-STILL against the JAX package's.

* ``MG94Base.syn_nonsyn_unit_rates`` against the JAX package's.
* The grid form of the gene pruning (the grid folded into K1's node axis)
  against a loop of the one-set form, on a binary tree and on a polytomy
  wider than the chunked product's four children; the grid chunk capped so
  that every level's K1 launch stays within its node rows at 1000 taxa.
* The copied grid posteriors fed the JAX package's own conditionals.
* ``grid_site_loglik_matrix`` and the whole FUBAR and B-STILL JSONs, with
  the JAX run's GTR fit carried across, on a 5 x 5 grid, the matrix also
  with the grid split over a mesh of three blocks; a grid pass on the
  card's fp32 route against the fp64 one.

The fixture is an alignment simulated along an 8-taxon tree with two codons
under omega = 8."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import hyphy_tpu.methods.common as jcommon
from hyphy_tpu.methods import bstill as jbstill
from hyphy_tpu.methods import fubar as jfubar
from hyphy_tpu.methods import grid_bayes as jgrid_bayes
from hyphy_tpu.models.codon import MG94Base as JMG94Base
from hyphy_tpu.ops import pruning as jpruning
from hyphy_tpu.tree.topology import Tree as JTree
from hyphy_tpu.utils import synth as jsynth
import hyphy_tpu_torch.methods.common as tcommon
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.convert import params_from_numpy
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.data.genetic_code import GeneticCode
from hyphy_tpu_torch.methods import bstill, fubar, grid_bayes
from hyphy_tpu_torch.models.codon import MG94Base
from hyphy_tpu_torch.models.dna import GTR
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.tree.topology import Tree
from hyphy_tpu_torch.utils import synth

torch.set_num_threads(2)

N_TAXA, N_CODONS, SEED, PLANTED, GRID = 8, 30, 5, (4, 17), 5


def carried_gtr(g):
    """The JAX run's single-partition GTR fit as the port's."""
    return tcommon.GTRFit(
        loglik=g.loglik,
        params=params_from_numpy({k: np.asarray(v) for k, v in g.params.items()}, "cpu"),
        branch_lengths=np.asarray(g.branch_lengths), frequencies=np.asarray(g.frequencies),
        n_parameters=g.n_parameters, model=GTR(np.asarray(g.frequencies), device="cpu"))


def run_both(jmodule, module, fasta, newick, **options):
    """The JAX package's ``run`` and the port's with the JAX run's GTR fit
    carried across; both silent, the port on the CPU."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        original = jcommon.fit_gtr

        def spy(*args, **kwargs):
            seen["gtr"] = original(*args, **kwargs)
            return seen["gtr"]

        mp.setattr(jcommon, "fit_gtr", spy)
        ref = jmodule.run(fasta, tree=newick, **options)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        mp.setattr(tcommon, "fit_gtr", lambda data, precision=1e-5: carried_gtr(seen["gtr"]))
        ours = module.run(fasta, tree=newick, device="cpu", **options)
    return ours, ref


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    omegas = np.full(N_CODONS, 0.3)
    omegas[list(PLANTED)] = 8.0
    aln, newick = jsynth.simulated_codon_alignment(N_TAXA, N_CODONS, seed=SEED,
                                                   site_omegas=omegas, mean_branch=0.15)
    path = tmp_path_factory.mktemp("fubar") / "fubar.fasta"
    path.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    return str(path), newick


@pytest.fixture(scope="module")
def fubar_runs(fixture):
    return run_both(jfubar, fubar, *fixture, grid_points=GRID)


@pytest.fixture(scope="module")
def jax_grid(fubar_runs):
    """The JAX package's ``grid_site_loglik_matrix`` on FUBAR's grid."""
    _, ref = fubar_runs
    return jfubar.grid_site_loglik_matrix(ref.data, ref.grid)


@pytest.fixture(scope="module")
def bstill_runs(fixture):
    return run_both(jbstill, bstill, *fixture, grid_points=GRID)


# -- the pieces -----------------------------------------------------------------

def test_unit_rates_match():
    gc = GeneticCode("Universal")
    rng = np.random.default_rng(3)
    corners = rng.dirichlet(np.ones(4) * 4, size=3).T
    codon_freqs = rng.dirichlet(np.ones(gc.n_states) * 5)
    theta = {f"theta_{p}": rng.uniform(0.2, 3.0) for p in ("AC", "AT", "CG", "CT", "GT")}
    ours = MG94Base(gc, corners, codon_freqs, device="cpu").syn_nonsyn_unit_rates(
        {k: torch.tensor(v, dtype=torch.float64) for k, v in theta.items()})
    ref = JMG94Base(gc, corners, codon_freqs).syn_nonsyn_unit_rates(
        {k: jnp.asarray(v) for k, v in theta.items()})
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-12, atol=0)


@pytest.mark.parametrize("points,non_zero", [(5, False), (20, False), (20, True)])
def test_grids_match(points, non_zero):
    np.testing.assert_array_equal(fubar.alpha_beta_grid(points, non_zero),
                                  jfubar.alpha_beta_grid(points, non_zero))
    np.testing.assert_array_equal(bstill.bstill_grid(points, non_zero),
                                  jbstill.bstill_grid(points, non_zero))


_TREES = {
    "binary": jsynth.random_tree_newick(9, seed=2),
    "wide": ("((t0:0.1,t1:0.2,t2:0.05,t3:0.1,t4:0.02,t5:0.3,t6:0.1,t7:0.05,t8:0.2):0.05,"
             "(t9:0.1,t10:0.2):0.1,t11:0.2)"),
}


@pytest.mark.parametrize("name", sorted(_TREES))
def test_grid_folding_matches_one_set_form(name):
    """Four grid points in one call against the one-set form point by point
    (<= 1e-12 relative), and against the grid form of one point each (equal:
    a point's values do not depend on the points beside it)."""
    newick = _TREES[name]
    aln = jsynth.synthetic_codon_alignment(newick.count("t"), 12, seed=4)
    filt = DataFilter.from_alignment(aln, "codon")
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    rng = np.random.default_rng(1)
    s, n_points = filt.n_states, 4
    p = rng.dirichlet(np.ones(s), size=(n_points, tree.n_nodes, s))       # row-stochastic
    freqs = torch.tensor(rng.dirichlet(np.ones(s)))
    leaves = torch.tensor(filt.leaf_partials())
    schedule = pruning.build_pruning_data(tree, "cpu")
    folded = pruning.site_log_likelihoods(torch.tensor(p), leaves, freqs, schedule)
    assert folded.shape == (n_points, filt.n_patterns)
    for g in range(n_points):
        one = pruning.site_log_likelihoods(torch.tensor(p[g]), leaves, freqs, schedule)
        np.testing.assert_allclose(folded[g].numpy(), one.numpy(), rtol=1e-12, atol=0)
        alone = pruning.site_log_likelihoods(torch.tensor(p[g:g + 1]), leaves, freqs, schedule)
        np.testing.assert_array_equal(folded[g].numpy(), alone[0].numpy())


def _wide_grid_pruning(n_patterns=2):
    """A grid pass's inputs at 1000 taxa, on 4 states (GTR-like bases, so
    that 210 grid points prune in seconds on the CPU) and ``n_patterns``
    random one-hot patterns: the widest level is 320 nodes, so more than
    204 grid points in one call would pass K1's 65535 node rows."""
    tree = Tree.from_newick(synth.random_tree_newick(1000, seed=11))
    rng = np.random.default_rng(3)
    pi = rng.dirichlet(np.ones(4) * 5)
    bases = []
    for _ in range(2):
        e = rng.uniform(0.2, 2.0, (4, 4))
        q = (e + e.T) * pi[None, :]
        np.fill_diagonal(q, 0.0)
        bases.append(torch.tensor(q))
    leaves = np.eye(4)[rng.integers(0, 4, (tree.n_leaves, n_patterns))]
    schedule = pruning.build_pruning_data(tree, "cpu")
    gp = fubar.GridPruning(q_syn=bases[0], q_non=bases[1], freqs=torch.tensor(pi),
                           leaves=torch.tensor(leaves), schedule=schedule,
                           dtype=torch.float64,
                           point_bytes=pruning.grid_point_bytes(schedule, n_patterns, 4, 8))
    return tree, gp


@pytest.mark.parametrize("mesh, n_points, forced, calls", [
    (None, 400, None, [196, 204]),
    (None, 400, 400, [196, 204]),
    (None, 400, 1000, [196, 204]),
    (None, 400, 150, [100, 150, 150]),
    (None, 100, None, [100]),
    (("cpu",) * 3, 700, None, [29, 29, 30, 204, 204, 204]),
])
def test_grid_chunk_capped_at_k1_node_limit(mesh, n_points, forced, calls, monkeypatch):
    """At 1000 taxa every block of a grid pass prunes at most 65535 // 320 =
    204 grid points per call, what the free memory would allow (every point
    on the CPU) or a forced chunk notwithstanding, so that every level's
    launch stays within K1's node rows: one block, or three over a mesh of
    the CPU (234, 233 and 233 points, each cut at 204).  The propagators
    and the pruning are stubbed, the pruning to record its calls' grid
    points.  The per-point working set
    counts the kept levels and the gathered children (1745 CLV rows of
    patterns x S at this tree)."""
    tree, gp = _wide_grid_pruning()
    widest = max(p.child_branch.shape[0] for p in gp.schedule.plans)
    assert widest == 320 and pruning.max_grid_points(gp.schedule) == 204
    assert gp.point_bytes == 1745 * 2 * 4 * 8
    assert gp.point_bytes / (2 * 4 * 8) > tree.n_nodes - tree.n_leaves
    seen = []

    def recorded(p, leaves, freqs, schedule):
        seen.append(p.shape[0])
        return torch.zeros(p.shape[0], leaves.shape[1], dtype=p.dtype)

    monkeypatch.setattr(settings, "mesh", mesh)
    monkeypatch.setattr(fubar.GridPruning, "propagators",
                        lambda self, points, times: torch.zeros(points.shape[0], 1))
    monkeypatch.setattr(pruning, "site_log_likelihoods", recorded)
    grid = torch.full((n_points, 2), 0.5, dtype=torch.float64)
    times = torch.full((gp.schedule.n_nodes - 1,), 0.1, dtype=torch.float64)
    sll = fubar.grid_pass(gp, grid, times, chunk=forced)
    assert sll.shape == (n_points, 2)
    assert sorted(seen) == calls and max(seen) * widest <= 65535


def test_grid_pass_past_k1_node_limit():
    """A grid pass of 210 points at 1000 taxa runs in two calls (204 + 6)
    and gives every point what it gets alone; one call of all 210 is
    refused by the kernel's limit, on the CPU as on the card."""
    _, gp = _wide_grid_pruning()
    rng = np.random.default_rng(4)
    grid = torch.tensor(np.stack([rng.uniform(0.05, 2.0, 210), rng.uniform(0.05, 4.0, 210)], 1))
    times = torch.tensor(rng.uniform(0.01, 0.3, gp.schedule.n_nodes - 1))
    sll = fubar.grid_pass(gp, grid, times)
    assert sll.shape == (210, 2) and torch.isfinite(sll).all()
    for g in (0, 203, 204, 209):
        alone = fubar.grid_pass(gp, grid[g:g + 1], times)
        np.testing.assert_array_equal(sll[g].numpy(), alone[0].numpy())
    with torch.no_grad(), pytest.raises(ValueError, match="unsupported level shape"):
        pruning.site_log_likelihoods(gp.propagators(grid, times), gp.leaves,
                                     gp.freqs, gp.schedule)


def test_impossible_patterns_get_no_floor():
    """A fault of the reference (ROADMAP 3.11): its pruning clamps a site's
    likelihood at ``finfo.tiny``, so a pattern a grid point cannot produce
    (alpha = beta = 0: every propagator the identity) scores log(tiny) plus
    its scales, about -708 in fp64 (-87 in fp32), which lies above the lnL
    of a real, very variable site of a large tree: there the reference's
    scaling pass would prefer the impossible point.  The grid form gives
    -inf (HyPhy's likelihood of 0) and the real value unchanged.  A
    200-taxon tree with branches of mean 0.5, one pattern cycling through
    the 61 codons."""
    gc = GeneticCode("Universal")
    newick = synth.random_tree_newick(200, seed=3, mean_branch=0.5)
    tree = Tree.from_newick(newick)
    leaves = np.eye(gc.n_states)[np.arange(tree.n_leaves) % gc.n_states][:, None, :]
    q = synth._mg94_generator(gc, 2.5, 1.0)
    real = np.stack([sla.expm(q * t) for t in tree.input_lengths[:-1]])
    impossible = np.broadcast_to(np.eye(gc.n_states), real.shape)
    freqs = np.full(gc.n_states, 1.0 / gc.n_states)
    jdata = jpruning.build_pruning_data(JTree.from_newick(newick))
    want = {name: float(jpruning.site_log_likelihoods(jnp.asarray(p), jnp.asarray(leaves),
                                                      jnp.asarray(freqs), jdata)[0])
            for name, p in (("real", real), ("impossible", impossible))}
    assert np.isfinite(want["impossible"]) and want["impossible"] > want["real"]
    got = pruning.site_log_likelihoods(
        torch.tensor(np.stack([real, impossible])), torch.tensor(leaves), torch.tensor(freqs),
        pruning.build_pruning_data(tree, "cpu"))[:, 0].numpy()
    np.testing.assert_allclose(got[0], want["real"], rtol=1e-12)
    assert got[1] == -np.inf


@pytest.mark.parametrize("method", ["Variational-Bayes", "Collapsed-Gibbs"])
def test_grid_posteriors_match(fubar_runs, jax_grid, method):
    """The copied posterior on the JAX run's own conditionals gives the JAX
    package's posterior exactly (Collapsed-Gibbs: a short chain, one seed)."""
    _, ref = fubar_runs
    sll = jax_grid[0]
    cond = fubar.conditionals(np.asarray(sll), ref.data.codon_filter)
    args = (method, cond, 0.5, 60, 20, 8)
    ours, ours_samples = grid_bayes.posterior_over_grid(*args, rng=np.random.default_rng(3))
    want, want_samples = jgrid_bayes.posterior_over_grid(*args, rng=np.random.default_rng(3))
    np.testing.assert_array_equal(ours, want)
    if method == "Collapsed-Gibbs":
        np.testing.assert_array_equal(ours_samples, want_samples)


# -- the methods ------------------------------------------------------------------

def test_grid_matrix_matches(fubar_runs, jax_grid):
    """``[G, patterns]`` site lnL of both packages' two passes, both on the
    fp64 spectral route at the same GTR fit: within 1e-9 relative at the
    grid points with alpha > 0 and beta > 0.  Where alpha or beta is 0 the
    generator cannot reach some codons, their exact propagator entries are
    0 and both packages' eigendecompositions give round-off there (ROADMAP
    3.5): a pattern that needs such a path gets a value of round-off on
    either side, held here only to lie 10 lnL units or more below the
    pattern's best grid point in both (posterior weight < 5e-5)."""
    ours, _ = fubar_runs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcommon, "fit_gtr", lambda data, precision=1e-5: ours.gtr)
        sll, _, rs, rn = fubar.grid_site_loglik_matrix(ours.data, ours.grid)
    _hold_grid_matrix(ours, sll, rs, rn, jax_grid)


def test_grid_matrix_sharded_matches(fubar_runs, jax_grid):
    """The two passes with the grid points split over a mesh of three
    blocks (``settings.mesh``, each block from a host thread of its own)
    against the JAX package's passes under its 8-device mesh
    (``tests/conftest.py``), held as above."""
    ours, _ = fubar_runs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcommon, "fit_gtr", lambda data, precision=1e-5: ours.gtr)
        mp.setattr(settings, "mesh", ("cpu",) * 3)
        sll, _, rs, rn = fubar.grid_site_loglik_matrix(ours.data, ours.grid)
    _hold_grid_matrix(ours, sll, rs, rn, jax_grid)


def _hold_grid_matrix(ours, sll, rs, rn, jax_grid):
    want, _, jrs, jrn = jax_grid
    want = np.asarray(want)
    assert sll.shape == want.shape == (GRID * GRID, ours.data.codon_filter.n_patterns)
    np.testing.assert_allclose([rs, rn], [jrs, jrn], rtol=1e-12, atol=0)
    inner = (ours.grid[:, 0] > 0) & (ours.grid[:, 1] > 0)
    np.testing.assert_allclose(sll[inner], want[inner], rtol=1e-9, atol=0)
    apart = ~np.isclose(sll[~inner], want[~inner], rtol=1e-6, atol=0)
    for values in (sll, want):
        gap = values.max(axis=0)[None, :] - values[~inner]
        assert (gap[apart] >= 10.0).all()


def test_grid_pass_fp32_matches_fp64(fubar_runs):
    """The card's route of a grid pass, fp32 shared-power Taylor
    propagators and fp32 pruning, against the fp64 spectral route at the
    interior grid points, within 0.03 per pattern (ROADMAP 3.4's per-site
    fp32 bound)."""
    import dataclasses

    from hyphy_tpu_torch.models import frequencies as tfreq

    ours, _ = fubar_runs
    data = ours.data
    corners, codon_freqs = tfreq.cf3x4(data.codon_filter, data.genetic_code, device="cpu")
    model = MG94Base(data.genetic_code, corners, codon_freqs, device="cpu")
    theta = {k: v for k, v in ours.gtr.params.items() if k.startswith("theta")}
    gp64 = fubar.grid_pruning(data, model, theta)
    gp32 = dataclasses.replace(gp64, leaves=gp64.leaves.float(), dtype=torch.float32)
    inner = (ours.grid[:, 0] > 0) & (ours.grid[:, 1] > 0)
    grid = torch.tensor(ours.grid[inner])
    times = torch.tensor(3.0 * ours.gtr.branch_lengths)
    sll64 = fubar.grid_pass(gp64, grid, times)
    sll32 = fubar.grid_pass(gp32, grid, times)
    assert sll32.dtype == torch.float64 and sll32.shape == sll64.shape
    np.testing.assert_allclose(sll32.numpy(), sll64.numpy(), rtol=0, atol=0.03)


def test_grid_matrix_cache(fubar_runs, tmp_path):
    """The ``.npz`` cache: written after pass 2, read back when the data and
    grid match, ignored when the fingerprint differs."""
    ours, _ = fubar_runs
    cache = str(tmp_path / "grid")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcommon, "fit_gtr", lambda data, precision=1e-5: ours.gtr)
        first, *_ = fubar.grid_site_loglik_matrix(ours.data, ours.grid, cache=cache)
        np.savez(cache + ".npz", sll=first + 1.0, grid=ours.grid,
                 fingerprint=np.load(cache + ".npz")["fingerprint"])
        again, *_ = fubar.grid_site_loglik_matrix(ours.data, ours.grid, cache=cache)
        other, *_ = fubar.grid_site_loglik_matrix(ours.data, ours.grid, cache=cache,
                                                  fingerprint_extra="other")
    np.testing.assert_array_equal(again, first + 1.0)
    np.testing.assert_array_equal(other, first)


def test_fubar_json_matches(fubar_runs):
    """FUBAR's site table and grid posterior within 1e-7 (both from the
    grid matrices held above), the JSON's keys and settings equal, the
    posterior weights summing to 1."""
    ours, ref = fubar_runs
    assert sorted(ours.json) == sorted(ref.json)
    assert ours.json["MLE"]["headers"] == ref.json["MLE"]["headers"]
    assert ours.json["settings"] == ref.json["settings"]
    assert ours.site_table.shape == (N_CODONS, 6)
    np.testing.assert_allclose(ours.site_table, ref.site_table, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.asarray(ours.json["grid"]), np.asarray(ref.json["grid"]),
                               rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(ours.posterior_weights.sum(), 1.0, rtol=1e-12)


def test_bstill_json_matches(bstill_runs):
    """B-STILL's site table, per-site grid posteriors and EBFs within 1e-7
    relative, the proximal sites equal."""
    ours, ref = bstill_runs
    assert sorted(ours.json) == sorted(ref.json)
    assert ours.json["MLE"]["headers"] == ref.json["MLE"]["headers"]
    assert ours.json["settings"] == ref.json["settings"]
    assert ours.site_table.shape == (N_CODONS, 14)
    np.testing.assert_allclose(ours.site_table, ref.site_table, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.asarray(ours.json["posterior"]["0"]),
                               np.asarray(ref.json["posterior"]["0"]), rtol=1e-7, atol=1e-12)
    np.testing.assert_array_equal(ours.proximal_sites, ref.proximal_sites)
    assert np.isfinite(ours.site_table).all()


def test_fubar_raises_without_cuda(fixture, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(settings, "device", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fubar.run(fixture[0], tree=fixture[1], grid_points=GRID)
