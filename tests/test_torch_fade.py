"""The port's FADE against the JAX package's.

* ``define_grid`` equal exactly; the bias factors and the biased
  generators equal.
* The biased propagators (the Taylor route, fp64) against
  ``scipy.linalg.expm`` at the grid's highest bias (1e-10), where the JAX
  package's spectral route of the tilted frequencies is off by up to 0.5
  (ROADMAP 3.19).
* Each grid pass, for two targets: the finite entries within 1e-8 relative
  of the JAX package's pruning fed ``scipy.linalg.expm`` propagators, and
  -inf exactly where the rate-0 point makes a pattern impossible; the JAX
  package's own grid (its spectral route) agrees below the highest bias.
* The run with ``grid_points=8`` and ``residues="AD"`` (as
  ``tests/test_leisr_fade_cfel.py:58-66`` runs it), the JAX run's baseline
  fit carried across: the posterior tables within 1e-6 of the JAX
  package's run with exact propagators, the site annotations and the JSON's
  keys equal; and Collapsed-Gibbs, whose draws share one generator across
  targets in the JAX package's order.
* The rate-0 floor (ROADMAP 3.11, 3.20): on a 200-taxon tree with a
  variable tested clade the JAX package's pruning scores a pattern at its
  ``finfo.tiny`` floor, above the pattern's real lnL, where the port gives
  -inf.

The fixture is an alignment of 8 taxa x 40 residues simulated under WAG,
with a biased block (toward K, rate 1, bias 10) on a 3-leaf clade at four
sites."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from hyphy_tpu.data.filter import DataFilter as JDataFilter
from hyphy_tpu.methods import fade as jfade
from hyphy_tpu.ops import expm as jexpm
from hyphy_tpu.ops import pruning as jpruning
from hyphy_tpu.tree.topology import Tree as JTree
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.data.alignment import Alignment, read_alignment
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.data.genetic_code import AMINO_ACIDS
from hyphy_tpu_torch.likelihood import FitResult
from hyphy_tpu_torch.methods import fade
from hyphy_tpu_torch.models import frequencies as tfreq
from hyphy_tpu_torch.models.base import fill_diagonal_from_rows
from hyphy_tpu_torch.models.protein import EmpiricalProtein
from hyphy_tpu_torch.tree.topology import Tree
from hyphy_tpu_torch.utils import synth
from tests.torch_carry import labelled_newick, pick_clades, protein_alignment

torch.set_num_threads(2)

N_TAXA, N_SITES, SEED, PLANTED = 8, 40, 3, [5, 12, 20, 33]
GRID = 8


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    newick = synth.random_tree_newick(N_TAXA, seed=SEED, mean_branch=0.2)
    tree = Tree.from_newick(newick)
    clade = pick_clades(tree, [3])[0]
    names, seqs, _ = protein_alignment(N_TAXA, N_SITES, SEED, planted=PLANTED, clade=clade)
    labelled = labelled_newick(tree, tree.input_lengths, {nd: "FG" for nd in clade})
    fasta = tmp_path_factory.mktemp("fade") / "p.fasta"
    fasta.write_text("".join(f">{n}\n{s}\n" for n, s in zip(names, seqs)))
    return {"fasta": str(fasta), "newick": labelled}


def _spy_fit(mp, module, seen):
    original = module.LikelihoodFunction.fit

    def spy(self, *args, **kwargs):
        seen["fit"] = original(self, *args, **kwargs)
        return seen["fit"]

    mp.setattr(module.LikelihoodFunction, "fit", spy)


class _ExactExpm:
    """The JAX package's ``expm_ops`` as FADE calls it, with every
    propagator from ``jax.scipy.linalg.expm``: its ``reversible_spectral``
    hands the generator through and ``spectral_propagators`` exponentiates
    it at each branch's time."""

    @staticmethod
    def reversible_spectral(q, pi):
        return q, jnp.zeros(q.shape[:-1], q.dtype), q

    @staticmethod
    def spectral_propagators(left, lam, right, t):
        return jax.vmap(lambda m, tb: jax.scipy.linalg.expm(m * tb))(left, t)


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """The JAX package's FADE with ``grid_points=8, residues="AD"``: as it
    is, and with exact propagators; and its baseline fit."""
    seen, out = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        _spy_fit(mp, jfade, seen)
        out["spectral"] = jfade.run(inputs["fasta"], tree=inputs["newick"], branches="FG",
                                    grid_points=GRID, residues="AD")
        mp.setattr(jfade, "expm_ops", _ExactExpm)
        out["exact"] = jfade.run(inputs["fasta"], tree=inputs["newick"], branches="FG",
                                 grid_points=GRID, residues="AD")
        out["gibbs"] = jfade.run(inputs["fasta"], tree=inputs["newick"], branches="FG",
                                 grid_points=GRID, residues="AD", method="Collapsed-Gibbs",
                                 chain_length=400, burn_in=100, samples=20)
    out["fit"] = seen["fit"]
    return out


def _carried(jfit):
    return FitResult(params={"t": torch.tensor(np.asarray(jfit.params["t"]))},
                     loglik=jfit.loglik, n_free_parameters=jfit.n_free_parameters,
                     n_iterations=0)


@pytest.mark.parametrize("points", [5, 8, 20, 33])
def test_define_grid_matches(points):
    np.testing.assert_array_equal(fade.define_grid(points), jfade.define_grid(points))


def test_biased_generators_match():
    bias = torch.tensor([0.0, 0.5, 7.1, 50.0], dtype=torch.float64)
    for a, b in zip(fade._bias_factors(bias), jfade._bias_factors(jnp.asarray(bias.numpy()))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15)
    mdl = EmpiricalProtein("WAG", device="cpu")
    s_pi = torch.as_tensor(mdl.exchangeabilities) * mdl.frequencies[None, :]
    grid = torch.tensor(fade.define_grid(GRID))
    q = fade.biased_generators(s_pi, grid, 8)
    pi, sp = np.asarray(mdl.frequencies), s_pi.numpy()
    for g, (rate, b) in enumerate(grid.numpy()):
        toward, away = jfade._bias_factors(jnp.asarray(b))
        onehot = np.eye(20)[8]
        mult = 1.0 + (float(toward) - 1.0) * onehot[None, :] + (float(away) - 1.0) * onehot[:, None]
        want = rate * sp * mult
        want = want - np.diag(np.diag(want))
        want -= np.diag(want.sum(axis=1))
        np.testing.assert_allclose(q[g].numpy(), want, rtol=1e-14, atol=1e-300)
    assert pi.shape == (20,)


def test_biased_propagators_hold_at_the_highest_bias():
    """At bias 50 the Taylor route is at ``scipy.linalg.expm``'s round-off;
    the JAX package's spectral route of the tilted frequencies is not."""
    mdl = EmpiricalProtein("WAG", device="cpu")
    s_pi = torch.as_tensor(mdl.exchangeabilities) * mdl.frequencies[None, :]
    t = torch.tensor([0.001, 0.05, 0.5, 2.0], dtype=torch.float64)
    worst_spectral = 0.0
    for rate in (0.1, 1.0, 50.0):
        grid = torch.tensor([[rate, 50.0]], dtype=torch.float64)
        q = fade.biased_generators(s_pi, grid, AMINO_ACIDS.index("K"))
        from hyphy_tpu_torch.ops import expm as expm_ops

        p = expm_ops.taylor_propagators_batched(q, t[:, None])[:, 0].numpy()
        want = np.stack([sla.expm(q[0].numpy() * tb) for tb in t.numpy()])
        np.testing.assert_allclose(p, want, rtol=0, atol=1e-10)
        pi_tilt = mdl.frequencies.numpy() * np.exp(50.0 * np.eye(20)[AMINO_ACIDS.index("K")])
        left, lam, right = jexpm.reversible_spectral(jnp.asarray(q.numpy()),
                                                     jnp.asarray(pi_tilt / pi_tilt.sum()))
        spec = np.asarray(jexpm.spectral_propagators(left[0], lam[0], right[0],
                                                     jnp.asarray(t.numpy())))
        worst_spectral = max(worst_spectral, float(np.abs(spec - want).max()))
    assert worst_spectral > 1e-3


def _setup(inputs, jfit):
    aln = read_alignment(inputs["fasta"])
    filt = DataFilter.from_alignment(aln, "protein")
    jfilt = JDataFilter.from_alignment(aln, "protein")
    tree = Tree.from_newick(inputs["newick"], leaf_order=filt.names)
    jtree = JTree.from_newick(inputs["newick"], leaf_order=jfilt.names)
    mdl = EmpiricalProtein("WAG", frequencies=tfreq.empirical_character(filt), device="cpu")
    t = torch.tensor(np.asarray(jfit.params["t"]))
    gp = fade.grid_pruning(mdl, filt, tree, t, tree.select_branches("FG"))
    return filt, jfilt, tree, jtree, mdl, gp


@pytest.mark.parametrize("residue", ["A", "K"])
def test_grid_pass_matches(inputs, jax_runs, residue):
    filt, jfilt, tree, jtree, mdl, gp = _setup(inputs, jax_runs["fit"])
    target = AMINO_ACIDS.index(residue)
    grid = fade.define_grid(GRID)
    got = fade.grid_pass(gp, torch.tensor(grid), target).numpy()
    # against the JAX package's pruning fed scipy propagators
    tested = tree.select_branches("FG")
    t = np.asarray(jax_runs["fit"].params["t"])
    q_base = fill_diagonal_from_rows(gp.s_pi).numpy()
    q = fade.biased_generators(gp.s_pi, torch.tensor(grid), target).numpy()
    jdata = jpruning.build_pruning_data(jtree)
    leaves = jnp.asarray(jfilt.leaf_partials())
    base = [sla.expm(q_base * tb) for tb in t]
    want = np.empty_like(got)
    for g in range(len(grid)):
        p = np.stack([sla.expm(q[g] * tb) if tested[b] else base[b] for b, tb in enumerate(t)])
        want[g] = np.asarray(jpruning.site_log_likelihoods(jnp.asarray(p), leaves,
                                                           jnp.asarray(mdl.frequencies.numpy()),
                                                           jdata))
    finite = np.isfinite(got)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-8)
    # -inf only at the rate-0 point, where the JAX pruning scores its floor
    assert (~finite).any() and not (~finite[1:]).any()
    assert (want[0, ~finite[0]] < -700).all()
    # the JAX package's own grid: its spectral route agrees below the
    # highest bias (1 + 49 = 49.99999999999999 in floating point), and parts
    # from the exact values there
    jsll = _jax_spectral_grid(gp, jfilt, jtree, mdl, t, tested, grid, target)
    top = grid[:, 1] == grid[:, 1].max()
    low = ~top
    low[0] = False
    np.testing.assert_allclose(got[low], jsll[low], rtol=1e-8)
    assert np.abs(got[top] - jsll[top]).max() > 1e-3


def _jax_spectral_grid(gp, jfilt, jtree, mdl, t, tested, grid, target):
    """The JAX package's grid pass (``fade.py:161-187``) at the same fit."""
    pi = jnp.asarray(mdl.frequencies.numpy())
    s_pi = jnp.asarray(gp.s_pi.numpy())
    from hyphy_tpu.models.base import fill_diagonal_from_rows as jfill

    base_left, base_lam, base_right = jexpm.reversible_spectral(jfill(s_pi)[None], pi)
    pdata = jpruning.build_pruning_data(jtree)
    lp = jnp.asarray(jfilt.leaf_partials())
    tested_idx = jnp.asarray(tested.astype(np.int32))
    t_hat = jnp.asarray(t)
    out = []
    for rate, bias in grid:
        toward, away = jfade._bias_factors(jnp.asarray(bias))
        onehot = jnp.zeros(20).at[target].set(1.0)
        mult = 1.0 + (toward - 1.0) * onehot[None, :] + (away - 1.0) * onehot[:, None]
        biased = jfill(rate * s_pi * mult)
        pi_tilt = pi * jnp.exp(jnp.maximum(bias, 1e-10) * onehot)
        b_left, b_lam, b_right = jexpm.reversible_spectral(biased[None], pi_tilt / pi_tilt.sum())
        left = jnp.stack([base_left[0], b_left[0]])[tested_idx]
        lam = jnp.stack([base_lam[0], b_lam[0]])[tested_idx]
        right = jnp.stack([base_right[0], b_right[0]])[tested_idx]
        p = jexpm.spectral_propagators(left, lam, right, t_hat)
        out.append(np.asarray(jpruning.site_log_likelihoods(p, lp, pi, pdata)))
    return np.stack(out)


def test_run_matches(inputs, jax_runs, monkeypatch):
    # the baseline fit of its own, within the optimizer tolerance
    own = fade.run(inputs["fasta"], tree=inputs["newick"], branches="FG", grid_points=5,
                   residues="K")
    assert abs(own.baseline_loglik - jax_runs["spectral"].baseline_loglik) <= 0.15
    monkeypatch.setattr(fade, "fit_baseline", lambda lf, tree, precision: _carried(jax_runs["fit"]))
    ours = fade.run(inputs["fasta"], tree=inputs["newick"], branches="FG", grid_points=GRID,
                    residues="AD")
    want = jax_runs["exact"]
    assert sorted(ours.json) == sorted(want.json)
    assert ours.json["settings"] == want.json["settings"]
    assert ours.headers == want.headers
    assert set(ours.site_tables) == {"A", "D"}
    for residue in "AD":
        np.testing.assert_allclose(ours.site_tables[residue], want.site_tables[residue],
                                   rtol=1e-6, atol=1e-9)
        p = ours.site_tables[residue][:, 2]
        assert ((p >= 0) & (p <= 1)).all()
    assert ours.json["site annotations"] == want.json["site annotations"]
    np.testing.assert_array_equal(ours.grid, want.grid)


def test_collapsed_gibbs_draws_match(inputs, jax_runs, monkeypatch):
    """The sampler's generator is shared across targets in the JAX package's
    order: the same draws, so the same tables (exact propagators in the JAX
    run, so that both chains see the same conditionals to round-off)."""
    monkeypatch.setattr(fade, "fit_baseline", lambda lf, tree, precision: _carried(jax_runs["fit"]))
    ours = fade.run(inputs["fasta"], tree=inputs["newick"], branches="FG", grid_points=GRID,
                    residues="AD", method="Collapsed-Gibbs", chain_length=400, burn_in=100,
                    samples=20)
    for residue in "AD":
        np.testing.assert_allclose(ours.site_tables[residue],
                                   jax_runs["gibbs"].site_tables[residue], rtol=1e-6, atol=1e-9)


def test_rate_zero_point_gets_no_floor():
    """A fault of the reference (ROADMAP 3.20, 3.11 in FADE): at FADE's
    rate-0 grid point the tested branches are the identity, so a pattern
    that varies inside the tested clade has likelihood 0.  The JAX package's
    pruning clamps it at ``finfo.tiny`` and scores log(tiny) plus its
    scales, which on a 200-taxon tree lies above the real lnL of that
    pattern at rate 1 (so the point would dominate the posterior); the
    port's grid form gives -inf and the real value unchanged.  One pattern
    cycling through the 20 residues, a tested clade of 171 of the 200
    leaves, branches of mean 0.2."""
    newick = synth.random_tree_newick(200, seed=3, mean_branch=0.2)
    tree = Tree.from_newick(newick)
    clade = pick_clades(tree, [150])[0]
    names = tree.names[: tree.n_leaves]
    aln = Alignment(names=list(names),
                    sequences=[AMINO_ACIDS[i % 20] for i in range(tree.n_leaves)])
    filt = DataFilter.from_alignment(aln, "protein")
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    tested = np.zeros(tree.n_branches, dtype=bool)
    tested[[nd for nd in clade if nd != tree.root]] = True
    mdl = EmpiricalProtein("WAG", device="cpu")
    t = torch.tensor(np.asarray(tree.input_lengths[:-1]))
    gp = fade.grid_pruning(mdl, filt, tree, t, tested)
    grid = torch.tensor([[0.0, 0.0], [1.0, 0.0]], dtype=torch.float64)
    got = fade.grid_pass(gp, grid, AMINO_ACIDS.index("K"))[:, 0].numpy()
    p = gp.propagators(grid, AMINO_ACIDS.index("K")).numpy()
    jdata = jpruning.build_pruning_data(JTree.from_newick(newick, leaf_order=filt.names))
    want = [float(jpruning.site_log_likelihoods(
        jnp.asarray(p[g]), jnp.asarray(filt.leaf_partials()),
        jnp.asarray(mdl.frequencies.numpy()), jdata)[0]) for g in range(2)]
    assert np.isfinite(want[0]) and want[0] > want[1]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
    assert got[0] == -np.inf
