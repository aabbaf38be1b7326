"""The port's contrast-MEME against the JAX package's, with the JAX run's
GTR and MG94 fits carried across, on two testable branch sets plus
background with two permutations per screened site (``pvalue`` 1.0
screens in every non-constant site, 5 of the tiny fixture's 6: ten
permutation jobs); the site objective
at fixed points, with the data's and with permuted branch-to-set maps,
against the JAX package's spectral mixture; and the per-item
branch-to-set maps of the mixture routes against a dense weight table.
The fixture is ``tests/test_torch_contrast_fel.py``'s at 6 taxa and 6
codons."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyphy_tpu.methods import common as jcommon
from hyphy_tpu.methods import contrast_meme as jcmeme
from hyphy_tpu.models.base import fill_diagonal_from_rows as jfill
from hyphy_tpu.ops import expm as jexpm
from hyphy_tpu.ops import pruning as jpruning
from hyphy_tpu_torch.methods import contrast_meme
from hyphy_tpu_torch.ops import expm, pruning
from test_torch_contrast_fel import carried_single_mg94, run_both, write_contrast_fixture

torch.set_num_threads(2)

N_TAXA, N_CODONS, PERMUTATIONS = 6, 6, 2


@pytest.fixture(scope="module")
def cmeme_runs(tmp_path_factory):
    """The two runs, the JAX run's fits, and the permutation jobs of both:
    ``{"jax": (alt lnL, null lnL), "port": (alt lnL, null lnL, model)}``,
    one row per job, site by site.  The JAX run's only Nelder-Mead calls
    outside ``jit`` are its permutation fits, the alternative then the
    null (``contrast_meme.py:301,318``)."""
    fasta, newick = write_contrast_fixture(tmp_path_factory.mktemp("cmeme"), N_CODONS, [2, 2],
                                           ["FG", "REF"], n_taxa=N_TAXA)
    jax_fits, port_jobs = [], {}
    jax_nm, port_stage = jcmeme.vmapped_nelder_mead, contrast_meme.permutation_stage

    def jax_spy(*args, **kwargs):
        out = jax_nm(*args, **kwargs)
        if not isinstance(out[1], jax.core.Tracer):
            jax_fits.append(np.asarray(out[1]))
        return out

    def port_spy(model, specs, grid, idx):
        alt, null = port_stage(model, specs, grid, idx)
        port_jobs.update(alt=alt.numpy(), null=null.numpy(), model=model, specs=specs)
        return alt, null

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcmeme, "vmapped_nelder_mead", jax_spy)
        mp.setattr(contrast_meme, "permutation_stage", port_spy)
        ours, ref, fits = run_both(jcmeme, contrast_meme, fasta, newick,
                                   test_labels=["FG", "REF"], pvalue=1.0,
                                   permutations=PERMUTATIONS)
    return ours, ref, fits, {"jax": tuple(jax_fits[-2:]), "port": port_jobs}


def test_site_objective_matches(cmeme_runs):
    """The port's per-site mixture lnL (fp64 spectral, as on the CPU) at
    fixed points against the JAX package's route (``contrast_meme.py``'s
    ``_loglik``) within 1e-9, with the data's branch-to-set map and with a
    permuted one per item, as the permutation jobs carry."""
    ours, ref, fits, _ = cmeme_runs
    data, jdata = ours.data, ref.data
    jmg = fits["fit_partitioned_mg94"]
    mix = contrast_meme.set_mixture(data, carried_single_mg94(jmg, data), torch.float64,
                                    spectral=True)
    q_syn, q_non = jmg.model.basis_matrices(jmg.params)
    freqs = jmg.model.frequencies
    leaves = jnp.asarray(jdata.codon_filter.leaf_partials())
    schedule = jpruning.build_pruning_data(jdata.tree)
    alpha_hat = jnp.asarray(jmg.alphas)

    @jax.jit
    def jax_lnl(site, a, b1, b2, prop, groups):
        betas = jnp.stack([b1, b2], axis=1).reshape(-1)
        m = jfill(a * q_syn[None] + betas[:, None, None] * q_non[None])
        left, lam, right = jexpm.reversible_spectral(m, freqs)
        pw = prop[groups]
        return jpruning.single_site_log_likelihood_spectral_mixture(
            left, lam, right, jnp.stack([2 * groups, 2 * groups + 1], axis=1),
            jnp.stack([pw, 1.0 - pw], axis=1), alpha_hat, leaves[:, site, :], freqs, schedule)

    rng = np.random.default_rng(8)
    n, g = data.codon_filter.n_patterns, mix.n_groups
    a, b1, b2 = rng.uniform(0.2, 2, n), rng.uniform(0, 1, (n, g)), rng.uniform(0.5, 6, (n, g))
    prop = rng.uniform(0.05, 0.95, (n, g))
    groups = np.stack([rng.permutation(data.branch_groups) for _ in range(n)])
    for per_item in (None, groups):
        got = mix.loglik(torch.arange(n), *(torch.tensor(x) for x in (a, b1, b2, prop)),
                         None if per_item is None else torch.tensor(per_item))
        item_groups = np.broadcast_to(data.branch_groups, (n, len(data.branch_groups))) \
            if per_item is None else per_item
        want = [float(jax_lnl(i, a[i], b1[i], b2[i], prop[i], jnp.asarray(item_groups[i])))
                for i in range(n)]
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)


def test_site_table_matches(cmeme_runs):
    """The substitution counts equal; the overall p-values (Holm) and
    q-values within 5e-3 and the calls at p <= 0.1 equal: the alternative
    has 7 free rates and weights per site, and on the tiny fixture's flat
    surfaces the two packages' Nelder-Mead runs stop at points a few 1e-3
    apart in p (the site objectives agree to 1e-9, above); alpha within
    0.15 as MEME's mixture columns.

    The permutation stage: the jobs' branch-to-set maps are the JAX
    package's draws (``default_rng(0)``, site by site); every job's
    alternative lnL, fitted from the Latin-hypercube starts, within 1e-8 of
    the JAX run's; and each job counts as a hit (permuted p <= observed)
    in both packages alike, except where its permuted p ties the observed
    one within 1e-10 (the ``<=`` may then go either way) or where the two
    runs' nulls stopped apart (more than 1e-6 in lnL): the null starts from
    a fixed point and its stop moves with 1e-12 changes in the objective
    (ROADMAP 3.12; ``test_permutation_null_stop_is_unstable``).  The
    p-values are the counts' (1 + hits) / (1 + N)."""
    ours, ref, _, jobs = cmeme_runs
    assert ours.headers == ref.headers
    names = [h[0] for h in ours.headers]
    col = {name: i for i, name in enumerate(names)}
    a, b = ours.site_table, ref.site_table
    assert a.shape == b.shape == (N_CODONS, len(names))
    assert np.isfinite(a).all()
    for name in ("P-value (overall)", "Q-value (overall)"):
        np.testing.assert_allclose(a[:, col[name]], b[:, col[name]], rtol=0, atol=5e-3,
                                   err_msg=name)
    p = col["P-value (overall)"]
    np.testing.assert_array_equal(a[:, p] <= 0.1, b[:, p] <= 0.1)
    for name in ("subs (FG)", "subs (REF)"):
        np.testing.assert_array_equal(a[:, col[name]], b[:, col[name]])
    np.testing.assert_allclose(a[:, col["alpha"]], b[:, col["alpha"]], rtol=0, atol=0.15)
    perm = col["Permutation p-value"]
    np.testing.assert_array_equal(a[:, perm] < 0, b[:, perm] < 0)
    tested = a[:, perm] >= 0
    assert tested.sum() == 5
    screened = np.unique(ours.data.codon_filter.duplicate_map[tested])
    rng = np.random.default_rng(0)
    groups = np.asarray(ours.data.branch_groups)
    draws = [rng.permutation(groups) for _ in screened for _ in range(PERMUTATIONS)]
    np.testing.assert_array_equal(jobs["port"]["model"].groups.numpy(), np.stack(draws))
    np.testing.assert_array_equal(jobs["port"]["model"].sites.numpy(),
                                  np.repeat(screened, PERMUTATIONS))
    (j_alt, j_null), (t_alt, t_null) = jobs["jax"], (jobs["port"]["alt"], jobs["port"]["null"])
    np.testing.assert_allclose(t_alt, j_alt, rtol=0, atol=1e-8)
    observed = np.repeat(b[tested, p], PERMUTATIONS)

    def perm_p(alt, null):
        return np.array([jcommon.chi2_sf(x, 3) for x in np.maximum(2.0 * (alt - null), 0.0)])

    j_perm, t_perm = perm_p(j_alt, j_null), perm_p(t_alt, t_null)
    j_hit, t_hit = j_perm <= observed + 1e-12, t_perm <= observed + 1e-12
    tie = np.abs(j_perm - observed) <= 1e-10
    apart = np.abs(t_null - j_null) > 1e-6
    assert (j_hit == t_hit)[~(tie | apart)].all()
    for table, hit in ((a, t_hit), (b, j_hit)):
        hits = hit.reshape(-1, PERMUTATIONS).sum(axis=1)
        np.testing.assert_allclose(table[tested, perm], (1.0 + hits) / (1 + PERMUTATIONS),
                                   rtol=0, atol=1e-12)


def test_permutation_null_stop_is_unstable(cmeme_runs):
    """A fault of the reference's permutation test (ROADMAP 3.12): a job's
    overall null starts from the fixed point (0.5, 0.5, 0.7, alpha 1) and,
    on the fixture's flat surface, where it stops moves with 1e-12 changes
    in the objective, by more than 1 lnL unit on the first job; the
    alternative, from the best of the Latin-hypercube starts, does not
    (within 1e-8 of the JAX run's at every job, above)."""
    _, _, _, jobs = cmeme_runs
    model, specs = jobs["port"]["model"], jobs["port"]["specs"]
    null_specs = model.null_specs(specs)
    idx = torch.arange(1)
    start = {k: torch.full((1,), 1.0 if k == "alpha" else 0.7 if k.startswith("pr") else 0.5,
                           dtype=torch.float64) for k in null_specs}
    noise = torch.Generator().manual_seed(0)

    def jittered(i, params):
        return model.null(i, params) + 1e-12 * torch.randn(i.shape[0], generator=noise,
                                                           dtype=torch.float64)

    _, exact = contrast_meme.vmapped_nelder_mead(model.null, null_specs, start, idx)
    _, moved = contrast_meme.vmapped_nelder_mead(jittered, null_specs, start, idx)
    assert float(exact[0]) == pytest.approx(jobs["port"]["null"][0], abs=1e-12)
    assert abs(float(moved[0]) - float(exact[0])) > 1.0


def test_json_matches(cmeme_runs):
    ours, ref, *_ = cmeme_runs
    assert sorted(ours.json) == sorted(ref.json)
    assert ours.json["test results"]["tested"] == ref.json["test results"]["tested"]
    assert sorted(ours.json["fits"]) == sorted(ref.json["fits"])


def test_start_grid_matches():
    """The Latin-hypercube starts, drawn in the JAX package's order."""
    grid = contrast_meme._start_grid(3, True, "cpu")
    rng = np.random.default_rng(7)
    for pre in ("b1", "b2", "pr"):
        for g in range(3):
            strata = (np.arange(24) + rng.random(24)) / 24
            np.testing.assert_array_equal(grid[f"{pre}_{g}"].numpy(), rng.permutation(strata))
    np.testing.assert_array_equal(grid["alpha"].numpy(), np.ones(24))


@pytest.mark.parametrize("route", ["taylor", "spectral"])
def test_per_item_families_match_dense_weights(route):
    """Per-item (weight, family) pairs scattered by
    ``dense_mixture_weights`` equal the dense table built branch by branch,
    and a batch of items, each with its own branch-to-family map, gives
    every item the lnL it gets alone (equal: the routes are batch-invariant)."""
    from test_torch_meme import _mixture_problem

    pr = _mixture_problem("binary")
    rng = np.random.default_rng(2)
    n, n_b = pr["weights"].shape[:2]
    families = rng.integers(0, 3, size=(n, n_b, 2))
    families[..., 1] = (families[..., 0] + 1 + rng.integers(0, 2, size=(n, n_b))) % 3
    w = rng.dirichlet(np.ones(2), size=(n, n_b))
    dense = np.zeros((n, n_b, 3))
    for i in range(n):
        for b in range(n_b):
            dense[i, b, families[i, b]] += w[i, b]
    scattered = pruning.dense_mixture_weights(torch.tensor(w), torch.tensor(families), 3)
    np.testing.assert_array_equal(scattered.numpy(), dense)
    q, leaves, pi = (torch.tensor(pr[k]) for k in ("q", "leaves", "pi"))
    times = torch.tensor(pr["times"])

    def evaluate(items):
        if route == "spectral":
            left, lam, right = expm.reversible_spectral(q[items], pi)
            return pruning.single_site_log_likelihood_spectral_mixture(
                left, lam, right, scattered[items], times, leaves[items], pi, pr["tdata"])
        qn, m2p, r, j = expm.taylor_action_factors(q[items], times)
        return pruning.single_site_log_likelihood_taylor(
            qn, m2p, r.transpose(1, 2), j.transpose(1, 2), None,
            expm.taylor_action_terms(torch.float64), leaves[items], pi, pr["tdata"],
            mix_weights=scattered[items])

    batch = evaluate(torch.arange(n)).numpy()
    alone = np.concatenate([evaluate(torch.tensor([i])).numpy() for i in range(n)])
    assert np.isfinite(batch).all()
    np.testing.assert_array_equal(batch, alone)
