"""The port's MEME against the JAX package's with the options a K = 2 run
leaves out: three rate classes, background branches (four of the six
leaves tested) and ``--multiple-hits Double`` with per-site 2H rates; and
``--resample 2``, the parametric bootstrap: its draws against the JAX
package's (propagators against ``scipy``, states from the JAX package's
``simulate_states`` in its order) and its p-values against the JAX run's.
The JAX runs' GTR and MG94 fits are carried across.  The fixture and the
table comparison are ``tests/test_torch_meme.py``'s."""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

from hyphy_tpu.utils import simulate as jsimulate
from hyphy_tpu.utils import synth as jsynth
from hyphy_tpu_torch.methods import meme
from hyphy_tpu_torch.utils import simulate as tsimulate
from test_torch_meme import PLANTED, assert_tables_match, run_both, write_fixture

torch.set_num_threads(2)

RESAMPLE, RESAMPLE_CODONS = 2, 6


@pytest.fixture(scope="module")
def k3_runs(tmp_path_factory):
    fasta, newick = write_fixture(tmp_path_factory.mktemp("meme_k3"))
    return run_both(fasta, newick, rate_classes=3, branches="t0,t1,t2,t3",
                    multiple_hits="Double")


@pytest.fixture(scope="module")
def resample_runs(tmp_path_factory):
    """K = 2 with ``resample`` 2 on a 6-codon alignment simulated along a
    6-taxon tree, omega = 8 at codon 2."""
    omegas = np.full(RESAMPLE_CODONS, 0.3)
    omegas[2] = 8.0
    aln, newick = jsynth.simulated_codon_alignment(6, RESAMPLE_CODONS, seed=7,
                                                   site_omegas=omegas, mean_branch=0.15)
    path = tmp_path_factory.mktemp("meme_rs") / "resample.fasta"
    path.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    return run_both(str(path), newick, rate_classes=2, resample=RESAMPLE, resample_seed=5)


def test_meme_k3_background_double_hits_match(k3_runs):
    ours, ref = k3_runs
    assert (~ours.data.tested_branches).any()
    calls = assert_tables_match(ours, ref, 3)
    names = [h[0] for h in ours.headers]
    assert names[-1] == "2H rate"
    np.testing.assert_allclose(ours.site_table[:, -1], ref.site_table[:, -1], rtol=0, atol=0.15)
    # a planted site is called
    assert calls[list(PLANTED)].any()


def _null_point(data, rng):
    """Per-pattern null parameters of a K = 3 run with background branches
    and per-site delta."""
    n = data.codon_filter.n_patterns
    return {"alpha": rng.uniform(0.2, 3.0, n), "omega_1": rng.uniform(0, 1, n),
            "omega_2": rng.uniform(0, 1, n), "w_1": rng.uniform(0.1, 0.9, n),
            "w_2": rng.uniform(0.1, 0.9, n), "beta_bg": rng.uniform(0.1, 2.0, n),
            "delta": rng.uniform(0.0, 0.5, n)}


def test_resample_draws_match_the_jax_package(k3_runs, monkeypatch):
    """The bootstrap's draws at a null point of K = 3, background branches
    and per-site delta: every site's branch propagators, built in fp64 by
    the shared-power Taylor series, within 1e-12 of the JAX package's host
    ``scipy.linalg.expm`` mixtures, and the states equal to the JAX
    package's ``simulate_states`` drawing from those, site by site, from
    one generator."""
    ours, _ = k3_runs
    data, mgp = ours.data, ours.mg94
    null = _null_point(data, np.random.default_rng(4))
    drawn = []
    original = tsimulate.simulate_states

    def recording(tree, p, root_freqs, n, rng):
        drawn.append(np.array(p))
        return original(tree, p, root_freqs, n, rng)

    monkeypatch.setattr(tsimulate, "simulate_states", recording)
    states = meme.simulate_null_states(data, mgp, null, 3, RESAMPLE, seed=9,
                                       per_site_multihit=True)

    # the JAX package's loop (meme.py:472-514) on the same bases
    model = mgp.model
    q1s, q1n = (q.detach().numpy() for q in model.basis_matrices(mgp.params))
    q2s, q2n = (q.detach().numpy() for q in model.multihit_basis_matrices(mgp.params, 2))
    tested = data.tested_branches
    filt = data.codon_filter
    constant = filt.constant_pattern_mask()
    rng = np.random.default_rng(9)
    want = np.ones((filt.n_patterns * RESAMPLE, filt.n_sequences), dtype=np.int64) * -1
    sites = 0
    for s in range(filt.n_patterns):
        if constant[s]:
            continue
        a = null["alpha"][s]
        qs, qn = q1s + null["delta"][s] * q2s, q1n + null["delta"][s] * q2n
        w = meme._stick_weights(torch.tensor([null["w_1"][s], null["w_2"][s]])).numpy()
        fams = []
        for b in [null["omega_1"][s] * a, null["omega_2"][s] * a, a, null["beta_bg"][s]]:
            q = a * qs + b * qn
            fams.append(q - np.diag(q.sum(axis=1)))
        p = np.stack([
            sum(w[c] * sla.expm(fams[c] * t) for c in range(3)) if tested[b]
            else sla.expm(fams[3] * t)
            for b, t in enumerate(mgp.alphas)])
        np.testing.assert_allclose(drawn[sites], p, rtol=0, atol=1e-12)
        st = jsimulate.simulate_states(data.tree, p, model.frequencies.numpy(), RESAMPLE, rng)
        want[s * RESAMPLE:(s + 1) * RESAMPLE] = st[: filt.n_sequences].T
        sites += 1
    assert sites == len(drawn) == int((~constant).sum()) > 0
    np.testing.assert_array_equal(states, want)


def test_resample_pvalues_match(resample_runs):
    """Bootstrap p-values equal to the JAX run's, or one 1/(N+1) step apart
    (where a simulated LRT ties the observed one within the two fits'
    tolerance); the rest of the table as MEME's K = 2 table."""
    ours, ref = resample_runs
    names = [h[0] for h in ours.headers]
    p = names.index("p-value")
    step = 1.0 / (RESAMPLE + 1)
    apart = np.round((ours.site_table[:, p] - ref.site_table[:, p]) / step)
    np.testing.assert_allclose(ours.site_table[:, p] - ref.site_table[:, p], apart * step,
                               rtol=0, atol=1e-12)
    assert (np.abs(apart) <= 1).all()
    # alpha, beta1, p1: as assert_tables_match holds the mixture columns
    np.testing.assert_allclose(ours.site_table[:, :3], ref.site_table[:, :3], rtol=0, atol=0.15)
    for name in ("MEME LogL", "FEL LogL", "LRT"):
        np.testing.assert_allclose(ours.site_table[:, names.index(name)],
                                   ref.site_table[:, names.index(name)], rtol=0, atol=1e-5)
    assert ours.json["analysis settings"] == ref.json["analysis settings"]


def test_resample_pvalues_lie_on_the_bootstrap_grid(resample_runs):
    """p in {1/3, 2/3, 1}; 1 wherever the positive-evidence condition
    fails (LRT 0), as the asymptotic p-value is there."""
    ours, _ = resample_runs
    names = [h[0] for h in ours.headers]
    p, lrt = ours.site_table[:, names.index("p-value")], ours.site_table[:, names.index("LRT")]
    step = 1.0 / (RESAMPLE + 1)
    np.testing.assert_allclose(np.round(p / step) * step, p, rtol=0, atol=1e-12)
    assert ((p >= step - 1e-12) & (p <= 1.0)).all()
    assert (p[lrt == 0] == 1.0).all()
