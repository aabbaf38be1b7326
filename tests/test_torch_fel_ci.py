"""FEL's ``--ci`` in the port against the JAX package, on the tiny fixture
of ``tests/test_torch_fel.py`` (6 taxa x 20 codons, seed 11), fp64, the
per-site stage run on the JAX run's carried global fits.  One JAX run and
one port run are shared through a module-scoped fixture."""

import numpy as np
import pytest
import torch

import hyphy_tpu.methods.common as jcommon
from hyphy_tpu.methods import fel as jfel
from hyphy_tpu.utils import synth as jsynth
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.methods import fel
from tests.torch_carry import carry_into, spy_fits

torch.set_num_threads(2)

N_TAXA, N_CODONS, SEED = 6, 20, 11
# LRT and p within 1e-6; rates within 1e-5 relative where above 1e-6 (as
# tests/test_torch_fel.py)
P_ATOL, RATE_RTOL = 1e-6, 1e-5
# The CI bounds come from 25 bisection steps on profile lnLs that each
# package reoptimizes with its own Nelder-Mead: a site whose profile lnL
# lies within the fits' tolerance of the band edge can take the other
# branch at one step, which moves that bound by up to the remaining
# interval (2^-k of it at step k).  1e-3 relative holds a flip from step 10
# on.  Where the alternative fit puts alpha at its lower bound, dN/dS sits
# at the cap (10000) and the profile is flat in the ratio over decades
# (alpha trades against it): the two bisections part at an early step
# (0.87 relative at one site here), so such sites are held to
# LB <= MLE <= UB = cap only.  The MLE column is a ratio of fitted rates
# and is held to RATE_RTOL.
CI_RTOL = 1e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run with ``ci``, and the port's on its carried fits."""
    aln = jsynth.synthetic_codon_alignment(N_TAXA, N_CODONS, seed=SEED)
    fasta = tmp_path_factory.mktemp("ci") / "tiny.fasta"
    fasta.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    tree = jsynth.random_tree_newick(N_TAXA, seed=SEED)
    seen = {}
    saved = settings.device
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("HYPHY_TPU_PROGRESS", "0")
            spy_fits(jcommon, mp, seen)
            jres = jfel.run(str(fasta), tree=tree, ci=True)
        settings.device = "cpu"
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("HYPHY_TPU_PROGRESS", "0")
            carry_into(mp, seen)
            res = fel.run(str(fasta), tree=tree, ci=True)
    finally:
        settings.device = saved
    return jres, res


def test_ci_matches_on_carried_fits(runs):
    jres, res = runs
    assert res.headers == jres.headers
    assert [h[0] for h in res.headers[6:]] == ["dN/dS LB", "dN/dS MLE", "dN/dS UB"]
    ours, ref = res.site_table, jres.site_table
    np.testing.assert_allclose(ours[:, 3:5], ref[:, 3:5], rtol=0, atol=P_ATOL)
    for col in range(3):              # alpha, beta, alpha=beta
        big = np.abs(ref[:, col]) > 1e-6
        np.testing.assert_allclose(ours[big, col], ref[big, col], rtol=RATE_RTOL,
                                   err_msg=res.headers[col][0])
    lb, mle, ub = ours[:, 6], ours[:, 7], ours[:, 8]
    assert (lb <= mle).all() and (mle <= ub).all()
    big = np.abs(ref[:, 7]) > 1e-6
    np.testing.assert_allclose(mle[big], ref[big, 7], rtol=RATE_RTOL)
    capped = ref[:, 7] >= fel._OMEGA_CAP
    np.testing.assert_array_equal(ub[capped], ref[capped, 8])
    assert (~capped).sum() >= N_CODONS // 2
    for col in (6, 8):
        np.testing.assert_allclose(ours[~capped, col], ref[~capped, col], rtol=CI_RTOL,
                                   atol=1e-8, err_msg=res.headers[col][0])
