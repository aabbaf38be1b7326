"""The port's contrast-FEL against the JAX package's, with the JAX run's GTR
and MG94 fits carried across: two testable branch sets plus background
(G = 3), and three testable sets plus background (G = 4), where the
pairwise nulls run.  The site table (alpha, the betas, p-values after
Holm-Bonferroni, the BH q-values) is compared to stated tolerances and the
per-set substitution counts are equal.

The fixture (``torch_carry.contrast_alignment``) is an alignment simulated
along ``random_tree_newick(8, seed, 0.2)`` with labelled clades and omega = 5 on
the first set's branches at two codons; it is shared with
``tests/test_torch_contrast_meme.py``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import hyphy_tpu.methods.common as jcommon
from hyphy_tpu.methods import contrast_fel as jcfel
import hyphy_tpu_torch.methods.common as tcommon
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.methods import contrast_fel
from torch_carry import carried_gtr, carried_mg94, contrast_alignment

torch.set_num_threads(2)

N_TAXA, SEED, PLANTED, MEAN_BRANCH = 8, 3, (2, 5), 0.2
# (codons, clade sizes, labels) of the two cases
CASES = {"two sets": (10, [3, 2], ["FG", "REF"]),
         "three sets": (6, [2, 2, 2], ["FG", "REF", "OTHER"])}


def write_contrast_fixture(directory, n_codons, sizes, labels, n_taxa=N_TAXA):
    names, seqs, newick = contrast_alignment(n_taxa, n_codons, SEED, sizes, labels, PLANTED,
                                             mean_branch=MEAN_BRANCH)
    path = directory / "contrast.fasta"
    path.write_text("".join(f">{n}\n{s}\n" for n, s in zip(names, seqs)))
    return str(path), newick


def carried_single_mg94(jmg, data):
    """The JAX run's single-partition MG94 fit as the port's, on ``data``."""
    return carried_mg94(SimpleNamespace(parts=[jmg], loglik=jmg.loglik, n_parameters=0),
                        SimpleNamespace(parts=[data])).parts[0]


def run_both(jmodule, module, fasta, newick, **options):
    """The JAX package's ``run`` and the port's with the JAX run's GTR and
    MG94 fits carried across; both silent, the port on the CPU.  Returns
    (port result, JAX result, the JAX run's fits by function name)."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        for name in ("fit_gtr", "fit_partitioned_mg94"):
            original = getattr(jcommon, name)

            def spy(*args, _original=original, _name=name, **kwargs):
                seen[_name] = _original(*args, **kwargs)
                return seen[_name]

            mp.setattr(jcommon, name, spy)
        ref = jmodule.run(fasta, tree=newick, **options)
    gtr = seen["fit_gtr"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        mp.setattr(tcommon, "fit_gtr", lambda data, precision=1e-5: carried_gtr(
            SimpleNamespace(parts=[gtr], loglik=gtr.loglik,
                            n_parameters=gtr.n_parameters)).parts[0])
        mp.setattr(tcommon, "fit_partitioned_mg94", lambda data, g, precision=1e-5:
                   carried_single_mg94(seen["fit_partitioned_mg94"], data))
        ours = module.run(fasta, tree=newick, device="cpu", **options)
    return ours, ref, seen


@pytest.fixture(scope="module", params=sorted(CASES))
def cfel_runs(request, tmp_path_factory):
    n_codons, sizes, labels = CASES[request.param]
    fasta, newick = write_contrast_fixture(tmp_path_factory.mktemp("cfel"), n_codons, sizes,
                                           labels)
    return request.param, run_both(jcfel, contrast_fel, fasta, newick, test_labels=labels)[:2]


def test_multigroup_loading_matches(cfel_runs):
    _, (ours, ref) = cfel_runs
    np.testing.assert_array_equal(ours.data.branch_groups, ref.data.branch_groups)
    np.testing.assert_array_equal(ours.data.tested_branches, ref.data.tested_branches)
    assert ours.group_names == ref.group_names
    assert ours.group_names[-1] == "background"


def test_site_table_matches(cfel_runs):
    """The p-values (Holm-corrected, overall and pairwise) and q-values
    within 1e-5, the rates within 1e-4 relative where the alternative's
    lnL surface is not flat along them (rates above 1e-3), the calls at p
    <= 0.1 equal, the substitution counts equal."""
    case, (ours, ref) = cfel_runs
    assert ours.headers == ref.headers
    names = [h[0] for h in ours.headers]
    a, b = ours.site_table, ref.site_table
    n_sets = len(ours.group_names)
    assert a.shape == b.shape and a.shape[1] == 3 + 2 * n_sets + (3 if case == "three sets" else 0)
    assert np.isfinite(a).all()
    rates = slice(0, 1 + n_sets)
    subs = slice(1 + n_sets, 1 + 2 * n_sets)
    tests = slice(1 + 2 * n_sets, None)
    np.testing.assert_array_equal(a[:, subs], b[:, subs])
    np.testing.assert_allclose(a[:, tests], b[:, tests], rtol=0, atol=1e-5, err_msg=str(names))
    big = np.abs(b[:, rates]) > 1e-3
    np.testing.assert_allclose(a[:, rates][big], b[:, rates][big], rtol=1e-4)
    p = names.index("P-value (overall)")
    np.testing.assert_array_equal(a[:, p] <= 0.1, b[:, p] <= 0.1)


def test_json_matches(cfel_runs):
    _, (ours, ref) = cfel_runs
    assert sorted(ours.json) == sorted(ref.json)
    assert ours.json["test results"] == ref.json["test results"]
    assert sorted(ours.json["fits"]) == sorted(ref.json["fits"])


@pytest.mark.parametrize("n", [1, 5, 12])
def test_multiple_testing_corrections_match(n):
    rng = np.random.default_rng(n)
    p = rng.uniform(size=n) ** 3
    np.testing.assert_array_equal(contrast_fel.benjamini_hochberg(p),
                                  jcfel.benjamini_hochberg(p))
    fam = {f"k{i}": float(x) for i, x in enumerate(p)}
    assert contrast_fel.holm_bonferroni(fam) == jcfel.holm_bonferroni(fam)


def test_contrast_fel_raises_without_cuda(tmp_path, monkeypatch):
    fasta, newick = write_contrast_fixture(tmp_path, 8, [3, 3], ["FG", "REF"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(settings, "device", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        contrast_fel.run(fasta, tree=newick, test_labels=["FG", "REF"])
