"""The per-site solves over a device mesh (``parallel/mesh.py::
sharded_site_solve``) on the CPU, as ``("cpu",) * 3``: every call site that
the JAX package sends through its ``sharded_site_solve`` (FUBAR's and
FADE's grid passes, MEME's three stages and its EBFs, contrast-FEL,
contrast-MEME's fits and permutations, PRIME, LEISR) gives over three
blocks, each run from a host thread of its own, what it gives unsharded,
to 1e-12 relative: the items are independent and the per-site routes do
not depend on the items that share their batch.  FEL's stage is held in
``tests/test_torch_mesh.py``, the sharded FUBAR grid pass against the JAX
package's under its 8-device mesh in ``tests/test_torch_fubar.py``.

The threaded solve itself: a block that raises fails the solve, after the
other blocks have ended; the caller's ``no_grad`` reaches every block;
blocks that share a card split its free memory; K1's launch count is exact
when blocks launch at once.

Inputs: ``tests/test_torch_mesh.py``'s 6 taxa x 21 codons (seed 3) for
FUBAR, MEME, PRIME and LEISR (as 63 nucleotides); ``tests/
test_torch_contrast_fel.py``'s two-set contrast alignment (8 taxa x 10
codons) for the contrast methods; ``tests/test_torch_fade.py``'s protein
alignment (8 taxa x 40 residues) for FADE and LEISR's protein model.  The
global fits are capped (``warmup``) and so are the stages' Nelder-Mead
runs (6 iterations): the stages only need a fit to start from, the same
one both ways, and a block gives the one batch's results after any number
of iterations."""

import contextlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import hyphy_tpu_torch.methods.common as tcommon
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.data.alignment import read_alignment
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
from hyphy_tpu_torch.methods import contrast_fel, contrast_meme, fade, fubar, leisr, meme, prime
from hyphy_tpu_torch.models import frequencies as tfreq
from hyphy_tpu_torch.models.codon import MG94Base
from hyphy_tpu_torch.models.protein import EmpiricalProtein
from hyphy_tpu_torch.ops import cuda_build
from hyphy_tpu_torch.ops import level_products as lp_mod
from hyphy_tpu_torch.optimize import batched, nelder_mead
from hyphy_tpu_torch.parallel import mesh as mesh_mod
from hyphy_tpu_torch.tree.topology import Tree
from hyphy_tpu_torch.utils.synth import random_tree_newick, synthetic_codon_alignment
from torch_carry import contrast_alignment, protein_alignment

torch.set_num_threads(2)

THREE = ("cpu",) * 3
REL = 1e-12
THETAS = dict(zip(("theta_AC", "theta_AT", "theta_CG", "theta_CT", "theta_GT"),
                  (0.4, 0.3, 0.6, 1.4, 0.5)))


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setattr(settings, "mesh", None)
    monkeypatch.setattr(settings, "warmup", True)
    # capped Nelder-Mead runs: the blocks must give the one batch's results
    # at any iteration count, and the CPU's fp64 eigh per item and
    # evaluation is what these tests pay for
    monkeypatch.setattr(nelder_mead, "_WARMUP_ITERATIONS", 6)
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")
    monkeypatch.delenv("HYPHY_TPU_MESH", raising=False)


def _write(path, names, seqs):
    path.write_text("".join(f">{n}\n{s}\n" for n, s in zip(names, seqs)))
    return str(path)


@pytest.fixture(scope="module")
def codon(tmp_path_factory):
    """The 6 x 21 codon fixture with its capped GTR and MG94 fits."""
    aln = synthetic_codon_alignment(6, 21, seed=3)
    newick = random_tree_newick(6, seed=3)
    fasta = _write(tmp_path_factory.mktemp("mesh_sites") / "tiny.fasta", aln.names,
                   aln.sequences)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(settings, "warmup", True)
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        data = tcommon.load_codon_data(fasta, tree_newick=newick, device="cpu")
        gtr = tcommon.fit_gtr(data)
        mg = tcommon.fit_partitioned_mg94(data, gtr)
    return SimpleNamespace(fasta=fasta, newick=newick, data=data, mg=mg)


@pytest.fixture(scope="module")
def contrast(tmp_path_factory):
    """The two-set contrast fixture with its capped global fits."""
    names, seqs, newick = contrast_alignment(8, 10, 3, [3, 2], ["FG", "REF"], (2, 5),
                                             mean_branch=0.2)
    fasta = _write(tmp_path_factory.mktemp("mesh_sites") / "contrast.fasta", names, seqs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(settings, "warmup", True)
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        data = contrast_fel.load_multigroup(fasta, "Universal", newick, ["FG", "REF"],
                                            device="cpu")
        _, mg = contrast_fel.global_fits(data, 1e-3)
    return SimpleNamespace(data=data, mg=mg)


@pytest.fixture(scope="module")
def protein():
    names, seqs, newick = protein_alignment(8, 40, 3)
    from hyphy_tpu_torch.data.alignment import Alignment

    filt = DataFilter.from_alignment(Alignment(names=names, sequences=seqs), "protein")
    return SimpleNamespace(filt=filt, tree=Tree.from_newick(newick, leaf_order=filt.names))


# -- each call site's stage, run unsharded and over three blocks ------------------


def _fubar_grid(codon, _contrast, _protein):
    data = codon.data
    gc = data.genetic_code
    corners, codon_freqs = tfreq.cf3x4(data.codon_filter, gc, device="cpu")
    model = MG94Base(gc, corners, codon_freqs, device="cpu")
    theta = {k: torch.tensor(v, dtype=torch.float64) for k, v in THETAS.items()}
    gp = fubar.grid_pruning(data, model, theta)
    grid = torch.as_tensor(fubar.alpha_beta_grid(20))
    times = torch.as_tensor(np.maximum(data.tree.input_lengths[:-1], 1e-3))

    def run():
        return {"sll": fubar.grid_pass(gp, grid, times)}
    return run


def _fade_grid(_codon, _contrast, protein):
    filt, tree = protein.filt, protein.tree
    mdl = EmpiricalProtein("WAG", frequencies=tfreq.empirical_character(filt), device="cpu")
    t_hat = torch.as_tensor(np.maximum(tree.input_lengths[:-1], 1e-3))
    gp = fade.grid_pruning(mdl, filt, tree, t_hat, tree.select_branches("All"))
    grid = torch.as_tensor(fade.define_grid(10))

    def run():
        return {"sll": fade.grid_pass(gp, grid, 8)}
    return run


def _meme_sites(codon):
    data, mgp = codon.data, codon.mg
    sites = meme.mixture_sites(data, mgp, torch.float64, spectral=True, rate_classes=2)
    specs = meme._specs(2, bool((~data.tested_branches).any()), {})
    return data, sites, specs


def _meme_stages(codon, _contrast, _protein):
    data, sites, specs = _meme_sites(codon)

    def run():
        fel_fit, alt, null = meme.site_pipeline(sites, specs, {}, False,
                                                data.codon_filter.n_patterns, "cpu")
        return dict({f"fel_{k}": v for k, v in fel_fit.items()},
                    **{f"alt_{k}": v for k, v in alt.items()},
                    **{f"null_{k}": v for k, v in null.items()})
    return run


def _meme_ebf(codon, _contrast, _protein):
    data, sites, specs = _meme_sites(codon)
    n = data.codon_filter.n_patterns
    rng = np.random.default_rng(5)
    alt = {"alpha": rng.uniform(0.2, 2.0, n), "beta_plus": rng.uniform(0.5, 5.0, n),
           "omega_1": rng.uniform(0.0, 1.0, n), "w_1": rng.uniform(0.2, 0.9, n)}
    alt = {k: torch.as_tensor(v) for k, v in alt.items()}
    with torch.no_grad():
        alt["lnl"] = sites.loglik(torch.arange(n), alt)
    tested_idx = np.nonzero(data.tested_branches)[0]

    def run():
        return {"ebf": torch.as_tensor(meme.branch_ebfs(sites, alt, tested_idx))}
    return run


def _contrast_fel(_codon, contrast, _protein):
    def run():
        keys = ("alpha", "betas", "alt_lnl", "null_lnl", "pair_lnl")
        return {k: torch.as_tensor(v) for k, v in
                zip(keys, contrast_fel.fit_sites(contrast.data, contrast.mg, srv=True))}
    return run


def _contrast_meme_fits(_codon, contrast, _protein):
    def run():
        return {k: torch.as_tensor(v)
                for k, v in contrast_meme.fit_sites(contrast.data, contrast.mg, True).items()}
    return run


def _contrast_meme_permutation(_codon, contrast, _protein):
    groups = np.asarray(contrast.data.branch_groups)
    rng = np.random.default_rng(2)
    job_sites = np.array([2, 5, 7])                # three sites, one permutation each
    job_groups = np.stack([rng.permutation(groups) for _ in job_sites])

    def run():
        return {"lrt": torch.as_tensor(contrast_meme.permutation_lrts(
            contrast.data, contrast.mg, True, job_sites, job_groups))}
    return run


def _prime(codon, _contrast, _protein):
    dists = torch.as_tensor(np.stack(prime.property_distance_tensors(codon.data.genetic_code)))

    def run():
        return {k: torch.as_tensor(v) for k, v in prime.fit_sites(codon.data, codon.mg,
                                                                  dists).items()}
    return run


def _leisr(filt, tree, mdl):
    lf = LikelihoodFunction([Partition(filt, tree, mdl)], device="cpu")
    res = leisr.fit_baseline(lf, tree, 1e-3)

    loglik_on = leisr.site_log_likelihood_on(mdl, res.params, filt, tree, torch.float64,
                                             spectral=True)

    def run():
        keys = ("r", "lo", "hi", "global", "local")
        out = leisr.fit_sites(loglik_on, filt.n_patterns,
                              leisr._site_bytes(tree, torch.float64, mdl.n_states), "cpu")
        return {k: torch.as_tensor(v) for k, v in zip(keys, out)}
    return run


def _leisr_nucleotide(codon, _contrast, _protein):
    filt = DataFilter.from_alignment(read_alignment(codon.fasta), "nucleotide")
    tree = Tree.from_newick(codon.newick, leaf_order=filt.names)
    return _leisr(filt, tree, leisr._nucleotide_model("GTR", filt, "cpu"))


def _leisr_protein(_codon, _contrast, protein):
    mdl = EmpiricalProtein("LG", frequencies=tfreq.empirical_character(protein.filt),
                           device="cpu")
    return _leisr(protein.filt, protein.tree, mdl)


SITES = {
    "fubar_grid": _fubar_grid, "fade_grid": _fade_grid, "meme_stages": _meme_stages,
    "meme_ebf": _meme_ebf, "contrast_fel": _contrast_fel,
    "contrast_meme_fits": _contrast_meme_fits,
    "contrast_meme_permutation": _contrast_meme_permutation, "prime": _prime,
    "leisr_nucleotide": _leisr_nucleotide, "leisr_protein": _leisr_protein,
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_stage_sharded_equals_unsharded(site, codon, contrast, protein, monkeypatch):
    run = SITES[site](codon, contrast, protein)
    blocks = []
    original = batched.chunked_site_solve

    def recorded(solver, n_items, *args, **kwargs):
        blocks.append((threading.get_ident(), n_items))
        return original(solver, n_items, *args, **kwargs)

    monkeypatch.setattr(batched, "chunked_site_solve", recorded)
    one = run()
    assert len(blocks) >= 1 and all(t == threading.get_ident() for t, _ in blocks)
    n_solves = len(blocks)
    blocks.clear()
    monkeypatch.setattr(settings, "mesh", THREE)
    sharded = run()
    # every solve split into three blocks, none run on the calling thread
    assert len(blocks) == 3 * n_solves
    assert all(t != threading.get_ident() for t, _ in blocks)
    assert sorted(one) == sorted(sharded)
    for k in one:
        a, b = sharded[k].double().numpy(), one[k].double().numpy()
        assert a.shape == b.shape, k
        # a grid point of zero rates gives -inf at variable sites, as it does
        # in the reference; the infinities must fall on the same entries
        assert not np.isnan(b).any() and (b.size == 0 or np.isfinite(b).any()), k
        np.testing.assert_allclose(a, b, rtol=REL, atol=0, err_msg=k)


# -- the threaded solve itself ------------------------------------------------------


def test_failing_block_fails_the_solve_after_the_others(monkeypatch):
    """The middle block raises at once; the solve raises it in the caller
    only once the two others, slower, have ended."""
    ended = []

    def make_solver(dev):
        def solver(idx):
            if int(idx[0]) == 4:
                raise FloatingPointError("block 1")
            time.sleep(0.2)
            ended.append(int(idx[0]))
            return {"x": idx.double()}
        return solver

    monkeypatch.setattr(settings, "mesh", THREE)
    with pytest.raises(FloatingPointError, match="block 1"):
        mesh_mod.sharded_site_solve(make_solver, 12, 1.0, "cpu")
    assert sorted(ended) == [0, 8]


@pytest.mark.parametrize("grad", [True, False])
def test_callers_grad_mode_reaches_every_block(monkeypatch, grad):
    seen = []

    def make_solver(dev):
        def solver(idx):
            seen.append((torch.is_grad_enabled(), threading.get_ident()))
            return {"x": idx.double()}
        return solver

    monkeypatch.setattr(settings, "mesh", THREE)
    with torch.set_grad_enabled(grad):
        out = mesh_mod.sharded_site_solve(make_solver, 9, 1.0, "cpu")
    np.testing.assert_array_equal(out["x"].numpy(), np.arange(9))
    assert [g for g, _ in seen] == [grad] * 3
    assert threading.get_ident() not in {t for _, t in seen}


def test_blocks_sharing_a_card_split_its_free_memory(monkeypatch):
    """Free memory is read once per card, before the blocks run, and each
    block's chunks are sized from its share; the host takes every item."""
    reads = []

    def mem_get_info(device=None):
        reads.append(str(device))
        return (80e9, 85e9)

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    cards = [torch.device("cuda", 0), torch.device("cuda", 0), torch.device("cuda", 1),
             torch.device("cpu")]
    blocks = mesh_mod.shards(40, cards)
    budgets = mesh_mod.block_budgets(blocks)
    assert budgets == [40e9, 40e9, 80e9, None]
    assert sorted(reads) == ["cuda:0", "cuda:1"]
    # half of a 40 GB share at 1 GB per item: 20 items, memory read no more
    assert batched.site_chunk(100, 1e9, cards[0], free=budgets[0]) == 20
    assert batched.site_chunk(100, 1e9, cards[2], free=budgets[2]) == 40
    assert batched.site_chunk(100, 1e9, "cpu") == 100
    assert len(reads) == 2


def test_launch_count_exact_under_threads(monkeypatch):
    """Three blocks each launching K1 2000 times at once (a stand-in for
    the compiled library, the wrapper's own count): none is lost."""
    def fake_entry(*args):
        return 0

    lib = SimpleNamespace(level_products_f32=fake_entry, level_products_f64=fake_entry)
    monkeypatch.setattr(cuda_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    cc, cp = torch.zeros(1, 2, 4, 4, dtype=torch.float64), torch.zeros(1, 2, 4, 4,
                                                                       dtype=torch.float64)

    def make_solver(dev):
        def solver(idx):
            for _ in range(2000):
                lp_mod._launch(cc, cp)
            return {"x": idx.double()}
        return solver

    monkeypatch.setattr(settings, "mesh", THREE)
    before = lp_mod.level_products.launches
    mesh_mod.sharded_site_solve(make_solver, 3, 1.0, "cpu")
    assert lp_mod.level_products.launches - before == 6000
