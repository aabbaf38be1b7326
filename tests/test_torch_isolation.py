"""The port stands alone: it imports neither ``jax`` nor ``hyphy_tpu``, and
its entry points do not fall back to the CPU when CUDA is missing."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "hyphy_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import hyphy_tpu_torch
for mod in pkgutil.walk_packages(hyphy_tpu_torch.__path__, "hyphy_tpu_torch."):
    importlib.import_module(mod.name)
leaked = sorted(m for m in sys.modules
                if m == "hyphy_tpu" or m.startswith("hyphy_tpu."))
print("LEAKED", leaked)
print("LOADED", sorted(m for m in sys.modules if m.startswith("hyphy_tpu_torch.")))
"""

# modules added with FEL's options and CHARSET partitions, with SLAC, MEME
# and simulate, with FUBAR, B-STILL and the contrast methods, with PRIME and
# the BUSTED family, with RELAX and aBSREL, with the protein models,
# LEISR, FADE and FitMultiModel, with BGM and GARD, and with the rest of the
# engine (constraints, the binary model, rate variation, linear algebra, the
# SCFG, alignment, random deviates and the host C++ kernels), and with the
# device mesh, which the walk above must reach
_NEW_MODULES = ["hyphy_tpu_torch.utils.simulate", "hyphy_tpu_torch.optimize.batched",
                "hyphy_tpu_torch.methods.fel", "hyphy_tpu_torch.io.json_out",
                "hyphy_tpu_torch.ops.ancestral", "hyphy_tpu_torch.methods.counting",
                "hyphy_tpu_torch.methods.slac", "hyphy_tpu_torch.methods.meme",
                "hyphy_tpu_torch.methods.simulate", "hyphy_tpu_torch.utils.synth",
                "hyphy_tpu_torch.methods.grid_bayes", "hyphy_tpu_torch.methods.fubar",
                "hyphy_tpu_torch.methods.bstill", "hyphy_tpu_torch.methods.contrast_fel",
                "hyphy_tpu_torch.methods.contrast_meme", "hyphy_tpu_torch.methods.prime",
                "hyphy_tpu_torch.methods.busted", "hyphy_tpu_torch.methods.bustedph",
                "hyphy_tpu_torch.methods.error_filter", "hyphy_tpu_torch.methods.clade_support",
                "hyphy_tpu_torch.models.bsrel", "hyphy_tpu_torch.ops.hmm",
                "hyphy_tpu_torch.io.serialize", "hyphy_tpu_torch.methods.relax",
                "hyphy_tpu_torch.methods.absrel", "hyphy_tpu_torch.models.protein",
                "hyphy_tpu_torch.methods.leisr", "hyphy_tpu_torch.methods.fade",
                "hyphy_tpu_torch.methods.fmm", "hyphy_tpu_torch.methods.bgm",
                "hyphy_tpu_torch.methods.gard", "hyphy_tpu_torch.models.constraints",
                "hyphy_tpu_torch.models.binary", "hyphy_tpu_torch.models.rate_variation",
                "hyphy_tpu_torch.ops.linalg", "hyphy_tpu_torch.scfg", "hyphy_tpu_torch.align",
                "hyphy_tpu_torch.utils.random", "hyphy_tpu_torch.native",
                "hyphy_tpu_torch.parallel.mesh"]


def test_imports_without_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout
    loaded = out.stdout.split("LOADED", 1)[1]
    for name in _NEW_MODULES:
        assert repr(name) in loaded, name


def test_sources_reference_neither_jax_nor_the_jax_package():
    bad = re.compile(
        r"^\s*(import|from)\s+jax\b|\bhyphy_tpu\.|from\s+hyphy_tpu\s|import\s+hyphy_tpu\b"
    )
    offenders = []
    for path in [*PACKAGE.rglob("*.py"), REPO / "chip_smoke.py"]:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            # references to the port itself are allowed
            if bad.search(line.replace("hyphy_tpu_torch", "")):
                offenders.append(f"{path.relative_to(REPO)}:{n}: {line.strip()}")
    assert not offenders, "\n".join(offenders)


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from hyphy_tpu_torch import cli
    from hyphy_tpu_torch.config import settings
    from hyphy_tpu_torch.data.filter import DataFilter
    from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
    from hyphy_tpu_torch.methods import fel
    from hyphy_tpu_torch.methods.common import load_codon_data_multi
    from hyphy_tpu_torch.models.dna import GTR
    from hyphy_tpu_torch.optimize.core import maximize
    from hyphy_tpu_torch.tree.topology import Tree
    from hyphy_tpu_torch.utils.synth import random_tree_newick, synthetic_codon_alignment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(settings, "device", "cuda")
    aln = synthetic_codon_alignment(4, 5, seed=1)
    filt = DataFilter.from_alignment(aln, "nucleotide")
    tree = Tree.from_newick(random_tree_newick(4, seed=1), leaf_order=filt.names)
    model = GTR(np.full(4, 0.25), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LikelihoodFunction([Partition(filt, tree, model)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GTR(np.full(4, 0.25))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        maximize(lambda p: -p["x"] ** 2, {}, {})
    fasta = tmp_path / "a.fasta"
    fasta.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    newick = random_tree_newick(4, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fel.run(str(fasta), tree=newick)
    out = tmp_path / "a.json"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["fel", "--alignment", str(fasta), "--tree", newick, "--output", str(out)])
    assert not out.exists()
    # the options and CHARSET partitions take the same road
    nexus = tmp_path / "parts.nex"
    nexus.write_text(
        "#NEXUS\nBEGIN DATA;\nDIMENSIONS NTAX=4 NCHAR=15;\nFORMAT DATATYPE=DNA;\nMATRIX\n"
        + "".join(f"{n} {s}\n" for n, s in zip(aln.names, aln.sequences))
        + ";\nEND;\nBEGIN ASSUMPTIONS;\nCHARSET one = 1-6;\nCHARSET two = 7-15;\nEND;\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_codon_data_multi(str(nexus), tree_newick=newick)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["fel", "--alignment", str(nexus), "--tree", newick, "--output", str(out),
                  "--ci", "Yes", "--resample", "2", "--multiple-hits", "Double+Triple"])
    assert not out.exists()
    # asking for the CPU is the only way onto it
    lf = LikelihoodFunction([Partition(filt, tree, model)], device="cpu")
    assert lf.device.type == "cpu" and lf.dtype == torch.float64


@pytest.mark.parametrize("method", ["slac", "meme", "simulate"])
def test_new_entry_points_raise_without_cuda(monkeypatch, tmp_path, method):
    """SLAC, MEME and simulate, called as functions and through the CLI:
    they raise without CUDA, and run on the CPU only when asked."""
    import importlib

    from hyphy_tpu_torch import cli
    from hyphy_tpu_torch.config import settings
    from hyphy_tpu_torch.utils.synth import random_tree_newick, synthetic_codon_alignment

    module = importlib.import_module(f"hyphy_tpu_torch.methods.{method}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(settings, "device", "cuda")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")
    aln = synthetic_codon_alignment(4, 5, seed=1)
    fasta = tmp_path / "a.fasta"
    fasta.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    newick = random_tree_newick(4, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.run(str(fasta), tree=newick)
    out = tmp_path / "a.json"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([method, "--alignment", str(fasta), "--tree", newick, "--output", str(out)])
    assert not out.exists()
    # asking for the CPU is the only way onto it
    result = module.run(str(fasta), tree=newick, device="cpu")
    assert "fits" in result.json


@pytest.mark.parametrize("method", ["fubar", "b-still", "contrast-fel", "contrast-meme"])
def test_grid_and_contrast_entry_points_raise_without_cuda(monkeypatch, tmp_path, method):
    """FUBAR, B-STILL and the contrast methods through the CLI, plain and
    under ``warmup``: they raise without CUDA, and run on the CPU only when
    asked (here the capped ``warmup`` run, on a labelled 5-taxon tree)."""
    import json

    from hyphy_tpu_torch import cli
    from hyphy_tpu_torch.config import settings
    from hyphy_tpu_torch.utils.synth import synthetic_codon_alignment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(settings, "device", "cuda")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")
    aln = synthetic_codon_alignment(5, 4, seed=2)
    fasta = tmp_path / "a.fasta"
    fasta.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    newick = "((t0{FG}:0.1,t1{FG}:0.2){FG}:0.05,(t2{REF}:0.1,t3:0.15):0.1,t4:0.2)"
    out = tmp_path / "a.json"
    argv = [method, "--alignment", str(fasta), "--tree", newick, "--output", str(out)]
    argv += {"fubar": ["--grid", "5"], "b-still": ["--grid", "5"],
             "contrast-fel": ["--branch-set", "FG", "--branch-set", "REF"],
             "contrast-meme": ["--branch-set", "FG", "--branch-set", "REF",
                               "--permutations", "1", "--pvalue", "1"]}[method]
    for prefix in ([], ["warmup"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(prefix + argv)
        assert not out.exists()
    # asking for the CPU is the only way onto it
    monkeypatch.setattr(settings, "device", "cpu")
    assert cli.main(["warmup"] + argv) == 0
    assert "fits" in json.loads(out.read_text())


@pytest.mark.parametrize("method", ["prime", "busted", "busted-ph"])
def test_prime_and_busted_entry_points_raise_without_cuda(monkeypatch, tmp_path, method):
    """PRIME, BUSTED and BUSTED-PH through the CLI, plain and under
    ``warmup``, and as functions: they raise without CUDA, and run on the
    CPU only when asked (the capped ``warmup`` run, on a labelled 5-taxon
    tree)."""
    import importlib
    import json

    from hyphy_tpu_torch import cli
    from hyphy_tpu_torch.config import settings
    from hyphy_tpu_torch.utils.synth import synthetic_codon_alignment

    module = importlib.import_module(
        f"hyphy_tpu_torch.methods.{method.replace('-', '')}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(settings, "device", "cuda")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")
    aln = synthetic_codon_alignment(5, 4, seed=2)
    fasta = tmp_path / "a.fasta"
    fasta.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    newick = "((t0{FG}:0.1,t1{FG}:0.2){FG}:0.05,(t2:0.1,t3:0.15):0.1,t4:0.2)"
    out = tmp_path / "a.json"
    argv = [method, "--alignment", str(fasta), "--tree", newick, "--output", str(out)]
    argv += ["--branches", "FG"] if method == "busted-ph" else []
    for prefix in ([], ["warmup"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(prefix + argv)
        assert not out.exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.run(str(fasta), tree=newick)
    monkeypatch.setattr(settings, "device", "cpu")
    assert cli.main(["warmup"] + argv) == 0
    assert "fits" in json.loads(out.read_text())


@pytest.mark.parametrize("method, flags", [
    ("relax", ["--test", "FG", "--models", "Minimal"]),
    ("relax", ["--groups", "FG,REF,Unlabeled", "--reference", "Unlabeled"]),
    ("absrel", ["--srv", "Yes"]),
], ids=["relax", "relax-groups", "absrel"])
def test_relax_and_absrel_entry_points_raise_without_cuda(monkeypatch, tmp_path, method, flags):
    """RELAX (classic and group mode) and aBSREL through the CLI, plain and
    under ``warmup``, and as functions: they raise without CUDA, and run on
    the CPU only when asked (the capped ``warmup`` run, on a labelled
    5-taxon tree)."""
    import importlib
    import json

    from hyphy_tpu_torch import cli
    from hyphy_tpu_torch.config import settings
    from hyphy_tpu_torch.utils.synth import synthetic_codon_alignment

    module = importlib.import_module(f"hyphy_tpu_torch.methods.{method}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(settings, "device", "cuda")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")
    aln = synthetic_codon_alignment(5, 4, seed=2)
    fasta = tmp_path / "a.fasta"
    fasta.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    newick = "((t0{FG}:0.1,t1{FG}:0.2){FG}:0.05,(t2{REF}:0.1,t3:0.15):0.1,t4:0.2)"
    out = tmp_path / "a.json"
    argv = [method, "--alignment", str(fasta), "--tree", newick, "--output", str(out)] + flags
    for prefix in ([], ["warmup"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(prefix + argv)
        assert not out.exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.run(str(fasta), tree=newick)
    monkeypatch.setattr(settings, "device", "cpu")
    assert cli.main(["warmup"] + argv) == 0
    assert "fits" in json.loads(out.read_text())


_PROTEIN_RUNS = """
import builtins, json, sys
import torch
torch.set_num_threads(2)           # beside the other test workers
sys.modules["jax"] = None
sys.modules["hyphy_tpu"] = None    # nor the JAX package, its data files included
opened = []
_open = builtins.open
def spy(path, *args, **kwargs):
    opened.append(str(path))
    return _open(path, *args, **kwargs)
builtins.open = spy
from hyphy_tpu_torch import cli
from hyphy_tpu_torch.config import settings
settings.device = "cpu"
d = sys.argv[1]
for argv in (["leisr", "--alignment", d + "/p.fasta", "--tree", d + "/p.nwk", "--type", "protein",
              "--model", "LG"],
             ["leisr", "--alignment", d + "/c.fasta", "--tree", d + "/c.nwk"],
             ["fade", "--alignment", d + "/p.fasta", "--tree", d + "/p.nwk", "--grid", "5"],
             ["fmm", "--alignment", d + "/c.fasta", "--tree", d + "/c.nwk"]):
    out = d + "/" + argv[0] + ".json"
    assert cli.main(["warmup"] + argv + ["--output", out]) == 0
    print(argv[0], sorted(json.load(_open(out))))
matrices = [p for p in opened if "resources" in p]
print("MATRICES", matrices)
assert matrices and all("hyphy_tpu_torch/resources/protein/" in p for p in matrices), matrices
leaked = sorted(m for m in sys.modules if m == "hyphy_tpu" and sys.modules[m] is not None)
print("LEAKED", leaked)
"""


def test_protein_and_fmm_commands_run_without_jax(tmp_path):
    """``leisr`` (protein and nucleotide), ``fade`` and ``fmm`` through the
    port's CLI under ``warmup`` on the CPU in a process where ``jax`` and
    the JAX package cannot be imported; the protein matrices are read from
    the port's own ``resources/``."""
    from hyphy_tpu_torch.utils.synth import random_tree_newick, synthetic_codon_alignment

    amino = "ACDEFGHIKLMNPQRSTVWY"
    rng = np.random.default_rng(4)
    names = [f"t{i}" for i in range(5)]
    seqs = ["".join(amino[k] for k in rng.integers(0, 20, size=12)) for _ in names]
    (tmp_path / "p.fasta").write_text("".join(f">{n}\n{s}\n" for n, s in zip(names, seqs)))
    (tmp_path / "p.nwk").write_text(random_tree_newick(5, seed=4))
    aln = synthetic_codon_alignment(5, 6, seed=4)
    (tmp_path / "c.fasta").write_text(
        "".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    (tmp_path / "c.nwk").write_text(random_tree_newick(5, seed=4))
    out = subprocess.run(
        [sys.executable, "-c", _PROTEIN_RUNS, str(tmp_path)], cwd=REPO, capture_output=True,
        text=True, timeout=600,
        env={**os.environ, "HYPHY_TPU_PROGRESS": "0", "OMP_NUM_THREADS": "2"},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LEAKED []" in out.stdout
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines() if " [" in line)
    assert "'MLE'" in lines["leisr"] and "'MLE'" in lines["fade"]
    assert "'site annotations'" in lines["fade"] and "'test results'" in lines["fmm"]
    assert "LG.json" in lines["MATRICES"] and "WAG.json" in lines["MATRICES"]


@pytest.mark.parametrize("method, flags", [
    ("leisr", ["--type", "protein", "--model", "WAG"]),
    ("fade", ["--grid", "5"]),
    ("fmm", []),
])
def test_protein_and_fmm_entry_points_raise_without_cuda(monkeypatch, tmp_path, method, flags):
    """LEISR, FADE and FitMultiModel through the CLI, plain and under
    ``warmup``, and as functions: they raise without CUDA."""
    import importlib

    from hyphy_tpu_torch import cli
    from hyphy_tpu_torch.config import settings
    from hyphy_tpu_torch.utils.synth import random_tree_newick, synthetic_codon_alignment

    module = importlib.import_module(f"hyphy_tpu_torch.methods.{method}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(settings, "device", "cuda")
    if method == "fmm":
        aln = synthetic_codon_alignment(4, 5, seed=1)
        names, seqs = aln.names, aln.sequences
    else:
        names = [f"t{i}" for i in range(4)]
        seqs = ["ACDEFGHIKL", "ACDEFGHIKW", "ACDQFGHIKL", "YCDEFGHIKL"]
    fasta = tmp_path / "a.fasta"
    fasta.write_text("".join(f">{n}\n{s}\n" for n, s in zip(names, seqs)))
    newick = random_tree_newick(4, seed=1)
    out = tmp_path / "a.json"
    argv = [method, "--alignment", str(fasta), "--tree", newick, "--output", str(out)] + flags
    for prefix in ([], ["warmup"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(prefix + argv)
        assert not out.exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.run(str(fasta), tree=newick)


@pytest.mark.parametrize("method", ["bgm", "gard"])
def test_bgm_and_gard_entry_points_raise_without_cuda(monkeypatch, tmp_path, method):
    """BGM and GARD through the CLI, plain and under ``warmup``, and as
    functions: they raise without CUDA, and run on the CPU only when asked
    (BGM with a short chain, GARD with one breakpoint at most)."""
    import importlib
    import json

    from hyphy_tpu_torch import cli
    from hyphy_tpu_torch.config import settings
    from hyphy_tpu_torch.utils.synth import random_tree_newick, synthetic_codon_alignment

    module = importlib.import_module(f"hyphy_tpu_torch.methods.{method}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(settings, "device", "cuda")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")
    aln = synthetic_codon_alignment(5, 6, seed=3)
    fasta = tmp_path / "a.fasta"
    fasta.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    newick = random_tree_newick(5, seed=3)
    out = tmp_path / "a.json"
    if method == "bgm":
        argv = ["bgm", "--alignment", str(fasta), "--tree", newick, "--output", str(out),
                "--steps", "300", "--burn-in", "30", "--samples", "10"]
        call = dict(tree=newick)
    else:
        argv = ["gard", "--alignment", str(fasta), "--output", str(out),
                "--max-breakpoints", "1"]
        call = {}
    for prefix in ([], ["warmup"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(prefix + argv)
        assert not out.exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.run(str(fasta), **call)
    monkeypatch.setattr(settings, "device", "cpu")
    assert cli.main(argv) == 0
    result = json.loads(out.read_text())
    assert ("fits" in result and "MLE" in result) if method == "bgm" else (
        "breakpointData" in result and result["input"]["number of sequences"] == 5)


def test_engine_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The binary and codon models and the likelihood function raise
    without CUDA; asked for the CPU, the constrained fit, the covariance,
    the profile CI and the marginal posteriors run there, on the plain
    version of K1 (no launch); a failed build of the host C++ kernels
    raises, and GARD's TN93 then raises too instead of taking its NumPy
    mirror."""
    from hyphy_tpu_torch.config import settings
    from hyphy_tpu_torch.data.alignment import Alignment
    from hyphy_tpu_torch.data.filter import DataFilter
    from hyphy_tpu_torch.data.genetic_code import GeneticCode
    from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
    from hyphy_tpu_torch.methods import gard
    from hyphy_tpu_torch.models import frequencies
    from hyphy_tpu_torch.models.binary import Binary
    from hyphy_tpu_torch.models.codon import MG94xREV, MG94xREVLocal
    from hyphy_tpu_torch.models.constraints import MolecularClock, Proportional
    from hyphy_tpu_torch.models.dna import GTR
    from hyphy_tpu_torch.ops import ancestral, cuda_build, level_products, pruning
    from hyphy_tpu_torch.tree.topology import Tree
    from hyphy_tpu_torch.utils.synth import synthetic_codon_alignment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(settings, "device", "cuda")
    aln = Alignment(["a", "b", "c", "d"], ["0101100110", "0101110110", "1101100010",
                                           "1001101010"])
    filt = DataFilter.from_alignment(aln, "binary")
    tree = Tree.from_newick("((a,b),(c,d))", leaf_order=filt.names)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Binary([0.5, 0.5])
    codons = synthetic_codon_alignment(4, 5, seed=1)
    cfilt = DataFilter.from_alignment(codons, "codon")
    gc = GeneticCode("Universal")
    corners, freqs = frequencies.f1x4(cfilt, gc)
    for cls in (MG94xREV, MG94xREVLocal):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(gc, corners, freqs)
    model = Binary([0.5, 0.5], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LikelihoodFunction([Partition(filt, tree, model)])
    lf = LikelihoodFunction([Partition(filt, tree, model)], device="cpu")
    before = level_products.level_products.launches
    res = lf.fit(max_iterations=3, constraints=[MolecularClock(tree)])
    assert res.params["t"].device.type == "cpu"
    cov, _ = lf.covariance_matrix(res.params, keys=["t"])
    assert np.isfinite(cov).all()
    nfilt = DataFilter.from_alignment(codons, "nucleotide")
    ntree = Tree.from_newick("((t0,t1),(t2,t3))", leaf_order=nfilt.names)
    gtr_lf = LikelihoodFunction([Partition(nfilt, ntree, GTR(np.full(4, 0.25), device="cpu"))],
                                device="cpu")
    gres = gtr_lf.fit(max_iterations=3,
                      constraints=[Proportional("theta_AC", "theta_AT", ratio=2.0)])
    lo, hi = gtr_lf.profile_ci(gres.params, "theta_CT", gres.loglik)
    assert lo <= float(gres.params["theta_CT"]) <= hi
    out = model.build(res.params, tree.n_branches)
    post = ancestral.marginal_posteriors(
        out.p_matrices, torch.as_tensor(filt.leaf_partials()), out.root_freqs,
        pruning.build_pruning_data(tree, "cpu"))
    assert post.device.type == "cpu"
    assert level_products.level_products.launches == before
    # the host kernels: a failed build raises, with no NumPy fallback
    (tmp_path / "datapath.cpp").write_text("int broken(;\n")
    monkeypatch.setattr(cuda_build, "NATIVE", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="failed for"):
        gard.tn93_distance(DataFilter.from_alignment(codons, "nucleotide"))
    assert gard.tn93_distance(DataFilter.from_alignment(codons, "nucleotide"),
                              use_native=False).shape == (4, 4)
