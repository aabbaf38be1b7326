"""The port's command line (``python -m hyphy_tpu_torch``) against the JAX
package's on the tiny fixture of ``tests/test_fast_methods.py``: the same
``fel`` flags, and a result JSON with the same top-level keys, headers and
rows.  Called in-process with ``settings.device = "cpu"``."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from hyphy_tpu import cli as jcli
from hyphy_tpu.utils import synth as jsynth
from hyphy_tpu_torch import cli
from hyphy_tpu_torch.config import settings

torch.set_num_threads(2)

N_TAXA, N_CODONS, SEED = 6, 20, 11


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    aln = jsynth.synthetic_codon_alignment(N_TAXA, N_CODONS, seed=SEED)
    d = tmp_path_factory.mktemp("cli")
    fa = d / "tiny.fasta"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    tree = d / "tiny.nwk"
    tree.write_text(jsynth.random_tree_newick(N_TAXA, seed=SEED))
    return {"fasta": str(fa), "tree": str(tree), "dir": d}


def _fel_flags(parser, method="fel"):
    sub = parser._subparsers._group_actions[0].choices[method]
    return sorted((a.dest, tuple(a.option_strings), a.default, tuple(a.choices or ()))
                  for a in sub._actions)


def test_fel_flags_match_the_jax_cli():
    assert _fel_flags(cli.build_parser()) == _fel_flags(jcli.build_parser())


@pytest.mark.parametrize("method", ["slac", "meme", "simulate", "fubar", "b-still",
                                    "contrast-fel", "contrast-meme", "prime", "busted",
                                    "busted-ph", "error-filter", "clade-support", "relax",
                                    "absrel", "fmm", "leisr", "fade", "bgm", "gard"])
def test_method_flags_match_the_jax_cli(method):
    assert _fel_flags(cli.build_parser(), method) == _fel_flags(jcli.build_parser(), method)


def test_fel_cli_json_matches_the_jax_cli(tiny):
    ours_path, ref_path = tiny["dir"] / "port.json", tiny["dir"] / "jax.json"
    argv = ["fel", "--alignment", tiny["fasta"], "--tree", tiny["tree"]]
    assert cli.main(argv + ["--output", str(ours_path)]) == 0
    assert jcli.main(argv + ["--output", str(ref_path)]) == 0
    ours, ref = json.loads(ours_path.read_text()), json.loads(ref_path.read_text())
    assert sorted(ours) == sorted(ref)
    assert ours["MLE"]["headers"] == ref["MLE"]["headers"]
    table = np.asarray(ours["MLE"]["content"]["0"])
    assert table.shape == np.asarray(ref["MLE"]["content"]["0"]).shape == (N_CODONS, 6)
    assert np.isfinite(table).all()
    assert ours["timers"]["Total time"]["timer"] >= 0


def test_warmup_restores_state_and_spares_results(tiny):
    assert cli.main(["warmup", "fel", "--alignment", tiny["fasta"], "--tree", tiny["tree"]]) == 0
    assert settings.warmup is False
    warm = json.loads(open(f"{tiny['fasta']}.FEL.warmup.json").read())
    assert np.asarray(warm["MLE"]["content"]["0"]).shape == (N_CODONS, 6)


def test_module_entry_point_parses():
    out = subprocess.run([sys.executable, "-m", "hyphy_tpu_torch", "fel", "--help"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--multiple-hits" in out.stdout


def test_busted_family_and_post_processors_run_on_the_cpu(tiny):
    """``prime``, ``busted --error-sink`` then ``error-filter`` on its JSON,
    and ``busted-ph`` then ``clade-support`` on its JSON, in-process on the
    CPU (the method runs capped under ``warmup``)."""
    d = tiny["dir"]
    tree = open(tiny["tree"]).read().strip()
    labelled = tree.replace("t0:", "t0{FG}:").replace("t1:", "t1{FG}:")
    base = ["--alignment", tiny["fasta"]]
    prime_json, busted_json, ph_json = d / "p.json", d / "b.json", d / "ph.json"
    assert cli.main(["warmup", "prime"] + base + ["--tree", tree, "--output", str(prime_json)]) == 0
    table = np.asarray(json.loads(prime_json.read_text())["MLE"]["content"]["0"])
    assert table.shape == (N_CODONS, 18) and np.isfinite(table).all()
    assert cli.main(["warmup", "busted"] + base + ["--tree", tree, "--output", str(busted_json),
                                                   "--error-sink", "--srv", "No"]) == 0
    masked = d / "masked.fasta"
    assert cli.main(["error-filter", "--json", str(busted_json), "--output", str(masked)]) == 0
    seqs = [ln for ln in masked.read_text().splitlines() if ln and not ln.startswith(">")]
    assert all(len(x) == 3 * N_CODONS for x in seqs[:N_TAXA])
    assert json.loads((d / "b.json.filter.json").read_text())["filter"].keys()
    assert cli.main(["warmup", "busted-ph"] + base + ["--tree", labelled, "--branches", "FG",
                                                      "--output", str(ph_json), "--srv", "No"]) == 0
    assert "BUSTED-PH" in json.loads(ph_json.read_text())
    assert cli.main(["clade-support", "--json", str(ph_json)]) == 0
    assert json.loads((d / "ph.json.ECB.json").read_text())["0"]["perplexity"] >= 1.0
