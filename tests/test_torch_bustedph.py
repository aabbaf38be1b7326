"""The port's BUSTED-PH against the JAX package's on an alignment
simulated along an 8-taxon tree with a 3-leaf clade labelled FG, omega 5
on FG at every sixth codon (``torch_carry.contrast_alignment``; no
synonymous rate variation, to keep the JAX run near a minute): the three
tests' fits no worse than the JAX package's by 0.15 lnL, their LRTs within
0.3 and p-values on the same side of 0.05, the same verdict; and
``clade-support`` of both packages on the port's BUSTED-PH JSON (the same
perplexity and clade weights, 1e-12)."""

import json

import numpy as np
import pytest
import torch

from hyphy_tpu.methods import bustedph as jbustedph
from hyphy_tpu.methods import clade_support as jclade_support
from hyphy_tpu.utils import synth as jsynth
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.methods import bustedph, clade_support
from torch_carry import contrast_alignment

torch.set_num_threads(2)

OPTIONS = dict(srv=False, starting_points=2, precision=1e-3)


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    names, seqs, newick = contrast_alignment(8, 40, seed=3, clade_sizes=[3], labels=["FG"],
                                             planted=list(range(0, 40, 6)), mean_branch=0.1)
    d = tmp_path_factory.mktemp("bustedph")
    fa = d / "a.fasta"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in zip(names, seqs)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        mp.setenv("HYPHY_TPU_MESH", "off")
        ref = jbustedph.run(str(fa), tree=newick, branches="FG", **OPTIONS)
    ours = bustedph.run(str(fa), tree=newick, branches="FG", device="cpu", **OPTIONS)
    path = d / "port.json"
    path.write_text(json.dumps(ours.json))
    return {"ours": ours, "ref": ref, "json": str(path)}


def _lnl(result, key):
    return result.json[key].get("Log Likelihood")


def test_tests_match_jax(runs):
    ours, ref = runs["ours"], runs["ref"]
    assert ours.busted.unconstrained_lnl >= ref.busted.unconstrained_lnl - 0.15
    assert ours.busted.null_lnl >= ref.busted.null_lnl - 0.15
    for key in ("Background selection test results", "Comparative selection test results"):
        assert (_lnl(ours, key) is None) == (_lnl(ref, key) is None), key
        if _lnl(ref, key) is not None:
            assert _lnl(ours, key) >= _lnl(ref, key) - 0.15, key
        assert abs(ours.json[key]["LRT"] - ref.json[key]["LRT"]) <= 0.3, key
    for name in ("p_foreground", "p_background", "p_comparative"):
        p, q = getattr(ours, name), getattr(ref, name)
        assert 0.0 <= p <= 1.0 and (p <= 0.05) == (q <= 0.05), name
    assert ours.summary == ref.summary
    assert sorted(ours.json) == sorted(ref.json)
    assert ours.json["BUSTED-PH"]["trait associated"] == ref.json["BUSTED-PH"]["trait associated"]


def test_clade_support_matches_jax_on_the_port_json(runs, tmp_path):
    ours = clade_support.run(runs["json"], output_json=str(tmp_path / "ecb.json"))
    ref = jclade_support.run(runs["json"])
    assert set(ours.perplexity) == set(ref.perplexity)
    for part, value in ref.perplexity.items():
        assert abs(ours.perplexity[part] - value) <= 1e-12
        assert ours.perplexity[part] >= 1.0 - 1e-12
        for key in ("expected_sites", "weights", "branch_support"):
            got, want = ours.json[part][key], ref.json[part][key]
            assert sorted(got) == sorted(want)
            np.testing.assert_allclose([got[k] for k in sorted(got)],
                                       [want[k] for k in sorted(want)], rtol=1e-12, atol=0)
        assert ours.json[part]["clade_stats"] == ref.json[part]["clade_stats"]
    assert json.loads((tmp_path / "ecb.json").read_text()).keys() == ours.json.keys()


def test_background_branches_are_required(tmp_path):
    """BUSTED-PH refuses a selector that matches every branch."""
    aln = jsynth.synthetic_codon_alignment(4, 6, seed=2)
    fa = tmp_path / "a.fasta"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    with pytest.raises(ValueError, match="background"):
        bustedph.run(str(fa), tree=jsynth.random_tree_newick(4, seed=2), branches="All",
                     device="cpu", srv=False, starting_points=1, precision=1e-1)
