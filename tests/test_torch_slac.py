"""The port's SLAC against the JAX package's: the by-site RESOLVED and
AVERAGED tables and the ancestral-sampling quantile tables, with the JAX
run's GTR and MG94 fits carried across (so both count substitutions from
the same global point), on a NEXUS of three CHARSET partitions with a
tested-branch selection; and the ``slac`` CLI end to end."""

import json

import numpy as np
import pytest
import torch

import hyphy_tpu.methods.common as jcommon
from hyphy_tpu.methods import slac as jslac
from hyphy_tpu_torch import cli
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.methods import slac
from torch_carry import carry_into, spy_fits, write_partitioned_nexus

torch.set_num_threads(2)

SAMPLES, BRANCHES = 3, "t0,t1,t2,t3"
_QUANTILES = ("sample-median", "sample-2.5", "sample-97.5")


@pytest.fixture(autouse=True)
def _on_cpu():
    saved = settings.device
    settings.device = "cpu"
    yield
    settings.device = saved


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's ``slac.run`` on the partitioned fixture, with its
    global fits recorded."""
    nexus = write_partitioned_nexus(tmp_path_factory.mktemp("slac") / "parts.nex")
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPHY_TPU_PROGRESS", "0")
        spy_fits(jcommon, mp, seen)
        result = jslac.run(nexus, branches=BRANCHES, samples=SAMPLES)
    return nexus, result, seen


def test_tables_match_with_carried_fits(jax_run, monkeypatch):
    nexus, jres, seen = jax_run
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")
    carry_into(monkeypatch, seen)
    res = slac.run(nexus, branches=BRANCHES, samples=SAMPLES)
    np.testing.assert_array_equal(res.ancestor_states, jres.ancestor_states)
    for key in ("RESOLVED", "AVERAGED"):
        assert res.by_site[key].shape == jres.by_site[key].shape == (10, 11)
        np.testing.assert_allclose(res.by_site[key], jres.by_site[key], rtol=0, atol=1e-8,
                                   err_msg=key)
    content, ref = res.json["MLE"]["content"], jres.json["MLE"]["content"]
    assert sorted(content) == sorted(ref) == ["0", "1", "2"]
    for part in ref:
        for key in ("RESOLVED", "AVERAGED"):
            np.testing.assert_allclose(np.asarray(content[part]["by-site"][key]),
                                       np.asarray(ref[part]["by-site"][key]),
                                       rtol=0, atol=1e-8, err_msg=f"{part} {key}")
    # the sampled states are equal draws, so the quantile tables are equal
    for key in _QUANTILES:
        assert sorted(res.json[key]) == sorted(jres.json[key]) == ["0", "1", "2"]
        for part in jres.json[key]:
            np.testing.assert_array_equal(
                np.asarray(res.json[key][part]["by-site"]["RESOLVED"]),
                np.asarray(jres.json[key][part]["by-site"]["RESOLVED"]), err_msg=f"{key} {part}")


def test_slac_cli_writes_the_reference_keys(jax_run, tmp_path, monkeypatch):
    nexus, jres, _ = jax_run
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")
    out = tmp_path / "o.json"
    assert cli.main(["slac", "--alignment", nexus, "--branches", BRANCHES,
                     "--samples", str(SAMPLES), "--output", str(out)]) == 0
    result = json.loads(out.read_text())
    assert sorted(result) == sorted(jres.json)
    for key in ("input", "fits", "MLE", "data partitions", "tested") + _QUANTILES:
        assert sorted(result[key]) == sorted(jres.json[key]), key
    assert result["MLE"]["headers"] == jres.json["MLE"]["headers"]
    assert result["tested"] == jres.json["tested"]
    rows = 0
    for part, block in result["MLE"]["content"].items():
        table = np.asarray(block["by-site"]["RESOLVED"])
        rows += table.shape[0]
        assert table.shape[1] == 11 and np.isfinite(table[:, [0, 1, 2, 3, 10]]).all(), part
        assert ((table[:, 8:10] >= 0) & (table[:, 8:10] <= 1)).all(), part
    assert rows == 30
