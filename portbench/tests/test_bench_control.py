"""The control comes out not correct: at a cell's own size on the card, the
reference computed with TF32 products in the program's place fails a limit
that the program's own run keeps.  Needs the card (``card`` fixture)."""

import json
import time

import pytest

from portbench import harness
from portbench.tests.conftest import ROOT


CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(card, manifest, workload, monkeypatch):
    from hyphy_tpu_torch.config import settings

    monkeypatch.setattr(settings, "device", "cuda")
    cell = harness.Cell(manifest, workload)
    result = harness.run(cell, 424242, 5.0, False, time.perf_counter(), control=True)
    assert result["correct"], result["checks"]
    assert any(result["control"][k] > c["limit"] for k, c in result["checks"].items()), \
        (result["control"], result["checks"])
