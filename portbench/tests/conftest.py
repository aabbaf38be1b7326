"""Tests of the benchmark (``python -m pytest portbench/tests``).  CPU tests
drive the harness on a small copy of each cell with the port on the CPU in
fp64; tests marked ``card`` need a CUDA card and skip without one (decided in
the ``card`` fixture, never at import)."""

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


# the global MG94xREV fit: its stage, reference, traffic and limits are in
# place, the cell is not in BENCHMARK.json (PERF.md, Open questions); the CPU
# tests hold its reference to the port all the same
MG94_CELL = {"name": "fel-codon.gene", "config": "fel-mg94-1000x2048",
             "traffic": "mg94_gene_fit", "chips": 1, "why": "the global MG94xREV fit"}


@pytest.fixture(scope="session")
def manifest():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    if not any(w["name"] == MG94_CELL["name"] for w in m["workloads"]):
        m["workloads"].append(MG94_CELL)
        for metric in m["end_to_end"]:
            if metric["name"] == "gene_evals_per_s":
                metric["workloads"].append(MG94_CELL["name"])
    return m


@pytest.fixture(autouse=True)
def _port_on_cpu():
    from hyphy_tpu_torch.config import settings

    saved = settings.device
    settings.device = "cpu"
    yield
    settings.device = saved


def small(manifest, workload, taxa=12, codons=16, limits=None):
    """The cell ``workload`` on ``taxa`` x ``codons`` codons."""
    from portbench import harness

    cell = harness.Cell(manifest, workload)
    config = dict(cell.config, n_taxa=taxa, n_codons=codons, planted_sites=[1, 5],
                  name=f"{cell.config['name']}-test-{taxa}x{codons}")
    return harness.Cell(manifest, workload, config=config, limits=limits)
