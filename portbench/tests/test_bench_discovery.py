"""A configuration, a traffic mix, a cell's limits and a per-layer metric
dropped in as new files are found by name, and nothing that was there is
edited: the cell runs from a copy of the benchmark with only files added."""

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_from_new_files_only(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(HERE, copy / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digests(copy / "portbench")

    bench = copy / "portbench"
    config = json.loads((bench / "configs" / "fel-mg94-1000x2048.json").read_text())
    config.update(name="fel-mg94-10x12", n_taxa=10, n_codons=12, planted_sites=[3])
    (bench / "configs" / "fel-mg94-10x12.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "fel_site_stage.json").read_text())
    traffic.update(warmup_calls=2, check={"calls": 2, "items": 3})
    (bench / "traffic" / "fel_short_stage.json").write_text(json.dumps(traffic))
    (bench / "limits" / "fel-tiny.sites.json").write_text(json.dumps({"site_lnl_gap": 1e-9}))
    (bench / "metrics" / "sites.calls.py").write_text(
        "def read(ctx):\n    return len(ctx.window.calls)\n")
    manifest["configs"].append({"name": "fel-mg94-10x12", "source": "test",
                                "file": "portbench/configs/fel-mg94-10x12.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "fel-tiny.sites", "config": "fel-mg94-10x12",
                                  "traffic": "fel_short_stage", "chips": 1, "why": "test"})
    for metric in manifest["end_to_end"]:
        if metric["name"] == "site_evals_per_s":
            metric["workloads"].append("fel-tiny.sites")
    manifest["per_layer"].append({"name": "sites.calls", "unit": "calls", "better": "higher",
                                  "source": "program_counter", "layer": "test",
                                  "moves": "site_evals_per_s", "workloads": ["fel-tiny.sites"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))

    script = (
        "import json, sys, time\n"
        "from hyphy_tpu_torch.config import settings\n"
        "settings.device = 'cpu'\n"
        "from portbench import harness\n"
        "m = json.load(open('BENCHMARK.json'))\n"
        "for traced in (False, True):\n"
        "    r = harness.run(harness.Cell(m, 'fel-tiny.sites'), 5, 0.5, traced, time.perf_counter(),"
        " device='cpu')\n"
        "    print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(copy), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", script], cwd=copy, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and "site_evals_per_s" in plain["metrics"]
    assert traced["metrics"]["sites.calls"]["value"] == traced["attempted"]
    after = _digests(copy / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
