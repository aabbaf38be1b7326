"""One run of one cell: inputs, set-up, warm-up, the window, the metrics,
the check.

Everything a cell needs is found by name: the workload in ``BENCHMARK.json``
names a configuration (``configs[].file``) and a traffic mix
(``portbench/traffic/<traffic>.json``); the traffic names the program stage
(``portbench/stages/<stage>.py``) and its reference
(``portbench/references/<stage>.py``); the cell's limits are in
``portbench/limits/<workload>.json``; each metric is read by
``portbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import pathlib
import sys
import time
import types
from typing import Optional

import numpy as np
import torch

from portbench import inputs as inputs_mod
from portbench import reference, trace as trace_mod
from portbench.window import Window, WindowClosed

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "hyphy_tpu")


class Cell:
    """A workload of the manifest with its files."""

    def __init__(self, manifest: dict, workload: str, config: Optional[dict] = None,
                 limits: Optional[dict] = None):
        """``config`` and ``limits`` stand in for the files (tests)."""
        self.manifest = manifest
        self.workload = next(w for w in manifest["workloads"] if w["name"] == workload)
        entry = next(c for c in manifest["configs"] if c["name"] == self.workload["config"])
        self.config = config or json.loads((ROOT / entry["file"]).read_text())
        self.config.setdefault("name", entry["name"])
        self.traffic = json.loads((HERE / "traffic" / f"{self.workload['traffic']}.json")
                                  .read_text())
        self.limits = limits or json.loads((HERE / "limits" / f"{workload}.json").read_text())
        self.stage = importlib.import_module(f"portbench.stages.{self.traffic['stage']}")
        self.reference = importlib.import_module(f"portbench.references.{self.traffic['stage']}")

    def metrics(self, section: str):
        """(name, unit) of the ``end_to_end`` or ``per_layer`` metrics this
        cell reports."""
        name = self.workload["name"]
        return [(m["name"], m["unit"]) for m in self.manifest[section]
                if name in m.get("workloads", [name])]


def read_metric(name: str, ctx) -> Optional[float]:
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    value = module.read(ctx)
    return None if value is None else float(value)


def shapes(inp, cell) -> dict:
    """The work's shapes, from the benchmark's own inputs."""
    tree = inp.data.tree
    columns, _, _ = reference.patterns(inp.data.states)
    internal = range(tree.n_leaves, tree.n_nodes)
    return {"taxa": inp.n_taxa, "patterns": columns.shape[1], "branches": tree.n_branches,
            "states": len(reference.synth.SENSE_CODONS), "groups": 1,
            "children": [len(tree.children[n]) for n in internal],
            "classes": int(cell.config.get("srv_classes", 1)),
            "itemsize": torch.finfo(getattr(torch, cell.config["precision"])).bits // 8}


def _drive(stage, window: Window) -> None:
    window.open()
    try:
        while True:
            stage.run(window)
            window.stages += 1
    except WindowClosed:
        pass
    window.close()


def run(cell: Cell, seed: int, seconds: float, traced: bool, t0: float,
        device: str = "cuda", control: bool = False) -> dict:
    """One run; with ``control``, the result also holds the numbers that
    the reference in TF32 gives in the program's place, on the same sample
    (``result["control"]``)."""
    on_card = torch.device(device).type == "cuda"
    inp = inputs_mod.make(cell.config, seed)
    t_inputs = time.perf_counter()
    stage = cell.stage.Stage(inp, device)
    t_stage = time.perf_counter()
    _drive(stage, Window(max_calls=int(cell.traffic["warmup_calls"])))
    print(f"[portbench] set-up: to the inputs {t_inputs - t0:.3f} s, stage "
          f"{t_stage - t_inputs:.3f} s, warm-up {time.perf_counter() - t_stage:.3f} s",
          file=sys.stderr, flush=True)

    window = Window(seconds=seconds, events=traced and on_card)
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    setup_s = time.perf_counter() - t0
    _drive(stage, window)
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        summary = trace_mod.summarize(prof, window.wall_s)
        prof = None
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    stage.release()
    stage = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    ctx = types.SimpleNamespace(window=window, setup_s=setup_s, trace=summary,
                                shapes=shapes(inp, cell), inputs=inp)
    section = "per_layer" if traced else "end_to_end"
    metrics = {}
    for name, unit in cell.metrics(section):
        value = read_metric(name, ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    failed = sum(1 for c in window.calls if not bool(torch.isfinite(c.value).all()))
    print(f"[portbench] {cell.workload['name']} seed {seed}: set-up {setup_s:.3f} s, "
          f"{len(window.calls)} calls in {window.wall_s:.3f} s over {window.stages} whole "
          f"stage(s); {json.dumps(metrics)}", file=sys.stderr, flush=True)
    t_check = time.perf_counter()

    def sample():
        return np.random.default_rng([int(seed) % (1 << 64), 17])

    numbers = cell.reference.numbers(inp, window.calls, sample(), device, cell.traffic["check"])
    control_numbers = (cell.reference.numbers(inp, window.calls, sample(), device,
                                              cell.traffic["check"], control=True)
                       if control else None)
    print(f"[portbench] reference {time.perf_counter() - t_check:.3f} s", file=sys.stderr,
          flush=True)
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    correct = bool(numbers) and all(v["value"] <= v["limit"] for v in checks.values())

    result = {"correct": correct, "attempted": len(window.calls), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in summary.device_ops],
                               "idle_gaps": [list(x) for x in summary.idle_gaps]}
    if control_numbers is not None:
        result["control"] = control_numbers
    result["checks"] = checks
    return result


def banned_modules():
    """The JAX stack or the JAX package among the loaded modules, compared
    by whole top-level name."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))
