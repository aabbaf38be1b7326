"""Readings for the limits of a cell: the program's numbers on many seeds and
the control's (the reference in TF32 in the program's place) on the same
samples, in one process, each seed a whole run of the cell at its own size.

    python3 portbench/control.py --workload NAME --seeds 1,2,3 --seconds S

prints one JSON line per seed: the seed, the program's numbers, the
control's, the end-to-end metrics.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control readings need the card", file=sys.stderr)
        return 3
    from portbench import harness

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(manifest, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run(cell, seed, args.seconds, False, time.perf_counter(), control=True)
        print(json.dumps({"seed": seed, "program": {k: v["value"] for k, v in res["checks"].items()},
                          "control": res["control"], "metrics": res["metrics"],
                          "attempted": res["attempted"], "failed": res["failed"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
