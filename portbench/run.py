"""The benchmark of the port (``hyphy_tpu_torch``) on one H100.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

run from the root of a checkout.  Prints the cell's result as the last line
of standard output (``--trace 0``: its end-to-end metrics; ``--trace 1``:
its per-layer metrics, read from a profiled window) and each number the
check compared, beside its limit, as the last lines of standard error.
Exits with another code than 0, and prints no result, where there is no card
or fewer than the cell asks for, or where the JAX stack or the JAX package
was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in manifest["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    from portbench import harness

    result = harness.run(harness.Cell(manifest, args.workload), args.seed, args.seconds,
                         bool(args.trace), T0)
    found = harness.banned_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
