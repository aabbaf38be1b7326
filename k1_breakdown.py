#!/usr/bin/env python3
"""Where K1's time goes: ``csrc/level_products.cu`` timed whole, with its
copies only and with its compute only, on one card.

    python3 k1_breakdown.py

Builds the kernel source three times through ``ops/cuda_build.py``, with
``K1_PART`` = 0 (the kernel as the port runs it), 1 (the copies, barriers
and stores with an empty j loop) and 2 (the j loop on stale shared memory
without the copies); prints each build's registers and local memory
(``cuobjdump -res-usage``); and times each part with CUDA events at the
codon fit's widest level shapes in fp32 and fp64, with the wrapper's
launch plan.  Part 0 is held against the plain version.  The record goes
to ``chiprun_out/k1_breakdown.json``.  Needs a card and ``nvcc``; imports
nothing of ``jax`` or ``hyphy_tpu``.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
SHAPES = [(500, 2, 2048, 61), (320, 2, 2048, 61)]
PARTS = {0: "whole", 1: "copies only", 2: "compute only"}
REPS = 30


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_breakdown: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from hyphy_tpu_torch.ops import cuda_build
    from hyphy_tpu_torch.ops.level_products import _launch_plan, level_products_reference

    rel_bound = {torch.float32: 1e-5, torch.float64: 1e-12}   # as chip_smoke.py

    defines = {part: () if part == 0 else (f"K1_PART={part}",) for part in PARTS}
    libs = {part: cuda_build.load("level_products", d) for part, d in defines.items()}
    cuobjdump = pathlib.Path(cuda_build._nvcc()).with_name("cuobjdump")
    record = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), "resources": {}, "rows": []}
    print(record["card"])
    for part, d in defines.items():
        usage = subprocess.run([str(cuobjdump), "-res-usage",
                                str(cuda_build._target("level_products", d))],
                               capture_output=True, text=True, check=True).stdout
        lines = [line.strip() for line in usage.splitlines() if "REG:" in line]
        record["resources"][PARTS[part]] = lines
        print(PARTS[part], lines)

    for dtype in (torch.float32, torch.float64):
        for shape in SHAPES:
            w, k, p, s = shape
            gen = torch.Generator(device="cuda").manual_seed(0)
            cc = torch.rand(shape, generator=gen, device="cuda", dtype=dtype) * 0.9 + 0.1
            cp = torch.rand((w, k, s, s), generator=gen, device="cuda", dtype=dtype) * 0.2
            out = torch.empty((w, p, s), device="cuda", dtype=dtype)
            plan = _launch_plan(w, k, p, s, dtype)
            stream = torch.cuda.current_stream().cuda_stream
            for part, lib in libs.items():
                fn = lib.level_products_f32 if dtype == torch.float32 else lib.level_products_f64
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int

                def call():
                    err = fn(cc.data_ptr(), cp.data_ptr(), out.data_ptr(), w, k, p, s,
                             *plan, stream)
                    if err != 0:
                        raise RuntimeError(f"launch failed, part {part}: CUDA error {err}")

                call()
                torch.cuda.synchronize()
                err = None
                if part == 0:
                    ref = level_products_reference(cc, cp)
                    err = float(((out - ref).abs() / ref.abs()).max())
                    if not err <= rel_bound[dtype]:
                        raise RuntimeError(f"{shape} {dtype}: max rel {err:.3e} from the plain version")
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS):
                    call()
                end.record()
                torch.cuda.synchronize()
                row = dict(dtype=str(dtype).split(".")[1], shape=list(shape),
                           part=PARTS[part], ms=start.elapsed_time(end) / REPS,
                           max_rel_err=err)
                record["rows"].append(row)
                print(json.dumps(row), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "k1_breakdown.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
