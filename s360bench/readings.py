"""The check's readings of many seeds in one process, for setting a cell's
limits (``limits/<cell>.json``, as ``PERF.md`` section 2 describes).

    python3 -m s360bench.readings --workload <cell> --seeds <n>[,<n>...] \
        [--system program|tf32] [--fault <name>] [--seconds <s>] > <file>

Each seed is one run of the cell (``run.run_cell``: set-up, warm-up, a
window of ``--seconds``, the check) with the system under test, the
reference and the program's kernels and graphs built once: the program,
the precision control (``tf32``: the reference in TF32 in the program's
place, as ``run.py --control tf32`` makes it), or the program with a
fault of ``faults.py`` planted. The check's reference is made once too:
its context takes 20 s to build at 6k and 44 s at 8k (H100 host), more
than a seed's run. Prints one JSON object
a seed on standard output, with the worst reading of every number the
check read, compared or not. No benchmark run uses it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    from . import run

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--system", choices=("program", "tf32"), default="program")
    p.add_argument("--fault", default="", help="a fault of faults.py, planted in the program")
    p.add_argument("--seconds", type=float, default=0.5)
    args = p.parse_args(argv)

    cell = run.resolve(args.workload)
    os.makedirs(run.CACHE_DIR, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(run.CACHE_DIR, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(run.CACHE_DIR, "torch_extensions")
    import torch

    from .reference.system import Reference

    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    reference = Reference(cell.config, device)
    if args.system == "tf32":
        system = Reference(cell.config, device, tf32=True)
    elif args.fault:
        from .faults import Faulty

        system = Faulty(cell.config, device, args.fault)
    else:
        from .program import Program

        system = Program(cell.config, device)
    label = args.fault or args.system
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = run.run_cell(cell, seed, args.seconds, False, device,
                         make_system=lambda config, dev: system, reference=reference)
        line = {"workload": cell.name, "system": label, "seed": seed,
                "correct": all(v["value"] <= v["limit"] for v in r["numbers"].values()),
                "frames": r["attempted"], "seconds": time.perf_counter() - t,
                "readings": r["readings"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
