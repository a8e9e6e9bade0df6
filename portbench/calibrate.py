"""Readings that set the limits of ``correct``: the program's over many
seeds (the lower reading) and the reference put in the program's place in
a lower precision or with a fault planted (the upper reading), each seed
in one process.

    python -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--program 1] [--stand-ins bfloat16,float32:half,float32:stale]

Prints one JSON line per seed and kind. The benchmark's own runs never run
this; its readings and the limits set from them are in ``PERF.md``.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--program", type=int, default=1)
    p.add_argument("--stand-ins", default="")
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    root = os.getcwd()
    cell = harness.resolve_cell(harness.load_spec(root), args.workload, root)
    entry = harness.entry_of(cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program:
            line = harness.run_cell(cell, seed, args.seconds, False, device,
                                    time.perf_counter())
            print(json.dumps({"seed": seed, "kind": "program",
                              "correct": line["correct"],
                              "metrics": line["metrics"],
                              "readings": {k: c["value"] for k, c in
                                           line["checks"].items()}}),
                  flush=True)
        for spec in filter(None, args.stand_ins.split(",")):
            dtype, _, fault = spec.partition(":")
            ctx = harness.Context(cell, seed, args.seconds, False, device,
                                  time.perf_counter())
            r = entry.stand_in(ctx, getattr(torch, dtype), fault or None)
            print(json.dumps({"seed": seed, "kind": spec, "readings": r}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
