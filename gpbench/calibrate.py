"""The readings that a cell's limits for `correct` are set from.

    python gpbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control]

For each seed, in one process (set-up is long): a run of the cell with a
window of SECONDS at the cell's own load, and the numbers its
comparison reads (the program against the reference, over as many
cycles as a run compares); with --control also the control's (the
reference computed in the step below the configuration's precision, put
in the program's place, on the same cycles). One JSON line a seed on
standard output, then one with the largest program reading and the
smallest control reading of each number. Needs a CUDA card.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

SECONDS = 5.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from gpbench import run
    run.caches()
    import torch
    from gpbench.harness import manifest, runner

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = manifest.load(args.workload)
    device = torch.device("cuda", 0)
    high, low = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        res = runner.run_cell(cell, seed, SECONDS, False, device,
                              time.perf_counter(), control=args.control)
        line = {"seed": seed, "correct": res.correct,
                "readings": res.readings, "control": res.control,
                "metrics": {k: v["value"] for k, v in res.metrics.items()}}
        print(json.dumps(line), flush=True)
        for k, v in res.readings.items():
            high[k] = max(high.get(k, v), v)
        for k, v in (res.control or {}).items():
            low[k] = min(low.get(k, v), v)
    print(json.dumps({"program_highest": high, "control_lowest": low}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
