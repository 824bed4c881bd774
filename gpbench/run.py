"""The benchmark of gridpp_tpu_torch: one run of one cell.

    python gpbench/run.py --workload <cell> --seed <n> --seconds <s>
                          --trace <0|1>

Run from the root of a checkout. The cell's configuration, traffic mix,
check and metrics are found by name from BENCHMARK.json
(harness/manifest.py). Needs as many CUDA cards as the cell asks for:
without them it exits 2 and prints no result. It exits 3, and prints no
result, when the program (gridpp_tpu_torch) is not in the checkout, and
when JAX or the JAX package (gridpp_tpu) was loaded by the time the window
closed.

Standard error carries progress and, as its last lines, each number
compared beside its limit. The last line of standard output is the
result: {"correct", "attempted", "failed", "metrics", "device"[,
"breakdown"], "checks"}; with --trace 0 the metrics are the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, read from a
torch.profiler trace of the window.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "gpbench")


def args_of(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def caches():
    """Every kernel cache in fixed directories of the checkout (the
    program builds its own libraries into <checkout>/build)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)


def program_here() -> bool:
    """Whether gridpp_tpu_torch imports, and from this checkout."""
    try:
        import gridpp_tpu_torch
    except ImportError as e:
        print(f"gpbench: the program does not import: {e}", file=sys.stderr)
        return False
    where = os.path.dirname(os.path.abspath(gridpp_tpu_torch.__file__))
    if os.path.dirname(where) != ROOT:
        print(f"gpbench: gridpp_tpu_torch comes from {where}, not from "
              f"this checkout", file=sys.stderr)
        return False
    return True


def main(argv=None) -> int:
    args = args_of(argv)
    caches()
    sys.path.insert(0, ROOT)
    import torch
    from gpbench.harness import manifest, runner

    cell = manifest.load(args.workload)
    if not program_here():
        return 3
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"gpbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          device, T0)
    foreign = sorted(set(res.foreign) | set(runner.foreign_modules()))
    if foreign:
        print(f"gpbench: loaded in this process: {', '.join(foreign)}",
              file=sys.stderr)
        return 3
    for key, c in res.checks.items():
        print(f"check {key}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res.line()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
