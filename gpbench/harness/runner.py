"""One run of one cell: set-up, warm-up, the window, the trace (in a
traced run), then the comparison with the reference.

setup_s runs from the process's start (run.py's first statement) to the
window's opening: CUDA's start, the draws, the program's constructor and
the warm-up cycles of the cell's own traffic, which build the kernels and
capture the graphs. Nothing the window runs is built there. The
reference's comparison runs after the window, once memory_peak_bytes has
been read and the program has been freed; it is not in setup_s.
"""
from __future__ import annotations

import gc
import math
import statistics
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function

from . import compare, manifest, trace, window
from .traffic import WARMUP, Traffic
from ..counts import peaks as peak_table

FOREIGN = ("jax", "jaxlib", "flax", "gridpp_tpu")
WARM_STEP_S = 1.0      # a traced run's warm-up step
TRACE_STEP_S = 4.0     # ... and its recorded step, at most


def log(msg: str) -> None:
    print(f"[gpbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def foreign_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FOREIGN))


@dataclass
class Context:
    """What a per-layer reader (metrics/<name>.py) gets."""
    config: dict
    traffic: dict
    trace: trace.Trace
    setup: dict
    counters: dict
    peaks: dict | None
    cycle_bound: tuple


@dataclass
class Result:
    correct: bool = False
    attempted: int = 0
    failed: int = 0
    metrics: dict = field(default_factory=dict)
    device: dict = field(default_factory=dict)
    breakdown: dict | None = None
    checks: dict = field(default_factory=dict)
    readings: dict = field(default_factory=dict)
    control: dict | None = None
    foreign: list = field(default_factory=list)

    def line(self) -> dict:
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": self.metrics,
               "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = self.checks
        return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
             device, t0: float, control: bool = False,
             serve_wrap=None) -> Result:
    """The run. device: torch.device; t0: the process's start on the host
    clock; control: also read the control (the reference in the step
    below the configuration's precision) on the kept cycles; serve_wrap:
    a function wrapping the program's serving entry (tests plant faults
    with it)."""
    cuda = device.type == "cuda"
    system = manifest.system(cell.config)
    res = Result()
    with record_function("gpbench.setup.draws"):
        tr = Traffic(cell.config, cell.traffic, seed, device)
    _sync(device)
    log(f"draws {time.perf_counter() - t0:.3f} s from start")
    t = time.perf_counter()
    with record_function("gpbench.setup.pipeline"):
        program = system.build(cell.config, tr, device)
        _sync(device)
    setup = {"pipeline_s": time.perf_counter() - t}
    log(f"constructor {setup['pipeline_s']:.3f} s")
    serve = program.serve_stream
    if serve_wrap is not None:
        serve = serve_wrap(serve)
    t = time.perf_counter()
    for _ in serve(tr.make(i) for i in range(WARMUP)):
        pass
    _sync(device)
    log(f"warm-up ({WARMUP} cycles) {time.perf_counter() - t:.3f} s")
    setup_s = time.perf_counter() - t0

    keep = int(cell.check["check_cycles"])
    counters = {}
    if traced:
        before = system.counters(program)
        prof = trace.profiler()
        prof.start()
        w = window.run(serve, tr, WARMUP, seconds, keep, seed,
                       steps=(WARM_STEP_S, min(seconds, TRACE_STEP_S)),
                       on_step=prof.step)
        prof.stop()
        _sync(device)
        after = system.counters(program)
        counters = {k: after[k] - before[k] for k in after}
        counters["cycles"] = w.done
    else:
        w = window.run(serve, tr, WARMUP, seconds, keep, seed)
        _sync(device)
    res.foreign = foreign_modules()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"window {w.seconds:.3f} s, {w.done} cycles")
    if w.error:
        print(w.error, file=sys.stderr, flush=True)
    res.attempted, res.failed = w.pulled, w.failed()
    ny, nx = tr.ny, tr.nx
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    res.device = {"platform": "gpu" if cuda else "cpu", "kind": name,
                  "count": cell.chips, "memory_peak_bytes": int(peak)}
    if traced:
        tt = trace.parse(prof, w.steps[1][1] - w.steps[0][1]
                         if len(w.steps) == 2 else 0)
        res.device["busy_s"] = trace.covered(tt.device()) / 1e6
        res.device["window_s"] = tt.seconds
        res.breakdown = trace.breakdown(tt)
        ctx = Context(cell.config, cell.traffic, tt, setup, counters,
                      peak_table.peaks(name) if cuda else None,
                      manifest.counts(cell.config_name).cycle(
                          cell.config, cell.traffic))
        for m in cell.per_layer:
            v = manifest.reader(m["name"]).read(ctx)
            if v is not None:
                res.metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
        del prof
    else:
        lat_ms = [x * 1e3 for x in w.latencies]
        values = {
            "served_gridpoints_per_s": (w.done * ny * nx / w.seconds
                                        if w.done else 0.0),
            "cycle_p95_ms": (float(np.percentile(lat_ms, 95)) if lat_ms
                             else math.inf),
            "peak_device_gib": peak / 2 ** 30,
            "setup_s": setup_s}
        if lat_ms:
            log(f"latency: median {statistics.median(lat_ms):.3f} ms, 95th "
                f"percentile {values['cycle_p95_ms']:.3f} ms, "
                f"{len(lat_ms)} cycles")
        for m in cell.end_to_end:   # a qualified name is its base's value
            base = m["name"].split(".")[0]
            res.metrics[m["name"]] = {"value": values[base],
                                      "unit": m["unit"]}

    # the comparison, on a freed card
    del program, serve
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    check = system.Check(cell.config, tr, device)
    errs = [check.errors(i, out) for i, out in sorted(w.kept.items())]
    res.readings = compare.readings(errs)
    res.readings["failed_cycles"] = res.failed
    if control:
        res.control = compare.readings(
            [check.control_errors(i) for i in sorted(w.kept)])
    _sync(device)
    log(f"reference over {len(errs)} cycles {time.perf_counter() - t:.3f} s")
    res.checks = compare.judged(res.readings, cell.check["limits"])
    res.correct = (compare.passed(res.checks) and not w.error
                   and w.done > 0 and bool(errs))
    return res
