"""A run of each cell drives the program and the comparison end to end on
the CPU at a tiny size (the look for a card skipped): it is correct, and
it comes out not correct for the control and for each fault the cells
can have, planted under the timed path."""
import collections
import time

import numpy as np
import pytest
import torch

from gpbench.harness import compare, runner, trace
from gpbench.tests import tiny

DET = ["det2k_10k.static", "det2k_10k.churn5"]
CELLS = DET + ["ensi2k_10k_m10.static"]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 99


def run(name, seconds=0.5, **kw):
    return runner.run_cell(tiny.cell(name), SEED, seconds, False, CPU,
                           time.perf_counter(), **kw)


def planted(fault):
    """A serve_wrap that hands each analysis through fault(analysis,
    the cycle's input field) on its way out."""
    def wrap(serve):
        def served(cycles):
            fields = collections.deque()

            def noted():
                for args in cycles:
                    fields.append(args[0].copy())
                    yield args
            for out in serve(noted()):
                yield fault(np.array(out), fields.popleft())
        return served
    return wrap


def altered(out, field):
    """One answer altered where it is produced: 0.05 K at one value."""
    out.reshape(-1)[out.size // 3] += 0.05
    return out


def tile_row_off(out, field):
    """The size of the fast path's fault seen on the CPU (PERF.md, Open
    questions): 0.009 K, the least it read, on one row of one 32 x 64
    tile."""
    out[out.shape[0] // 2 + 1, :64] += 0.009
    return out


def half_left_out(out, field):
    """Half of the gridpoints left unanalysed."""
    out[: out.shape[0] // 2] = field[: out.shape[0] // 2]
    return out


def unchanged(out, field):
    """The state handed back unchanged: no analysis at all."""
    return field.copy()


@pytest.mark.parametrize("name", CELLS)
def test_run_is_correct(name):
    res = run(name)
    assert res.correct, res.checks
    assert res.attempted >= res.failed == 0
    assert set(res.line()) == {"correct", "attempted", "failed", "metrics",
                               "device", "checks"}
    assert list(res.line())[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    res = run(name, control=True)
    checks = compare.judged(dict(res.control, failed_cycles=0),
                            tiny.cell(name).check["limits"])
    assert not compare.passed(checks), checks


@pytest.mark.parametrize("fault", [altered, half_left_out, unchanged])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    res = run(name, serve_wrap=planted(fault))
    assert not res.correct, res.checks


@pytest.mark.parametrize("name", DET)
def test_a_fault_of_the_cpu_fault_size_is_not_correct(name):
    res = run(name, serve_wrap=planted(tile_row_off))
    assert not res.correct, res.checks


def test_a_stream_that_raises_fails_its_cycles():
    calls = []

    def broken(serve):
        def served(cycles):
            calls.append(1)
            for out in serve(cycles):
                if len(calls) > 1:      # the window's stream, not warm-up's
                    raise RuntimeError("planted")
                yield out
        return served
    res = run("det2k_10k.static", serve_wrap=broken)
    assert not res.correct and res.failed >= 1


def test_traced_run_reports_per_layer_metrics():
    res = runner.run_cell(tiny.cell("det2k_10k.static"), SEED, 1.0, True,
                          CPU, time.perf_counter())
    assert res.correct
    assert "setup.pipeline_s" in res.metrics
    assert res.metrics["cycle.rebuilds_per_cycle.host_bound"]["value"] == 0.0
    assert {"busy_s", "window_s"} <= set(res.device)
    assert set(res.breakdown) == {"device_ops", "idle_gaps"}


def _trace():
    t = trace.Trace(start=0.0, end=1000.0, cycles=4)
    t.kernels = [("void strip::strip_kernel<(strip::Mode)0>(x)", 100, 110),
                 ("gemm", 105, 300), ("gemm", 500, 600)]
    t.copies = [("Memcpy HtoD (Pinned -> Device)", 0, 50),
                ("Memcpy DtoH (Device -> Pinned)", 590, 700)]
    t.other = [("Memset (Device)", 650, 660)]
    t.spans = [("gpbench.stream.next", 0, 1000),
               ("gpbench.client.make_cycle", 750, 1000)]
    return t


def test_readers_on_a_known_trace():
    from gpbench.harness import manifest
    ctx = runner.Context(
        config={"grid": {"ny": 100, "nx": 100}}, traffic={}, trace=_trace(),
        setup={"pipeline_s": 1.5}, counters={"rebuilds": 6, "cycles": 4},
        peaks={"bytes": 1e12, "f32": 1e12}, cycle_bound=(4e5, 0.0))
    read = {m: manifest.reader(m).read(ctx) for m in (
        "setup.pipeline_s", "serve.copy_ms", "cycle.device_ms",
        "cycle.rebuilds_per_cycle", "kernel.k1_roofline_pct",
        "cycle.roofline_pct", "device.idle_pct")}
    assert read["setup.pipeline_s"] == 1.5
    assert read["serve.copy_ms"] == pytest.approx(160 / 1e3 / 4)
    assert read["cycle.device_ms"] == pytest.approx(310 / 1e3 / 4)
    assert read["cycle.rebuilds_per_cycle"] == 1.5
    # K1: 80,000 bytes at 1e12 B/s = 0.08 us over its 10 us
    assert read["kernel.k1_roofline_pct"] == pytest.approx(0.8)
    # the cycle: 0.4 us over 77.5 us
    assert read["cycle.roofline_pct"] == pytest.approx(40 / 77.5)
    # busy: 0-50, 100-300, 500-700 -> 450 of 1000
    assert read["device.idle_pct"] == pytest.approx(55.0)
    gaps = trace.breakdown(ctx.trace)["idle_gaps"]
    assert gaps[0] == ["gpbench.client.make_cycle", 300 / 1e6]
    assert gaps[1] == ["gpbench.stream.next", 200 / 1e6]


def test_a_qualified_metric_is_read_by_its_base_reader():
    from gpbench.harness import manifest
    assert manifest.reader("cycle.device_ms.host_bound") is \
        manifest.reader("cycle.device_ms")


def test_readers_find_nothing_in_an_empty_trace():
    from gpbench.harness import manifest
    ctx = runner.Context(config={"grid": {"ny": 1, "nx": 1}}, traffic={},
                         trace=trace.Trace(cycles=0), setup={}, counters={},
                         peaks=None, cycle_bound=(1, 1))
    for m in ("serve.copy_ms", "cycle.device_ms", "kernel.k1_roofline_pct",
              "cycle.roofline_pct", "device.idle_pct",
              "cycle.rebuilds_per_cycle", "setup.pipeline_s"):
        assert manifest.reader(m).read(ctx) is None
