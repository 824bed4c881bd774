"""The cells utem2k_10k_m10.static and ensi2k_10k_m10.churn5 on the CPU at a
tiny size: each run is correct, and the control and planted faults are not;
the manifest gives each cell its metrics; the utem count; and the readers
of the utem sweep's spans (cycle.select_ms, cycle.update_ms), on a
hand-built record, on a record without those spans, on a program without
the recorder, and in a traced run."""
import os
import sys
import time

import numpy as np
import pytest
import torch

from gpbench.harness import compare, manifest, runner
from gpbench.tests import tiny
from gpbench.tests.test_gpbench_control import (altered, half_left_out,
                                                planted, unchanged)
from gridpp_tpu_torch import tracing

UTEM = "utem2k_10k_m10.static"
CHURN = "ensi2k_10k_m10.churn5"
CELLS = [UTEM, CHURN]
# the qualifier of each cell's served rate and of its serving metrics
KIND = {UTEM: ".host_bound", CHURN: ".host_bound"}
SERVING = ["serve.copy_ms", "cycle.device_ms", "cycle.roofline_pct",
           "device.idle_pct", "serve.check_ms", "serve.stage_ms",
           "serve.fetch_ms", "serve.wait_ms", "cycle.launch_ms"]
READERS = ["cycle.select_ms", "cycle.update_ms"]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 99
MS = 1_000_000      # ns


def run(name, seconds=0.5, **kw):
    return runner.run_cell(tiny.cell(name), SEED, seconds, False, CPU,
                           time.perf_counter(), **kw)


def corr_is_background(serve):
    """A serve_wrap that serves each cycle with background_corr replaced by
    the background itself."""
    served = serve.__self__

    def wrapped(cycles):
        return served.pipe.serve_stream(
            (bg, pobs, served.pratios, bg) for bg, pobs in cycles)
    return wrapped


@pytest.mark.parametrize("name", CELLS)
def test_run_is_correct(name):
    res = run(name)
    assert res.correct, res.checks
    assert res.attempted >= res.failed == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    res = run(name, control=True)
    checks = compare.judged(dict(res.control, failed_cycles=0),
                            tiny.cell(name).check["limits"])
    assert not compare.passed(checks), checks


@pytest.mark.parametrize("wrap", [planted(altered), planted(half_left_out),
                                  planted(unchanged), corr_is_background],
                         ids=["altered", "half_left_out", "unchanged",
                              "corr_is_background"])
def test_utem_fault_is_not_correct(wrap):
    res = run(UTEM, serve_wrap=wrap)
    assert not res.correct, res.checks


def test_the_correlation_ensemble_follows_the_background_slot():
    """Cycle i and cycle i + POOL share their background's slot, and so
    their correlation ensemble; the program finds it from the array."""
    from gpbench.harness.traffic import POOL, Traffic
    from gpbench.systems import utem
    c = tiny.cell(UTEM)
    t = Traffic(c.config, c.traffic, SEED, CPU)
    prog = utem.build(c.config, t, CPU)
    seen = []
    prog.pipe.serve_stream = lambda cycles: [seen.append(x) for x in cycles]
    prog.serve_stream([t.make(3), t.make(3 + POOL), t.make(4)])
    assert seen[0][3] is seen[1][3] is prog.pool[3]
    assert seen[2][3] is prog.pool[4]
    assert all(x[2] is prog.pratios for x in seen)
    assert not np.array_equal(prog.pool[3], t.fields[3])
    again = utem.corr_pool(c.config, Traffic(c.config, c.traffic, SEED,
                                             CPU), CPU)
    assert all(np.array_equal(a, b) for a, b in zip(again, prog.pool))


def test_manifest_gives_each_cell_its_metrics():
    for cell, q in KIND.items():
        c = manifest.load(cell)
        assert c.chips == 1
        assert {m["name"] for m in c.end_to_end} == {
            "served_gridpoints_per_s" + q, "peak_device_gib", "setup_s"}
        want = {"setup.pipeline_s"} | {m + q for m in SERVING}
        if cell == UTEM:
            want |= set(READERS)
        else:
            want.add("cycle.host_syncs_per_cycle" + q)
        assert {m["name"] for m in c.per_layer} == want, cell
    for name in READERS:
        m = {x["name"]: x for x in manifest.read_json(os.path.join(
            manifest.ROOT, "BENCHMARK.json"))["per_layer"]}[name]
        assert m["workloads"] == [UTEM]
        assert m["moves"] == "served_gridpoints_per_s" + KIND[UTEM]
        assert (m["source"], m["layer"]) == ("program_span", "cycle")


def test_utem_bound():
    n, e, s, k, p = 15, 3, 2, 4, 7
    cfg = {"grid": {"ny": 3, "nx": 5}, "stations": p, "max_points": s,
           "candidates": k, "members": e}
    count = manifest.counts("utem2k_10k_m10")
    nbytes, ops = count.cycle(cfg, {"missing_fraction": 0.0})
    assert nbytes == 12 * n * e + 4 * n + 8 * n * s + 8 * p + 8 * p * e
    assert ops == n * (e * s + 2 * e * e * s + e ** 3 + 2 * e * s
                       + 2 * e * e + 2 * e * e + 10 * e)
    nbytes2, _ = count.cycle(cfg, {"missing_fraction": 0.05})
    assert nbytes2 == nbytes + 8 * n * (k - s)


def _session(with_spans=True):
    """Two served cycles; each a gridpp.cycle of 10 ms holding a table of
    1 ms and two blocks, each a 1.5 ms select and a 2 ms update."""
    spans = []
    for c in (0, 1):
        t = 100 * c * MS
        spans.append(("gridpp.cycle.table", "gridpp.cycle", c, t, t + MS))
        for b in (0, 1):
            u = t + MS + 4 * b * MS
            spans += [("gridpp.cycle.select", "gridpp.cycle", c, u,
                       u + 3 * MS // 2),
                      ("gridpp.cycle.update", "gridpp.cycle", c,
                       u + 3 * MS // 2, u + 7 * MS // 2)]
        spans.append(("gridpp.cycle", None, c, t, t + 10 * MS))
    if not with_spans:
        spans = [s for s in spans if s[0] == "gridpp.cycle"]
    return tracing.Session(spans=spans, counts={"serve.cycles": 2,
                                                "cycle.utem": 2})


def test_readers_on_a_hand_built_session(monkeypatch):
    monkeypatch.setattr(tracing, "session", _session)
    assert manifest.reader("cycle.select_ms").read(None) == pytest.approx(3)
    assert manifest.reader("cycle.update_ms").read(None) == pytest.approx(4)
    # the cycle's self time is what the three spans leave: 10 - 1 - 3 - 4
    assert manifest.reader("cycle.launch_ms").read(None) == pytest.approx(2)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_none_without_its_spans(monkeypatch, name):
    monkeypatch.setattr(tracing, "session", lambda: _session(False))
    assert manifest.reader(name).read(None) is None
    monkeypatch.setattr(tracing, "session", tracing.Session)
    assert manifest.reader(name).read(None) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_none_without_the_recorder(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "gridpp_tpu_torch.tracing", None)
    monkeypatch.delattr(sys.modules["gridpp_tpu_torch"], "__getattr__",
                        raising=False)
    assert manifest.reader(name).read(None) is None


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_every_listed_metric(name):
    c = tiny.cell(name)
    res = runner.run_cell(c, 2 ** 31 + 7, 0.5, True, CPU,
                          time.perf_counter())
    assert res.correct
    s = tracing.session()
    n = s.counts["serve.cycles"]
    assert n > 0
    if name == UTEM:
        assert s.counts["cycle.utem"] == s.counts["cycle.multi"] == n
        assert s.counts["sweep.blocks"] == n    # 256 x 256 is one block
        assert set(READERS) <= set(res.metrics)
    else:
        assert s.counts["cycle.ensi"] == n
        assert "sweep.blocks" not in s.counts
    # on the CPU the trace holds no device record: the device's metrics
    # read nothing there
    host = {m["name"] for m in c.per_layer
            if m["source"] != "device_trace"}
    assert host <= set(res.metrics)
