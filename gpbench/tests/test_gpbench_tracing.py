"""The readers of the program's own record (harness/program_trace.py and
the six metrics that read gridpp_tpu_torch.tracing's session): values on a
hand-built session, None on an empty one and on a program without the
recorder; and a traced run of each cell on the CPU at a tiny size, whose
session holds the window's cycles on their path and reads in every metric
the cell lists."""
import sys
import time

import pytest
import torch

from gpbench.harness import manifest, runner
from gpbench.tests import tiny
from gridpp_tpu_torch import tracing

READERS = ["serve.check_ms", "serve.stage_ms", "serve.fetch_ms",
           "serve.wait_ms", "cycle.launch_ms", "cycle.host_syncs_per_cycle"]
MS = 1_000_000      # ns


def _session():
    """Two served cycles, each with a stage of 4 ms holding a 0.5 ms wait,
    a cycle of 6 ms holding a 1 ms sync and a 0.5 ms capture, and a fetch
    of 4.5 ms holding a 3.5 ms wait; 3 + 5 ms of check; three host
    syncs."""
    spans = []
    for c, check in ((0, 3), (1, 5)):
        t = 100 * c * MS
        spans += [("gridpp.serve.check", None, c, t, t + check * MS),
                  ("gridpp.serve.stage.wait", "gridpp.serve.stage", c,
                   t + 10 * MS, t + 10 * MS + MS // 2),
                  ("gridpp.serve.stage", None, c, t + 10 * MS, t + 14 * MS),
                  ("gridpp.cycle.sync", "gridpp.cycle", c, t + 20 * MS,
                   t + 21 * MS),
                  ("gridpp.cycle.capture", "gridpp.cycle", c, t + 22 * MS,
                   t + 22 * MS + MS // 2),
                  ("gridpp.cycle", None, c, t + 20 * MS, t + 26 * MS),
                  ("gridpp.serve.fetch.wait", "gridpp.serve.fetch", c,
                   t + 30 * MS, t + 33 * MS + MS // 2),
                  ("gridpp.serve.fetch", None, c, t + 30 * MS,
                   t + 34 * MS + MS // 2)]
    return tracing.Session(spans=spans, counts={"serve.cycles": 2,
                                                "host.sync": 3,
                                                "cycle.fast": 2})


WANT = {"serve.check_ms": 4.0, "serve.stage_ms": 3.5,
        "serve.fetch_ms": 1.0, "serve.wait_ms": 0.5 + 3.5 + 1.0,
        "cycle.launch_ms": 4.5, "cycle.host_syncs_per_cycle": 1.5}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_hand_built_session(monkeypatch, name):
    monkeypatch.setattr(tracing, "session", _session)
    for metric in (name, name + ".host_bound"):
        assert manifest.reader(metric).read(None) == pytest.approx(
            WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_none_without_cycles(monkeypatch, name):
    monkeypatch.setattr(tracing, "session", tracing.Session)
    assert manifest.reader(name).read(None) is None
    s = _session()
    s.counts.pop("serve.cycles")
    monkeypatch.setattr(tracing, "session", lambda: s)
    assert manifest.reader(name).read(None) is None


def test_syncs_read_zero_where_none_was_counted(monkeypatch):
    s = _session()
    s.counts.pop("host.sync")
    monkeypatch.setattr(tracing, "session", lambda: s)
    assert manifest.reader("cycle.host_syncs_per_cycle").read(None) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_none_without_the_recorder(monkeypatch, name):
    """A program that predates the recorder: the import fails."""
    monkeypatch.setitem(sys.modules, "gridpp_tpu_torch.tracing", None)
    monkeypatch.delattr(sys.modules["gridpp_tpu_torch"], "__getattr__",
                        raising=False)
    assert manifest.reader(name).read(None) is None


@pytest.mark.parametrize("cell, path", [
    ("det2k_10k.static", "cycle.fast"),
    ("det2k_10k.churn5", "cycle.general"),
    ("ensi2k_10k_m10.static", "cycle.ensi_prefix")])
def test_traced_run_reads_the_programs_record(cell, path):
    c = tiny.cell(cell)
    res = runner.run_cell(c, 2 ** 31 + 7, 0.5, True, torch.device("cpu"),
                          time.perf_counter())
    assert res.correct
    s = tracing.session()
    n = s.counts["serve.cycles"]
    assert n > 0 and s.counts[path] == n
    assert "graph.capture" not in s.counts and not s.dropped
    assert s.counts.get("host.sync", 0) == (n if path == "cycle.general"
                                            else 0)
    ours = {m["name"] for m in c.per_layer
            if m["name"].split(".host_bound")[0] in READERS}
    assert ours and ours <= set(res.metrics)
    for name in ours:
        assert res.metrics[name]["value"] >= 0.0
