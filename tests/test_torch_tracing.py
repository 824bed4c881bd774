"""gridpp_tpu_torch.tracing on the CPU: the serving stream's and the
cycle's spans and counts, recorded only while a torch.profiler session
records (on the card, tests/test_torch_cuda.py adds the waits and the graph
capture).

A tiled Pipeline at 256 x 256 with 150 stations, max_points 6, Mean h=2 and
static ratios serves 6 cycles: all obs valid (the fast path), or a third of
them missing (the general path, after the host's finiteness check). With
the profiler off nothing is recorded and record_function is never entered;
under the benchmark's schedule (one warm-up step, one active step) only the
active step's cycles are; each run_device path counts its name once; a new
profiler session replaces the record of the last; the record is bounded; a
consumer's time between two analyses is in no span. A served utem cycle
(MultiEnsiPipeline at 40 x 40) opens its table, selection and update spans
inside gridpp.cycle, and no other pipeline opens them.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, schedule  # noqa: E402

import gridpp_tpu_torch as gt  # noqa: E402
from gridpp_tpu_torch import tracing  # noqa: E402

SHAPE = (256, 256)
N_OBS = 150
CYCLES = 6
SERVE = {"gridpp.serve.check", "gridpp.serve.stage", "gridpp.cycle",
         "gridpp.serve.fetch"}
_CACHE = {}


def _problem(n=SHAPE, n_obs=N_OBS, seed=5):
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(55, 56, n[0]),
                             np.linspace(5, 6.5, n[1]), indexing="ij")
    grid = gt.Grid(lats, lons)
    pts = gt.Points(rng.uniform(55, 56, n_obs), rng.uniform(5, 6.5, n_obs),
                    np.zeros(n_obs), np.zeros(n_obs))
    bg = rng.normal(280, 5, n).astype(np.float32)
    pobs = (bg.reshape(-1)[grid.nearest_map(pts.lats, pts.lons)]
            + rng.normal(0, 1, n_obs)).astype(np.float32)
    return grid, pts, bg, pobs


def _pipeline():
    """(tiled Pipeline, all-valid cycles, cycles with a third of the obs
    missing), built once."""
    if "pipe" not in _CACHE:
        grid, pts, bg, pobs = _problem()
        pipe = gt.Pipeline(grid, pts, gt.BarnesStructure(10000.0),
                           halfwidth=2, statistic=gt.Mean, max_points=6,
                           ratios=np.full(N_OBS, 0.1, np.float32),
                           device="cpu")
        gap = pobs.copy()
        gap[::3] = np.nan
        _CACHE["pipe"] = (
            pipe,
            [(bg + np.float32(i), pobs + np.float32(i))
             for i in range(CYCLES)],
            [(bg + np.float32(i), gap + np.float32(i))
             for i in range(CYCLES)])
    return _CACHE["pipe"]


def _profiled(fn, **kw):
    """fn(prof) under a CPU profiler session, after a record made with the
    profiler off, so that the session's record is a new one."""
    assert not torch._C._autograd._profiler_enabled()
    tracing.count("serve.cycles")   # off: records nothing
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        out = fn(prof)
    return prof, out


def _spans(name=None):
    return [s for s in tracing.session().spans
            if name is None or s[0] == name]


def test_profiler_off_records_nothing(monkeypatch):
    pipe, valid, gaps = _pipeline()

    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(tracing, "record_function", refused)
    before = tracing.session()
    n, counts = len(before.spans), dict(before.counts)
    assert len(list(pipe.serve_stream(valid + gaps))) == 2 * CYCLES
    assert tracing.session() is before
    assert len(before.spans) == n and before.counts == counts
    # one shared context, whatever the span
    assert tracing.span("gridpp.cycle", 1) is tracing.span("a")


def test_schedule_records_the_active_step_alone():
    """Warm-up step: analyses 0 and 1 (cycles 0-2 queued); active step:
    analyses 2 and 3, so cycles 3 and 4 are checked, staged and run and
    cycles 2 and 3 fetched. The obs have gaps, so each cycle's host sync
    is a child of its gridpp.cycle."""
    pipe, _, gaps = _pipeline()

    def serve(prof):
        it = iter(pipe.serve_stream(gaps))
        for _ in range(2):
            next(it)
            next(it)
            prof.step()
        return list(it)

    prof, rest = _profiled(serve, schedule=schedule(wait=0, warmup=1,
                                                    active=1, repeat=1))
    assert len(rest) == CYCLES - 4
    got = sorted((s[0], s[1], s[2]) for s in _spans())
    want = sorted(
        [(name, None, c) for c in (3, 4) for name in
         ("gridpp.serve.check", "gridpp.serve.stage", "gridpp.cycle")]
        + [("gridpp.cycle.sync", "gridpp.cycle", c) for c in (3, 4)]
        + [("gridpp.serve.fetch", None, c) for c in (2, 3)])
    assert got == want
    assert tracing.session().counts == {"serve.cycles": 2,
                                        "cycle.general": 2, "host.sync": 2}
    assert all(0 <= s[3] <= s[4] for s in _spans())
    names = {e.name for e in prof.events()}
    assert SERVE | {"gridpp.cycle.sync"} <= names


def _small(kind):
    """(a pipeline of kind, its run_device call) at 40 x 40: flat
    Pipeline, EnsiPipeline with 3 members, MultiEnsiPipeline ebesc."""
    grid, pts, bg, pobs = _problem((40, 40), 30, seed=2)
    st = gt.BarnesStructure(30000.0)
    po = torch.as_tensor(pobs)
    if kind == "flat":
        pipe = gt.Pipeline(grid, pts, st, max_points=5, device="cpu")
        ratios = torch.full((30,), 0.2)
        return lambda: pipe.run_device(torch.as_tensor(bg), po, ratios)
    ens = torch.as_tensor(np.stack([bg + i for i in range(3)], axis=2))
    if kind == "multi":
        pipe = gt.MultiEnsiPipeline(grid, pts, st, max_points=5,
                                    device="cpu")
        pe = po[:, None].expand(30, 3).contiguous()
        return lambda: pipe.run_device(ens, pe, torch.full((30,), 0.2))
    pipe = gt.EnsiPipeline(grid, pts, st, max_points=5, device="cpu")
    return lambda: pipe.run_device(ens, po, torch.full((30,), 1.5),
                                   assume_valid=kind == "ensi_prefix")


def _tiled_call(kw, gaps=False):
    pipe, valid, cycles_gaps = _pipeline()
    bg, po = (cycles_gaps if gaps else valid)[0]
    return lambda: pipe.run_device(torch.as_tensor(bg), torch.as_tensor(po),
                                   **kw)


@pytest.mark.parametrize("case, want", [
    ("fast", {"cycle.fast": 1}),
    ("fast_checked", {"cycle.fast": 1, "host.sync": 1}),
    ("fast_tensor_ratios", {"cycle.fast": 1, "host.sync": 1}),
    ("auto_gaps", {"cycle.general": 1, "host.sync": 1}),
    ("general", {"cycle.general": 1}),
    ("resolve", {"cycle.resolve": 1}),
    ("flat", {"cycle.flat": 1}),
    ("ensi", {"cycle.ensi": 1}),
    ("ensi_prefix", {"cycle.ensi_prefix": 1}),
    ("multi", {"cycle.multi": 1})])
def test_each_path_counts_its_name(case, want):
    ratios = torch.full((N_OBS,), 0.1)
    call = {
        "fast": lambda: _tiled_call(dict(assume_valid=True)),
        "fast_checked": lambda: _tiled_call({}),
        "fast_tensor_ratios": lambda: _tiled_call(
            dict(pratios=ratios, assume_valid=True)),
        "auto_gaps": lambda: _tiled_call({}, gaps=True),
        "general": lambda: _tiled_call(dict(path="general")),
        "resolve": lambda: _tiled_call(dict(path="resolve")),
    }.get(case, lambda: _small(case))()
    _profiled(lambda prof: call())
    assert tracing.session().counts == want
    syncs = _spans("gridpp.cycle.sync")
    assert len(syncs) == want.get("host.sync", 0)
    assert all(s[1] is None for s in syncs)   # run_device called directly


@pytest.mark.parametrize("gaps", [False, True])
def test_served_cycles_count_their_path(gaps):
    """All obs valid: the fast path alone, no host sync. A third missing:
    the general path and one host sync a cycle."""
    pipe, valid, cycles_gaps = _pipeline()
    cycles = cycles_gaps if gaps else valid
    _profiled(lambda prof: list(pipe.serve_stream(cycles)))
    want = ({"cycle.general": CYCLES, "host.sync": CYCLES} if gaps
            else {"cycle.fast": CYCLES})
    assert tracing.session().counts == dict(want, **{"serve.cycles": CYCLES})
    for name in SERVE:
        assert sorted(s[2] for s in _spans(name)) == list(range(CYCLES))


def test_a_new_session_replaces_the_last():
    pipe, valid, _ = _pipeline()
    _profiled(lambda prof: list(pipe.serve_stream(valid[:2])))
    first = tracing.session()
    assert first.counts["serve.cycles"] == 2
    _profiled(lambda prof: list(pipe.serve_stream(valid[:3])))
    assert tracing.session() is not first
    assert tracing.session().counts["serve.cycles"] == 3
    assert first.counts["serve.cycles"] == 2


def test_the_record_is_bounded(monkeypatch):
    pipe, valid, _ = _pipeline()
    monkeypatch.setattr(tracing, "MAX_SPANS", 5)
    _profiled(lambda prof: list(pipe.serve_stream(valid[:3])))
    s = tracing.session()
    assert len(s.spans) == 5 and s.dropped == 4 * 3 - 5
    assert s.counts["serve.cycles"] == 3


def test_a_slow_consumer_is_in_no_span():
    """No span stays open across a yield: the 20 ms a consumer sleeps after
    each analysis lies in no span, the fetch's included."""
    pipe, valid, _ = _pipeline()
    naps = []

    def serve(prof):
        for _ in pipe.serve_stream(valid[:4]):
            t0 = time.perf_counter_ns()
            time.sleep(0.02)
            naps.append((t0, time.perf_counter_ns()))

    _profiled(serve)
    assert len(_spans("gridpp.serve.fetch")) == 4 and len(naps) == 4
    for name, _, _, t0, t1 in _spans():
        assert all(t1 <= a or b <= t0 for a, b in naps), name


UTEM_SPANS = {"gridpp.cycle.table", "gridpp.cycle.select",
              "gridpp.cycle.update"}


def _served_cycles(kind, block=1 << 20):
    """(a pipeline of kind at 40 x 40 with 30 stations, two host cycles
    for its serve_stream): a flat Pipeline with static ratios, EnsiPipeline
    with 3 members, or MultiEnsiPipeline ebe, ebesc or utem, whose
    correlation ensemble is drawn apart from the background."""
    grid, pts, bg, pobs = _problem((40, 40), 30, seed=2)
    st = gt.BarnesStructure(30000.0)
    rng = np.random.default_rng(3)
    ratios = np.full(30, 0.2, np.float32)
    if kind == "pipeline":
        pipe = gt.Pipeline(grid, pts, st, max_points=5, ratios=ratios,
                           device="cpu")
        return pipe, [(bg + np.float32(i), pobs) for i in range(2)]
    ens = [rng.normal(280, 5, (40, 40, 3)).astype(np.float32)
           for _ in range(2)]
    if kind == "ensi":
        pipe = gt.EnsiPipeline(grid, pts, st, max_points=5, device="cpu")
        return pipe, [(x, pobs, np.full(30, 1.5, np.float32)) for x in ens]
    pipe = gt.MultiEnsiPipeline(grid, pts, st, variant=kind, max_points=5,
                                block=block, device="cpu")
    po = pobs if kind == "utem" else np.repeat(pobs[:, None], 3, axis=1)
    corr = () if kind == "ebesc" else (
        rng.normal(280, 5, (40, 40, 3)).astype(np.float32),)
    return pipe, [(x, po, ratios) + corr for x in ens]


def test_a_utem_cycle_traces_its_table_selection_and_update():
    """Blocks of 512 rows: 4 a 1600-gridpoint cycle (3 of 512, 1 of 64).
    Each served cycle opens gridpp.cycle.table once and gridpp.cycle.select
    and gridpp.cycle.update once a block, each inside its gridpp.cycle."""
    pipe, cycles = _served_cycles("utem", block=512)
    _profiled(lambda prof: list(pipe.serve_stream(cycles)))
    assert tracing.session().counts == {
        "serve.cycles": 2, "cycle.multi": 2, "cycle.utem": 2,
        "sweep.blocks": 8}
    outer = {s[2]: s for s in _spans("gridpp.cycle")}
    assert sorted(outer) == [0, 1]
    for name, per_cycle in (("gridpp.cycle.table", 1),
                            ("gridpp.cycle.select", 4),
                            ("gridpp.cycle.update", 4)):
        spans = _spans(name)
        assert sorted(s[2] for s in spans) == [0] * per_cycle \
            + [1] * per_cycle
        for _, parent, c, t0, t1 in spans:
            assert parent == "gridpp.cycle"
            assert outer[c][3] <= t0 <= t1 <= outer[c][4]
    # select and update alternate, block by block
    inner = [s[0] for s in sorted(_spans(), key=lambda s: s[3])
             if s[0] in UTEM_SPANS and s[2] == 0]
    assert inner == ["gridpp.cycle.table"] + [
        "gridpp.cycle.select", "gridpp.cycle.update"] * 4


@pytest.mark.parametrize("kind", ["pipeline", "ensi", "ebe", "ebesc"])
def test_other_cycles_trace_no_utem_span(kind):
    pipe, cycles = _served_cycles(kind)
    _profiled(lambda prof: list(pipe.serve_stream(cycles)))
    counts = tracing.session().counts
    assert counts["serve.cycles"] == 2
    assert not {"cycle.utem", "sweep.blocks"} & set(counts)
    assert not UTEM_SPANS & {s[0] for s in _spans()}
    assert len(_spans("gridpp.cycle")) == 2
