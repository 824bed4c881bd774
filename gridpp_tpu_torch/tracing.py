"""Spans and counts of the serving stream and the cycle, recorded only while
a torch.profiler session records.

The recorder is keyed on the profiler's own flag
(`torch._C._autograd._profiler_enabled()`), so it records exactly what a
profiler records: nothing outside a session, and under a schedule only the
active steps (the flag is off in `wait` and `warmup` steps). With the flag
off, `span()` returns one shared no-op context and `count()` returns at
once: no torch op, no allocation.

With the flag on, `span(name, cycle)` enters `torch.profiler.
record_function(name)`, which puts the span in the profiler's trace on the
clock of its device records, and appends `(name, parent, cycle, t0_ns,
t1_ns)` to the session's list (host `perf_counter_ns`, taken inside the
record_function, around the work alone). `parent` is the name of the
innermost span open at entry; `cycle` is the serving loop's index of the
cycle, inherited from the enclosing span when not given. `count(name, n)`
adds to the session's counts.

A session starts at the first record made with the flag on after one made
with it off (a span or count that found the profiler off), and replaces the
one before; `session()` returns the newest. Spans are opened from one
thread at a time (the serving loop's).

Span names (the work each holds): `gridpp.serve.check` (on the CPU the
host's finiteness check of a cycle's arrays; on a card their dtype and
layout test and any conversion to contiguous float32),
`gridpp.serve.stage` (their upload: pinned staging, which on a card is
also the finiteness check, native/stage.py, and the host-to-device
enqueue), `gridpp.serve.stage.wait`
(the host waiting for a staging set's last upload), `gridpp.cycle`
(`run_device`: path choice and the replay's launch or the eager cycle's
enqueue), `gridpp.cycle.sync` (the host waiting for a value the device
computes), `gridpp.cycle.capture` (a path's first call on a card: its eager
run and graph capture), `gridpp.serve.fetch` (the download's enqueue and
the copy out to a fresh array), `gridpp.serve.fetch.wait` (the host
waiting for the download). On the utem path alone (MultiEnsiPipeline's
`run_device` and ops/oi_ensi_multi.utem_serve_sweep), inside
`gridpp.cycle`: `gridpp.cycle.table` (the two ensembles gathered at the
obs and the packed per-obs table), `gridpp.cycle.select` (a block's
re-selection) and `gridpp.cycle.update` (a block's table gather and ETKF
update). Counts: `serve.cycles` (analyses yielded), `cycle.<path>` (one a
`run_device` call: fast, general, resolve, flat, ensi, ensi_prefix, multi,
and utem beside multi), `sweep.blocks` (a utem sweep's blocks),
`graph.capture`, `graph.replay`, `host.sync` (each read under
`gridpp.cycle.sync`), `serve.stage.fused` (arrays staged by the one pass
that copies and checks) and `serve.stage.converted` (arrays converted to
contiguous float32 before their staging or upload).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from time import perf_counter_ns

import torch
from torch.profiler import record_function

__all__ = ["Session", "span", "count", "session", "MAX_SPANS"]

MAX_SPANS = 1 << 20     # a session's span records; later ones are dropped
_on = torch._C._autograd._profiler_enabled


@dataclass
class Session:
    """One profiler session's record: `spans`, a list of (name, parent
    name or None, cycle or None, t0_ns, t1_ns); `counts`, name -> total;
    `dropped`, the spans past MAX_SPANS left out."""
    spans: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)
    dropped: int = 0


class _Off:
    """The shared no-op context of a span made with the profiler off. Both
    methods are C functions ("".format() and "".format(None, None, None)
    return "", which is false, so an exception passes), so entering and
    leaving it runs no Python frame."""
    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()
_session = Session()
_fresh = True       # the last record was made with the profiler off
_open = []          # the spans entered and not yet left, innermost last


def _current() -> Session:
    global _session, _fresh
    if _fresh:
        _session, _fresh = Session(), False
    return _session


class _Span:
    __slots__ = ("name", "cycle", "parent", "rf", "t0")

    def __init__(self, name, cycle):
        self.name = name
        self.cycle = cycle

    def __enter__(self):
        _current()
        up = _open[-1] if _open else None
        self.parent = up.name if up is not None else None
        if self.cycle is None and up is not None:
            self.cycle = up.cycle
        self.rf = record_function(self.name)
        self.rf.__enter__()
        _open.append(self)
        self.t0 = perf_counter_ns()

    def __exit__(self, *exc):
        t1 = perf_counter_ns()
        _open.pop()
        spans = _session.spans
        if len(spans) < MAX_SPANS:
            spans.append((self.name, self.parent, self.cycle, self.t0, t1))
        else:
            _session.dropped += 1
        self.rf.__exit__(*exc)


def span(name: str, cycle: int | None = None):
    """A context that records the span `name` of cycle `cycle` while a
    profiler records, and does nothing otherwise."""
    if not _on():
        global _fresh
        _fresh = True
        return _OFF
    return _Span(name, cycle)


def count(name: str, n: int = 1) -> None:
    """Add n to the session's count `name` while a profiler records."""
    global _fresh
    if not _on():
        _fresh = True
        return
    counts = _current().counts
    counts[name] = counts.get(name, 0) + n


def session() -> Session:
    """The newest session (an empty one before any)."""
    return _session
