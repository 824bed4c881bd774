"""The traced run's profiler and what the per-layer readers get from it.

torch.profiler runs a schedule of one warm-up step and one recorded step
(a plain window loses part of a CUDA graph replay's kernels unless a step
comes first). Only the recorded step is kept. Its span ("ProfilerStep*")
is the traced window; every device record inside it is clipped to it and
sorted into kernels, host-device copies (HtoD, DtoH) and the rest of the
device's copies and sets (DtoD, memset), which count with the kernels as
the cycle's own device work. Spans (record_function ranges, which the
profiler also draws on the device's timeline) are no device work.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, schedule

HOST_COPIES = ("Memcpy HtoD", "Memcpy DtoH")
SPAN_PREFIX = "gpbench."


def profiler():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))


@dataclass
class Trace:
    start: float = 0.0      # the recorded step, microseconds
    end: float = 0.0
    cycles: int = 0         # analyses that arrived in the recorded step
    kernels: list = field(default_factory=list)   # (name, start, end)
    copies: list = field(default_factory=list)    # HtoD / DtoH
    other: list = field(default_factory=list)     # DtoD, memset
    spans: list = field(default_factory=list)     # the benchmark's spans

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e6

    def device(self) -> list:
        return self.kernels + self.copies + self.other


def union(intervals) -> list:
    """Disjoint sorted (start, end) covering the intervals."""
    out = []
    for a, b in sorted((a, b) for _, a, b in intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(intervals) -> float:
    """Microseconds that the union of the intervals covers."""
    return sum(b - a for a, b in union(intervals))


def _annotation(e) -> bool:
    """A record_function span or a profiler step, on either timeline."""
    return bool(getattr(e, "is_user_annotation", False)) or \
        e.name.startswith((SPAN_PREFIX, "ProfilerStep"))


def parse(prof, cycles: int) -> Trace:
    events = prof.events()
    steps = [e for e in events if e.name.startswith("ProfilerStep")]
    if not steps:
        raise RuntimeError("the profiler recorded no step")
    t = Trace(start=steps[0].time_range.start, end=steps[0].time_range.end,
              cycles=cycles)
    for e in events:
        a = max(e.time_range.start, t.start)
        b = min(e.time_range.end, t.end)
        if b <= a:
            continue
        rec = (e.name, a, b)
        if _annotation(e):
            # a span; on the device's timeline too, where it is no work
            if e.device_type != torch.autograd.DeviceType.CUDA \
                    and e.name.startswith(SPAN_PREFIX):
                t.spans.append(rec)
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith(HOST_COPIES):
                t.copies.append(rec)
            elif e.name.startswith(("Memcpy", "Memset")):
                t.other.append(rec)
            else:
                t.kernels.append(rec)
    return t


def breakdown(t: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the recorded step, and
    its longest idle gaps, each named by the innermost benchmark span the
    host was in at the gap's middle (seconds)."""
    by_name = {}
    for name, a, b in t.device():
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union(t.device())
    edges = [t.start] + [x for ab in busy for x in ab] + [t.end]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (a + b)
        inside = [s for s in t.spans if s[1] <= mid <= s[2]]
        name = (min(inside, key=lambda s: s[2] - s[1])[0] if inside
                else "outside the benchmark's spans")
        named.append([name, (b - a) / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
