"""The measured window: one client feeding host cycles back to back to
the program's serving entry (a closed loop), timed by the host clock.

The client makes cycle i (traffic.Traffic.make) when the stream pulls it
and notes the time; the window closes when the client stops making
cycles: at `seconds` after the window opened, or, in a traced run, when
the profiler's recorded step has ended. The program then yields the
cycles it still holds, and those count. Every yielded analysis is timed
at its arrival (the latency of cycle i: its arrival minus its pull) and
checked for finiteness on every 97th value; a uniform sample of `keep`
analyses, drawn from the seed, is kept whole for the comparison with the
reference after the window. Spans from the benchmark's own code mark the
client's making of a cycle, each pull from the stream and the harness's
handling of an analysis (gpbench.*), for the trace's idle gaps.
"""
from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field

import numpy as np
from torch.profiler import record_function

SUBSAMPLE = 97


@dataclass
class Window:
    start: int                      # index of the window's first cycle
    t0: float = 0.0                 # host clock when the window opened
    t_end: float = 0.0              # ... when its last analysis arrived
    pulled: int = 0                 # cycles handed to the program
    done: int = 0                   # analyses that arrived
    bad: set = field(default_factory=set)      # ... found not finite
    latencies: list = field(default_factory=list)
    kept: dict = field(default_factory=dict)   # cycle index -> analysis
    error: str = ""                 # the traceback of a stream that raised
    steps: list = field(default_factory=list)  # (host time, done) at steps

    @property
    def seconds(self) -> float:
        return self.t_end - self.t0

    def failed(self) -> int:
        """Cycles that never came back, and those found not finite (by
        the subsample, or whole for the kept ones)."""
        bad = self.bad | {i for i, out in self.kept.items()
                          if not np.isfinite(out).all()}
        return self.pulled - self.done + len(bad)


def run(serve, traffic, start: int, seconds: float, keep: int, seed: int,
        steps=None, on_step=None) -> Window:
    """Serve cycles start, start + 1, ... through serve(iterable of host
    cycles) -> iterator of analyses.

    steps: None for a plain window of `seconds`; else (warm_s, active_s),
    the profiler's warm-up and recorded steps: on_step() is called at the
    first arrival after warm_s and again after a further active_s, and the
    client stops after the second."""
    w = Window(start=start)
    pulls = []
    stop = [False]
    rng = np.random.default_rng([seed, 2])

    def client():
        i = start
        while not stop[0]:
            if steps is None and time.perf_counter() - w.t0 >= seconds:
                return
            with record_function("gpbench.client.make_cycle"):
                args = traffic.make(i)
            pulls.append(time.perf_counter())
            yield args
            i += 1

    w.t0 = time.perf_counter()
    w.t_end = w.t0
    it = iter(serve(client()))
    while True:
        try:
            with record_function("gpbench.stream.next"):
                out = next(it)
        except StopIteration:
            break
        except Exception:   # noqa: BLE001 - the program's fault, reported
            w.error = traceback.format_exc()
            break
        now = time.perf_counter()
        with record_function("gpbench.harness.consume"):
            i = start + w.done
            w.latencies.append(now - pulls[w.done])
            flat = np.asarray(out).reshape(-1)
            if not np.isfinite(flat[::SUBSAMPLE]).all():
                w.bad.add(i)
            # a uniform sample of `keep` analyses (reservoir sampling)
            if len(w.kept) < keep:
                w.kept[i] = out
            else:
                j = int(rng.integers(w.done + 1))
                if j < keep:
                    del w.kept[sorted(w.kept)[j]]
                    w.kept[i] = out
            w.done += 1
            w.t_end = now
        if steps is not None and len(w.steps) < 2:
            due = steps[0] if not w.steps else steps[1]
            since = w.t0 if not w.steps else w.steps[-1][0]
            if now - since >= due:
                on_step()
                w.steps.append((now, w.done))
                if len(w.steps) == 2:
                    stop[0] = True
    w.pulled = len(pulls)
    return w
