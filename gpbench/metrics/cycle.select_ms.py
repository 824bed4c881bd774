"""cycle.select_ms (ms): the program's span gridpp.cycle.select per served
cycle: each block's re-selection of the top max_points valid shortlist
candidates in the utem sweep. None where the program's record holds no
such span."""

from gpbench.harness.program_trace import session

SPAN = "gridpp.cycle.select"


def read(ctx):
    s = session()
    if s is None:
        return None
    ns = [t1 - t0 for name, _, _, t0, t1 in s.spans if name == SPAN]
    if not ns:
        return None
    return sum(ns) / 1e6 / s.counts["serve.cycles"]
