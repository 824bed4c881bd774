"""cycle.roofline_pct (%): the configuration's frozen cycle bound
(counts/<config>.py, at the card's peaks) over cycle.device_ms."""

from gpbench.counts import peaks
from gpbench.harness.trace import covered


def read(ctx):
    t, p = ctx.trace, ctx.peaks
    work = t.kernels + t.other
    if not work or not t.cycles or p is None:
        return None
    device_s = covered(work) / 1e6 / t.cycles
    return 100.0 * peaks.bound_s(*ctx.cycle_bound, p) / device_s
