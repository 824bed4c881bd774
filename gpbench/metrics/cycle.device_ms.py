"""cycle.device_ms (ms): the union of the intervals of the cycle's own
device work (kernels, device-to-device copies and sets; not the
host-device copies) per cycle in the recorded step."""

from gpbench.harness.trace import covered


def read(ctx):
    t = ctx.trace
    work = t.kernels + t.other
    if not work or not t.cycles:
        return None
    return covered(work) / 1e3 / t.cycles
