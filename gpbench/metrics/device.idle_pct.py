"""device.idle_pct (%): 100 x (1 - the union of every device record,
kernels and copies, over the recorded step's span)."""

from gpbench.harness.trace import covered


def read(ctx):
    t = ctx.trace
    if not t.device() or t.end <= t.start:
        return None
    return 100.0 * (1.0 - covered(t.device()) / (t.end - t.start))
