"""serve.copy_ms (ms): device time of the host-to-device and
device-to-host copies per cycle in the recorded step (the serving
stream's uploads and downloads)."""


def read(ctx):
    t = ctx.trace
    if not t.copies or not t.cycles:
        return None
    return sum(b - a for _, a, b in t.copies) / 1e3 / t.cycles
