"""serve.fetch_ms (ms): the self time of the program's span
gridpp.serve.fetch per served cycle: the download's enqueue and the copy
out of the pinned buffer into a fresh array, without the wait for the
download."""

from gpbench.harness.program_trace import self_ms_per_cycle


def read(ctx):
    return self_ms_per_cycle("gridpp.serve.fetch")
