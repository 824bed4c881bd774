"""serve.stage_ms (ms): the self time of the program's span
gridpp.serve.stage per served cycle: the copy into pinned buffers and the
upload's enqueue, without the wait for a staging set's last upload."""

from gpbench.harness.program_trace import self_ms_per_cycle


def read(ctx):
    return self_ms_per_cycle("gridpp.serve.stage")
